"""The port's distribution slice (M7b) on 4 gloo ranks: (2, 2) and (1, 4)
("data", "model") CPU meshes, spawned once for the module by
tests/torch_mesh_worker.py (its "serve" part; a FileStore under tmp_path, no
TCP port; 120 s limit; the train steps are test_torch_distribution_train.py's).
Held against:

  * the reference's oracles (`repro.kernels.ref`): the meshed
    `sharded_topk` — K1/K3's plain versions on each rank's 16-row slab,
    the lists all-gathered and re-ranked — over the whole bank, masked
    (tombstones, a tenant with 2 rows, one with none) and unmasked, k = 6
    and k = 20 > a slab's rows, the bank as a DTensor and whole;
  * the unmeshed port service: the reference's mesh case of
    test_sharded_service.py (shards=8, eight tenants' cities) with
    `mesh=`: equal contexts, `bank_device()` a DTensor Shard(0) over the 4
    ranks; its durable directory written by rank 0 alone and recovered by
    every rank with equal contexts (the meshed scheduler and frontend are
    test_torch_mesh_serving.py's);
  * the one-device port: prefill + 3 decode steps' logits of the serving
    families (and, on the (1, 4) mesh, 2 kv heads over the 4-wide `model`
    axis, each rank's query head cutting the kv head it reads).

Tolerances: logits 1e-4 of their largest |value|; top-k ids exact, scores
rtol 1e-5.  The meshed sums (partial products reduced over `model`) add in
other orders than one device's.
"""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import torch_mesh_worker as W  # noqa: E402

LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return W.results(tmp_path_factory.mktemp("mesh"), "serve")


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "plain"])
@pytest.mark.parametrize("k", [6, 20])
def test_meshed_sharded_topk_equals_the_reference_oracles(results, k, masked):
    import jax.numpy as jnp
    from repro.kernels import ref
    q, bank, q_ns, bank_ns = W.topk_inputs()
    if masked:
        sr, ir = ref.topk_mips_masked_ref(jnp.asarray(q), jnp.asarray(bank),
                                          jnp.asarray(q_ns),
                                          jnp.asarray(bank_ns), k=k)
        got = [results[f"topk_masked_{k}"],
               results[f"topk_masked_whole_{k}"]]
    else:
        sr, ir = ref.topk_mips_ref(jnp.asarray(q), jnp.asarray(bank), k=k)
        got = [results[f"topk_{k}"]]
    sr, ir = np.asarray(sr), np.asarray(ir)
    live = ir >= 0
    if masked:
        assert not live[4].any() and live[3].sum() == 2   # ns 9, ns 7
    for s, i in got:
        np.testing.assert_array_equal(i.numpy(), ir)
        np.testing.assert_allclose(s.numpy()[live], sr[live], rtol=1e-5)
        assert (s.numpy()[~live] < -1e37).all()


def test_meshed_service_answers_as_the_unmeshed_one(results):
    from torch.distributed.tensor import Shard
    from repro_torch.core import MemoryService
    from repro_torch.core.embedder import HashEmbedder
    ref = W.fill(MemoryService(HashEmbedder(device="cpu"), device="cpu",
                               budget=800))
    want = [c.text for c in ref.retrieve_batch(W.QUERIES)]
    assert results["svc_texts"] == want
    assert all(c.lower() in t.lower() for c, t in zip(W.CITIES, want))
    placements, shape, local, ranks = results["svc_bank"]
    assert placements == (Shard(0), Shard(0)) and ranks == W.WORLD
    assert local == (shape[0] // W.WORLD, shape[1])
    stats = results["svc_stats"]
    assert stats["meshed"] and stats["n_shards"] == 8
    assert stats["total_slots"] == shape[0]


def test_meshed_durable_files_come_from_rank_0(results):
    from repro_torch.checkpoint.replication import open_wal
    assert results["svc_rotate"].get("written_by") is None   # rank 0 wrote
    assert results["rank1"]["svc_rotate"] == {
        "written_by": "rank 0 of the mesh"}
    wal = open_wal(str(results["root"] / "meshed-dir"))
    assert wal.latest_snapshot() is not None
    assert results["svc_recovered"] == results["svc_texts"]
    assert results["rank1"]["svc_recovered"] == results["svc_texts"]


@pytest.mark.parametrize("name", W.SERVE_FAMILIES)
def test_meshed_prefill_and_decode_logits_equal_one_device(results, name):
    cfg, model, params = W.one_device(name)
    P = W.S + (cfg.num_image_tokens or 0)
    with torch.no_grad():
        logits, caches = model.prefill(params, W.family_batch(cfg))
        caches = model.prepare_decode_caches(caches, P, W.MAX_LEN)
        want = [logits]
        for t in range(W.STEPS):
            tok = torch.full((W.B, 1), 5 + t, dtype=torch.int32)
            lg, caches = model.decode_step(
                params, tok, caches, torch.full((W.B,), P + t,
                                                dtype=torch.int32))
            want.append(lg)
    got = results[f"serve_{name}"]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= LOGIT_TOL * scale, (name, i, err, scale)
