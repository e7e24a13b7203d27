"""The port's scheduler and HTTP frontend on a mesh of several ranks (M7c),
on 4 gloo ranks: tests/torch_mesh_worker.py's "scheduler" part, spawned
once for the module (a FileStore under tmp_path; the frontend listens on
127.0.0.1).  Every rank builds the meshed service (shards 8 over the
(2, 2) mesh, a durable directory, a policy that auto-compacts and rotates
snapshots) and a MemoryScheduler; rank 0 serves it with a MemoryFrontend
and drives 8 closed-loop clients (records, retrieves, two evictions, the
auto-compaction, an explicit compaction, retrieves again), through the
scheduler and as `HttpMemory`.  Held against:

  * the same requests (`drive_scheduled`) on an unmeshed service (shards
    8, the same policy, its own scheduler and frontend) in this process:
    every answer byte-equal (the payloads' JSON, the HTTP contexts'
    fields);
  * one another: every rank's bank SHA-256 (its host state and the whole
    device bank) equal after the run, every rank running the same number
    of ticks and the same shipped maintenance (auto-compactions, snapshot
    rotations), submit and the frontend refused on ranks 1-3 with an
    error naming rank 0, and every rank's close() returning once rank 0's
    stops it;
  * the durable directory: written by rank 0 (the other ranks journal
    nothing) and recovered by an unmeshed service with the same answers.

Then the part's faults (`run_faults`): a meshed service whose policy
wants a daemon refuses client ops without a scheduler, a bounded queue
in "block" mode flushes on the enqueue, and a tick that fails on one
rank alone breaks the scheduler on every rank.
"""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import torch_mesh_worker as W  # noqa: E402

ANSWERS = ("record", "http_record", "retrieve", "http_retrieve", "evict",
           "compact", "after", "http_after")
RANKS = range(1, W.WORLD)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return W.results(tmp_path_factory.mktemp("sched"), "scheduler",
                     timeout=120.0)


@pytest.fixture(scope="module")
def unmeshed(tmp_path_factory):
    from repro_torch.core import MemoryService
    from repro_torch.core.embedder import HashEmbedder
    from repro_torch.serving.frontend import MemoryFrontend
    svc = MemoryService(HashEmbedder(device="cpu"), device="cpu",
                        budget=800, shards=8,
                        data_dir=str(tmp_path_factory.mktemp("plain")),
                        policy=W.sched_policy())
    svc.start_scheduler(tick_interval_s=0.002)
    fe = MemoryFrontend(svc, {W.HTTP_KEY: W.HTTP_TENANT}).start()
    try:
        return W.drive_scheduled(svc, fe.address)
    finally:
        fe.close()
        svc.close()


@pytest.mark.parametrize("what", ANSWERS)
def test_meshed_answers_equal_the_unmeshed_service(results, unmeshed, what):
    got = results["sched_answers"][what]
    assert got == unmeshed[what]
    if what in ("retrieve", "http_retrieve"):
        assert all('"triples": []' not in a for a in got)


def test_every_rank_holds_the_same_bank(results):
    digests = {results["sched_digest"]} | {
        results[f"rank{r}"]["sched_digest"] for r in RANKS}
    assert len(digests) == 1


def test_every_rank_runs_the_same_ticks_and_maintenance(results):
    ticks = results["sched_ticks"]
    lifecycle = results["sched_lifecycle"]
    assert ticks > 0 and results["sched_mesh"]["leader"] == 0
    assert lifecycle["auto_compactions"] >= 1
    for r in RANKS:
        other = results[f"rank{r}"]
        assert other["sched_ticks"] == ticks
        assert other["sched_lifecycle"]["auto_compactions"] == \
            lifecycle["auto_compactions"]
        # the shipped rotations; rank 0 writes one more, its final snapshot
        assert other["sched_lifecycle"]["rotations"] == \
            lifecycle["rotations"] - 1


@pytest.mark.parametrize("rank", RANKS)
def test_other_ranks_refuse_requests_and_close_with_rank_0(results, rank):
    other = results[f"rank{rank}"]
    for what in ("submit", "frontend"):
        assert "rank 0" in other[f"sched_{what}"], other[f"sched_{what}"]
    assert other["sched_closed"] and results["sched_closed"]


def test_durable_files_come_from_rank_0(results):
    import json
    from repro_torch.checkpoint.replication import open_wal
    from repro_torch.core import MemoryService
    from repro_torch.core.api import payload_to_json
    from repro_torch.core.embedder import HashEmbedder
    data_dir = str(results["root"] / "sched-dir")
    assert open_wal(data_dir).latest_snapshot() is not None
    rec = MemoryService.recover(data_dir, HashEmbedder(device="cpu"),
                                device="cpu", budget=800)
    questions = [(f"u{i}/c0", q) for i in range(W.SCHED_CLIENTS)
                 for q in ("Which city does the user live in?",
                           "What is the dog's name?")]
    got = [json.dumps(payload_to_json(c), sort_keys=True)
           for c in rec.retrieve_batch(questions)]
    assert got == results["sched_answers"]["after"]
    rec.close()


def test_unmaintained_meshed_service_refuses_a_daemon_policy(results):
    for out in [results] + [results[f"rank{r}"] for r in RANKS]:
        assert "start_scheduler()" in out["fault_unmaintained"], \
            out["fault_unmaintained"]


def test_meshed_bounded_queue_flushes_on_the_enqueue(results):
    """No daemon drains a meshed service's queue: a "block"-mode enqueue
    that finds it full flushes it, at the same enqueue on every rank; the
    answers equal an unmeshed service's flushed at those points."""
    import json
    from repro_torch.core import MemoryService
    from repro_torch.core.api import payload_to_json
    from repro_torch.core.embedder import HashEmbedder
    got = results["fault_block"]
    assert got["pending"] == 1 and got["flushes"] == 2
    for r in RANKS:
        assert results[f"rank{r}"]["fault_block"] == got
    svc = MemoryService(HashEmbedder(device="cpu"), device="cpu",
                        budget=800, shards=8)
    for i in range(W.BLOCK_OPS):
        if svc.store.pending_count >= W.BLOCK_PENDING:
            svc.flush()
        svc.enqueue(f"u{i}/c0", "s0", W._msg(f"I live in {W.CITIES[i]}.", i))
    svc.flush()
    want = [json.dumps(payload_to_json(c), sort_keys=True)
            for c in svc.retrieve_batch(W.block_questions())]
    assert got["answers"] == want


def test_a_tick_failed_on_one_rank_breaks_every_rank(results):
    """rank 1's evict fails where rank 0's succeeds: the ranks' outcomes
    differ, so rank 0 answers the evict with MeshDiverged, refuses the
    next submit, reports it on /v1/readyz, and every rank's scheduler is
    marked broken and still closes."""
    assert results["fault_tick"] == ["ok", "error", "MeshDiverged"]
    assert results["fault_submit"] == "MeshDiverged"
    status, body = results["fault_readyz"]
    assert status == 503 and "MeshDiverged" in body["mesh_broken"]
    for out in [results] + [results[f"rank{r}"] for r in RANKS]:
        assert "outcomes differ" in out["fault_broken"]
        assert out["fault_closed"]
    assert "failed requests [0]" in results["rank1"]["fault_broken"]
