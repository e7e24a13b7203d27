"""Multi-pod dry-run, as the reference's `repro/launch/dryrun.py`: build
every (arch x input shape) step on the production meshes, run rank 0's view
of it once with no device and no memory, and dump per-rank counts and the
H100 roofline.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-3b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multipod] [--out artifacts/dryrun]

The reference AOT-compiles each step for 512 placeholder host devices and
reads XLA's cost and memory analysis.  Here the step runs in one process
under an in-process "fake" process group of the mesh's world size (256, or
512 with --multipod) and `FakeTensorMode`: parameters, optimizer moments,
batch and caches are DTensors whose local shards are fake tensors of rank
0's shapes, so the train step (forward, backward, `update`), prefill or
decode runs through the same code as on cards, launching nothing.  What it
records, per rank:

  flops             the local ops' FLOPs, by FlopCounterMode's formulas
                    (`torch.utils.flop_counter.flop_registry`), counted by
                    a dispatch mode that sees each DTensor op's local ops
                    (the DTensor-level op itself is not counted), on a
                    second run of the step (the first fills DTensor's
                    sharding cache, whose shape inference runs ops on
                    global shapes);
  bytes             the local ops' operand and result bytes (views
                    excluded): an upper bound on what they move, standing
                    in for XLA's "bytes accessed";
  collective_bytes  result bytes of each `_c10d_functional` collective
                    (all_gather_into_tensor, all_reduce,
                    reduce_scatter_tensor, all_to_all_single) and their
                    counts — DTensor's redistributes;
  memory.argument_bytes  the local shard bytes of params, optimizer state,
                    batch and caches, from the rules' specs;
  memory.temp_bytes the peak of what the step itself allocates on the rank
                    (its temporaries and its outputs alike: the reference's
                    temp leaves outputs out), from MemTracker
                    (`torch.distributed._tools.mem_tracker`) around the
                    counted run; peak_bytes adds the arguments;
  memory.moe_dispatch_bytes  a rank's bytes of one MoE layer's dispatch
                    buffers (its block of the expert buffer, and the
                    gathered tokens in the global dispatch), computed
                    from the config and the mesh;
  model_flops, roofline (launch/roofline.py), useful_flops_ratio.

Fields with the reference's names keep them; `hlo_flops`/
`hlo_bytes_accessed` are `flops`/`bytes`.  No counterpart: the reference's
`lower_s`/`compile_s` (here `run_s`, the fake run's seconds), its
scan-body-once fields, and `memory`'s output/generated-code/alias bytes
(None).  The probes of
launch/roofline.py keep a 61-layer model cheap: `run_one(probes=True)` runs
only the probe configs and extrapolates (temp_bytes too, as if a peak
grew linearly with the layers).  Every figure is computed from
counts and datasheet figures, not measured.

Context-parallel decode (long_500k at batch 1: the cache's sequence
sharded over `data`) runs here as on real ranks: each rank's K5 plain
version (MLA's latent scores) on its own rows with the log-sum-exp, and the
combine (`attention.combine_shards`), so the collectives counted there are
the all-gathers of each layer's (R, B, 1, H, D) outputs and (R, B, H)
log-sum-exps over `data`, never the cache.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.common import partitioning as pt
from repro_torch.common.module import leaves_with_names, unflatten
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.sharding import build_step, supported
from repro_torch.models.config import INPUT_SHAPES

COLLECTIVES = ("all_gather_into_tensor", "all_reduce",
               "reduce_scatter_tensor", "all_to_all_single")


def fake_world(world: int) -> None:
    """An in-process "fake" process group of `world` ranks (this process
    is rank 0), replacing an earlier fake one of another size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry-run needs a process of its own: a "
                               "real process group is initialised")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def fake_mesh(shape: pt.MeshShape):
    from torch.distributed.device_mesh import init_device_mesh
    fake_world(shape.size)
    return init_device_mesh("cpu", tuple(shape.shape[a]
                                         for a in shape.axis_names),
                            mesh_dim_names=shape.axis_names)


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


class RankCounter:
    """A dispatch mode counting rank 0's local work (see the module
    docstring); built lazily so importing this module stays cheap."""

    def __new__(cls):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves
        from torch.utils.flop_counter import flop_registry

        class _Counter(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.flops = 0
                self.bytes = 0
                self.coll = {k: 0 for k in COLLECTIVES}
                self.counts = {k: 0 for k in COLLECTIVES}

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented   # count its local ops instead
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                packet = func._overloadpacket
                formula = flop_registry.get(packet)
                if formula is not None:
                    self.flops += int(formula(*args, **kwargs, out_val=out))
                name = func.__name__.split(".")[0]
                if func.namespace == "_c10d_functional" and \
                        name in self.coll:
                    self.coll[name] += sum(_nbytes(t)
                                           for t in tree_leaves(out))
                    self.counts[name] += 1
                elif not func.is_view and func.namespace == "aten":
                    self.bytes += sum(_nbytes(t) for t in tree_leaves(
                        (args, kwargs, out)))
                return out

        return _Counter()


def model_flops(cfg, shape) -> float:
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch            # decode: 1 token


def _sharded(shape, dtype, spec, mesh):
    """A fake DTensor of global `shape` laid out by `spec`."""
    from torch.distributed.tensor import DTensor
    local = torch.empty(pt.local_shape(spec, shape, mesh), dtype=dtype)
    stride = torch.empty(shape, dtype=dtype, device="meta").stride()
    return DTensor.from_local(local, mesh, pt.placements_for(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def step_arguments(bundle, cfg, shape):
    """(args of bundle.fn as fake tensors, argument bytes of one rank):
    must run under FakeTensorMode."""
    from repro_torch.training import optimizer as opt
    mesh, rules, model = bundle.mesh, bundle.rules, bundle.model
    specs = [s for _, s in leaves_with_names(model.param_specs())]
    tree = model.param_specs()

    def leaves(dtype=None):
        return unflatten(tree, [
            _sharded(s.shape, dtype or s.dtype or cfg.pdtype,
                     rules.spec_for(s.axes, s.shape), mesh) for s in specs])

    def local_bytes(x):
        return _nbytes(x.to_local()) if pt.is_dtensor(x) else _nbytes(x)

    params = leaves()
    nbytes = sum(local_bytes(p) for _, p in leaves_with_names(params))
    B = shape.global_batch
    if bundle.meta.get("kind") == "decode":
        window = bundle.meta.get("window_override")
        caches = [{name: _sharded(shp, dt, rules.spec_for(axes, shp), mesh)
                   for name, (shp, axes, dt) in layer.items()}
                  for layer in model._cache_shape_specs(B, shape.seq_len,
                                                        window)]
        tokens = _batch((B, 1), torch.int32, mesh)
        pos = torch.full((B,), shape.seq_len - 1, dtype=torch.int32)
        nbytes += sum(local_bytes(c) for layer in caches
                      for c in layer.values())
        nbytes += local_bytes(tokens) + local_bytes(_batch((B,), torch.int32,
                                                           mesh))
        return (params, tokens, caches, pos), nbytes
    batch = {name: _batch(shp, dt, mesh)
             for name, (shp, dt) in bundle.inputs.items()}
    nbytes += sum(local_bytes(v) for v in batch.values())
    if bundle.meta.get("kind") != "train":
        return (params, batch), nbytes
    sdt = getattr(torch, bundle.opt.state_dtype)
    mu, nu = leaves(sdt), leaves(sdt)
    nbytes += 2 * sum(local_bytes(p) for _, p in leaves_with_names(mu))
    state = opt.OptState(step=torch.zeros((), dtype=torch.int32), mu=mu,
                         nu=nu)
    nbytes += _nbytes(state.step)
    return (params, state, batch), nbytes


def _batch(shape, dtype, mesh):
    """A fake batch input sharded on the batch axes over its leading dim,
    as `sharding.place_batch` lays it out."""
    from torch.distributed.tensor import DTensor
    pl = pt.batch_axes_placements(mesh, shape[0], 0)
    local, _ = pt.local_shape_and_offset(shape, mesh, pl)
    return DTensor.from_local(torch.zeros(local, dtype=dtype), mesh, pl,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def measure(cfg, shape, mesh, variant: str = "") -> dict:
    """Run rank 0's view of the step once under FakeTensorMode; its
    counts."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    bundle = build_step(cfg, shape, mesh, variant=variant, device="cpu")
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        args, arg_bytes = step_arguments(bundle, cfg, shape)
        # a first run fills DTensor's sharding-propagation cache: its shape
        # inference runs each new op once on global-shaped fake tensors,
        # which the counted run must not see
        bundle.fn(*args)
        counter, mem = RankCounter(), MemTracker()
        with counter, mem:
            bundle.fn(*args)
    coll = dict(counter.coll)
    coll["total"] = sum(counter.coll.values())
    coll["counts"] = dict(counter.counts)
    peak = mem.get_tracker_snapshot("peak")
    return {"bundle": bundle, "flops": float(counter.flops),
            "bytes": float(counter.bytes), "coll": coll,
            "argument_bytes": int(arg_bytes),
            "temp_bytes": max((v["Total"] for v in peak.values()),
                              default=0),
            "run_s": time.perf_counter() - t0}


def moe_dispatch_bytes(cfg, shape, mesh_shape):
    """Bytes a rank holds for one MoE layer's dispatch buffers in this step
    (`moe.dispatch_rank_bytes` of the step's tokens: global_batch x seq_len,
    one token a sequence in decode); None for a model with no MoE."""
    if not cfg.use_moe:
        return None
    from repro_torch.models.layers import moe
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    return moe.dispatch_rank_bytes(cfg, tokens, mesh_shape)


def apply_variant(cfg, variant: str, multi_pod: bool):
    """The reference's §Perf variants."""
    if not variant or variant == "baseline":
        return cfg
    shards = 32 if multi_pod else 16      # batch-axis size
    moe_local = lambda c: dataclasses.replace(      # noqa: E731
        c, moe=dataclasses.replace(c.moe, dispatch="local",
                                   local_shards=shards))
    if variant == "moe_local":
        return moe_local(cfg)
    if variant == "mla_absorbed":
        return dataclasses.replace(cfg, mla_absorbed_train=True)
    if variant in ("kv_int8", "kv_replicated+int8", "serve_mesh_32x8+int8"):
        return dataclasses.replace(cfg, kv_cache_quant="int8")
    if variant in ("kv_replicated", "serve_mesh_32x8"):
        return cfg          # rules / mesh change, handled by build_step
    if variant == "moe_local+mla_absorbed":
        return dataclasses.replace(moe_local(cfg), mla_absorbed_train=True)
    raise KeyError(variant)


def mesh_name(shape: pt.MeshShape) -> str:
    return "x".join(str(shape.shape[a]) for a in shape.axis_names)


def run_one(arch: str, shape_name: str, multi_pod: bool,
            probes: bool = True, cfg=None, variant: str = "",
            mesh_shape: pt.MeshShape = None, shape=None) -> dict:
    """One (arch, shape, mesh) record.  `cfg`, `shape` (an InputShape) and
    `mesh_shape` override the registry's config, the named input shape and
    the production mesh (tests run reduced archs on a small fake mesh)."""
    from repro_torch.launch import roofline as rf
    cfg = cfg or get_config(arch)
    cfg = apply_variant(cfg, variant, multi_pod)
    shape = shape or INPUT_SHAPES[shape_name]
    if mesh_shape is None:
        mesh_shape = (pt.MeshShape({"data": 32, "model": 8},
                                   ("data", "model"))
                      if variant.startswith("serve_mesh")
                      else mesh_lib.production_shape(multi_pod=multi_pod))
    ok, why = supported(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name(mesh_shape),
           "variant": variant or "baseline",
           "status": "skipped" if not ok else "?", "skip_reason": why}
    if not ok:
        print(f"[dryrun] SKIP {arch} x {shape_name}: {why}")
        return rec
    mesh = fake_mesh(mesh_shape)
    runs = rf.probe_configs(cfg) if probes else [cfg]
    metrics, run_s, first = [], 0.0, None
    for c in runs:
        m = measure(c, shape, mesh, variant=variant)
        first = first or m
        run_s += m["run_s"]
        entry = {"flops": m["flops"], "bytes": m["bytes"],
                 "temp_bytes": float(m["temp_bytes"])}
        for k in COLLECTIVES + ("total",):
            entry[f"coll_{k}"] = float(m["coll"][k])
        metrics.append(entry)
    pred = rf.extrapolate(cfg, runs, metrics) if probes else metrics[0]
    # the full config's arguments, from its specs (no run needed)
    from torch._subclasses.fake_tensor import FakeTensorMode
    bundle = build_step(cfg, shape, mesh, variant=variant, device="cpu")
    with FakeTensorMode(allow_non_fake_inputs=True):
        _, arg_bytes = step_arguments(bundle, cfg, shape)
    ranks = mesh_shape.size
    rec.update({
        "status": "ok",
        "chips": ranks,
        "meta": bundle.meta,
        "run_s": round(run_s, 2),
        "flops": pred["flops"],
        "bytes": pred["bytes"],
        "collective_bytes": {k.replace("coll_", ""): v
                             for k, v in pred.items()
                             if k.startswith("coll_")},
        "collective_counts": first["coll"]["counts"],
        "model_flops": model_flops(cfg, shape),
        "memory": {"argument_bytes": int(arg_bytes), "output_bytes": None,
                   "temp_bytes": int(pred["temp_bytes"]),
                   "peak_bytes": int(arg_bytes + pred["temp_bytes"]),
                   "generated_code_bytes": None, "alias_bytes": None,
                   "moe_dispatch_bytes": moe_dispatch_bytes(
                       cfg, shape, mesh_shape)},
        "computed_not_measured": True,
    })
    if probes:
        rec["probe_layers"] = [c.num_layers for c in runs]
    rec["roofline"] = rf.roofline_terms(
        pred["flops"], pred["bytes"], pred["coll_total"],
        compute_dtype=cfg.compute_dtype)
    rec["useful_flops_ratio"] = (rec["model_flops"] / ranks) / max(
        1.0, pred["flops"])
    print(f"[dryrun] OK {arch} x {shape_name} x {rec['mesh']} "
          f"(run {run_s:.1f}s): flops={pred['flops']:.3e}/rank "
          f"bytes={pred['bytes']:.3e}/rank "
          f"coll={pred['coll_total']:.3e}B/rank")
    print(f"  roofline (computed, {mesh_lib.H100_SXM5}): {rec['roofline']} "
          f"useful_ratio={rec['useful_flops_ratio']:.3f}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--variant", default="")
    ap.add_argument("--no-probes", action="store_true",
                    help="run the whole config instead of its probes")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)

    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multipod]
    os.makedirs(args.out, exist_ok=True)
    results = []
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape_name}__{'2x16x16' if mp else '16x16'}"
                if args.variant:
                    tag += f"__{args.variant}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[dryrun] cached {tag}")
                    with open(path) as f:
                        results.append(json.load(f))
                    continue
                try:
                    rec = run_one(arch, shape_name, mp, variant=args.variant,
                                  probes=not args.no_probes)
                except Exception as e:  # noqa: BLE001 — record and go on
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": "2x16x16" if mp else "16x16",
                           "variant": args.variant or "baseline",
                           "status": "error", "error": repr(e),
                           "trace": traceback.format_exc()[-2000:]}
                    print(f"[dryrun] ERROR {tag}: {e!r}")
                with open(path, "w") as f:
                    json.dump(rec, f, indent=2)
                results.append(rec)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"of {len(results)}")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
