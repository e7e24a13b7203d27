"""Training launcher of the port, as the reference's `repro/launch/train.py`:
the train step of any arch on one CUDA card (or the CPU when asked), or on
a `DeviceMesh` of ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --shape train_4k [--steps 10] [--host-demo] [--device cuda|cpu]
    torchrun --nproc-per-node N -m repro_torch.launch.train ...
    torchrun ... (512 ranks) -m repro_torch.launch.train --multipod ...

Parameters are drawn from a generator seeded 0, random tokens (and stub
images / audio) for step i from a generator seeded `fold_in(1, i)`.
`--host-demo` trains the reduced config at global_batch=4, seq_len=64: with
`--device cpu` on the reference's (2, 2) ("data", "model") host mesh, four
gloo ranks spawned here on a FileStore in a temporary directory; on a CUDA
card on that one card (NCCL takes one rank a card).  Under torchrun (its
WORLD_SIZE, RANK, LOCAL_RANK and MASTER_ADDR environment) each rank takes
the card LOCAL_RANK and the mesh is the production one — (16, 16) at 256
ranks, (2, 16, 16) with `--multipod` at 512 — and (ranks, 1) at any
other count; every rank draws the whole parameters and batch from the
seeds and keeps its own shards.  Each step prints `step i: loss=...
gnorm=...` (rank 0), then `done`.
"""
import argparse
import os


def fold_in(seed: int, step: int) -> int:
    """The seed of step `step`'s data generator."""
    return seed * 1_000_003 + step


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--host-demo", action="store_true",
                    help="the reduced config at global_batch=4, seq_len=64 "
                         "(on the CPU: four gloo ranks on a (2, 2) mesh)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--multipod", action="store_true",
                    help="the (2, 16, 16) production mesh: 512 torchrun "
                         "ranks")
    args = ap.parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.multipod and world != 512:
        ap.error("--multipod builds the (2, 16, 16) production mesh: run it "
                 f"under torchrun with 512 ranks (WORLD_SIZE is {world})")
    return args


def _batch(bundle, cfg, step, device):
    import torch
    gen = torch.Generator(device=device).manual_seed(fold_in(1, step))
    batch = {}
    for name, (shp, dt) in bundle.inputs.items():
        batch[name] = (torch.randint(4, cfg.vocab_size, shp, generator=gen,
                                     device=device, dtype=dt)
                       if name == "tokens" else
                       torch.randn(shp, generator=gen, device=device,
                                   dtype=dt))
    return batch


def _config(args):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.config import INPUT_SHAPES
    cfg = get_config(args.arch)
    shape = INPUT_SHAPES[args.shape]
    if args.host_demo:
        cfg = cfg.reduced()
        shape = dataclasses.replace(shape, global_batch=4, seq_len=64)
    return cfg, shape


def train(args, mesh=None, rank: int = 0) -> None:
    """args.steps steps of the train step on `mesh` (one device when
    None); rank 0 prints."""
    import torch

    from repro_torch.common.module import materialize
    from repro_torch.launch.sharding import build_train_step
    from repro_torch.training import optimizer as opt

    cfg, shape = _config(args)
    bundle = build_train_step(cfg, shape, mesh, device=args.device)
    device = bundle.device
    params = materialize(torch.Generator(device=device).manual_seed(0),
                         bundle.model.param_specs(), cfg.pdtype)
    if mesh is not None:
        params = bundle.model.shard_params(params, mesh, bundle.rules)
    opt_state = opt.init(bundle.opt, params)
    for step in range(args.steps):
        params, opt_state, metrics = bundle.fn(
            params, opt_state, _batch(bundle, cfg, step, device))
        loss = metrics["loss"]
        loss = float(loss.full_tensor() if hasattr(loss, "full_tensor")
                     else loss)
        if rank == 0:
            print(f"step {step}: loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f}", flush=True)
    if rank == 0:
        print("done", flush=True)


def _host_demo_rank(rank: int, args, store: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=4)
    try:
        train(args, make_host_mesh(2, 2, device_type="cpu"), rank)
    finally:
        dist.destroy_process_group()


def _torchrun(args) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib
    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if cuda else "gloo")
    try:
        world, kind = dist.get_world_size(), args.device
        if args.multipod or world == 256:
            mesh = mesh_lib.make_production_mesh(multi_pod=args.multipod,
                                                 device_type=kind)
        else:
            mesh = mesh_lib.make_host_mesh(world, 1, device_type=kind)
        train(args, mesh, dist.get_rank())
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.host_demo and args.device == "cpu":
        import tempfile

        import torch.multiprocessing as mp
        with tempfile.TemporaryDirectory() as tmp:
            mp.spawn(_host_demo_rank,
                     args=(args, os.path.join(tmp, "store")), nprocs=4)
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
        _torchrun(args)
    else:
        train(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
