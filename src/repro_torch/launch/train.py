"""Training launcher of the port: the train step of any arch on one CUDA
card (or the CPU when asked), as the reference's `repro/launch/train.py`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --shape train_4k [--steps 10] [--host-demo] [--device cuda|cpu]

Parameters are drawn from a generator seeded 0 on the device, random
tokens (and stub images / audio) for step i from a generator seeded
`fold_in(1, i)`.  `--host-demo` trains the reduced config at
global_batch=4, seq_len=64.  Each step prints `step i: loss=... gnorm=...`,
then the launcher prints `done`.  `--multipod` comes with the
distribution slice of the port (M7b) and exits with an error that says so.
"""
import argparse

from repro_torch.common.utils import SLICE_M7B


def fold_in(seed: int, step: int) -> int:
    """The seed of step `step`'s data generator."""
    return seed * 1_000_003 + step


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--host-demo", action="store_true",
                    help="the reduced config at global_batch=4, seq_len=64")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--multipod", action="store_true",
                    help=f"(comes with {SLICE_M7B})")
    args = ap.parse_args(argv)
    if args.multipod:
        ap.error(f"--multipod comes with {SLICE_M7B}")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    import dataclasses

    import torch

    from repro_torch.common.module import materialize
    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import build_train_step
    from repro_torch.models.config import INPUT_SHAPES
    from repro_torch.models.model_api import Model
    from repro_torch.training import optimizer as opt

    cfg = get_config(args.arch)
    shape = INPUT_SHAPES[args.shape]
    if args.host_demo:
        cfg = cfg.reduced()
        shape = dataclasses.replace(shape, global_batch=4, seq_len=64)
    bundle = build_train_step(cfg, shape, device=args.device)
    device = bundle.device
    params = materialize(torch.Generator(device=device).manual_seed(0),
                         Model(cfg).param_specs(), cfg.pdtype)
    opt_state = opt.init(bundle.opt, params)
    for step in range(args.steps):
        gen = torch.Generator(device=device).manual_seed(fold_in(1, step))
        batch = {}
        for name, (shp, dt) in bundle.inputs.items():
            batch[name] = (torch.randint(4, cfg.vocab_size, shp,
                                         generator=gen, device=device,
                                         dtype=dt)
                           if name == "tokens" else
                           torch.randn(shp, generator=gen, device=device,
                                       dtype=dt))
        params, opt_state, metrics = bundle.fn(params, opt_state, batch)
        print(f"step {step}: loss={float(metrics['loss']):.4f} "
              f"gnorm={float(metrics['grad_norm']):.3f}", flush=True)
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
