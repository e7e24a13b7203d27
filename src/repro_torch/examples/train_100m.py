"""End-to-end run of the port, as the reference's
`examples/train_100m.py`: train the ~100M-parameter memori-agent LM on the
synthetic conversation stream, checkpoint it in the reference's layout,
and sample from it through the port's `Engine`.

    PYTHONPATH=src python -m repro_torch.examples.train_100m \\
        [--steps 200] [--batch 8] [--seq 256] [--small] [--out PATH] \\
        [--device cuda|cpu]

On the card every attention layer of the step runs K6 (forward, and again
in each block's recompute), the sampling K6 (prefill) and K5 (decode).
`--small` trains the reduced config (2 layers of width 128); the full
12-layer, 768-wide config is the default.  The checkpoint loads in either
package (`checkpoint.io.load_params` here, `repro.checkpoint.io.load`
there).
"""
import argparse
import os


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", default="artifacts/memori_agent.msgpack")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.checkpoint import io as ckpt
    from repro_torch.common.utils import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import batches
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.models.model_api import Model
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.sampler import SamplerConfig
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import TrainConfig, train

    device = resolve_device(args.device)
    cfg = get_config("memori-agent")
    if args.small:
        cfg = cfg.reduced(layers=2, d_model=128)
    model = Model(cfg)
    print(f"training {cfg.name}: {cfg.param_count() / 1e6:.1f}M params",
          flush=True)

    params = model.init_params(torch.Generator(device=device).manual_seed(0))
    tok = HashTokenizer(cfg.vocab_size)
    data = batches(args.batch, args.seq, tokenizer=tok, device=device)
    tc = TrainConfig(
        steps=args.steps, log_every=max(1, args.steps // 20),
        opt=opt.OptimizerConfig(peak_lr=6e-4, warmup_steps=args.steps // 10,
                                total_steps=args.steps))
    params, hist = train(model, params, data, tc,
                         log_fn=lambda s, m: print(
                             f"step {s:4d} ce={m['ce']:.3f} "
                             f"acc={m['accuracy']:.3f} lr={m['lr']:.2e} "
                             f"({m['wall']:.0f}s)", flush=True))

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    n = ckpt.save_params(args.out, cfg, params)
    print(f"checkpoint: {args.out} ({n / 1e6:.1f} MB)", flush=True)

    eng = Engine(model, params, max_len=args.seq, slots=2,
                 sampler=SamplerConfig(temperature=0.8, top_k=40),
                 tokenizer=tok)
    outs = eng.generate(["Caroline: My favorite food is",
                         "Ben: I went to"], max_new_tokens=12)
    for o in outs:
        print("sample:", o, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
