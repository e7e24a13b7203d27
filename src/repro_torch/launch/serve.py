"""Serving launcher of the port: the agent's LM behind the Memori memory
layer, on one CUDA card (or the CPU when asked).

    PYTHONPATH=src python -m repro_torch.launch.serve
    PYTHONPATH=src python -m repro_torch.launch.serve --host-demo --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --snapshot-path /tmp/memori.d --flush-interval 0.5 \\
        --snapshot-interval 30 --max-pending 256

`--arch` (default `memori-agent`) runs at full width; `--host-demo`
reduces it to two layers of width 128 for a quick run.  The LM's weights
are random, from a seed, so its replies are noise: the retrieval and
token-accounting lines are the signal.

`--snapshot-path` mounts the memory layer on a lifecycle runtime rooted at
that durable directory: the service recovers from it on boot (newest valid
snapshot + WAL replay — a restarted server answers as the last one did up
to its last durable flush) and every flush appends to the write-ahead log.
`--flush-interval` runs the background flusher (seconds); `--max-pending`
bounds the queue with blocking backpressure; `--snapshot-interval` rotates
full snapshots (retaining `--snapshot-retain` generations and truncating
the WAL).  SIGTERM/SIGINT trigger a final flush + snapshot before exit, so
a shutdown loses nothing that reached the queue drain.
`--tick-interval` mounts the cross-client MemoryScheduler: concurrent
handlers' single retrieves coalesce into one batched device launch per
tick (`--max-batch` caps the tick).

`--http-port` exposes the memory layer over HTTP (serving/frontend.py):

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --tick-interval 0.002 --http-port 8080 \
        --api-keys secret1=acme,secret2=beta \
        --qos-rate 50 --qos-burst 100 --qos-max-queued 256

`--api-keys` maps each api key to its tenant; every request's namespace is
scoped under its tenant, and the tenant is the QoS identity admission
control charges.  The `--qos-*` flags set the default per-tenant contract
(token-bucket rate limit, backlog cap) and the global shed threshold —
rejections surface as HTTP 429 + Retry-After.  QoS needs the scheduler, so
`--qos-*` requires --tick-interval.  The server prints "memory layer
serving on <address>" once it listens (`--http-port 0` picks a free
port), serves until SIGTERM/SIGINT, then closes the frontend and the
service.

`--multipod` comes with the training and launch slice of the port and
exits with an error that says so.
"""
import argparse
import os
import signal

_SLICE_LAUNCH = "the training and launch slice of the port"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="memori-agent")
    ap.add_argument("--host-demo", action="store_true",
                    help="reduce the LM to 2 layers of width 128")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--snapshot-path", default=None,
                    help="durable directory for the lifecycle runtime "
                         "(rotating snapshots + WAL); recovered on boot, "
                         "snapshotted on shutdown incl. SIGTERM/SIGINT")
    ap.add_argument("--flush-interval", type=float, default=None,
                    help="background flusher period in seconds "
                         "(policy.flush_interval_s); default: synchronous "
                         "record")
    ap.add_argument("--max-pending", type=int, default=None,
                    help="bound the pending queue (blocking backpressure)")
    ap.add_argument("--snapshot-interval", type=float, default=None,
                    help="periodic full-snapshot rotation period in seconds")
    ap.add_argument("--snapshot-retain", type=int, default=2,
                    help="snapshot generations kept by rotation")
    ap.add_argument("--tick-interval", type=float, default=None,
                    help="mount a MemoryScheduler: micro-batch window in "
                         "seconds collecting concurrent clients' requests "
                         "into one device launch per tick")
    ap.add_argument("--max-batch", type=int, default=64,
                    help="scheduler tick size cap (use a power of two: "
                         "batches pad to pow2 Q buckets anyway)")
    ap.add_argument("--http-port", type=int, default=None,
                    help="serve the memory layer over HTTP on this port "
                         "(0 = ephemeral); requires --api-keys")
    ap.add_argument("--http-host", default="0.0.0.0",
                    help="HTTP bind address (default 0.0.0.0)")
    ap.add_argument("--api-keys", default=None,
                    help="comma-separated key=tenant pairs; the key "
                         "authenticates, the tenant scopes namespaces and "
                         "is the QoS identity")
    ap.add_argument("--qos-rate", type=float, default=None,
                    help="default per-tenant rate limit in req/s "
                         "(token bucket; rejections are 429 on the wire)")
    ap.add_argument("--qos-burst", type=int, default=32,
                    help="token-bucket burst capacity per tenant")
    ap.add_argument("--qos-max-queued", type=int, default=None,
                    help="per-tenant backlog cap (shed above it)")
    ap.add_argument("--qos-max-queued-global", type=int, default=None,
                    help="global backlog cap; tenants above their "
                         "weight-proportional fair share are shed first")
    ap.add_argument("--multipod", action="store_true",
                    help=f"(comes with {_SLICE_LAUNCH})")
    args = ap.parse_args(argv)
    if args.multipod:
        ap.error(f"--multipod comes with {_SLICE_LAUNCH}")
    if args.snapshot_interval is not None and args.snapshot_path is None:
        ap.error("--snapshot-interval needs --snapshot-path (rotation "
                 "without a durable directory would silently no-op)")
    if args.http_port is not None and not args.api_keys:
        ap.error("--http-port needs --api-keys (an unauthenticated frontend "
                 "would serve every tenant's memory to anyone)")
    args.wants_qos = (args.qos_rate is not None
                      or args.qos_max_queued is not None
                      or args.qos_max_queued_global is not None)
    if args.wants_qos and args.tick_interval is None:
        ap.error("--qos-* flags need --tick-interval (admission control "
                 "lives in the scheduler's submit path)")
    if args.snapshot_path is not None and os.path.isfile(args.snapshot_path):
        ap.error(f"--snapshot-path {args.snapshot_path} is a single-file "
                 "snapshot; the lifecycle runtime needs a directory "
                 "(restore the file once via MemoryService.restore, then "
                 "serve with a directory)")
    return args


def main(argv=None) -> None:
    args = parse_args(argv)

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import (AdmissionPolicy, HashEmbedder,
                                  LifecyclePolicy, MemoriClient,
                                  MemoryService, TenantPolicy)
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.models.model_api import Model
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.sampler import SamplerConfig

    device = torch.device(args.device)
    cfg = get_config(args.arch)
    if args.host_demo:
        cfg = cfg.reduced(layers=2, d_model=128)
    model = Model(cfg)
    params = model.init_params(torch.Generator(device=device).manual_seed(0))
    tok = HashTokenizer(cfg.vocab_size)
    engine = Engine(model, params, max_len=args.max_len, slots=2,
                    sampler=SamplerConfig(temperature=0.8, top_k=40),
                    tokenizer=tok)
    policy = LifecyclePolicy(
        flush_interval_s=args.flush_interval,
        max_pending=args.max_pending,
        snapshot_interval_s=args.snapshot_interval,
        snapshot_retain=args.snapshot_retain,
    )
    wants_runtime = args.snapshot_path is not None or policy.wants_daemon \
        or args.max_pending is not None
    # one multi-tenant service fronts every conversation on this host;
    # with --snapshot-path it picks up exactly where the last run stopped
    embedder = HashEmbedder(device=device)
    if args.snapshot_path is not None:
        service = MemoryService.recover(
            args.snapshot_path, embedder, policy=policy, device=device,
            budget=800)
        print(f"recovered memory store from {args.snapshot_path}: "
              f"{service.stats()}", flush=True)
    else:
        service = MemoryService(embedder, budget=800, device=device,
                                policy=policy if wants_runtime else None)
    if args.tick_interval is not None:
        # every handler / SDK client request from here on coalesces with
        # its concurrent peers into one batched launch per scheduler tick
        # (the ticks run on this thread's CUDA stream)
        admission = None
        if args.wants_qos:
            admission = AdmissionPolicy(
                default=TenantPolicy(rate=args.qos_rate,
                                     burst=args.qos_burst,
                                     max_queued=args.qos_max_queued),
                max_queued_global=args.qos_max_queued_global)
        service.start_scheduler(tick_interval_s=args.tick_interval,
                                max_batch=args.max_batch,
                                admission=admission)

    def _shutdown(signum, frame):
        # unwind via SystemExit (flush's all-or-nothing guard restores the
        # queue if it lands mid-batch) and let the `finally` below run the
        # single close path — the handler itself must not flush or rotate,
        # it may be interrupting a commit
        print(f"signal {signum}: shutting down", flush=True)
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)

    def llm(prompt: str) -> str:
        # the engine's first step captures a CUDA graph in thread-local
        # mode: the scheduler's ticks and the lifecycle daemon go on
        # working on the device meanwhile, so no lock is held here
        return engine.generate([prompt[-500:]], max_new_tokens=12)[0]

    client = MemoriClient(llm, service.namespace("u0/demo"))
    frontend = None
    try:
        if args.http_port is not None:
            from repro_torch.serving.frontend import MemoryFrontend
            keys = dict(pair.split("=", 1)
                        for pair in args.api_keys.split(","))
            frontend = MemoryFrontend(service, keys, host=args.http_host,
                                      port=args.http_port)
            print(f"memory layer serving on {frontend.address} "
                  f"({len(keys)} api keys)", flush=True)
            frontend.serve_forever()       # until SIGTERM/SIGINT
        else:
            print(client.chat("I work as a translator and I live in Cusco."),
                  flush=True)
            client.end_session()
            [ctx] = service.retrieve_batch(
                [("u0/demo", "Where does the user live?")])
            print(f"retrieved {len(ctx.triples)} triples, "
                  f"{ctx.token_count} tokens", flush=True)
            print("service:", service.stats(), flush=True)
            if service.scheduler is not None:
                print("scheduler:", service.scheduler.stats(), flush=True)
            print("engine:", engine.stats, flush=True)
    finally:
        if frontend is not None:
            frontend.close()
        try:
            service.close(final_snapshot=args.snapshot_path is not None)
            if args.snapshot_path is not None:
                print(f"final snapshot rotation -> {args.snapshot_path}",
                      flush=True)
        except Exception as e:
            # the WAL already holds every durable flush; recovery replays
            # it even when the final rotation could not be written
            print(f"clean close failed ({e!r}); durable WAL state in "
                  f"{args.snapshot_path} remains recoverable", flush=True)


if __name__ == "__main__":
    main()
