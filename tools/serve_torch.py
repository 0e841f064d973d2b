#!/usr/bin/env python
"""Stand up (or administer) a paddle_tpu_torch model server from the CLI.

The PyTorch port's counterpart of ``tools/serve.py``, with the same
parser: the servers it stands up run on the card (``cuda:0``), as the
port's entry points do.

Serve a saved inference model dir (``fluid.io.save_inference_model``
output) on the framed-TCP serving endpoint, with continuous batching,
a warmed bucket ladder, and optional registry-announced replica
membership:

    python tools/serve_torch.py /models/mnist/v1 --model mnist \\
        --endpoint 0.0.0.0:9000 --buckets 1,2,4,8,16,32 \\
        --max-delay-ms 5 --registry 10.0.0.2:8800 --debug-port 8080

    # serve a saved GENERATIVE model (decode.save_lm dir) with the
    # autoregressive decode plane: paged KV cache, token-level
    # continuous batching, streaming DECODE replies:
    python tools/serve_torch.py /models/lm/v1 --model lm --decode \\
        --endpoint 0.0.0.0:9100 --decode-slots 8 --debug-port 8080

    # slots/cache/queue gauges of a running decode server:
    python tools/serve_torch.py --decode --admin 10.0.0.7:9100 --status

    # hot-swap a new version into a RUNNING server (zero downtime):
    python tools/serve_torch.py /models/mnist/v2 --model mnist --version 2 \\
        --admin 10.0.0.7:9000 --swap

    # router + batching gauges of a running server:
    python tools/serve_torch.py --admin 10.0.0.7:9000 --status

The server prints one JSON banner line on stdout once it listens.
``--debug-port`` exposes /servingz and /decodez (and the rest of the
observability plane) over HTTP.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading

__all__ = ["build_parser", "main"]

# runnable as `python tools/serve_torch.py` from anywhere: the repo root
# (paddle_tpu_torch's parent) must be importable
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="serve_torch.py",
        description="paddle_tpu_torch model server / serving admin CLI")
    p.add_argument("model_dir", nargs="?", default=None,
                   help="saved inference model dir (save_inference_model)")
    p.add_argument("--model", default="default",
                   help="served model name (default: %(default)s)")
    p.add_argument("--version", default="1",
                   help="model version label (default: %(default)s)")
    p.add_argument("--endpoint", default="127.0.0.1:0",
                   help="host:port to serve on (default ephemeral loopback)")
    p.add_argument("--registry", default=None, metavar="HOST:PORT",
                   help="announce this replica via the pserver registry")
    p.add_argument("--replica-id", default=None,
                   help="replica id in the registry key (default: endpoint)")
    p.add_argument("--buckets", default=None,
                   help="batch-size ladder, e.g. 1,2,4,8,16,32 "
                        "(default: FLAGS_serving_buckets)")
    p.add_argument("--max-delay-ms", type=float, default=None,
                   help="max queue delay before a partial batch dispatches")
    p.add_argument("--max-queue-rows", type=int, default=None,
                   help="admission-control queue bound in rows")
    p.add_argument("--slo-ms", type=float, default=None,
                   help="queue-delay SLO: shed when it is unmeetable")
    p.add_argument("--max-seq-len", type=int, default=None,
                   help="per-model sequence-length bound: an over-length "
                        "request is rejected at submit with a typed "
                        "RequestTooLong instead of poisoning its batch")
    # decode mode ----------------------------------------------------------
    p.add_argument("--decode", action="store_true",
                   help="serve model_dir as a GENERATIVE model "
                        "(decode.save_lm layout) on the streaming decode "
                        "plane instead of one-shot inference")
    p.add_argument("--decode-slots", type=int, default=None,
                   help="decode-batch width (default: "
                        "FLAGS_decode_max_slots)")
    p.add_argument("--decode-block-tokens", type=int, default=None,
                   help="paged KV cache block size in tokens (default: "
                        "FLAGS_decode_block_tokens)")
    p.add_argument("--decode-prefill-buckets", default=None,
                   help="prompt-length ladder, e.g. 16,32,64,128 "
                        "(default: FLAGS_decode_prefill_buckets)")
    p.add_argument("--no-warm", action="store_true",
                   help="skip the bucket-ladder warm pool (first requests "
                        "build their plans)")
    p.add_argument("--no-ir-optim", action="store_true",
                   help="disable the analysis fusion passes")
    p.add_argument("--debug-port", type=int, default=0,
                   help="debug HTTP server port (/servingz etc.); 0 = off")
    # admin mode -----------------------------------------------------------
    p.add_argument("--admin", default=None, metavar="HOST:PORT",
                   help="administer a RUNNING server instead of serving")
    p.add_argument("--status", action="store_true",
                   help="with --admin: print the server's router + gauges")
    p.add_argument("--swap", action="store_true",
                   help="with --admin: hot-swap model_dir in as "
                        "--model @ --version")
    return p


def _bucket_list(spec):
    if spec is None:
        return None
    from paddle_tpu_torch.serving import BucketLadder
    return BucketLadder.parse(spec)


def _batcher_kw(args) -> dict:
    kw = {}
    if args.max_delay_ms is not None:
        kw["max_delay_ms"] = args.max_delay_ms
    if args.max_queue_rows is not None:
        kw["max_queue_rows"] = args.max_queue_rows
    if args.slo_ms is not None:
        kw["queue_delay_slo_ms"] = args.slo_ms
    if args.max_seq_len is not None:
        kw["max_seq_len"] = args.max_seq_len
    return kw


def _serve_decode(args) -> int:
    """Stand up a streaming decode server for a saved LM dir."""
    import paddle_tpu_torch as fluid  # noqa: F401 (registers lowerings)
    from paddle_tpu_torch.core import flags as _flags
    from paddle_tpu_torch.decode import DecodeEngine, DecodeServer, load_lm
    from paddle_tpu_torch.serving import BucketLadder

    if args.debug_port:
        _flags.set_flags({"debug_server_port": args.debug_port})
    lm, params = load_lm(args.model_dir)
    kw = {}
    if args.decode_slots is not None:
        kw["max_slots"] = args.decode_slots
    if args.decode_block_tokens is not None:
        kw["block_tokens"] = args.decode_block_tokens
    if args.decode_prefill_buckets is not None:
        kw["prefill_buckets"] = BucketLadder.parse(
            args.decode_prefill_buckets)
    eng = DecodeEngine(lm, params, name=args.model, **kw)
    srv = DecodeServer(args.endpoint, engines={args.model: eng},
                       registry_ep=args.registry,
                       replica_id=args.replica_id)
    srv.start()
    print(json.dumps({
        "decoding": f"{args.model}@{args.version}",
        "endpoint": srv.endpoint,
        "model": lm.config.to_dict(),
        "max_slots": eng.max_slots,
        "block_tokens": eng.cache.block_tokens,
        "prefill_buckets": list(eng.prefill_ladder.sizes),
        "registry": args.registry,
        "debug_port": args.debug_port or None}, default=repr), flush=True)

    stop = threading.Event()
    drain = {"requested": False}

    def on_signal(signum, frame):
        # SIGTERM = graceful drain: deregister the lease first, let
        # in-flight streams generate to their FIN, reject stragglers
        # with a typed Draining — zero dropped streams on a rolling
        # restart.  SIGINT stays immediate.
        drain["requested"] = signum == signal.SIGTERM
        stop.set()
    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    try:
        while not stop.wait(1.0):
            pass
    finally:
        srv.stop(drain=drain["requested"])
        print("decode server stopped"
              + (" (drained)" if drain["requested"] else ""), flush=True)
    return 0


def _admin(args) -> int:
    from paddle_tpu_torch.serving import ServingClient

    if args.decode:
        from paddle_tpu_torch.decode import DecodeClient
        out = DecodeClient(endpoints=[args.admin]).status(args.admin)
        print(json.dumps(out, indent=2, default=repr))
        return 0

    cli = ServingClient(endpoints=[args.admin])
    if args.swap:
        if not args.model_dir:
            print("--swap needs a model_dir", file=sys.stderr)
            return 2
        cmd = {"cmd": "swap", "model": args.model,
               "version": args.version, "model_dir": args.model_dir}
        buckets = _bucket_list(args.buckets)
        if buckets:
            cmd["buckets"] = buckets
        cmd.update(_batcher_kw(args))
        out = cli.admin(args.admin, cmd)
    else:  # default: status
        out = cli.admin(args.admin, {"cmd": "status"})
    print(json.dumps(out, indent=2, default=repr))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.admin:
        return _admin(args)
    if not args.model_dir:
        print("model_dir is required (or use --admin)", file=sys.stderr)
        return 2
    if args.decode:
        return _serve_decode(args)

    import paddle_tpu_torch as fluid  # noqa: F401 (registers lowerings)
    from paddle_tpu_torch.core import flags as _flags
    from paddle_tpu_torch.inference.predictor import AnalysisConfig
    from paddle_tpu_torch.serving import ModelServer

    if args.debug_port:
        _flags.set_flags({"debug_server_port": args.debug_port})
    cfg = AnalysisConfig(args.model_dir)
    if args.no_ir_optim:
        cfg.switch_ir_optim(False)
    srv = ModelServer(args.endpoint, registry_ep=args.registry,
                      replica_id=args.replica_id)
    srv.load(args.model, args.version, model_dir=args.model_dir,
             config=cfg, warm=not args.no_warm,
             buckets=_bucket_list(args.buckets), activate=True,
             **_batcher_kw(args))
    srv.start()
    sm = srv.manager.models()[0]
    print(json.dumps({
        "serving": f"{args.model}@{args.version}",
        "endpoint": srv.endpoint,
        "buckets": list(sm.batcher.ladder.sizes),
        "warm": sm.warm_info,
        "registry": args.registry,
        "debug_port": args.debug_port or None}, default=repr), flush=True)

    stop = threading.Event()
    drain = {"requested": False}

    def on_signal(signum, frame):
        # SIGTERM = graceful drain (the supervisor/orchestrator
        # shutdown path): deregister first, finish in-flight, then
        # close — zero dropped requests.  SIGINT stays immediate.
        drain["requested"] = signum == signal.SIGTERM
        stop.set()
    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    try:
        while not stop.wait(1.0):
            pass
    finally:
        srv.stop(drain=drain["requested"])
        print("server stopped"
              + (" (drained)" if drain["requested"] else ""), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
