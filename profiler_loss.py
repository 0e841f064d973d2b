"""How often the torch profiler loses device records on this card.

Runs many short profiler sessions, each of ``--calls`` float32 GEMMs
([2048, 512] x [512, 2048]) and a synchronise, and counts the sessions
that recorded every GEMM, some of them, or none.  Four kinds of session,
taken in turn: ``plain`` (as ``chip_smoke.py: device_ms_by_name`` opens
one), ``wait_before`` (2 ms of host sleep after the session opens),
``wait_after`` (2 ms after the synchronise, before it closes) and
``cuda_only`` (device activity only, no host ops).

    python3 profiler_loss.py [--sessions 2000] [--calls 20]

Prints the card's name and power limit, then one JSON object of counts
per kind.  Needs a CUDA device.
"""
import argparse
import collections
import json
import subprocess
import sys
import time

import torch

KINDS = ("plain", "wait_before", "wait_after", "cuda_only")


def session(kind, fn, calls) -> int:
    """GEMM records one session of ``kind`` kept."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA]
    if kind != "cuda_only":
        acts.insert(0, ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        if kind == "wait_before":
            time.sleep(0.002)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        if kind == "wait_after":
            time.sleep(0.002)
    return sum(1 for e in prof.events()
               if e.device_type == DeviceType.CUDA and "gemm" in e.name)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sessions", type=int, default=2000,
                    help="sessions of each kind")
    ap.add_argument("--calls", type=int, default=20,
                    help="GEMMs a session")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profiler_loss: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip())
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(2048, 512, generator=g, device=dev)
    b = torch.randn(512, 2048, generator=g, device=dev)
    fn = lambda: torch.matmul(a, b)  # noqa: E731
    counts = {k: collections.Counter() for k in KINDS}
    for _ in range(args.sessions):
        for kind in KINDS:
            n = session(kind, fn, args.calls)
            counts[kind]["all" if n >= args.calls
                         else ("none" if n == 0 else "some")] += 1
    print(json.dumps({"sessions": args.sessions, "calls": args.calls,
                      "torch": torch.__version__,
                      "kept": {k: dict(v) for k, v in counts.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
