#!/usr/bin/env python
"""Operate a self-healing fleet of the PyTorch port from the CLI.

The port's copy of ``tools/fleet.py``, against
``paddle_tpu_torch.distributed.supervisor`` (stateless roles: serving
and decode replicas; a spec with rollback roles or checkpoint fields is
refused, and there is no ``cut`` command).  Launch a fleet from a
declarative spec file and let the supervisor own worker lifecycle —
replace dead workers, hold on crash loops, drain on shrink::

    python tools/fleet_torch.py launch fleet.json
    python tools/fleet_torch.py launch fleet.json --debug-port 8080

Administer a RUNNING fleet through its debug server's ``/fleetz`` page
(the launch above with ``--debug-port``)::

    python tools/fleet_torch.py status  127.0.0.1:8080
    python tools/fleet_torch.py resize  127.0.0.1:8080 decode 3
    python tools/fleet_torch.py drain   127.0.0.1:8080 decode-2
    python tools/fleet_torch.py resume  127.0.0.1:8080 [role]

Spec file format (JSON; see ``FleetSpec.from_dict``)::

    {
      "name": "serve",
      "registry": "auto",
      "hysteresis": 2,
      "roles": {
        "decode": {"count": 2, "logical": ["decode/lm/r0",
                                           "decode/lm/r1"],
                   "health_role": "DECODE",
                   "argv": ["python", "tests/torch_decode_replica_runner.py"],
                   "env": {"PADDLE_REGISTRY": "{registry}",
                           "REPLICA_ID": "r{index}"},
                   "restart_budget": 3, "grace_s": 10.0}
      }
    }
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
import urllib.parse
import urllib.request

__all__ = ["build_parser", "fleetz_request", "main"]

# runnable as `python tools/fleet_torch.py` from anywhere
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fleet_torch.py",
        description="launch / administer a supervised self-healing fleet")
    sub = p.add_subparsers(dest="cmd", required=True)

    launch = sub.add_parser("launch", help="launch a fleet from a spec "
                                           "file and supervise it")
    launch.add_argument("spec", help="FleetSpec JSON file")
    launch.add_argument("--debug-port", type=int, default=0,
                        help="serve /fleetz (and the rest of the debug "
                             "plane) on this HTTP port")
    launch.add_argument("--poll-s", type=float, default=0.2,
                        help="control-loop tick (default %(default)s)")
    launch.add_argument("--timeout", type=float, default=0.0,
                        help="give up after this many seconds "
                             "(0 = run until done/HOLD/signal)")

    for name, args, help_str in (
            ("status", (), "print a running fleet's /fleetz card"),
            ("resize", ("role", "count"),
             "retarget a role's worker count (grow/drain)"),
            ("drain", ("worker",), "gracefully drain one worker"),
            ("resume", (), "lift a crash-loop HOLD")):
        sp = sub.add_parser(name, help=help_str)
        sp.add_argument("endpoint", help="debug server host:port of the "
                                         "supervising process")
        for a in args:
            sp.add_argument(a)
        if name == "resume":
            sp.add_argument("role", nargs="?", default="all")
        sp.add_argument("--fleet", default=None,
                        help="fleet name when several run in one process")
    return p


def fleetz_request(endpoint: str, params: dict, timeout: float = 30.0):
    """One GET against ``http://endpoint/fleetz`` (the admin surface)."""
    query = urllib.parse.urlencode(
        {k: v for k, v in params.items() if v is not None})
    url = f"http://{endpoint}/fleetz" + (f"?{query}" if query else "")
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return json.loads(resp.read().decode("utf-8"))
    except urllib.error.HTTPError as e:  # error payloads are JSON too
        return json.loads(e.read().decode("utf-8"))


def _launch(args) -> int:
    from paddle_tpu_torch.core import flags as _flags
    from paddle_tpu_torch.distributed.supervisor import FleetSpec, Supervisor
    from paddle_tpu_torch.observability import debug_server

    spec = FleetSpec.from_file(args.spec)
    if args.debug_port:
        _flags.set_flags({"debug_server_port": args.debug_port})
        debug_server.start(port=args.debug_port)
    sup = Supervisor(spec, poll_s=args.poll_s).start()
    print(f"[fleet] {spec.name!r} up: registry {sup.registry_ep}, roles "
          + ", ".join(f"{r}x{s.count}" for r, s in spec.roles.items()),
          flush=True)

    stop = {"sig": None}

    def _on_signal(signum, frame):
        stop["sig"] = signum

    signal.signal(signal.SIGINT, _on_signal)
    signal.signal(signal.SIGTERM, _on_signal)
    deadline = time.monotonic() + args.timeout if args.timeout else None
    verdict = None
    try:
        while stop["sig"] is None:
            verdict = sup.wait(timeout=1.0)
            if verdict in ("done", "hold"):
                break
            if deadline is not None and time.monotonic() >= deadline:
                verdict = "timeout"
                break
    finally:
        status = sup.status()
        sup.stop()
    print(json.dumps(status, indent=2, default=repr))
    if stop["sig"] is not None:
        print(f"[fleet] stopped on signal {stop['sig']}", flush=True)
        return 0
    print(f"[fleet] verdict: {verdict}", flush=True)
    return {"done": 0, "hold": 3, "timeout": 4}.get(verdict, 1)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "launch":
        return _launch(args)
    params = {"fleet": args.fleet}
    if args.cmd == "resize":
        params["resize"] = f"{args.role}:{args.count}"
    elif args.cmd == "drain":
        params["drain"] = args.worker
    elif args.cmd == "resume":
        params["resume"] = args.role
    out = fleetz_request(args.endpoint, params)
    print(json.dumps(out, indent=2, default=repr))
    if args.cmd == "status" and isinstance(out, dict):
        _print_role_table(out)
    return 2 if isinstance(out, dict) and "error" in out else 0


def _print_role_table(out: dict) -> None:
    """Per-role summary under the JSON card: liveness, SLO breaches,
    — when replicas publish capacity (FLAGS_capacity_attribution) —
    the tightest replica's headroom next to the SLO column, — when
    the golden canary runs (FLAGS_canary_probe) — the worst live
    canary-fail streak (`-` = all replicas passing), and — when
    replicas publish memory (FLAGS_memory_attribution) — the tightest
    replica's measured byte headroom (`leak!` = a refcount audit
    failed somewhere in the role)."""
    fleets = out if all(isinstance(v, dict) and "roles" in v
                        for v in out.values()) and out else {"": out}
    for fname, status in fleets.items():
        roles = status.get("roles")
        if not isinstance(roles, dict) or not roles:
            continue
        slo = status.get("slo_breaches") or {}
        print()
        title = f"fleet {status.get('fleet', fname) or fname}"
        print(f"{title}  [{status.get('state', '?')}]")
        print("{:<14}{:>7}{:>8}{:>8}{:>12}{:>11}{:>9}{:>9}".format(
            "role", "count", "target", "hold", "slo_breach", "headroom",
            "canary", "mem"))
        for r in sorted(roles):
            rs = roles[r]
            n_slo = sum(1 for w in slo if str(w).startswith(f"{r}-"))
            hr = rs.get("headroom_frac")
            streak = rs.get("canary_fail_streak")
            mem = rs.get("memory_headroom_frac")
            if rs.get("memory_leak"):
                mem_cell = "leak!"
            elif isinstance(mem, (int, float)):
                mem_cell = f"{mem:.1%}"
            else:
                mem_cell = "-"
            print("{:<14}{:>7}{:>8}{:>8}{:>12}{:>11}{:>9}{:>9}".format(
                r, rs.get("count", "?"), rs.get("target", "?"),
                "yes" if rs.get("hold") else "-",
                n_slo or "-",
                f"{hr:.1%}" if isinstance(hr, (int, float)) else "-",
                f"fail:{streak}" if streak else "-",
                mem_cell))


if __name__ == "__main__":
    sys.exit(main())
