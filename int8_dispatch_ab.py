#!/usr/bin/env python3
"""The int8 serving dispatch of this checkout against other checkouts', on
one CUDA card: device busy time and the kernels that fill it.

    git archive <commit> | tar -x -C <dir>
    python3 int8_dispatch_ab.py <dir> [<dir> ...]

Every checkout runs in a process of its own, in turns: other, this, this,
other for each other checkout.  A process imports the ``paddle_tpu_torch``
package of its checkout (built from that checkout's ``csrc``) and this
checkout's ``chip_smoke.py`` helpers, saves the serving model of
``chip_smoke.py``'s phase 10 (Transformer-base, 6+6 layers, T=256, seed
5), loads it through ``create_predictor`` with ``enable_int8()``, runs the
bucket-8 dispatch 16 times, then profiles three more
(``chip_smoke.profile_call``).  It reports each profile's device busy
time, its summed device time with and without copies (the logits'
copy to the host takes most of a dispatch's busy time, and its rate
varies with the host), the median one's top kernels, K5's device time
(``int8_fc_kernel``) and its launches a dispatch, and the K-major weight
copies the wrapper made over the 16 dispatches (``quant.kmajor_copies``,
null for a checkout whose K5 reads the weight as stored): a copy made in
a dispatch after the first would be device time that K5 alone does not
show.  One JSON line at the end; run on a card, it fails without one.
"""
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
DISPATCHES = 16
PROFILES = 3


def child(root: str) -> dict:
    sys.path.insert(0, HERE)
    sys.path.insert(0, root)
    import tempfile

    import numpy as np
    import torch

    import chip_smoke as C
    from paddle_tpu_torch.kernels import quant as Q
    assert os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(Q.__file__)))) == os.path.abspath(root)
    dev = torch.device("cuda:0")
    rows = C.serving_rows(8, C.SERVE_T, seed=17)
    with tempfile.TemporaryDirectory() as d:
        C.save_serving_model(d, C.SERVE_LAYERS, C.SERVE_T, dev)
        pred = C.int8_predictor(d, True)
        feed = {n: np.concatenate([r[n] for r in rows])
                for n in pred.feed_names}
        pred.run(feed)
        torch.cuda.synchronize()

        def copies():
            return Q.quantz()["counters"].get("kmajor_copies")

        n0, c0 = Q.int8_fc.launches, copies()
        for _ in range(DISPATCHES):
            pred.run(feed)
        torch.cuda.synchronize()
        launches = (Q.int8_fc.launches - n0) / DISPATCHES
        made = None if c0 is None else copies() - c0
        profs = [C.profile_call(lambda: pred.run(feed), ("int8_fc_kernel",))
                 for _ in range(PROFILES)]
    busy = [p.get("device_busy_ms") for p in profs]
    mid = sorted(range(PROFILES), key=lambda i: busy[i])[PROFILES // 2]
    p = profs[mid]
    return {"root": root, "k5_launches_per_dispatch": launches,
            "kmajor_copies_in_16_dispatches": made,
            "kmajor_copies_at_load": c0,
            "device_busy_ms": busy,
            "kernel_ms_total": [q.get("kernel_ms_total") for q in profs],
            "copy_ms": [q.get("copy_ms") for q in profs],
            "k5_ms": [q.get("focus_ms", {}).get("int8_fc_kernel")
                      for q in profs],
            "kernels_launched": [q.get("kernels_launched") for q in profs],
            "wall_ms": [q.get("wall_ms") for q in profs],
            "median_profile_top_kernels": p.get("top_kernels")}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        print("RESULT " + json.dumps(child(sys.argv[2])), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print("usage: int8_dispatch_ab.py <other checkout> ... "
              "(on a CUDA card)", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from chip_smoke import nvidia_smi_line
    card = nvidia_smi_line()
    print(card, flush=True)
    res = {"card": card, "runs": []}
    for other in sys.argv[1:]:
        for who in (other, HERE, HERE, other):
            tag = "this" if who == HERE else os.path.basename(
                os.path.normpath(who))
            p = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--child", os.path.abspath(who)],
                               capture_output=True, text=True, timeout=900)
            line = [x for x in p.stdout.splitlines()
                    if x.startswith("RESULT ")]
            if p.returncode != 0 or not line:
                print(p.stdout[-3000:], p.stderr[-6000:], file=sys.stderr)
                raise RuntimeError(f"the {tag} run failed ({p.returncode})")
            r = json.loads(line[-1][len("RESULT "):])
            r["who"] = tag
            res["runs"].append(r)
            print(tag, json.dumps({k: v for k, v in r.items()
                                   if k != "median_profile_top_kernels"}),
                  flush=True)
            for k in r["median_profile_top_kernels"] or []:
                print(f"    {k['ms']:.4f} ms  x{k['count']}  {k['name']}",
                      flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
