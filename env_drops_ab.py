#!/usr/bin/env python3
"""Peak device memory and step time of ResNet-50 training with and
without the interpreter's environment drops (``core/lowering.py:
plan_drops``: a variable leaves the run's environment after its last
use unless it is fetched or persistable).

Run from the repository root on one CUDA card:

    python3 env_drops_ab.py [B]

For bfloat16 NHWC and float32 NHWC (B=256 unless given), it trains
ResNet-50 at (3, 224, 224) from one seed for 5 steps with the drops on,
then off (the plan's drops emptied), then on again, each arm in a fresh
scope, and prints each arm's peak memory (``max_memory_allocated``),
median step ms (steps 2-5, the loss fetch the synchronise) and losses
(cuDNN's weight gradients may sum in another order on a rerun, so the
arms' losses are printed, not held equal).  An arm that does not fit
prints its out-of-memory error.  Details go to
``chiprun_out/env_drops_ab.json``.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

import chip_smoke as smoke

STEPS = 5


def arm(dev, dtype, layout, B, drops: bool) -> dict:
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import lowering
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.ops._util import torch_dtype
    saved = lowering.plan_drops
    if not drops:
        lowering.plan_drops = lambda block, plan: None
    try:
        main, startup, loss, feeds = smoke.build_conv(
            resnet, class_dim=1000, image_shape=(3, 224, 224), depth=50,
            lr=0.1, dtype=dtype, layout=layout)
        exe, scope = fluid.Executor(dev), fluid.Scope()
        exe.run(startup, scope=scope)
        batch = smoke.conv_batch(feeds, B, (3, 224, 224), 1000, seed=3)
        feed = {feeds[0]: torch.from_numpy(batch[feeds[0]]).to(dev).to(
                    torch_dtype(dtype)),
                feeds[1]: torch.from_numpy(batch[feeds[1]]).to(dev)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []
        try:
            with fluid.scope_guard(scope):
                for _ in range(STEPS):
                    t = time.perf_counter()
                    (l,) = exe.run(main, feed=feed, fetch_list=[loss])
                    ms.append((time.perf_counter() - t) * 1e3)
                    losses.append(float(np.asarray(l, np.float32)))
        except torch.cuda.OutOfMemoryError as e:
            return {"drops": drops, "oom": str(e).splitlines()[0][:300],
                    "max_memory_allocated":
                        torch.cuda.max_memory_allocated()}
        return {"drops": drops, "losses": losses, "step_ms": ms,
                "step_ms_median": float(np.median(ms[1:])),
                "max_memory_allocated": torch.cuda.max_memory_allocated()}
    finally:
        lowering.plan_drops = saved
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("env_drops_ab: no CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.platform import get_device
    dev = get_device()
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    card = smoke.nvidia_smi_line()
    print(card, flush=True)
    out = {"card": card, "B": B}
    for dtype, layout in (("bfloat16", "NHWC"), ("float32", "NHWC")):
        arms = [arm(dev, dtype, layout, B, d) for d in (True, False, True)]
        for a in arms:
            print(f"{dtype} {layout} B={B} drops {a['drops']} [{card}]: "
                  + json.dumps({k: v for k, v in a.items() if k != "drops"}),
                  flush=True)
        out[f"{dtype}_{layout}"] = arms
    os.makedirs(smoke.OUT_DIR, exist_ok=True)
    with open(os.path.join(smoke.OUT_DIR, "env_drops_ab.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
