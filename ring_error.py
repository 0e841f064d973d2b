#!/usr/bin/env python3
"""Ring attention's float32 error against a float64 reference, on the CPU.

    python3 ring_error.py [T]

Splits the ring's error on its training path into the float32 arithmetic
of the attention itself (its cancellation: ds = p * (dp - delta) and the
sums after it) and the share the ring's pairs add (each pair's output
normalized on its own, rounded and merged by log2 mass; each pair's
gradients summed across hops).  The inputs are the path's own: one step
of the 2-layer full-width ring Transformer (``chip_smoke.RING_PARITY`` at
T tokens, default 512, B=2, dropout 0.1, ``{"sp": 4}`` over four CPU
entries) copies the inputs of its first encoder self-attention, causal
decoder self-attention and cross-attention (``chip_smoke.ring_op_calls``:
D=64, the padding masks, the step's seed and rate); the cotangent is a
seeded unit normal, as ``chip_smoke.check_ring_on_path`` takes.  On each,
forward and backward:

- ``ring_attention`` (the hop route; on the CPU the ring entries' plain
  loops) and ``ring_attention_ref`` (the plain ring's pair-by-pair walk);
- the plain ring with every pair's products in split TF32
  (``kernels/_tf32.py: matmul_tf32x3``), the float32 kernels' arithmetic
  on the card;
- the whole sequence in float32 without pairs: one softmax over every key
  with the ring's dropout bits (each pair's tile hash on its pair seed),
  autograd's backward;
- the same in float64: the reference every other number is held to.

Prints one line a call and a JSON object with max|x - ref64| / max|ref64|
of out, dq, dk, dv for each.  The ring's float32 error splits into the
whole sequence's (cancellation) and the rest (the pairs'); the split-TF32
ring shows what the card's kernels add to it.
"""
import json
import sys

import numpy as np
import torch

import chip_smoke as C
from paddle_tpu_torch.kernels import attention as A
from paddle_tpu_torch.kernels._tf32 import matmul_tf32x3


def ring_tf32x3(q, k, v, mask, seed, devices, causal, sm_scale, rate, do):
    """The plain ring's walk with every pair's products in split TF32:
    (out, dq, dk, dv)."""
    def fwd(*a):
        return A.flash_attention_ref(*a, matmul=matmul_tf32x3)

    def dq(*a):
        return A._bwd_ref(*a, True, False, matmul_tf32x3)[0]

    def dkv(*a):
        return A._bwd_ref(*a, False, True, matmul_tf32x3)[1:]

    devices = tuple(devices)
    out, lse = A._ring_forward(q, k, v, mask, seed, devices, causal,
                               sm_scale, rate, fwd)
    return [out] + list(A._ring_backward(q, k, v, mask, seed, out, lse, do,
                                         devices, causal, sm_scale, rate,
                                         dq, dkv))


def grads(fn, x, dtype):
    leaves = [x[n].to(dtype).clone().requires_grad_(True)
              for n in ("q", "k", "v")]
    out = fn(*leaves)
    g = torch.autograd.grad(out, leaves, x["do"].to(dtype))
    return [out.detach()] + list(g)


def path_calls(T: int) -> dict:
    """The first layer's three ring ops' inputs from one step of the
    2-layer ring Transformer at T tokens on four CPU entries."""
    import paddle_tpu_torch as fluid
    cfg = dict(C.RING_PARITY, max_len=T, dropout=0.1)
    main, startup, loss, _ = C.build_transformer(cfg)
    scope = fluid.Scope()
    fluid.Executor("cpu").run(startup, scope=scope)
    exe = C.ring_executor(main, ["cpu"] * C.RING_SP, scope, loss)
    feed = C.train_feed(C.RING_PARITY_B, T, cfg["tgt_vocab"], seed=11)
    calls = {}
    n = cfg["n_layer"]
    with C.ring_op_calls(calls, {"encoder_self": 0, "decoder_self": n,
                                 "cross": n + 1}):
        exe.run(fetch_list=[loss], feed=feed)
    return calls


def main() -> int:
    T = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    torch.manual_seed(0)
    res = {"T": T}
    for name, c in path_calls(T).items():
        g = torch.Generator().manual_seed(97)
        x = {n: c[n] for n in ("q", "k", "v", "mask", "seed")}
        x["do"] = torch.randn(c["out"].shape, generator=g)
        B, H, Tq, D = x["q"].shape
        sp, causal, rate, sm = (len(c["devices"]), c["causal"], c["rate"],
                                c["sm_scale"])
        drop64 = C.ring_dropout_grid(A, x["seed"], B, H, Tq,
                                     x["k"].shape[2], sp, causal, rate,
                                     torch.float64, "cpu")

        def ring(fn):
            return lambda q, k, v: fn(q, k, v, x["mask"], c["devices"],
                                      causal, sm, rate, x["seed"])

        ref = grads(lambda q, k, v: C.attention_whole(
            q, k, v, x["mask"].double(), drop64, causal, sm), x,
            torch.float64)
        runs = {"hop_route": grads(ring(A.ring_attention), x, torch.float32),
                "plain_ring": grads(ring(A.ring_attention_ref), x,
                                    torch.float32),
                "whole_f32": grads(lambda q, k, v: C.attention_whole(
                    q, k, v, x["mask"], drop64.float(), causal, sm), x,
                    torch.float32),
                "ring_tf32x3": ring_tf32x3(
                    x["q"], x["k"], x["v"], x["mask"],
                    x["seed"].reshape(1), c["devices"], causal, sm, rate,
                    x["do"])}
        row = {"shape": [B, H, Tq, D], "causal": causal, "rate": rate,
               "max_ref": {}}
        for n, r in zip(("out", "dq", "dk", "dv"), ref):
            row["max_ref"][n] = r.abs().max().item()
        for who, got in runs.items():
            row[who] = {n: ((a.double() - r).abs().max() / r.abs().max()
                            ).item()
                        for n, a, r in zip(("out", "dq", "dk", "dv"), got,
                                           ref)}
        row["hop_route_equals_plain_ring"] = all(
            torch.equal(a, b) for a, b in zip(runs["hop_route"],
                                              runs["plain_ring"]))
        res[name] = row
        print(f"{name} B,H,T,D={row['shape']} causal={causal} dropout="
              f"{rate}: max|d| / max|ref64| dq: hop route "
              f"{row['hop_route']['dq']:.3e}, plain ring "
              f"{row['plain_ring']['dq']:.3e}, whole f32 "
              f"{row['whole_f32']['dq']:.3e}, split-TF32 ring "
              f"{row['ring_tf32x3']['dq']:.3e}; max|ref64| dq "
              f"{row['max_ref']['dq']:.4g}", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
