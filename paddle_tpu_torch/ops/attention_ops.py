"""fused_attention op: one IR node for the whole attention block.

The port of ``paddle_tpu/ops/attention_ops.py``.  Impl selection via
attr, names kept so that serialized programs run unchanged:

- ``xla``   : the plain softmax chain (``kernels.attention.mha_ref``,
              the port of ``mha_xla``, with its ``_hash_dropout`` bits)
- ``pallas``: the flash path (``kernels.attention.flash_attention``:
              the CUDA kernels K1–K3 on the card, their plain versions
              on the CPU)
- ``auto``  : ``xla`` on every device, as the reference resolves it off
              a TPU (its crossover was measured on a TPU; an H100
              crossover is not measured yet)
- ``ring``  : sequence-parallel ring attention over the mesh axis
              ``sp_axis`` (default "sp") of a ``ParallelExecutor``
              (``kernels.attention.ring_attention``: K1–K3 over the
              shard pairs on the card, their plain versions on the
              CPU); without a mesh, or without that axis, ``mha_ref``,
              as the reference falls back to ``mha_xla``

Attention-probability dropout is seeded by an explicit program input
(drawn per step by the layer), so the forward and its gradient see the
same bits.  The op has no custom grad rule: its grad op differentiates
the graph the forward recorded (``core/lowering.py``), which for
``pallas`` is the ``FlashAttentionFn`` node whose backward launches the
two backward kernels without re-running the forward, and for ``ring``
the ``RingAttentionFn`` node whose backward runs the ring over them.
"""
from __future__ import annotations

import torch

from ..core.registry import register
from ..kernels import attention as A


@register("fused_attention", no_grad_slots=("KvMask", "Seed"))
def _fused_attention(ctx, ins, attrs):
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    kv_mask = ins["KvMask"][0] if ins.get("KvMask") else None
    causal = attrs.get("causal", False)
    scale = attrs.get("scale", None)
    impl = attrs.get("impl", "auto")
    rate = float(attrs.get("dropout_rate", 0.0) or 0.0)
    if not ctx.training or attrs.get("is_test", False):
        rate = 0.0
    seed = ins["Seed"][0] if ins.get("Seed") else None
    if impl == "auto":
        impl = "xla"
    if impl == "xla":
        out = A.mha_ref(q, k, v, kv_mask, causal, scale,
                        dropout_rate=rate, dropout_seed=seed)
    elif impl == "pallas":
        if kv_mask is not None:
            kv_mask = kv_mask.float().contiguous()
        if seed is not None:
            seed = seed.reshape(-1).int().contiguous()
        out = A.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), kv_mask, causal, scale,
                                dropout_rate=rate, dropout_seed=seed)
    elif impl == "ring":
        mesh = ctx.mesh
        sp = attrs.get("sp_axis", "sp")
        if mesh is None or sp not in mesh.axis_names:
            out = A.mha_ref(q, k, v, kv_mask, causal, scale,
                            dropout_rate=rate, dropout_seed=seed)
        else:
            kv_mask = (torch.ones(q.shape[0], k.shape[2], device=q.device)
                       if kv_mask is None else kv_mask.float().contiguous())
            seed = (torch.zeros(1, dtype=torch.int32, device=q.device)
                    if seed is None else seed.reshape(-1).int().contiguous())
            out = A.ring_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), kv_mask,
                                   mesh.axis_devices(sp), causal, scale,
                                   dropout_rate=rate, dropout_seed=seed)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    return {"Out": [out]}
