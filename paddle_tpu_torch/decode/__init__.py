"""Autoregressive decode plane of the PyTorch port.

The port of ``paddle_tpu/decode``: a paged KV cache resident on the
card (:mod:`cache`), token-level continuous batching (:mod:`engine`),
the decoder-only LM with on-device sampling (:mod:`model`), beam search
over the paged cache by copy-on-write block forking (:mod:`beam`), and
paged decode attention as a hand-written CUDA kernel
(:func:`paddle_tpu_torch.kernels.attention.decode_attention`).
"""
from __future__ import annotations

from .cache import BlockAllocator, PagedKVCache, PrefixCache  # noqa: F401
from .model import (LMConfig, TransformerLM, load_lm,  # noqa: F401
                    save_lm)
from .engine import (DecodeEngine, DecodeHandle,  # noqa: F401
                     DecodeRequest, SamplingParams)
from .beam import PagedBeamDecoder  # noqa: F401
from ..serving.batcher import (Draining, Overloaded,  # noqa: F401
                               RequestTooLong)

__all__ = [
    "BlockAllocator", "PagedKVCache", "PrefixCache",
    "LMConfig", "TransformerLM", "save_lm", "load_lm",
    "DecodeEngine", "DecodeHandle", "DecodeRequest", "SamplingParams",
    "PagedBeamDecoder",
    "Draining", "Overloaded", "RequestTooLong",
]
