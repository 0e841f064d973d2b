"""Input layers (reference: layers/io.py — ``data:37``), copied from
``paddle_tpu/layers/io.py``.

``data`` declares a feed var.  For variable-length sequences
(``lod_level>=1``) it also declares the companion ``<name>@LEN`` int32
length vector (the padded-sequence contract replacing LoDTensor).
"""
from __future__ import annotations

from ..core.program import default_main_program


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True, type=None):
    if lod_level > 2:
        raise NotImplementedError(
            f"lod_level={lod_level}: the padded contract covers level 1 "
            "([B,T,...] + @LEN) and level 2 ([B,S,W,...] + @LEN/@LEN2, "
            "reference lod_tensor.h:58 nesting); deeper nesting has no "
            "in-scope reference workload")
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    if lod_level == 1:
        # padded-sequence: runtime layout is [B, T, ...]; T is symbolic
        shape = [shape[0], -1] + shape[1:]
    elif lod_level == 2:
        # padded-nested: [B, S, W, ...] (samples, sentences, words)
        shape = [shape[0], -1, -1] + shape[1:]
    main = default_main_program().global_block
    var = main.create_var(
        name=name, shape=shape, dtype=dtype, lod_level=lod_level,
        stop_gradient=stop_gradient,
    )
    if lod_level >= 1:
        len_var = main.create_var(
            name=name + "@LEN", shape=[-1], dtype="int32", stop_gradient=True)
        main.seq_len_map[name] = len_var.name
    if lod_level == 2:
        len2_var = main.create_var(
            name=name + "@LEN2", shape=[-1, -1], dtype="int32",
            stop_gradient=True)
        main.seq_len2_map[name] = len2_var.name
    return var


__all__ = ["data"]
