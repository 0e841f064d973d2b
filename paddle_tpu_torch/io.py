"""Checkpoint save/load and inference-model export.

The port of ``paddle_tpu/io.py`` (the reference's ``fluid/io.py``:
save_vars:89, save_persistables:252, load_persistables:464,
save_inference_model:544, load_inference_model:669), in the reference's
on-disk format, so a directory either package saved loads in the
other: the pruned program as ``__model__`` JSON, the persistables as
one ``.npz`` per combined save (``__params__.npz`` by default) or one
``.npy`` per variable.  Every file is written atomically (a unique
temporary, fsync, ``os.replace``): a crash mid-save leaves the previous
file whole.

The scope holds torch tensors on the executor's device: a save stages
them to host arrays, and a load puts the arrays on ``executor.device``
through :meth:`Scope.load_numpy` (``cuda:0`` when the executor is None).
A bfloat16 value is written as the reference writes it, the 2-byte
records ``np.save`` makes of an ``ml_dtypes.bfloat16`` array, with or
without ``ml_dtypes`` here, and loads back by its bits.
"""
from __future__ import annotations

import json
import os
import uuid
from typing import List, Sequence

import numpy as np
import torch

from .core.executor import _to_numpy, bf16_bits, global_scope
from .core.types import BFLOAT16_NP
from .core.program import Program, Variable, default_main_program

MODEL_FILENAME = "__model__"
PARAMS_FILENAME = "__params__.npz"

__all__ = ["MODEL_FILENAME", "PARAMS_FILENAME", "load_inference_model",
           "load_params", "load_persistables", "load_vars",
           "save_inference_model", "save_params", "save_persistables",
           "save_vars"]


def atomic_file_write(path: str, write_fn) -> None:
    """Write ``path`` atomically: ``write_fn(f)`` fills a unique
    temporary beside it, which is fsynced and renamed over ``path``; a
    failed write removes the temporary.  (A copy of the reference's
    ``checkpoint/store.atomic_file_write``, without its fault-injection
    site.)"""
    tmp = f"{path}.tmp.{uuid.uuid4().hex[:8]}"
    try:
        with open(tmp, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load_npz(path: str):
    """np.load with errors that name the file."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"checkpoint file {path!r} does not exist — nothing was "
            "saved there, or the directory is wrong")
    try:
        return np.load(path, allow_pickle=False)
    except Exception as e:
        raise RuntimeError(
            f"checkpoint file {path!r} is corrupt or not a checkpoint "
            f"({type(e).__name__}: {e}); a crash mid-save cannot "
            "produce this (saves are atomic) — look for disk faults or "
            "a foreign file") from e


def _persistable_vars(program: Program) -> List[Variable]:
    return [v for v in program.global_block.vars.values()
            if v.persistable and v.name != "@RNG_STATE@"]


def _var_file(dirname: str, name: str) -> str:
    return os.path.join(dirname, name.replace("/", "__") + ".npy")


def _saved_array(val) -> np.ndarray:
    """The host array a save writes for scope value ``val``: a bfloat16
    tensor's bits as ``ml_dtypes.bfloat16`` (or, without it, as the
    same raw 2-byte records, ``V2``)."""
    if isinstance(val, torch.Tensor) and val.dtype == torch.bfloat16:
        return bf16_bits(val).view(BFLOAT16_NP if BFLOAT16_NP is not None
                                   else np.dtype("V2"))
    return _to_numpy(val)


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Write the global scope's values of ``vars`` (every variable of the
    program that passes ``predicate`` when None) into ``dirname``: one
    ``.npy`` each, or one ``.npz`` named ``filename``.  Variables the
    scope does not hold are left out."""
    del executor
    program = main_program or default_main_program()
    if vars is None:
        vars = [v for v in program.global_block.vars.values()
                if predicate is None or predicate(v)]
    os.makedirs(dirname, exist_ok=True)
    scope = global_scope()
    arrays = {}
    for v in vars:
        val = scope.find_var(v.name)
        if val is not None:
            arrays[v.name] = _saved_array(val)
    if filename is None:
        for name, arr in arrays.items():
            atomic_file_write(_var_file(dirname, name),
                              lambda f, a=arr: np.save(f, a))
    else:
        atomic_file_write(os.path.join(dirname, filename),
                          lambda f: np.savez(f, **arrays))


def save_persistables(executor, dirname, main_program=None, filename=None):
    program = main_program or default_main_program()
    save_vars(executor, dirname, program, vars=_persistable_vars(program),
              filename=filename or PARAMS_FILENAME)


def save_params(executor, dirname, main_program=None, filename=None):
    program = main_program or default_main_program()
    params = [v for v in program.global_block.vars.values() if v.is_parameter]
    save_vars(executor, dirname, program, vars=params,
              filename=filename or PARAMS_FILENAME)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Read ``vars`` (as :func:`save_vars` chose them) from ``dirname``
    into the global scope, as tensors on the executor's device.  A
    variable with no saved value is left as it is."""
    program = main_program or default_main_program()
    if vars is None:
        vars = [v for v in program.global_block.vars.values()
                if predicate is None or predicate(v)]
    arrays = {}
    if filename is None:
        for v in vars:
            path = _var_file(dirname, v.name)
            if not os.path.exists(path):
                continue
            try:
                arrays[v.name] = np.load(path, allow_pickle=False)
            except Exception as e:
                raise RuntimeError(
                    f"checkpoint file {path!r} for variable {v.name!r} is "
                    f"corrupt ({type(e).__name__}: {e})") from e
    else:
        data = _load_npz(os.path.join(dirname, filename))
        arrays = {v.name: data[v.name] for v in vars if v.name in data}
    global_scope().load_numpy(arrays, getattr(executor, "device", None))


def load_persistables(executor, dirname, main_program=None, filename=None):
    program = main_program or default_main_program()
    load_vars(executor, dirname, program, vars=_persistable_vars(program),
              filename=filename or PARAMS_FILENAME)


def load_params(executor, dirname, main_program=None, filename=None):
    load_persistables(executor, dirname, main_program, filename)


def save_inference_model(dirname, feeded_var_names: Sequence[str],
                         target_vars: Sequence[Variable], executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True):
    """Prune the program to what ``target_vars`` need and save it with
    its persistables (reference io.py:544).  Returns the target
    names."""
    del export_for_deployment
    program = (main_program or default_main_program()).clone()
    pruned = program.prune([v.name for v in target_vars])
    os.makedirs(dirname, exist_ok=True)
    meta = pruned.to_dict()
    meta["feed_var_names"] = list(feeded_var_names)
    meta["fetch_var_names"] = [v.name for v in target_vars]
    text = json.dumps(meta).encode("utf-8")
    atomic_file_write(os.path.join(dirname, model_filename or MODEL_FILENAME),
                      lambda f: f.write(text))
    save_persistables(executor, dirname, pruned,
                      filename=params_filename or PARAMS_FILENAME)
    return [v.name for v in target_vars]


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """Read a :func:`save_inference_model` directory: ``(program, feed
    names, fetch variables)``, with the persistables in the global scope
    on the executor's device."""
    with open(os.path.join(dirname, model_filename or MODEL_FILENAME)) as f:
        meta = json.load(f)
    program = Program.from_dict({"version": meta.get("version", 1),
                                 "blocks": meta["blocks"]})
    load_persistables(executor, dirname, program,
                      filename=params_filename or PARAMS_FILENAME)
    feed_names = meta.get("feed_var_names", [])
    fetch_vars = [program.global_block.var(n)
                  for n in meta.get("fetch_var_names", [])]
    return program, feed_names, fetch_vars
