"""Binary serialization of runtime values for the var-transport wire.

The port's copy of ``paddle_tpu/distributed/serde.py``.  The port's
values may be torch tensors: a dense tensor and a ``SelectedRows``
(whose rows and values are torch tensors here) are converted to numpy
at this boundary, so the same data gives the reference's bytes.  A
loaded ``SelectedRows`` holds CPU torch tensors; dense values load as
ndarrays, as in the reference.

Reference analogue: ``VariableMessage`` proto + zero-copy serializers
(``paddle/fluid/operators/distributed/send_recv.proto.in:20-84``,
``grpc_serde.cc:35,147``).  Values are dense ndarrays or SelectedRows
sparse slices; payloads are raw row-major bytes with a small header.

Two forms per direction:

- ``dumps_value``/``loads_value``: one contiguous ``bytes`` payload
  (one memcpy each way — the original wire form, still used for small
  control payloads and by legacy peers).
- ``dumps_value_vec``/``loads_value(copy=False)``: the scatter-gather
  form.  ``dumps_value_vec`` returns a **buffer list**
  ``[header, memoryview(raw tensor bytes), ...]`` that the transport
  hands to ``socket.sendmsg``/``writev`` — the tensor bytes go from the
  ndarray straight to the kernel, no Python-level concat copy (the
  ``grpc_serde.cc:35`` zero-copy ByteBuffer role).  ``copy=False`` on
  load returns ``np.frombuffer`` views over the receive buffer: a
  100 MB gradient costs zero Python-level copies each way.

  View aliasing rules: ``copy=False`` arrays are **read-only** views
  that keep the receive buffer alive; they are safe to reduce, feed, or
  replace, but not to mutate in place.  Pass ``copy=True`` (default)
  when the caller needs a writable, independently-owned array.

Batched form (``SEND_VARS``/``GET_VARS``): ``dumps_batch_vec``/
``loads_batch`` carry many ``(name, value)`` pairs in one frame —
item = ``u16 name_len | name | u32 value_len | value`` after a ``u32``
count, with every tensor body still a gathered view.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.selected_rows import SelectedRows

_DENSE = 0x44      # 'D'
_SELROWS = 0x53    # 'S'
_NONE = 0x4E       # 'N'

_BATCH_COUNT = struct.Struct("<I")
_BATCH_ITEM = struct.Struct("<HI")  # name_len, value_len


def _host(value) -> np.ndarray:
    """An ndarray view of ``value``: a torch tensor is brought to the
    host (a CUDA tensor costs one copy), anything else goes through
    ``np.asarray``."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``arr``; a read-only view (``copy=False``) is
    copied first, since torch tensors are writable."""
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


def _raw_view(arr: np.ndarray):
    """Contiguous byte view of ``arr`` without copying (the view keeps
    the array alive for the transport's lifetime of the buffer list)."""
    try:
        return memoryview(arr).cast("B")
    except (TypeError, ValueError):  # non-native strides etc.
        return arr.tobytes()


def _dump_dense_vec(arr: np.ndarray) -> list:
    # ascontiguousarray only when needed: it would promote 0-d to (1,)
    # and copy; contiguous inputs (the hot path) pass through untouched
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    dt = arr.dtype.str.encode("ascii")  # e.g. b'<f4'
    head = struct.pack("<BB", len(dt), arr.ndim) + dt
    head += struct.pack(f"<{arr.ndim}q", *arr.shape)
    return [head, _raw_view(arr)]


def _dump_dense(arr: np.ndarray) -> bytes:
    return b"".join(_dump_dense_vec(arr))


def _load_dense(buf: memoryview, off: int, copy: bool = True):
    dt_len, ndim = struct.unpack_from("<BB", buf, off)
    off += 2
    dt = np.dtype(bytes(buf[off:off + dt_len]).decode("ascii"))
    off += dt_len
    shape = struct.unpack_from(f"<{ndim}q", buf, off)
    off += 8 * ndim
    n = int(np.prod(shape)) if ndim else 1
    nbytes = n * dt.itemsize
    arr = np.frombuffer(buf[off:off + nbytes], dtype=dt).reshape(shape)
    return (arr.copy() if copy else arr), off + nbytes


def dumps_value_vec(value) -> list:
    """value → scatter-gather buffer list (bytes headers + memoryviews
    of the raw tensor bytes; zero tensor copies)."""
    if value is None:
        return [struct.pack("<B", _NONE)]
    if isinstance(value, SelectedRows):
        rows = _host(value.rows)
        vals = _host(value.values)
        return ([struct.pack("<Bq", _SELROWS, int(value.height))]
                + _dump_dense_vec(rows) + _dump_dense_vec(vals))
    return [struct.pack("<B", _DENSE)] + _dump_dense_vec(_host(value))


def dumps_value(value) -> bytes:
    """value: None | ndarray-like | SelectedRows → bytes (one copy)."""
    return b"".join(dumps_value_vec(value))


def _load_value(buf: memoryview, off: int, copy: bool):
    kind = buf[off]
    off += 1
    if kind == _NONE:
        return None, off
    if kind == _SELROWS:
        (height,) = struct.unpack_from("<q", buf, off)
        rows, off = _load_dense(buf, off + 8, copy)
        vals, off = _load_dense(buf, off, copy)
        return SelectedRows(_tensor(rows), _tensor(vals), height), off
    arr, off = _load_dense(buf, off, copy)
    return arr, off


def loads_value(data, copy: bool = True):
    """bytes → None | ndarray | SelectedRows (torch-backed).

    ``copy=False`` returns read-only ``np.frombuffer`` views over
    ``data`` (zero-copy; the views pin the buffer)."""
    value, _ = _load_value(memoryview(data), 0, copy)
    return value


# ---------------------------------------------------------------------------
# batched (name, value) payloads — the SEND_VARS / GET_VARS frame body
# ---------------------------------------------------------------------------

def buffers_nbytes(buffers: Sequence) -> int:
    return sum(len(b) if isinstance(b, (bytes, bytearray))
               else memoryview(b).nbytes for b in buffers)


def value_nbytes(value) -> int:
    """Approximate wire size of a value's tensor payload (headers
    excluded) — the stripe-balancing weight; costs no serialization."""
    if value is None:
        return 1
    if isinstance(value, SelectedRows):
        return _nbytes(value.rows) + _nbytes(value.values)
    return _nbytes(value)


def _nbytes(value) -> int:
    if isinstance(value, torch.Tensor):    # no copy off the card to count
        return value.numel() * value.element_size()
    return np.asarray(value).nbytes


def dumps_batch_vec(pairs: Sequence[Tuple[str, object]]) -> list:
    """[(name, value)] → scatter-gather buffer list for one batched
    frame.  ``value=None`` items carry no tensor (the GET_VARS request
    form — names only)."""
    out = [_BATCH_COUNT.pack(len(pairs))]
    for name, value in pairs:
        nm = name.encode("utf-8")
        vec = dumps_value_vec(value)
        out.append(_BATCH_ITEM.pack(len(nm), buffers_nbytes(vec)) + nm)
        out.extend(vec)
    return out


def dumps_batch(pairs: Sequence[Tuple[str, object]]) -> bytes:
    return b"".join(dumps_batch_vec(pairs))


def loads_batch(data, copy: bool = False) -> List[Tuple[str, object]]:
    """Batched payload → [(name, value)] in frame order.

    Defaults to ``copy=False`` (the pserver apply path): values are
    read-only views over ``data`` — see the module docstring for the
    aliasing rules."""
    buf = memoryview(data)
    (count,) = _BATCH_COUNT.unpack_from(buf, 0)
    off = _BATCH_COUNT.size
    out: List[Tuple[str, Optional[object]]] = []
    for _ in range(count):
        name_len, value_len = _BATCH_ITEM.unpack_from(buf, off)
        off += _BATCH_ITEM.size
        name = bytes(buf[off:off + name_len]).decode("utf-8")
        off += name_len
        value, end = _load_value(buf, off, copy)
        if end - off != value_len:
            raise ValueError(
                f"corrupt batch item {name!r}: declared {value_len} bytes, "
                f"decoded {end - off}")
        off = end
        out.append((name, value))
    return out
