"""ctypes bindings for the native runtime library (native/paddle_tpu_native.cc).

The port's copy of ``paddle_tpu/data/native.py``, with its own loader:
it never writes under ``native/``.  It loads
``native/libpaddle_tpu_native.so`` as it is when that library is at
least as new as its source; otherwise it builds the source with ``g++``
into the port's gitignored ``paddle_tpu_torch/data/build/`` (once, then
reused while it stays newer than the source).  Exposes the framed-TCP
transport's C half (``distributed/transport.py``), BlockingQueue and
RecordIOWriter/Scanner (reference: recordio/*,
operators/reader/lod_tensor_blocking_queue.h).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional

_NATIVE_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                           "..", "native"))
_SRC = os.path.join(_NATIVE_DIR, "paddle_tpu_native.cc")
_SO = os.path.join(_NATIVE_DIR, "libpaddle_tpu_native.so")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
_BUILT_SO = os.path.join(BUILD_DIR, "libpaddle_tpu_native.so")
# native/Makefile's flags for the queue and transport library
_CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-shared"]
_LD_FLAGS = ["-lz", "-lpthread"]


def _fresh(so: str) -> bool:
    return (os.path.exists(so)
            and os.path.getmtime(so) >= os.path.getmtime(_SRC))


def _build() -> str:
    """Compile ``paddle_tpu_native.cc`` into :data:`BUILD_DIR`; the
    library is written under a temporary name and renamed, so processes
    building at once never load a half-written file."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [os.environ.get("CXX", "g++"), *_CXX_FLAGS, "-o", tmp, _SRC,
           *_LD_FLAGS]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, _BUILT_SO)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(
            f"native lib build failed:\n{e.stdout}\n{e.stderr}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return _BUILT_SO


def library_path() -> str:
    """The library :func:`load` opens, built first if neither copy is
    fresh."""
    if _fresh(_SO):
        return _SO
    if _fresh(_BUILT_SO):
        return _BUILT_SO
    return _build()


_lib: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(library_path())
    # queue
    lib.ptq_queue_create.restype = ctypes.c_void_p
    lib.ptq_queue_create.argtypes = [ctypes.c_size_t]
    lib.ptq_queue_push.restype = ctypes.c_int
    lib.ptq_queue_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
    lib.ptq_queue_pop.restype = ctypes.c_long
    lib.ptq_queue_pop.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_char))]
    lib.ptq_buffer_free.argtypes = [ctypes.POINTER(ctypes.c_char)]
    lib.ptq_queue_close.argtypes = [ctypes.c_void_p]
    lib.ptq_queue_size.restype = ctypes.c_size_t
    lib.ptq_queue_size.argtypes = [ctypes.c_void_p]
    lib.ptq_queue_closed.restype = ctypes.c_int
    lib.ptq_queue_closed.argtypes = [ctypes.c_void_p]
    lib.ptq_queue_destroy.argtypes = [ctypes.c_void_p]
    # recordio
    # transport (framed TCP; see native/paddle_tpu_native.cc)
    lib.ptq_conn_connect.restype = ctypes.c_void_p
    lib.ptq_conn_connect.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_double]
    lib.ptq_conn_send_frame_vec.restype = ctypes.c_int
    lib.ptq_conn_send_frame_vec.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_size_t]
    lib.ptq_conn_send_frame.restype = ctypes.c_int
    lib.ptq_conn_send_frame.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_size_t]
    lib.ptq_conn_recv_frame.restype = ctypes.POINTER(ctypes.c_char)
    lib.ptq_conn_recv_frame.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_size_t)]
    lib.ptq_conn_close.argtypes = [ctypes.c_void_p]
    lib.ptq_conn_shutdown.argtypes = [ctypes.c_void_p]
    lib.ptq_listener_create.restype = ctypes.c_void_p
    lib.ptq_listener_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.ptq_listener_port.restype = ctypes.c_int
    lib.ptq_listener_port.argtypes = [ctypes.c_void_p]
    lib.ptq_listener_accept.restype = ctypes.c_void_p
    lib.ptq_listener_accept.argtypes = [ctypes.c_void_p]
    lib.ptq_listener_close.argtypes = [ctypes.c_void_p]
    lib.ptq_listener_shutdown.argtypes = [ctypes.c_void_p]

    lib.ptq_recordio_writer_open.restype = ctypes.c_void_p
    lib.ptq_recordio_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_size_t]
    lib.ptq_recordio_write.restype = ctypes.c_int
    lib.ptq_recordio_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
    lib.ptq_recordio_writer_close.restype = ctypes.c_int
    lib.ptq_recordio_writer_close.argtypes = [ctypes.c_void_p]
    lib.ptq_recordio_scanner_open.restype = ctypes.c_void_p
    lib.ptq_recordio_scanner_open.argtypes = [ctypes.c_char_p]
    lib.ptq_recordio_next.restype = ctypes.c_long
    lib.ptq_recordio_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_char))]
    lib.ptq_recordio_scanner_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class BlockingQueue:
    """Bounded MPMC byte-buffer queue in native code (the py_reader staging
    queue, lod_tensor_blocking_queue.h:32)."""

    def __init__(self, capacity: int):
        self._lib = load()
        self._q = self._lib.ptq_queue_create(capacity)

    def push(self, data: bytes) -> bool:
        return self._lib.ptq_queue_push(self._q, data, len(data)) == 0

    def pop(self) -> Optional[bytes]:
        out = ctypes.POINTER(ctypes.c_char)()
        n = self._lib.ptq_queue_pop(self._q, ctypes.byref(out))
        if n < 0:
            return None
        try:
            return ctypes.string_at(out, n)
        finally:
            self._lib.ptq_buffer_free(out)

    def close(self):
        self._lib.ptq_queue_close(self._q)

    def size(self) -> int:
        return self._lib.ptq_queue_size(self._q)

    @property
    def closed(self) -> bool:
        return bool(self._lib.ptq_queue_closed(self._q))

    def __del__(self):
        try:
            if self._q:
                self._lib.ptq_queue_destroy(self._q)
                self._q = None
        except Exception:
            pass


class RecordIOWriter:
    """Chunked record writer (recordio/writer.h).  compressor: 0=none, 1=zlib."""

    def __init__(self, path: str, compressor: int = 1,
                 max_chunk_records: int = 1000):
        self._lib = load()
        self._w = self._lib.ptq_recordio_writer_open(
            path.encode(), compressor, max_chunk_records)
        if not self._w:
            raise IOError(f"cannot open {path!r} for writing")

    def write(self, record: bytes) -> None:
        if self._lib.ptq_recordio_write(self._w, record, len(record)) != 0:
            raise IOError("recordio write failed")

    def close(self) -> None:
        if self._w:
            if self._lib.ptq_recordio_writer_close(self._w) != 0:
                raise IOError("recordio flush failed")
            self._w = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class RecordIOScanner:
    """Sequential reader with CRC validation (recordio/scanner.h)."""

    def __init__(self, path: str):
        self._lib = load()
        self._s = self._lib.ptq_recordio_scanner_open(path.encode())
        if not self._s:
            raise IOError(f"cannot open {path!r}")

    def __iter__(self):
        return self

    def __next__(self) -> bytes:
        out = ctypes.POINTER(ctypes.c_char)()
        n = self._lib.ptq_recordio_next(self._s, ctypes.byref(out))
        if n == -1:
            raise StopIteration
        if n == -2:
            raise IOError("recordio: malformed chunk")
        if n == -3:
            raise IOError("recordio: CRC mismatch (corrupt chunk)")
        try:
            return ctypes.string_at(out, n)
        finally:
            self._lib.ptq_buffer_free(out)

    def close(self):
        if self._s:
            self._lib.ptq_recordio_scanner_close(self._s)
            self._s = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
