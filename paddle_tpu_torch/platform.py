"""Device selection for the PyTorch port.

The port runs on a CUDA card.  Every entry point resolves its device
through :func:`get_device`: ``cuda:0`` by default, the CPU only when the
caller asks for it by name (the CPU tests do).  Without a card and
without that request it raises; it never carries on on the CPU.
"""
from __future__ import annotations

from typing import Dict

import torch


class CUDAPlace:
    """The reference's place for card ``device_id`` (``Executor(place)``)."""

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def torch_device(self) -> torch.device:
        return torch.device("cuda", self.device_id)

    def __eq__(self, other):
        return isinstance(other, CUDAPlace) and \
            other.device_id == self.device_id

    def __hash__(self):
        return hash(("cuda", self.device_id))

    def __repr__(self):
        return f"CUDAPlace({self.device_id})"


class CPUPlace:
    """The host: runs the plain PyTorch versions of the kernels."""

    def torch_device(self) -> torch.device:
        return torch.device("cpu")

    def __eq__(self, other):
        return isinstance(other, CPUPlace)

    def __hash__(self):
        return hash("cpu")

    def __repr__(self):
        return "CPUPlace()"


def get_device(device=None) -> torch.device:
    """The torch device an entry point runs on.

    ``None`` means ``cuda:0``; a ``CUDAPlace``/``CPUPlace`` names its
    device.  A CUDA device raises ``RuntimeError``
    when CUDA is absent.  Float32 matrix products are pinned to full
    float32 (no TF32) here, so the card computes what the reference
    computes to float32 rounding."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if hasattr(device, "torch_device"):
        device = device.torch_device()
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


# ---------------------------------------------------------------------------
# Platform peak table (observability/perf.py rooflines)
# ---------------------------------------------------------------------------
# device name substring (lowercased, spaces and dashes stripped) ->
# (peak FLOP/s, HBM bytes/s).  The reference's table holds each TPU's
# matrix unit at bf16, so ``flops`` here is the card's dense bf16
# tensor-core peak: NVIDIA's H100 SXM5 80GB data sheet, 989 TFLOP/s
# dense bf16, HBM3 3.35 TB/s (the figures PERF.md's kernel bounds use).
# A float32 program's FMA units peak at 67 TFLOP/s on the same card, so
# its frac_of_peak_flops against this row reads ~15x low.  The CPU row
# is the reference's NOMINAL host envelope (``nominal=True``): rooflines
# still compute on a CPU run, as positions relative to each other.
PLATFORM_PEAKS: Dict[str, tuple] = {
    "h10080gbhbm3": (989e12, 3.35e12),    # "NVIDIA H100 80GB HBM3"
}
_CPU_NOMINAL_PEAKS = (0.5e12, 50e9)


def _default_device() -> torch.device:
    """The card when there is one, else the host: the device a report
    describes when the caller names none (reports never launch work)."""
    return torch.device("cuda", torch.cuda.current_device()) \
        if torch.cuda.is_available() else torch.device("cpu")


def platform_peaks(device=None) -> dict:
    """Peak FLOP/s and HBM bytes/s for ``device`` (default: ``cuda:0``
    where a card exists, else the CPU) from :data:`PLATFORM_PEAKS`;
    ``{"flops": None, ...}`` for an unknown card (rooflines then report
    intensity only)."""
    dev = torch.device(device) if device is not None else _default_device()
    if dev.type == "cuda":
        kind = torch.cuda.get_device_name(dev)
        plat = "gpu"
    else:
        kind, plat = "cpu", "cpu"
    norm = kind.lower().replace(" ", "").replace("-", "")
    out = {"device_kind": kind, "platform": plat,
           "flops": None, "hbm_bytes_per_s": None, "nominal": False}
    for tag, (fl, bw) in PLATFORM_PEAKS.items():
        if tag in norm:
            out["flops"], out["hbm_bytes_per_s"] = fl, bw
            return out
    if plat == "cpu":
        out["flops"], out["hbm_bytes_per_s"] = _CPU_NOMINAL_PEAKS
        out["nominal"] = True
    return out


def device_inventory() -> dict:
    """Hardware card for /statusz: platform, device name and count, and
    each card's ``total_memory``, so fleet dashboards can label perf
    series by what they ran on.  Never raises."""
    try:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            return {"platform": "cpu", "device_count": 1,
                    "local_device_count": 1,
                    "devices": [{"id": 0, "kind": "cpu",
                                 "process_index": 0,
                                 "memory_limit_bytes": None}]}
        devs = []
        for i in range(n):
            p = torch.cuda.get_device_properties(i)
            devs.append({"id": i, "kind": p.name, "process_index": 0,
                         "memory_limit_bytes": int(p.total_memory)})
        return {"platform": "gpu", "device_count": n,
                "local_device_count": n, "devices": devs}
    except Exception as e:  # pragma: no cover - CUDA runtime failure
        return {"error": repr(e)[:200]}


__all__ = ["CPUPlace", "CUDAPlace", "PLATFORM_PEAKS", "device_inventory",
           "get_device", "platform_peaks"]
