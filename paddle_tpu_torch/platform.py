"""Device selection for the PyTorch port.

The port runs on a CUDA card.  Every entry point resolves its device
through :func:`get_device`: ``cuda:0`` by default, the CPU only when the
caller asks for it by name (the CPU tests do).  Without a card and
without that request it raises; it never carries on on the CPU.
"""
from __future__ import annotations

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


__all__ = ["CPUPlace", "CUDAPlace", "get_device"]
