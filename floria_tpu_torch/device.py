"""Device resolution, the TF32 guard, and copies between host and card
that do not make the host wait.

The port takes its device explicitly on every public entry; there is no
global device state. Asking for CUDA on a host without it raises — the
port never quietly runs on the CPU.

TF32 keeps ~10 mantissa bits, so an f32 or f64-adjacent GEMM routed
through it would corrupt exact weight-quanta arithmetic. The guard sets
both TF32 switches off when the package is imported and asserts they
are still off at every entry.
"""

from __future__ import annotations

import numpy as np
import torch


def require_no_tf32() -> None:
    """Turn TF32 off (idempotent) and assert it is off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check_no_tf32()


def check_no_tf32() -> None:
    """Entry guard: raise if someone re-enabled TF32 after import."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 / "
            "torch.backends.cudnn.allow_tf32 must be False: TF32 GEMMs "
            "break the port's exact weight-quanta arithmetic")


def upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """`x` as a tensor on `device`. A card's copy goes through pinned
    host memory with non_blocking=True, so the host does not wait for the
    card (PyTorch's pinned-memory allocator keeps the staging buffer until
    the copy has run); on the CPU the tensor shares `x`'s memory."""
    t = torch.from_numpy(x)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def to_host(x: torch.Tensor) -> torch.Tensor:
    """A host copy of `x`. From a card it lands in pinned memory through
    a non_blocking copy: the values are there only after the stream's
    work up to this call has run (wait on an event recorded after it)."""
    if x.device.type != "cuda":
        return x
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return out.copy_(x, non_blocking=True)


def resolve_device(device) -> torch.device:
    """torch.device for `device` ("cuda", "cuda:0", "cpu" or a
    torch.device). Raises when CUDA is asked for and unavailable."""
    check_no_tf32()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() "
            "is False (pass device='cpu' to run the plain path)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
