"""Device resolution and the TF32 guard.

The port takes its device explicitly on every public entry; there is no
global device state. Asking for CUDA on a host without it raises — the
port never quietly runs on the CPU.

TF32 keeps ~10 mantissa bits, so an f32 or f64-adjacent GEMM routed
through it would corrupt exact weight-quanta arithmetic. The guard sets
both TF32 switches off when the package is imported and asserts they
are still off at every entry.
"""

from __future__ import annotations

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
