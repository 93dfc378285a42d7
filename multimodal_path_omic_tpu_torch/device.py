"""Device selection and float32 precision for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def configure_precision() -> None:
    """Full float32 everywhere: TF32 off for matmuls and cuDNN.

    TF32 keeps about three decimal digits, far outside the port's parity
    tolerances against the JAX package (5e-5 on model outputs). PyTorch's
    matmul default is already "highest", but cuDNN defaults to TF32, so both
    are stated here explicitly.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the GPU. Without a CUDA device the caller must ask for
    ``"cpu"`` explicitly; the port never drops to the CPU on its own."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU (plain PyTorch versions of the kernels)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    configure_precision()
    return dev
