"""Device resolution for the port's entry points.

Every entry point runs on the card unless its caller asks for the CPU by
name. With no card and no such request it raises: it never falls back.

Float32 numerics: a float32 matmul on the card runs in full float32 by
default, but a float32 convolution goes through cuDNN in TF32, which keeps
about three decimal digits and would put ~1e-3 relative error into the
resample and mel convolutions. Both switches are set off here, on every
resolution, so a caller that builds tensors on the card through this module
gets full float32.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None or "cuda[:n]" -> that CUDA device (raises without one);
    "cpu" -> the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
