"""Device resolution: CUDA unless the caller names another device."""

from __future__ import annotations

import torch


def require_cuda() -> None:
    """Raise unless PyTorch sees a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "openvm_tpu_torch needs a CUDA device; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")


def resolve_device(device=None) -> torch.device:
    """The device a constructor places its tensors on: CUDA by default."""
    if device is None:
        require_cuda()
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
    return dev
