"""Where the port runs: ``device=`` resolution for every entry point."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``"cuda"`` (the default everywhere) or ``"cpu"``, as a torch.device.

    A CUDA request without a visible card raises: the port never carries
    on quietly on the CPU. ``"cpu"`` runs the plain PyTorch versions of
    the kernels and must be asked for explicitly."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but no CUDA device is visible; pass "
                "device='cpu' to run the plain PyTorch versions")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
