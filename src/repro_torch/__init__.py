"""PlantD's what-if engine on PyTorch and CUDA (NVIDIA Hopper).

A second implementation of the JAX package ``repro`` beside it, module for
module: ``repro_torch.core.whatif.run_grid`` plays (twin x traffic) year
grids through the two hand-written policy-scan kernels of
``repro_torch.kernels`` (``csrc/policy_scan.cu``). Importing this package
imports ``torch`` and numpy only — never ``jax``, never ``repro``.

Entry points take ``device=`` (default ``"cuda"``): without a card they
raise instead of falling back to the CPU; ``device="cpu"`` runs the plain
PyTorch versions of the kernels (``repro_torch.kernels.ref``).
"""
from repro_torch.device import resolve_device  # noqa: F401
