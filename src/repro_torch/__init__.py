"""PlantD on PyTorch and CUDA (NVIDIA Hopper): the port of the JAX package.

A second implementation of the JAX package ``repro`` beside it, module for
module, slice by slice. So far:

* the what-if engine: ``repro_torch.core.whatif.run_grid`` plays (twin x
  traffic) year grids, with or without a fault schedule
  (``repro_torch.faults``), through the hand-written policy-scan kernels
  (``kernels/csrc/policy_scan.cu``);
* the serving pipeline-under-test: ``repro_torch.serve.engine.ServeEngine``
  serves attention + Mamba models (Jamba-1.5 without experts) through
  ``repro_torch.models`` and the hand-written flash-attention and
  selective-scan kernels (``kernels/csrc/flash_attention.cu``,
  ``kernels/csrc/ssm_scan.cu``), and RWKV-6 models (rwkv6-7b) through
  the WKV kernels (``kernels/csrc/rwkv6.cu``);
* the wind tunnel: ``repro_torch.core.experiment.Experiment`` drives a
  ``LoadPattern`` of synthetic ``DataSet`` records through a pipeline
  (the paper's telemetry pipeline, ``repro_torch.pipelines``, or a
  serving engine's ``as_pipeline()``), and ``core.twin.fit_twin`` fits a
  twin from the result for the what-if engine;
* run telemetry, ``repro_torch.obs`` (off unless ``REPRO_OBS=1`` or
  ``obs.capture()``).

Importing this package imports ``torch`` and numpy only — never ``jax``,
never ``repro``. Entry points take ``device=`` (default ``"cuda"``):
without a card they raise instead of falling back to the CPU;
``device="cpu"`` runs the plain PyTorch versions of the kernels
(``repro_torch.kernels.ref``).
"""
from repro_torch.device import resolve_device  # noqa: F401
