"""Serving: prefill/decode steps and the batched engine (the inference
pipeline-under-test)."""
from repro_torch.serve.steps import make_decode_step, make_prefill_step  # noqa: F401
