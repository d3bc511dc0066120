"""The port's training data pipeline (``repro.data``)."""
from repro_torch.data.loader import TokenBatchLoader  # noqa: F401
