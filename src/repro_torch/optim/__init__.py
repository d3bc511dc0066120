"""The port's optimizer: AdamW over dicts of tensors (``repro.optim``'s
float32 form; see ``optim.adamw``)."""
from repro_torch.optim.adamw import (  # noqa: F401
    OptState, adamw_update, init_opt_state, lr_at,
)
