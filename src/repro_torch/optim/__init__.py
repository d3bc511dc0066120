"""The port's optimizer: AdamW over dicts of tensors with float32,
bfloat16 or int8 moments (``optim.adamw``), and the block-wise int8
quantization of ``optim.compression``."""
from repro_torch.optim.adamw import (  # noqa: F401
    OptState, adamw_update, init_opt_state, lr_at,
)
from repro_torch.optim.compression import (  # noqa: F401
    dequantize_int8, quantize_int8,
)
