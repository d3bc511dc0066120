from repro_torch.models.model import (  # noqa: F401
    active_param_count,
    compute_params,
    decode_step,
    init_cache,
    init_params,
    param_count,
    prefill,
)
