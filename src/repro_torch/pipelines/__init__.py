from repro_torch.pipelines.telemetry import (  # noqa: F401
    make_telemetry_dataset,
    make_telemetry_pipeline,
    TELEMETRY_VARIANTS,
)
