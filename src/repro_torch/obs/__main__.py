"""``python -m repro_torch.obs`` — the console run-telemetry report."""
from repro_torch.obs.report import main

if __name__ == "__main__":
    raise SystemExit(main())
