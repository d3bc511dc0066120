"""Cost capture + modeling (the paper's OpenCost / billing-log analogue).

Copy of ``repro.core.cost`` for the port. The accelerator's price per
chip-hour has no default here: the what-if path never reads it, and a
price is the caller's to state (``CostModel(chip_usd_per_hour=...)``).
Generic vCPU $0.0425/hr and RAM $0.0057/GB-hr are public on-demand list
prices. Network and storage rates default to the paper's business-analysis
assumptions: 0.02 cents/MB network, 1 cent/GB/day storage, 3-month
retention.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

VCPU_USD_PER_HOUR = 0.0425
RAM_USD_PER_GB_HOUR = 0.0057


@dataclass(frozen=True)
class CostModel:
    """Business cost assumptions (paper Sec. VI-B defaults)."""
    network_usd_per_mb: float = 0.0002          # 0.02 cents / MB
    storage_usd_per_gb_day: float = 0.01        # 1 cent / GB / day
    retention_days: int = 91                    # 3 months
    chip_usd_per_hour: Optional[float] = None   # no default accelerator
    vcpu_usd_per_hour: float = VCPU_USD_PER_HOUR
    ram_usd_per_gb_hour: float = RAM_USD_PER_GB_HOUR

    def pipeline_usd_per_hour(self, resources) -> float:
        chips = resources.chips
        if chips and self.chip_usd_per_hour is None:
            raise ValueError("resources hold accelerator chips but the "
                             "CostModel has no chip_usd_per_hour")
        return ((chips * self.chip_usd_per_hour if chips else 0.0)
                + resources.vcpus * self.vcpu_usd_per_hour
                + resources.ram_gb * self.ram_usd_per_gb_hour)

    def experiment_cost(self, resources, duration_s: float,
                        ingest_mb: float = 0.0) -> Dict[str, float]:
        """Prorated cost of one experiment window (the paper prorates the
        provider's hourly billing granularity over the run length)."""
        hourly = self.pipeline_usd_per_hour(resources)
        compute = hourly * duration_s / 3600.0
        network = ingest_mb * self.network_usd_per_mb
        return {"compute_usd": compute, "network_usd": network,
                "total_usd": compute + network, "usd_per_hour": hourly}
