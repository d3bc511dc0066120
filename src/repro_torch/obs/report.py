"""Console run-telemetry report — ``python -m repro_torch.obs``.

Copy of ``repro.obs.report`` for the port. One consolidated table: per
span name — count, total seconds, mean / p50 / p95 / max, records; then
dispatch profiles (first call vs steady state, peak memory); then
counters and gauges.

Usage::

    python -m repro_torch.obs                    # demo run on the card
    python -m repro_torch.obs --device cpu       # the same on the CPU
    python -m repro_torch.obs obs.jsonl          # report a collect file

With no file the module runs a small instrumented workload (an aggregate
grid and a chaos grid through ``simulate_grid``; calibration and search,
the reference demo's other two paths, are not in the port yet) and
reports what it observed.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs.record import Recorder, get_recorder

__all__ = ["render", "summarize", "main"]


def summarize(recorder: Optional[Recorder] = None) -> Dict[str, Dict]:
    """Per-span-name stats over the recorder's current window."""
    rec = recorder or get_recorder()
    by: Dict[str, List] = {}
    for sp in rec.find():
        by.setdefault(sp.name, []).append(sp)
    out = {}
    for name, sps in by.items():
        durs = np.array([s.duration for s in sps])
        out[name] = {
            "count": len(sps),
            "total_s": float(durs.sum()),
            "mean_s": float(durs.mean()),
            "p50_s": float(np.percentile(durs, 50)),
            "p95_s": float(np.percentile(durs, 95)),
            "max_s": float(durs.max()),
            "records": float(sum(s.attrs.get("records", 0.0)
                                 for s in sps)),
        }
    return out


def _fmt_s(v: float) -> str:
    if v >= 1.0:
        return f"{v:8.3f}s"
    if v >= 1e-3:
        return f"{v * 1e3:7.2f}ms"
    return f"{v * 1e6:7.1f}us"


def render(recorder: Optional[Recorder] = None) -> str:
    """The console report: spans, dispatch profiles, counters, gauges."""
    rec = recorder or get_recorder()
    stats = summarize(rec)
    lines = []
    if stats:
        lines.append(f"{'span':<34} {'count':>6} {'total':>9} "
                     f"{'mean':>9} {'p50':>9} {'p95':>9} {'max':>9}")
        lines.append("-" * 92)
        for name in sorted(stats, key=lambda n: -stats[n]["total_s"]):
            s = stats[name]
            lines.append(
                f"{name:<34} {s['count']:>6d} {_fmt_s(s['total_s'])} "
                f"{_fmt_s(s['mean_s'])} {_fmt_s(s['p50_s'])} "
                f"{_fmt_s(s['p95_s'])} {_fmt_s(s['max_s'])}")
    else:
        lines.append("(no spans recorded — is obs enabled?)")
    if rec.profiles:
        lines.append("")
        lines.append(f"{'dispatch':<34} {'compile':>9} {'execute':>9} "
                     f"{'peak temp':>10}")
        lines.append("-" * 66)
        for p in rec.profiles:
            peak = (f"{p.peak_temp_bytes / 2**20:8.1f}MB"
                    if p.peak_temp_bytes is not None else "       n/a")
            lines.append(f"{p.name:<34} {_fmt_s(p.compile_s)} "
                         f"{_fmt_s(p.execute_s)} {peak}")
    with rec._lock:
        counters = list(rec.counters.items())
    if counters:
        cnt = {}
        for (nm, labels), v in counters:
            key = nm if not labels else nm + "{" + ",".join(
                f"{k}={val}" for k, val in labels) + "}"
            cnt[key] = v
        lines.append("")
        lines.append("counters:")
        for k in sorted(cnt):
            lines.append(f"  {k:<50} {cnt[k]:>12g}")
    with rec._lock:
        gauges = dict(rec.gauges)
    if gauges:
        lines.append("")
        lines.append("gauges:")
        for (nm, labels), v in sorted(gauges.items()):
            key = nm if not labels else nm + "{" + ",".join(
                f"{k}={val}" for k, val in labels) + "}"
            lines.append(f"  {key:<50} {v:>12g}")
    return "\n".join(lines)


def _report_file(path: str) -> str:
    """Rebuild a report from a collect JSONL file (span dicts only —
    counters show the latest snapshot)."""
    from repro_torch.obs.export import read_jsonl
    data = read_jsonl(path)
    rec = Recorder()
    for d in data["spans"]:
        attrs = dict(d.get("attributes", {}))
        attrs["records"] = d.get("records", 1.0)
        rec.add_span(d["name"], float(d["start"]), float(d["end"]), attrs)
    if data["counters"]:
        for k, v in data["counters"][-1].get("values", {}).items():
            rec.count(k, v)
    return render(rec)


def _demo(device="cuda") -> str:
    """The instrumented demo workload on ``device``: one aggregate grid
    whose eight rows dedup to four, and one chaos grid."""
    from repro_torch import faults, obs
    from repro_torch.core.simulate import simulate_grid
    from repro_torch.core.slo import SLO
    from repro_torch.core.traffic import TrafficModel
    from repro_torch.core.twin import make_twin

    with obs.capture() as rec:
        traffic = TrafficModel.honda_default("demo", R=3.0, G=1.3)
        hl = traffic.hourly_loads().astype(np.float32)
        twins = [make_twin(f"fifo{i % 4}", "fifo", max_rps=2.0 + 0.2 * (i % 4),
                           usd_per_hour=0.01, base_latency_s=0.2)
                 for i in range(8)]
        slo = SLO(limit_s=2 * 3600, met_fraction=0.95)
        simulate_grid(twins, slo=slo, return_series=False,
                      load_matrix=hl[None], load_index=np.zeros(8, np.int32),
                      device=device)
        sched = faults.FaultSchedule(specs=(faults.outage(),), n_futures=4)
        simulate_grid(twins[:4], np.tile(hl, (4, 1)), slo=slo,
                      return_series=False, faults=sched, device=device)
        return render(rec)


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    if argv:
        print(_report_file(argv[0]))
    else:
        print(_demo(device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
