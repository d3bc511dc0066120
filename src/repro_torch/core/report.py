"""Result rendering (PlantD-Studio's tables, as text/CSV).

Copy of ``repro.core.report`` for the port."""
from __future__ import annotations

import csv
import io
from typing import Dict, List, Sequence


def render_table(rows: Sequence[Dict], title: str = "") -> str:
    if not rows:
        return f"{title}\n(no rows)\n"
    cols = list(rows[0].keys())
    widths = {c: max(len(str(c)), *(len(_fmt(r.get(c))) for r in rows))
              for c in cols}
    out = io.StringIO()
    if title:
        out.write(title + "\n")
    out.write(" | ".join(str(c).ljust(widths[c]) for c in cols) + "\n")
    out.write("-+-".join("-" * widths[c] for c in cols) + "\n")
    for r in rows:
        out.write(" | ".join(_fmt(r.get(c)).ljust(widths[c]) for c in cols) + "\n")
    return out.getvalue()


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        if v == 0:
            return "0"
        if abs(v) >= 1e6 or abs(v) < 1e-3:
            return f"{v:.3e}"
        return f"{v:,.2f}"
    return str(v)


def write_csv(rows: Sequence[Dict], path: str):
    if not rows:
        return
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        for r in rows:
            w.writerow(r)


def bench_csv_line(name: str, us_per_call: float, derived: str = "") -> str:
    """Benchmark harness line format: ``name,us_per_call,derived``."""
    return f"{name},{us_per_call:.2f},{derived}"
