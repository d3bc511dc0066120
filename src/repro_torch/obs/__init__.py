"""``repro_torch.obs`` — run-telemetry for the wind tunnel itself.

Counterpart: ``repro.obs``, with the same names. PlantD's pitch is
instrumenting pipelines; this package instruments the *tool*: spans at
every dispatch boundary, counters for the runtime decisions (dedup hit
rates, blocks, fault-grid sizes, serving groups), per-dispatch first-call
vs steady-state profiling with peak device memory, and exporters (OTel
span dicts, Prometheus text exposition, a rolling JSONL collect file).

Off by default: export ``REPRO_OBS=1``, or::

    from repro_torch import obs
    with obs.capture() as rec:
        simulate_grid(..., return_series=False)
    print(obs.render(rec))                       # console report
    spans = obs.to_otel_spans(rec)               # OTel-style span dicts
    text = obs.prometheus_exposition(rows)       # scrape-able exposition
    obs.append_jsonl("obs.jsonl", retention_s=600)   # rolling collect

Disabled overhead is one module-attribute check per call site — the
instrumentation never sits between the launches of one call, so the
simulated numbers are bit-identical either way. See ``record``
(spans/counters/ring buffer), ``profile`` (first-call vs steady-state
dispatch profiling on the card), ``export`` (OTel / Prometheus / JSONL)
and ``report`` (the console summary, ``python -m repro_torch.obs``).
"""
from repro_torch.obs.export import (append_jsonl, prometheus_exposition,
                                    read_jsonl, to_otel_spans)
from repro_torch.obs.profile import (DispatchProfile, jit_cache_grew,
                                     jit_cache_size, profile_dispatch)
from repro_torch.obs.record import (ObsSpan, Recorder, capture, count,
                                    counters, disable, enable, enabled,
                                    event, gauge, get_recorder, instrument,
                                    set_recorder, span, timed)
from repro_torch.obs.report import render, summarize

__all__ = [
    "DispatchProfile", "ObsSpan", "Recorder", "append_jsonl", "capture",
    "count", "counters", "disable", "enable", "enabled", "event",
    "gauge", "get_recorder", "instrument", "jit_cache_grew",
    "jit_cache_size", "profile_dispatch", "prometheus_exposition",
    "read_jsonl", "render", "set_recorder", "span", "summarize", "timed",
    "to_otel_spans",
]
