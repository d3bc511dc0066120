"""Observed pipeline traces — the measurement side of twin calibration.

Copy of ``repro.calibrate.trace`` for the port. An ``ObservedTrace`` is
what ``repro_torch.calibrate.fit`` matches a simulated twin against:
per-bin arrivals, processed records, end-to-end latency, dropped records
and cost over a uniform time grid of ``bin_hours``-wide bins. Built:

* ``ObservedTrace.from_experiment`` — from a wind-tunnel
  ``ExperimentResult`` of ``repro_torch.core.experiment``: arrivals from
  the ``records_sent`` counter the experiment records in virtual time,
  completions from the final stage's spans, and per-record latency from
  FIFO-matching the cumulative arrival and completion curves (queueing
  delay included);
* ``ObservedTrace.from_loadpattern`` / ``from_simulation`` — replay a
  ``LoadPattern`` (or an arrivals array) through a ground-truth twin with
  ``core.simulate.scan_trace``, on the card by default (``device=``);
* ``ObservedTrace.from_otel_spans`` — from exported OpenTelemetry-style
  span dicts (``repro_torch.obs.to_otel_spans`` writes them);
* ``ObservedTrace.from_prometheus`` — from Prometheus range-query result
  matrices.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.loadpattern import LoadPattern
from repro_torch.device import resolve_device

#: the series a calibration loss may match, in canonical order
SERIES_KEYS = ("processed", "latency", "dropped", "cost")


def bin_loadpattern(pattern: LoadPattern, bin_s: float = 60.0) -> np.ndarray:
    """Integrate a piecewise-linear LoadPattern into records-per-bin counts."""
    total = pattern.total_duration
    nbins = max(1, int(math.ceil(total / bin_s)))
    edges = np.minimum(np.arange(nbins + 1) * bin_s, total)
    return np.array([pattern.records_between(float(t0), float(t1))
                     for t0, t1 in zip(edges[:-1], edges[1:])], np.float64)


@dataclass(frozen=True)
class ObservedTrace:
    """Per-bin series measured (or synthesized) from a pipeline run."""
    name: str
    bin_hours: float
    arrivals: np.ndarray       # records arriving per bin [T]
    processed: np.ndarray      # records completed per bin [T]
    latency_s: np.ndarray      # mean end-to-end latency of the bin [T]
    dropped: np.ndarray        # records shed per bin [T]
    cost_usd: np.ndarray       # cost accrued per bin [T]

    def __post_init__(self):
        T = len(self.arrivals)
        for key in ("processed", "latency_s", "dropped", "cost_usd"):
            arr = getattr(self, key)
            if arr.shape != (T,):
                raise ValueError(f"{key} has shape {arr.shape}, want ({T},)")

    @property
    def num_bins(self) -> int:
        return len(self.arrivals)

    @property
    def duration_hours(self) -> float:
        return self.num_bins * self.bin_hours

    def series(self) -> Dict[str, np.ndarray]:
        """The fit targets keyed by SERIES_KEYS."""
        return {"processed": self.processed, "latency": self.latency_s,
                "dropped": self.dropped, "cost": self.cost_usd}

    def scales(self) -> Dict[str, float]:
        """Per-series normalization so the loss mixes unlike units: the
        mean magnitude of the observed series, falling back to the arrival
        scale (dropped) or 1.0 when a series is identically zero."""
        arr_scale = float(np.mean(np.abs(self.arrivals))) or 1.0
        out = {}
        for key, vals in self.series().items():
            s = float(np.mean(np.abs(vals)))
            if s <= 0.0:
                s = arr_scale if key == "dropped" else 1.0
            out[key] = s
        return out

    def with_noise(self, frac: float, seed: int = 0) -> "ObservedTrace":
        """Element-wise multiplicative Gaussian measurement noise on every
        series (drop noise scales with arrivals so zero-drop bins still
        jitter) — for fit-robustness tests."""
        rng = np.random.default_rng(seed)

        def jitter(x, rel_to=None):
            scale = np.abs(x) if rel_to is None else np.mean(np.abs(rel_to))
            return np.maximum(x + rng.normal(0.0, frac, x.shape) * scale, 0.0)

        return replace(self,
                       name=f"{self.name}+noise{frac:g}",
                       processed=jitter(self.processed),
                       latency_s=jitter(self.latency_s),
                       dropped=jitter(self.dropped, rel_to=self.arrivals),
                       cost_usd=jitter(self.cost_usd))

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_simulation(cls, twin, arrivals: np.ndarray, bin_hours: float,
                        name: Optional[str] = None,
                        device="cuda") -> "ObservedTrace":
        """Ground-truth replay: run ``twin`` over ``arrivals`` (records per
        bin) through ``core.simulate.scan_trace`` on ``device`` (the
        series kernel on the card, the plain scan on the CPU) and package
        the outputs."""
        from repro_torch.core.simulate import scan_trace

        dev = resolve_device(device)
        load = torch.from_numpy(np.asarray(arrivals, np.float32)).to(dev)
        params = torch.from_numpy(twin.padded_params()).to(dev)
        _, outs = scan_trace(load, params, twin.policy_index,
                             float(bin_hours))
        proc, _queue, lat, cost, drop = (
            np.asarray(o.cpu().numpy(), np.float64) for o in outs)
        return cls(name=name or f"{twin.name}-replay",
                   bin_hours=float(bin_hours),
                   arrivals=np.asarray(arrivals, np.float64),
                   processed=proc, latency_s=lat, dropped=drop,
                   cost_usd=cost)

    @classmethod
    def from_loadpattern(cls, pattern: LoadPattern, twin,
                         bin_s: float = 60.0, name: Optional[str] = None,
                         device="cuda") -> "ObservedTrace":
        """Replay a LoadPattern through a ground-truth twin at sub-hour
        resolution (the paper's ramp/steady patterns become fit traces)."""
        arrivals = bin_loadpattern(pattern, bin_s)
        return cls.from_simulation(twin, arrivals, bin_s / 3600.0,
                                   name=name or f"{pattern.name}-replay",
                                   device=device)

    @classmethod
    def from_otel_spans(cls, spans, bin_seconds: float = 60.0,
                        name: str = "otel",
                        usd_per_hour: float = 0.0) -> "ObservedTrace":
        """Bin exported OpenTelemetry-style spans into a calibration trace.

        ``spans`` is a plain list of dicts — no OTel SDK dependency, just
        the shape an OTLP/JSON export (or a hand-rolled span log) already
        has. Recognized keys per span:

        * ``start`` / ``end`` — unix seconds, or the OTLP field names
          ``start_time_unix_nano`` / ``end_time_unix_nano`` (nanoseconds);
        * ``status`` — optional; ``"ERROR"`` (or OTLP status code 2)
          counts the span's records as dropped instead of processed;
        * ``records`` — optional batch size, default 1 record per span.

        Arrivals bin by span start, completions (and their end-to-end
        latency, record-weighted per bin) by span end; error spans feed
        the dropped series at their end bin. The cost series is flat at
        ``usd_per_hour`` (pass the deployment's known rate, or leave 0 and
        down-weight cost in the fit). Times are rebased to the earliest
        span start, so any epoch works.
        """
        if not spans:
            raise ValueError("from_otel_spans needs at least one span")

        def _time(sp, key):
            if key in sp:
                return float(sp[key])
            nano = sp.get(f"{key}_time_unix_nano")
            if nano is None:
                raise KeyError(f"span missing {key!r} / "
                               f"'{key}_time_unix_nano': {sp!r}")
            return float(nano) * 1e-9

        def _is_error(sp):
            status = sp.get("status", "OK")
            if isinstance(status, dict):      # OTLP: {"code": 2} — or the
                status = status.get("code", 0)   # protobuf-JSON enum NAME
            if isinstance(status, (int, float)):
                return int(status) == 2
            # "ERROR" / "STATUS_CODE_ERROR" / "2" string forms
            return str(status).upper() in ("ERROR", "STATUS_CODE_ERROR",
                                           "2")

        starts = np.array([_time(sp, "start") for sp in spans])
        ends = np.array([_time(sp, "end") for sp in spans])
        if (ends < starts).any():
            raise ValueError("span end precedes its start")
        recs = np.array([float(sp.get("records", 1.0)) for sp in spans])
        errors = np.array([_is_error(sp) for sp in spans])

        t0 = starts.min()
        dur = max(float(ends.max() - t0), bin_seconds)
        nbins = max(1, int(math.ceil(dur / bin_seconds)))

        def _binned(times, weights):
            out = np.zeros(nbins)
            which = np.clip((times - t0) / bin_seconds, 0,
                            nbins - 1).astype(int)
            np.add.at(out, which, weights)
            return out

        arrivals = _binned(starts, recs)
        ok = ~errors
        processed = _binned(ends[ok], recs[ok])
        dropped = _binned(ends[errors], recs[errors])
        # record-weighted mean end-to-end latency of the bin a span ends in
        lat_w = _binned(ends[ok], (recs * (ends - starts))[ok])
        latency = np.zeros(nbins)
        seen = processed > 0
        latency[seen] = lat_w[seen] / processed[seen]
        if seen.any():
            latency[~seen] = float(lat_w.sum() / processed.sum())

        bin_hours = bin_seconds / 3600.0
        return cls(name=name, bin_hours=bin_hours, arrivals=arrivals,
                   processed=processed, latency_s=latency, dropped=dropped,
                   cost_usd=np.full(nbins, usd_per_hour * bin_hours))

    @classmethod
    def from_prometheus(cls, responses: Dict, bin_seconds: float = 60.0,
                        name: str = "prometheus",
                        usd_per_hour: float = 0.0) -> "ObservedTrace":
        """Bin Prometheus range-query responses into a calibration trace.

        ``responses`` maps series keys to parsed range-query JSON
        (``/api/v1/query_range``) — either the full ``{"status", "data"}``
        envelope, the ``data`` object (``{"resultType": "matrix",
        "result": [...]}``), or the bare ``result`` list. Keys:

        * ``"arrivals"`` (required) and ``"processed"`` (required) —
          rates in records/second (the usual ``rate(counter[...])``
          query); per-bin records = rate at the bin center x bin width;
        * ``"dropped"`` — optional records/second rate (default zeros);
        * ``"latency"`` — optional gauge in seconds (e.g. a summary/
          histogram mean), default zeros;
        * ``"cost"`` — optional rate in USD/hour; omitted, the cost
          series is flat at ``usd_per_hour``.

        Sample values may be strings (Prometheus returns them quoted).
        Each response may hold several result entries (one per label
        set, e.g. per instance): rate-like series are SUMMED across
        entries, the latency gauge is averaged. Samples are linearly
        interpolated onto the common bin-center grid (clamped at the
        ends), so differing query steps and ranges line up; times are
        rebased to the earliest sample.
        """
        rate_keys = ("arrivals", "processed", "dropped", "cost")
        known = set(rate_keys) | {"latency"}
        unknown = set(responses) - known
        if unknown:
            raise ValueError(f"unknown series keys {sorted(unknown)}; "
                             f"expected a subset of {sorted(known)}")
        for req in ("arrivals", "processed"):
            if req not in responses:
                raise ValueError(f"from_prometheus needs an {req!r} "
                                 f"range-query response")

        def _entries(resp, key):
            if isinstance(resp, dict) and "status" in resp:
                # real Prometheus error envelopes carry NO 'data' key,
                # so check the status before unwrapping anything
                if resp.get("status") != "success":
                    raise ValueError(
                        f"{key}: Prometheus query failed: "
                        f"{resp.get('error', resp.get('status'))!r}")
                resp = resp.get("data", {})
            elif isinstance(resp, dict) and "data" in resp:
                resp = resp["data"]
            if isinstance(resp, dict) and "result" in resp:
                rtype = resp.get("resultType", "matrix")
                if rtype != "matrix":
                    raise ValueError(
                        f"{key}: need a range-query matrix result, got "
                        f"resultType {rtype!r} (instant queries have no "
                        f"time axis to bin)")
                resp = resp["result"]
            if not isinstance(resp, (list, tuple)):
                raise ValueError(f"{key}: unrecognized response shape "
                                 f"{type(resp).__name__}")
            series = []
            for entry in resp:
                values = entry.get("values") if isinstance(entry, dict) \
                    else None
                if not values:
                    continue
                ts = np.array([float(t) for t, _ in values])
                vs = np.array([float(v) for _, v in values])
                order = np.argsort(ts, kind="stable")
                series.append((ts[order], vs[order]))
            return series

        parsed = {k: _entries(r, k) for k, r in responses.items()}
        for key, series in parsed.items():
            # a PROVIDED series with zero samples would silently bin to
            # zeros (and, for cost, shadow the usd_per_hour fallback) —
            # fitting a twin to a pipeline that apparently did nothing
            if not series:
                raise ValueError(f"{key} response holds no samples")
        all_ts = np.concatenate([ts for ser in parsed.values()
                                 for ts, _ in ser])
        t0, t1 = float(all_ts.min()), float(all_ts.max())
        nbins = max(1, int(math.ceil((t1 - t0) / bin_seconds)))
        centers = t0 + (np.arange(nbins) + 0.5) * bin_seconds

        def _sampled(key, combine_mean=False):
            series = parsed.get(key) or []
            if not series:
                return np.zeros(nbins)
            interped = [np.interp(centers, ts, vs) for ts, vs in series]
            out = np.sum(interped, axis=0)
            return out / len(interped) if combine_mean else out

        bin_hours = bin_seconds / 3600.0
        cost = (_sampled("cost") * bin_hours if "cost" in parsed
                else np.full(nbins, usd_per_hour * bin_hours))
        return cls(name=name, bin_hours=bin_hours,
                   arrivals=_sampled("arrivals") * bin_seconds,
                   processed=_sampled("processed") * bin_seconds,
                   latency_s=_sampled("latency", combine_mean=True),
                   dropped=_sampled("dropped") * bin_seconds,
                   cost_usd=cost)

    @classmethod
    def from_experiment(cls, result, bin_s: float = 1.0,
                        stage: Optional[str] = None) -> "ObservedTrace":
        """Bin a measured ``ExperimentResult`` into a calibration trace.

        Times are virtual (undilated) seconds from experiment start, so
        ``time_scale``-accelerated test runs calibrate the same as real
        ones. ``stage`` selects which stage's completions count as
        "processed" (default: the last stage observed).
        """
        ts = getattr(result, "time_scale", 1.0)
        dur = max(result.duration_s, bin_s)
        nbins = max(1, int(math.ceil(dur / bin_s)))
        edges = np.arange(nbins + 1) * bin_s

        # arrivals: the cumulative records_sent counter, virtual-time stamped
        sent = result.metrics.series("records_sent")
        if sent:
            t = np.array([s.t for s in sent])
            v = np.array([s.value for s in sent])
            cum_arr = np.interp(edges, t, v, left=0.0, right=v[-1])
        else:   # pre-calibration results: spread the total uniformly
            cum_arr = np.linspace(0.0, result.records_sent, nbins + 1)
        arrivals = np.diff(cum_arr)

        # completions: spans of the final stage, converted to virtual time
        stage = stage or (list(result.stage_summary)[-1]
                          if result.stage_summary else None)
        spans = sorted(result.collector.spans(stage),
                       key=lambda s: s.end) if stage else []
        ends = np.array([(s.end - result.started) * ts for s in spans])
        recs = np.array([float(s.records) for s in spans])
        processed = np.zeros(nbins)
        latency = np.zeros(nbins)
        if len(spans):
            which = np.clip(np.searchsorted(edges, ends, side="right") - 1,
                            0, nbins - 1)
            np.add.at(processed, which, recs)
            # FIFO matching: the k-th completed record arrived at the time
            # the cumulative arrival curve crossed k, so its latency is the
            # span end minus that crossing — queueing delay included
            done_before = np.concatenate([[0.0], np.cumsum(recs)[:-1]])
            mid = done_before + 0.5 * recs
            t_arrive = np.interp(mid, cum_arr, edges)
            lat_span = np.maximum(ends - t_arrive, 0.0)
            wsum = np.zeros(nbins)
            np.add.at(wsum, which, recs)
            np.add.at(latency, which, recs * lat_span)
            seen = wsum > 0
            latency[seen] /= wsum[seen]
            if seen.any():
                latency[~seen] = float(
                    (latency[seen] * wsum[seen]).sum() / wsum[seen].sum())

        bin_hours = bin_s / 3600.0
        usd_hr = float(result.cost.get("usd_per_hour", 0.0))
        return cls(name=f"{result.name}-trace", bin_hours=bin_hours,
                   arrivals=arrivals, processed=processed,
                   latency_s=latency, dropped=np.zeros(nbins),
                   cost_usd=np.full(nbins, usd_hr * bin_hours))
