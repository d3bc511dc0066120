"""Roofline analysis from the dry run's JSON records, for the H100.

Counterpart: ``repro.launch.roofline``, with the same arithmetic; only
the hardware constants change. Per (arch x shape) cell on the single-pod
mesh (256 GPUs, ``(data, model)`` = (16, 16)):

  flops / collective bytes per rank are extrapolated from the probe
  records (``launch.dryrun``):   total = B + (n_groups - 1) * (C - B)
  where B / C are the one- and two-group runs (exact-attention probes
  feed the FLOP and collective terms; chunked probes the diagnostic
  operation bytes).

  compute term    = flops_dev / PEAK_BF16
  memory term     = bytes_dev / HBM_BW     (``analytic_bytes``)
  collective term = coll_bytes_dev / LINK_BW
  bound           = max of the three;  roofline fraction = compute/bound

  MODEL_FLOPS = 6 * N(_active) * D (train; 2 * N * D to serve), global,
  reported per rank for the ratio against the counted flops.

The port's records count flops with ``FlopCounterMode``: products and
attention, no elementwise work (a lower bound of XLA's count), and the
port's memory numbers are an eager step's (see ``launch.dryrun``). These
are analytic and fake-world numbers, not measurements on a card.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.config import SHAPES, get_shape
from repro_torch.configs import all_archs, get_config
from repro_torch.models.model import active_param_count, param_count

# NVIDIA H100 SXM5 (80 GB), from NVIDIA's H100 Tensor Core GPU datasheet:
PEAK_BF16 = 989e12          # bf16 dense tensor-core FLOP/s per GPU
HBM_BW = 3.35e12            # HBM3 bytes/s per GPU
HBM_BYTES = 80e9            # HBM3 capacity per GPU
# The collective term's link. The 16-wide model axis spans two 8-GPU
# NVLink domains (an HGX H100 board holds 8), so its collectives are
# bounded by the inter-node link: one 400 Gb/s NDR InfiniBand port per
# GPU (NVIDIA's DGX H100 layout, one ConnectX-7 port a GPU), 50e9 B/s.
# Inside a domain NVLink 4 gives 450e9 B/s per direction (900e9 is the
# two directions' total, the datasheet's figure); it bounds no
# collective of a 16-wide axis.
LINK_BW = 400e9 / 8         # bytes/s per GPU, one NDR port
NVLINK_BW = 450e9           # bytes/s per GPU per direction (not used)
CHIPS_SINGLE = 256
TP = 16                     # model-axis width on the single-pod mesh
DP = 16                     # data-axis width


def analytic_bytes(arch: str, shape_name: str, memfit: Dict) -> float:
    """Kernel-level HBM traffic model per device per step (bytes).

    The dry run's operation bytes count every eager operation's operands
    and results, tile and attention buffers included, which a fused
    kernel keeps on chip (shared memory and registers). This model counts
    only true HBM traffic: weights, residual/activation streams (per
    pass), logits, KV/recurrent caches and optimizer state. Constants are
    the reference's, deliberately simple; the operation bytes stay in the
    JSON as a diagnostic.
    """
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    mb = memfit.get("microbatches", 1)
    pdt = {"float32": 4, "bfloat16": 2}.get(
        memfit.get("param_dtype", "float32"), 1)
    act_b = 2                                  # bf16 activations
    p_local = param_count(cfg) * pdt / CHIPS_SINGLE
    d = cfg.d_model
    L = cfg.num_layers
    kinds = cfg.layer_types

    if shape.kind == "train":
        tok_l = shape.global_batch * shape.seq_len / DP
        passes = 3 if memfit.get("remat", "none") != "none" else 2
        # weights: read per pass per microbatch; grad accum rw; opt m/v rw +
        # master update (fp32)
        w = p_local * (passes * mb + 1) + p_local / pdt * (2 * 4 + 2 * 8)
        # activations: residual + block internals per layer per pass
        act = 0.0
        for i, kind in enumerate(kinds):
            if kind == "attn":
                per_tok = (12 * d + 3 * (cfg.d_ff / TP)) if not cfg.layer_uses_moe(i) else 12 * d
            elif kind == "mamba":
                di = cfg.ssm.expand * d
                per_tok = 8 * d + 6 * di / TP
            else:                               # rwkv
                per_tok = (14 * d + 3 * (cfg.d_ff / TP))
            if cfg.layer_uses_moe(i):
                m = cfg.moe
                per_tok += m.top_k * m.capacity_factor * (2 * d + 3 * m.d_ff / TP)
                if m.num_shared_experts:
                    per_tok += 3 * m.num_shared_experts * m.d_ff / TP
            act += per_tok * tok_l * act_b
        act *= passes
        logits = tok_l * (cfg.vocab_size / TP) * 4 * 2      # fwd + grad, fp32
        return w + act + logits

    if shape.kind == "prefill":
        tok_l = shape.global_batch * shape.seq_len / DP
        w = p_local
        act = 0.0
        cache = 0.0
        for i, kind in enumerate(kinds):
            if kind == "attn":
                per_tok = 10 * d + 3 * (cfg.d_ff / TP if not cfg.layer_uses_moe(i) else 0)
                a = cfg.attention
                kvh = a.num_kv_heads if a.kind == "gqa" else 1
                kv_dim = (2 * kvh * a.head_dim if a.kind == "gqa"
                          else a.kv_lora_rank + a.qk_rope_head_dim)
                cache += tok_l * kv_dim * act_b
            elif kind == "mamba":
                per_tok = 8 * d + 6 * (cfg.ssm.expand * d) / TP
            else:
                per_tok = 14 * d + 3 * (cfg.d_ff / TP)
            if cfg.layer_uses_moe(i):
                m = cfg.moe
                per_tok += m.top_k * m.capacity_factor * (2 * d + 3 * m.d_ff / TP)
            act += per_tok * tok_l * act_b
        logits = shape.global_batch / DP * (cfg.vocab_size / TP) * 4
        return w + act + cache + logits

    # decode: weights once + full local cache read + small activations
    w = p_local
    a = cfg.attention
    cache = 0.0
    seq_shard = DP * TP if shape.global_batch < 16 else TP
    batch_shard = 1 if shape.global_batch < 16 else DP
    b_l = shape.global_batch / batch_shard
    for i, kind in enumerate(kinds):
        if kind == "attn":
            if a.kind == "mla":
                kv_dim = a.kv_lora_rank + a.qk_rope_head_dim
            else:
                kv_dim = 2 * a.num_kv_heads * a.head_dim
            cache += b_l * (shape.seq_len / seq_shard) * kv_dim * act_b
        elif kind == "mamba":
            cache += b_l * cfg.ssm.expand * d * cfg.ssm.d_state * 4
        elif kind == "rwkv":
            H = d // cfg.rwkv.head_dim
            cache += b_l * H * cfg.rwkv.head_dim ** 2 * 4
    act = b_l * L * 20 * d * act_b
    logits = b_l * (cfg.vocab_size / TP) * 4
    return w + cache * 2 + act + logits        # cache read + update write


def _load(out_dir: str, arch: str, shape: str, mesh: str, mode: str,
          tag: str = "") -> Optional[Dict]:
    t = f".{tag}" if tag else ""
    p = os.path.join(out_dir, f"{arch}__{shape}__{mesh}__{mode}{t}.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def _coll_bytes(rec: Dict) -> float:
    return sum(v["bytes"] for v in rec.get("collectives", {}).values())


def _extrapolate(b: float, c: float, groups: int) -> float:
    return max(b + (groups - 1) * (c - b), 0.0)


@dataclass
class CellRoofline:
    arch: str
    shape: str
    status: str
    flops_dev: float = 0.0
    bytes_dev: float = 0.0          # analytic kernel-level HBM traffic
    hlo_bytes_dev: float = 0.0      # diagnostic: XLA HLO bytes accessed
    coll_bytes_dev: float = 0.0
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bound: str = ""
    bound_s: float = 0.0
    roofline_fraction: float = 0.0   # compute_s / bound_s
    model_flops_dev: float = 0.0
    useful_ratio: float = 0.0        # MODEL_FLOPS / HLO_FLOPS
    mem_gb_dev: float = 0.0          # argument+temp from memfit
    fits_hbm: Optional[bool] = None
    note: str = ""
    skip_reason: str = ""


def analyze_cell(out_dir: str, arch: str, shape_name: str,
                 mesh: str = "single", tag: str = "") -> CellRoofline:
    shape = get_shape(shape_name)
    memfit = _load(out_dir, arch, shape_name, mesh, "memfit", tag)
    if memfit is None:
        return CellRoofline(arch, shape_name, "missing")
    if memfit.get("status") == "skipped":
        return CellRoofline(arch, shape_name, "skipped",
                            skip_reason=memfit.get("skip_reason", ""))
    recs = {m: _load(out_dir, arch, shape_name, mesh, m, tag)
            for m in ("probe1_exact", "probe2_exact",
                      "probe1_chunked", "probe2_chunked")}
    if any(r is None or r.get("status") != "ok" for r in recs.values()):
        bad = [m for m, r in recs.items()
               if r is None or r.get("status") != "ok"]
        return CellRoofline(arch, shape_name, f"probe-missing:{bad}")
    groups = memfit.get("n_groups_full") or recs["probe1_exact"]["n_groups_full"]

    flops = _extrapolate(recs["probe1_exact"]["cost"]["flops"],
                         recs["probe2_exact"]["cost"]["flops"], groups)
    bytes_ = _extrapolate(recs["probe1_chunked"]["cost"]["bytes"],
                          recs["probe2_chunked"]["cost"]["bytes"], groups)
    coll = _extrapolate(_coll_bytes(recs["probe1_exact"]),
                        _coll_bytes(recs["probe2_exact"]), groups)

    # probes run at microbatches=1; production train steps use gradient
    # accumulation (memfit's count) which re-gathers the FSDP weight shards
    # once per extra microbatch (fwd+bwd).
    mb = memfit.get("microbatches", 1)
    if mb > 1 and memfit.get("fsdp"):
        cfgx = get_config(arch)
        pbytes = param_count(cfgx) * 4 / CHIPS_SINGLE     # fp32 train master
        coll += (mb - 1) * 2 * pbytes
    hlo_bytes = bytes_
    bytes_ = analytic_bytes(arch, shape_name, memfit)

    cell = CellRoofline(arch, shape_name,
                        memfit.get("status", "ok"))
    cell.flops_dev, cell.bytes_dev, cell.coll_bytes_dev = flops, bytes_, coll
    cell.hlo_bytes_dev = hlo_bytes
    cell.compute_s = flops / PEAK_BF16
    cell.memory_s = bytes_ / HBM_BW
    cell.collective_s = coll / LINK_BW
    terms = {"compute": cell.compute_s, "memory": cell.memory_s,
             "collective": cell.collective_s}
    cell.bound = max(terms, key=terms.get)
    cell.bound_s = terms[cell.bound]
    cell.roofline_fraction = (cell.compute_s / cell.bound_s
                              if cell.bound_s > 0 else 0.0)

    cfg = get_config(arch)
    n = active_param_count(cfg) if cfg.moe is not None else param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 6.0 * n * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 2.0 * n * tokens
    else:                      # decode: one token per sequence
        tokens = shape.global_batch
        model_flops = 2.0 * n * tokens
    cell.model_flops_dev = model_flops / CHIPS_SINGLE
    cell.useful_ratio = (cell.model_flops_dev / flops) if flops > 0 else 0.0

    mem = memfit.get("memory", {})
    arg = mem.get("argument_size_in_bytes", 0)
    tmp = mem.get("temp_size_in_bytes", 0)
    cell.mem_gb_dev = (arg + tmp) / 1e9
    if arg + tmp > 0:
        cell.fits_hbm = (arg + tmp) <= HBM_BYTES
    cell.note = _advice(cell)
    return cell


def _advice(c: CellRoofline) -> str:
    if c.bound == "compute":
        return ("compute-bound: raise MFU via kernel fusion/larger per-GPU "
                "batch; already at the right roofline corner")
    if c.bound == "memory":
        return ("memory-bound: cut HBM traffic (fuse elementwise chains, "
                "bf16/int8 states, larger arithmetic intensity per pass)")
    return ("collective-bound: reshard to cut all-gather/all-reduce volume "
            "(FSDP prefetch, TP only where heads divide, int8 grad "
            "compression, overlap with compute)")


def analyze_all(out_dir: str, mesh: str = "single", tag: str = ""
                ) -> List[CellRoofline]:
    cells = []
    for arch in all_archs():
        for shape in SHAPES:
            cells.append(analyze_cell(out_dir, arch, shape.name, mesh, tag))
    return cells


def rows(cells: List[CellRoofline]) -> List[Dict]:
    out = []
    for c in cells:
        if c.status in ("skipped",):
            out.append({"arch": c.arch, "shape": c.shape, "status": "skipped",
                        "bound": "-", "compute_ms": "-", "memory_ms": "-",
                        "collective_ms": "-", "roofline_frac": "-",
                        "useful_ratio": "-", "mem_gb": "-", "fits": "-"})
            continue
        out.append({
            "arch": c.arch, "shape": c.shape, "status": c.status,
            "bound": c.bound,
            "compute_ms": round(c.compute_s * 1e3, 3),
            "memory_ms": round(c.memory_s * 1e3, 3),
            "collective_ms": round(c.collective_s * 1e3, 3),
            "roofline_frac": round(c.roofline_fraction, 3),
            "useful_ratio": round(c.useful_ratio, 3),
            "mem_gb": round(c.mem_gb_dev, 2),
            "fits": c.fits_hbm,
        })
    return out


def main(argv=None):
    import argparse
    from repro_torch.core.report import render_table, write_csv
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--tag", default="")
    ap.add_argument("--csv", default="experiments/roofline_torch.csv")
    args = ap.parse_args(argv)
    cells = analyze_all(args.out, args.mesh, args.tag)
    r = rows(cells)
    print(f"H100 SXM constants (NVIDIA's datasheet): "
          f"{PEAK_BF16 / 1e12:g} TFLOP/s bf16 dense, {HBM_BW / 1e12:g} TB/s "
          f"HBM3, {HBM_BYTES / 1e9:g} GB; collectives at "
          f"{LINK_BW / 1e9:g} GB/s a GPU (one 400 Gb/s NDR port; NVLink's "
          f"{NVLINK_BW / 1e9:g} GB/s a direction stays inside an 8-GPU "
          f"node)")
    print(render_table(r, f"Roofline ({args.mesh} pod, 256 GPUs; analytic "
                          f"and fake-world numbers)"))
    write_csv(r, args.csv)
    print(f"wrote {args.csv}")


if __name__ == "__main__":
    main()
