"""Worker processes of the port's mesh tests (gloo on the CPU).

``spawn(fn, world, tmp_path, *args)`` starts ``world`` processes with
``torch.multiprocessing`` (spawn), joins them into one ``gloo`` group
through a ``file://`` rendezvous under ``tmp_path`` (so parallel test
workers never share a port), runs ``fn(rank, world, *args)`` in each
on one intra-op thread, and returns each rank's pickled result dict.
The workers import ``torch``, ``numpy`` and ``repro_torch`` only: the
tests compute the reference's answers in their own process. The
problems are built here, from seeds, so the test process rebuilds the
same inputs.
"""
import contextlib
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: a month of hourly bins keeps the parity grids fast (the engine
#: treats the horizon as opaque)
T_MONTH = 744


def _entry(rank, fn, world, init, out_dir, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=world)
    try:
        got = fn(rank, world, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(got, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn, world, tmp_path, *args):
    """Run ``fn(rank, world, *args)`` on ``world`` gloo ranks; returns
    the list of the dicts each rank returned."""
    out = tmp_path / f"world{world}_{fn.__name__}"
    out.mkdir(parents=True, exist_ok=True)
    mp.start_processes(_entry, args=(fn, world, str(out / "init"),
                                      str(out), args),
                       nprocs=world, start_method="spawn", join=True)
    got = []
    for r in range(world):
        with open(out / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return got


# ---------------------------------------------------------------------------
# the scenario mesh
# ---------------------------------------------------------------------------

def policy_twins(tw):
    """One twin of every built-in policy (``tests/test_grid_shard.py``'s
    ``ALL_POLICY_TWINS``)."""
    return [tw.SimpleTwin("fifo", 1.9512, 0.0082, 0.15),
            tw.QuickscalingTwin("quick", 1.9512, 0.0082, 0.15),
            tw.make_twin("auto", "autoscale", max_rps=0.5,
                         usd_per_hour=0.002, base_latency_s=0.1,
                         max_instances=32, scale_up_hours=3),
            tw.make_twin("shed", "shed", max_rps=1.0, usd_per_hour=0.0082,
                         base_latency_s=0.15, queue_cap_hours=2),
            tw.make_twin("batch", "batch_window", max_rps=6.15,
                         usd_per_hour=0.0703, base_latency_s=0.06,
                         window_hours=6)]


def traffics(tr):
    return [tr.TrafficModel.honda_default("nom"),
            tr.TrafficModel.honda_default("high", G=1.5)]


def grid_arrays(tw, tr, n, t_bins=T_MONTH):
    """(twins, matrix, index, params, policy index) of an n-row grid
    cycling through every policy over two traffic rows."""
    pt = policy_twins(tw)
    twins = [pt[i % len(pt)] for i in range(n)]
    matrix = np.stack([t.hourly_loads()[:t_bins] for t in traffics(tr)]) \
        .astype(np.float32)
    index = np.arange(n, dtype=np.int32) % 2
    params = np.stack([t.padded_params() for t in twins])
    idx = np.asarray([t.policy_index for t in twins], np.int32)
    return twins, matrix, index, params, idx


def chaos_schedule(f):
    """``tests/test_faults.py``'s chaos schedule."""
    return f.FaultSchedule(
        specs=(f.outage(rate_per_year=200, duration_hours=(2, 6)),
               f.disconnect(rate_per_year=150),
               f.brownout(rate_per_year=150)),
        n_futures=3, seed=7)


#: (name, n, scenario_block, devices as a share of the world: "all" or
#: 2) of the dispatch cases: n = 23 is divisible by neither the block
#: nor 4 (per-policy pads and an all-pad block both run); n = 11 in
#: blocks of 4 is three policy blocks over two ranks; no block is the
#: reference's auto block (one per policy)
DISPATCH_CASES = (("n23_block5", 23, 5, "all"), ("n11_block4_d2", 11, 4, 2),
                  ("n10_auto", 10, None, "all"))
SLO_LIMIT = 4 * 3600.0


def grid_worker(rank, world):
    from repro_torch import faults as pf
    from repro_torch import obs
    from repro_torch.core import simulate as psim
    from repro_torch.core import slo as pslo
    from repro_torch.core import traffic as ptr
    from repro_torch.core import twin as ptw
    from repro_torch.core import whatif as pwhatif
    cpu = torch.device("cpu")
    out = {}
    for name, n, block, d in DISPATCH_CASES:
        d = world if d == "all" else d
        _, matrix, index, params, idx = grid_arrays(ptw, ptr, n)
        out[name] = psim._grid_agg_dispatch(
            matrix, index, params, idx, 1.0, SLO_LIMIT, 0, block, cpu,
            devices=d)
    twins, matrix, index, _, _ = grid_arrays(ptw, ptr, 10)
    slo = pslo.SLO(limit_s=SLO_LIMIT, met_fraction=0.95)
    with obs.capture() as rec:
        out["end_to_end"] = psim.simulate_grid(
            twins, load_matrix=matrix, load_index=index, bin_hours=1.0,
            slo=slo, return_series=False, scenario_block=4, devices=world,
            device="cpu")
    out["rounds"] = [dict(s.attrs) for s in rec.find("grid.round")]
    out["blocks_counter"] = {k: v for k, v in rec.counters.items()
                             if k[0] == "grid.blocks"}
    out["fault"] = psim.simulate_grid(
        twins[:5], load_matrix=matrix, load_index=index[:5],
        bin_hours=1.0, slo=slo, return_series=False, scenario_block=4,
        devices=world, faults=chaos_schedule(pf), device="cpu")
    if world == 2:      # a full year: one world is enough
        out["run_grid"] = pwhatif.run_grid(
            policy_twins(ptw), traffics(ptr), slo=slo, scenario_block=4,
            devices=2, device="cpu")
    try:
        psim.simulate_grid(twins, load_matrix=matrix, load_index=index,
                           bin_hours=1.0, return_series=False,
                           devices=world + 1, device="cpu")
        out["too_many"] = None
    except ValueError as e:
        out["too_many"] = str(e)
    return out


# ---------------------------------------------------------------------------
# the restart meshes
# ---------------------------------------------------------------------------

RESTARTS = 4
FIT_STEPS = 30
SEARCH_STEPS = 12


def fit_problem(pc, plp, pt):
    """A noiseless shed replay of a 2 h ramp in 300 s bins."""
    truth = pt.make_twin("t", "shed", max_rps=2.0, usd_per_hour=0.05,
                         base_latency_s=0.2, queue_cap_hours=1.5)
    ramp = plp.LoadPattern.ramp("ramp", duration_s=2 * 3600, peak_rate=6.0)
    return pc.ObservedTrace.from_loadpattern(ramp, truth, bin_s=300.0,
                                             device="cpu")


def weekly_load(t_bins=168, mean=4000.0):
    rng = np.random.default_rng(0)
    t = np.arange(t_bins)
    load = (mean + 0.75 * mean * np.sin(2 * np.pi * t / 24.0)
            + rng.uniform(0, 0.2 * mean, t_bins))
    return np.maximum(load, 50.0).astype(np.float32)[None]


def search_base(pt):
    return pt.make_twin("auto", "autoscale", max_rps=2.5, usd_per_hour=0.01,
                        base_latency_s=0.2, max_instances=8.0,
                        scale_up_hours=2.0)


def restart_runs(devices, world=None):
    """(fit result, search result) of the restart-mesh problems."""
    from repro_torch import calibrate as pc
    from repro_torch.core import loadpattern as plp
    from repro_torch.core import slo as pslo
    from repro_torch.core import twin as pt
    from repro_torch.search import search
    fit = pc.fit(fit_problem(pc, plp, pt), "shed", restarts=RESTARTS,
                 steps=FIT_STEPS, seed=0, device="cpu", devices=devices)
    res = search(search_base(pt), loads=weekly_load(), bin_hours=1.0,
                 slo=pslo.SLO(limit_s=3600.0, met_fraction=0.95),
                 restarts=RESTARTS, steps=SEARCH_STEPS, seed=0,
                 polish_rounds=1, device="cpu", devices=devices)
    return fit, res


def restart_summary(fit, res):
    return {"fit_z": fit.start_params, "fit_losses": fit.start_losses,
            "fit_history": fit.loss_history, "fit_best": fit.best_start,
            "search_params": res.restart_params,
            "search_history": res.history, "search_cost": res.cost_usd,
            "search_best": res.best_restart}


def restart_worker(rank, world):
    import warnings
    out = {"mesh": restart_summary(*restart_runs(world))}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        from repro_torch import calibrate as pc
        from repro_torch.core import loadpattern as plp
        from repro_torch.core import twin as pt
        pc.fit(fit_problem(pc, plp, pt), "shed", restarts=RESTARTS + 1,
               steps=2, seed=0, device="cpu", devices=world)
    out["fallback_warnings"] = [str(w.message) for w in caught
                                if issubclass(w.category, RuntimeWarning)]
    return out


# ---------------------------------------------------------------------------
# training over a mesh
# ---------------------------------------------------------------------------

BATCH, SEQ = 4, 32
TRAIN_STEPS = 2
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
#: an MoE model over data=2: 2 rows of 128 a rank are one dispatch group
#: of 256 tokens, as the whole batch's groups are
MOE_ARCH, MOE_SEQ = "phi3.5-moe-42b-a6.6b", 128


def train_batch(vocab, seed=1, b=BATCH, s=SEQ):
    """``tests/test_torch_train.py``'s batch: row 0 has a masked tail, so
    the ranks' mask counts differ."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    mask[0, s // 2:] = 0.0
    return {"tokens": tokens, "loss_mask": mask}


def smoke(dtype, arch="llama3.2-1b"):
    import dataclasses
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(arch), dtype=dtype)


def cpu_mesh(shape, axes):
    from torch.distributed.device_mesh import DeviceMesh
    n = int(np.prod(shape))
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def np_tree(tree):
    """Tensors of a (params, OptState) or dict tree as numpy (bf16
    widened), for pickling."""
    from repro_torch.checkpoint.ckpt import _items
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            for k, v in _items(tree)}


def mesh_run(cfg, ocfg, par, mesh, params_np, batch_np, steps=TRAIN_STEPS,
             batch=BATCH):
    """``steps`` mesh steps from ``params_np`` on the rank's rows of
    ``batch_np``: (metrics per step, the whole state after each step,
    the whole gradient of the first step, the live shards)."""
    from repro_torch.checkpoint.ckpt import gather_tree, reshard_tree
    from repro_torch.distributed import sharding as sh
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train.steps import make_train_step
    step = make_train_step(cfg, ocfg, par, "cpu", mesh=mesh)
    pshard, oshard = step.shardings
    params = {k: torch.tensor(v) for k, v in params_np.items()}
    state = reshard_tree((params, init_opt_state(params, ocfg)),
                         (pshard, oshard))
    axes = sh.batch_partition(par, mesh)
    sizes = sh.mesh_shape_dict(mesh)
    index = 0
    for a in axes:
        index = index * sizes[a] + mesh.get_local_rank(a)
    rows = sh.batch_rows(batch, index, sh.axis_size(sizes, axes),
                         par.microbatches)
    batch = {k: torch.from_numpy(v[rows]) for k, v in batch_np.items()}
    grads, _ = step.grads(state[0], batch)
    grads = {k: pshard[k].gather(g) for k, g in grads.items()}
    metrics, whole = [], []
    for _ in range(steps):
        p, o, m = step(state[0], state[1], batch)
        state = (p, o)
        metrics.append({k: float(v) for k, v in m.items()})
        whole.append(np_tree(gather_tree(state, (pshard, oshard))))
    return metrics, whole, np_tree(grads), state, step


def train_worker(rank, world, params_np, moe_params_np, root):
    import dataclasses
    from repro_torch.checkpoint.ckpt import (gather_tree, reshard_tree,
                                             save_checkpoint)
    from repro_torch.config import OptimizerConfig, ParallelConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.elastic import elastic_restore
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train.steps import make_train_step
    out = {}
    data2 = cpu_mesh((world, 1), ("data", "model"))
    par = ParallelConfig(batch_axes=("data",))
    for name, dtype, state_dtype, k in (
            ("float32", "float32", "float32", 1),
            ("bf16_int8", "bfloat16", "int8", 1),
            ("microbatches", "float32", "float32", 2)):
        cfg = smoke(dtype)
        ocfg = OptimizerConfig(state_dtype=state_dtype, **OPT)
        p = ParallelConfig(batch_axes=("data",), microbatches=k)
        metrics, whole, grads, state, step = mesh_run(
            cfg, ocfg, p, data2, params_np, train_batch(cfg.vocab_size))
        out[name] = {"metrics": metrics, "whole": whole, "grads": grads}
    # pod int8 compression: the pods' own gradients beside the compressed
    cfg = smoke("float32")
    ocfg = OptimizerConfig(**OPT)
    pods = cpu_mesh((world, 1, 1), ("pod", "data", "model"))
    pod_par = ParallelConfig(batch_axes=("pod", "data"),
                             grad_compression="int8")
    batch_np = train_batch(cfg.vocab_size)
    metrics, whole, grads, _, _ = mesh_run(cfg, ocfg, pod_par, pods,
                                           params_np, batch_np, steps=1)
    rows = sh.batch_rows(BATCH, rank, world)
    local = make_train_step(cfg, ocfg, par, "cpu")
    own, own_m = local.grads({k: torch.tensor(v)
                              for k, v in params_np.items()},
                             {k: torch.from_numpy(v[rows])
                              for k, v in batch_np.items()})
    out["pod"] = {"metrics": metrics, "grads": grads,
                  "own_grads": np_tree(own),
                  "own_metrics": {k: float(v) for k, v in own_m.items()}}
    # an MoE model: the balance loss of the whole batch's statistics,
    # beside this rank's rows' own (what a mean over ranks would take)
    cfg = smoke("float32", MOE_ARCH)
    moe_np = train_batch(cfg.vocab_size, s=MOE_SEQ)
    metrics, _, grads, _, _ = mesh_run(cfg, ocfg, par, data2, moe_params_np,
                                       moe_np, steps=1)
    _, own_m = make_train_step(cfg, ocfg, par, "cpu").grads(
        {k: torch.tensor(v) for k, v in moe_params_np.items()},
        {k: torch.from_numpy(v[rows]) for k, v in moe_np.items()})
    try:        # 2 rows of 32 tokens a rank: no whole dispatch group
        mesh_run(cfg, ocfg, par, data2, moe_params_np,
                 train_batch(cfg.vocab_size), steps=1)
        groups = None
    except ValueError as e:
        groups = str(e)
    # under remat the recomputed layers take the statistics again
    remat_m, _, remat_g, _, _ = mesh_run(
        cfg, ocfg, ParallelConfig(batch_axes=("data",), remat="full"),
        data2, moe_params_np, moe_np, steps=1)
    out["moe"] = {"metrics": metrics, "grads": grads,
                  "own_aux": float(own_m["aux"]), "groups": groups,
                  "remat_metrics": remat_m, "remat_grads": remat_g}
    # checkpoints: 2 ranks -> disk -> 2 ranks, and a one-device state ->
    # disk -> 2 ranks
    cfg = smoke("bfloat16")
    ocfg = OptimizerConfig(state_dtype="int8", **OPT)
    _, _, _, state, step = mesh_run(cfg, ocfg, par, data2, params_np,
                                    train_batch(cfg.vocab_size))
    shardings = step.shardings
    whole = gather_tree(state, shardings)
    two = os.path.join(root, "two")
    if rank == 0:
        save_checkpoint(two, TRAIN_STEPS, whole, {"ranks": world})
    sh.barrier()
    p2, o2, step_r, _ = elastic_restore(two, cfg, ocfg, par, devices=world,
                                        device="cpu")
    from repro_torch.checkpoint.ckpt import _items
    live, back = dict(_items(state)), dict(_items((p2, o2)))
    out["ckpt"] = {"two_dir": two, "step": step_r,
                   "two_to_two_bitwise": sorted(live) == sorted(back) and all(
                       torch.equal(live[k], back[k]) for k in live),
                   "two_whole": np_tree(whole)}
    one_step = make_train_step(cfg, ocfg, par, "cpu")
    params = {k: torch.tensor(v) for k, v in params_np.items()}
    one = (params, init_opt_state(params, ocfg))
    full_batch = {k: torch.from_numpy(v)
                  for k, v in train_batch(cfg.vocab_size).items()}
    for _ in range(TRAIN_STEPS):
        p_, o_, _ = one_step(one[0], one[1], full_batch)
        one = (p_, o_)
    one_dir = os.path.join(root, "one")
    if rank == 0:
        save_checkpoint(one_dir, TRAIN_STEPS, one)
    sh.barrier()
    p3, o3, _, _ = elastic_restore(one_dir, cfg, ocfg, par, devices=world,
                                   device="cpu")
    want = dict(_items(reshard_tree(one, shardings)))
    got = dict(_items((p3, o3)))
    round_trip = dict(_items(gather_tree((p3, o3), shardings)))
    one_items = dict(_items(one))
    out["ckpt"]["one_to_two_bitwise"] = all(
        torch.equal(got[k], want[k]) for k in want)
    out["ckpt"]["one_to_two_gathers_back"] = all(
        torch.equal(round_trip[k], one_items[k]) for k in one_items)
    # the loop: faults on every rank alike, restart from the same step
    out["loop"] = loop_runs(root, data2)
    # the launcher
    from repro_torch.launch import train as launch_train
    ckdir = os.path.join(root, "launch")
    out["launch_rc"] = launch_train.main(
        ["--smoke", "--device", "cpu", "--data", str(world), "--steps", "3",
         "--seq-len", "32", "--batch", "4", "--ckpt-dir", ckdir,
         "--ckpt-every", "3"])
    out["launch_dir"] = ckdir
    # 3 query heads over a model axis of 2 (ROADMAP C19): the reference's
    # fall-back, each leaf by its spec, with the warning
    import warnings
    odd = smoke("float32")
    odd = dataclasses.replace(odd, attention=dataclasses.replace(
        odd.attention, num_heads=3, num_kv_heads=1))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        step = make_train_step(odd, OptimizerConfig(**OPT), par, "cpu",
                               mesh=cpu_mesh((1, world), ("data", "model")))
    out["model_axis"] = {
        "warnings": [str(m.message) for m in caught
                     if issubclass(m.category, RuntimeWarning)],
        "shapes": {k: tuple(s.local_shape)
                   for k, s in step.shardings[0].items()}}
    return out


LOOP_STEPS = 6


def loop_config(root, name):
    from repro_torch.config import (OptimizerConfig, ParallelConfig,
                                    TrainConfig)
    tcfg = TrainConfig(steps=LOOP_STEPS, seq_len=SEQ, global_batch=BATCH,
                       checkpoint_every=2, log_every=100,
                       checkpoint_dir=os.path.join(root, name),
                       async_checkpoint=False)
    return (smoke("float32"), tcfg, OptimizerConfig(**OPT),
            ParallelConfig(batch_axes=("data",)))


def loop_runs(root, mesh):
    """The loop on the mesh with a transient fault and a node loss, and
    uninterrupted: (losses, restarts, retries) of each."""
    from repro_torch.distributed.fault import FaultInjector
    from repro_torch.train.loop import train
    got = {}
    for name, inj in (("faults", FaultInjector(transient_at=(2,),
                                               node_loss_at=(5,))),
                      ("clean", None)):
        cfg, tcfg, ocfg, par = loop_config(root, f"loop_{name}")
        res = train(cfg, tcfg, ocfg, par, device="cpu", injector=inj,
                    verbose=False, mesh=mesh)
        got[name] = {"losses": res.losses, "restarts": res.restarts,
                     "fired": [] if inj is None else list(inj.fired),
                     "dir": tcfg.checkpoint_dir}
    return got


# ---------------------------------------------------------------------------
# training over a (data, model) mesh
# ---------------------------------------------------------------------------

#: (case, arch, overrides) of the tensor-parallel training cases: GQA
#: with RoPE, MLA, Mamba (Jamba without experts), RWKV-6 and experts
TP_CASES = (("llama", "llama3.2-1b", {}),
            ("minicpm3", "minicpm3-4b", {}),
            ("jamba", "jamba-1.5-large-398b", {"moe": None}),
            ("rwkv6", "rwkv6-7b", {}),
            ("phi35_moe", MOE_ARCH, {}))
#: the (data, model) meshes of each world
TP_MESHES = {2: ((1, 2),), 4: ((2, 2), (1, 4))}
TP_REMATS = ("none", "full")


def tp_cfg(case, dtype="float32"):
    import dataclasses
    from repro_torch.configs import get_smoke_config
    _, arch, kw = next(c for c in TP_CASES if c[0] == case)
    return dataclasses.replace(get_smoke_config(arch), dtype=dtype, **kw)


def tp_batch(case):
    """The case's batch: an MoE model's rows of MOE_SEQ, so that a rank
    of data=2 holds whole dispatch groups."""
    cfg = tp_cfg(case)
    return train_batch(cfg.vocab_size,
                       s=MOE_SEQ if cfg.moe is not None else SEQ)


def rows_of(mesh, par, batch=BATCH):
    """This rank's rows: its index over the batch axes alone, so the
    ranks of one data index take the same rows."""
    from repro_torch.distributed import sharding as sh
    axes = sh.batch_partition(par, mesh)
    sizes = sh.mesh_shape_dict(mesh)
    index = 0
    for a in axes:
        index = index * sizes[a] + mesh.get_local_rank(a)
    return sh.batch_rows(batch, index, sh.axis_size(sizes, axes),
                         par.microbatches)


def model_shared(state, shardings, tp="model"):
    """{key: (holders, array)} of the rank's shards that other ranks of
    its ``model`` axis hold too: leaves and moments not split over
    ``model`` (``holders`` -1: every model rank) and K/V heads that
    several ``model`` ranks read (``holders`` the index of that group of
    sharers), as numpy."""
    from repro_torch.checkpoint.ckpt import _items, _zip_shardings
    places = _zip_shardings(state, shardings)
    out = {}
    for k, v in _items(state):
        p = places[k]
        if tp in p.axes and p.sharers() == 1:
            continue
        holders = (-1 if tp not in p.axes
                   else p.mesh.get_local_rank(tp) // p.sharers())
        out[k] = (holders,
                  (v.float() if v.dtype == torch.bfloat16 else v).numpy())
    return out


def one_device_run(cfg, ocfg, par, params_np, batch_np, steps=TRAIN_STEPS):
    """The port's one-device step on the whole batch: (metrics of each
    step, the params after the last, the first step's gradients)."""
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train.steps import make_train_step
    step = make_train_step(cfg, ocfg, par, device="cpu")
    params = {k: torch.tensor(v) for k, v in params_np.items()}
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    grads, _ = step.grads(params, batch)
    state = (params, init_opt_state(params, ocfg))
    metrics = []
    for _ in range(steps):
        p, o, m = step(state[0], state[1], batch)
        state = (p, o)
        metrics.append({k: float(v) for k, v in m.items()})
    return (metrics, {k: v.float().numpy() for k, v in state[0].items()},
            {k: g.float().numpy() for k, g in grads.items()})


def thread_grads(case, mesh, params_np):
    """A remat="full" backward run on the forward's thread and on
    another one (the CPU's stand-in for CUDA's device thread, where no
    context of the forward is set): each one's gradients of the rank's
    compute shards."""
    import threading
    from repro_torch.checkpoint.ckpt import reshard_tree
    from repro_torch.config import OptimizerConfig, ParallelConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train.steps import make_train_step
    cfg = tp_cfg(case)
    par = ParallelConfig(batch_axes=("data",), remat="full")
    ocfg = OptimizerConfig(**OPT)
    step = make_train_step(cfg, ocfg, par, "cpu", mesh=mesh)
    params = {k: torch.tensor(v) for k, v in params_np.items()}
    state = reshard_tree((params, init_opt_state(params, ocfg)),
                         step.shardings)
    full = step.compute_params(state[0])
    rows = rows_of(mesh, par)
    batch = {k: torch.from_numpy(v[rows]) for k, v in tp_batch(case).items()}
    got, names = {}, list(full)
    for where in ("same", "other"):
        leaves = [full[n].detach().requires_grad_() for n in names]

        def backward():
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            got[where] = {n: None if g is None else g.numpy()
                          for n, g in zip(names, grads)}
        with torch.enable_grad(), sh.within(step.context):
            loss, _ = M.loss_fn(dict(zip(names, leaves)), cfg, batch,
                                remat="full")
            if where == "same":     # as the step runs it
                backward()
        if where == "other":
            t = threading.Thread(target=backward)
            t.start()
            t.join()
    return got


def tp_worker(rank, world, params_np, root):
    """Every tensor-parallel case over each mesh of this world, and (rank
    0 keeping the whole tensors) the first step's gradients, two steps'
    metrics and the last whole parameters; the state the rank shares
    with its model axis; at world 2 the thread and launcher checks, at
    world 4 bf16 + int8, two microbatches and checkpoints."""
    import os
    from repro_torch.config import OptimizerConfig, ParallelConfig
    out = {}
    ocfg = OptimizerConfig(**OPT)
    for shape in TP_MESHES[world]:
        mesh = cpu_mesh(shape, ("data", "model"))
        for case, _, _ in TP_CASES:
            for remat in TP_REMATS:
                par = ParallelConfig(batch_axes=("data",), remat=remat)
                metrics, whole, grads, state, step = mesh_run(
                    tp_cfg(case), ocfg, par, mesh, params_np[case],
                    tp_batch(case))
                rec = {"metrics": metrics,
                       "shared": model_shared(state, step.shardings)}
                if rank == 0:
                    rec.update(grads=grads, whole=params_of(whole[-1]))
                out[(shape, case, remat)] = rec
    if world == 2:
        mesh = cpu_mesh((1, 2), ("data", "model"))
        out["thread"] = {case: thread_grads(case, mesh, params_np[case])
                         for case in ("llama", "phi35_moe")}
        from repro_torch.launch import train as launch_train
        ckdir = os.path.join(root, "launch_model")
        out["launch_rc"] = launch_train.main(
            ["--smoke", "--device", "cpu", "--model", "2", "--data", "1",
             "--steps", "3", "--seq-len", "32", "--batch", "4",
             "--ckpt-dir", ckdir, "--ckpt-every", "3"])
        out["launch_dir"] = ckdir
    if world == 4:
        out.update(tp_mesh22_cases(rank, params_np["llama"], root))
    return out


def params_of(whole):
    """The parameters of a gathered (params, OptState) tree."""
    return {k[len("[0]['"):-2]: v for k, v in whole.items()
            if k.startswith("[0]")}


def tp_mesh22_cases(rank, params_np, root):
    """Smoke llama3.2 over (2, 2): bf16 compute with int8 moments, two
    microbatches, and a checkpoint (2, 2) -> one device -> (2, 2)."""
    import os
    from repro_torch.checkpoint.ckpt import (_items, gather_tree,
                                             reshard_tree, save_checkpoint)
    from repro_torch.config import OptimizerConfig, ParallelConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.elastic import elastic_restore
    mesh = cpu_mesh((2, 2), ("data", "model"))
    out = {}
    for name, dtype, state_dtype, k in (
            ("bf16_int8", "bfloat16", "int8", 1),
            ("microbatches", "float32", "float32", 2)):
        cfg = tp_cfg("llama", dtype)
        ocfg = OptimizerConfig(state_dtype=state_dtype, **OPT)
        par = ParallelConfig(batch_axes=("data",), microbatches=k)
        metrics, whole, grads, state, step = mesh_run(
            cfg, ocfg, par, mesh, params_np, tp_batch("llama"))
        rec = {"metrics": metrics,
               "shared": model_shared(state, step.shardings)}
        if rank == 0:
            rec.update(grads=grads, whole=params_of(whole[-1]))
        out[name] = rec
        if name == "bf16_int8":
            # the checkpoint: the live shards gathered whole (one
            # device's layout), written, and restored onto one device
            # and onto (2, 2)
            par_ck, ocfg_ck, live, shardings = par, ocfg, state, \
                step.shardings
    whole = gather_tree(live, shardings)
    ckdir = os.path.join(root, "ckpt22")
    if rank == 0:
        save_checkpoint(ckdir, TRAIN_STEPS, whole)
    sh.barrier()
    cfg = tp_cfg("llama", "bfloat16")
    p1, o1, _, _ = elastic_restore(ckdir, cfg, ocfg_ck, par_ck, device="cpu")
    one = dict(_items((p1, o1)))
    whole_items = dict(_items(whole))
    p2, o2, _, _ = elastic_restore(ckdir, cfg, ocfg_ck, par_ck, mesh=mesh,
                                   device="cpu")
    back = dict(_items((p2, o2)))
    again = dict(_items(reshard_tree((p1, o1), shardings)))
    live_items = dict(_items(live))
    out["ckpt"] = {
        "to_one_bitwise": sorted(one) == sorted(whole_items) and all(
            torch.equal(one[k], whole_items[k]) for k in one),
        "back_bitwise": sorted(back) == sorted(live_items) and all(
            torch.equal(back[k], live_items[k]) for k in back),
        "reshard_bitwise": all(torch.equal(again[k], live_items[k])
                               for k in live_items)}
    return out


# ---------------------------------------------------------------------------
# serving over a mesh
# ---------------------------------------------------------------------------

#: (case, arch, overrides) of the serving cases: every block kind, in
#: float32; whisper's vocabulary made odd so that ``model`` does not
#: divide it (it stays whole, as whisper-small's 51,865 does)
SERVE_CASES = (("llama", "llama3.2-1b", {}),
               ("minicpm3", "minicpm3-4b", {}),
               ("jamba_moe", "jamba-1.5-large-398b", {}),
               ("jamba", "jamba-1.5-large-398b", {"moe": None}),
               ("rwkv6", "rwkv6-7b", {}),
               ("whisper", "whisper-small", {"vocab_size": 257}),
               ("moonshot", "moonshot-v1-16b-a3b", {}),
               ("phi35_moe", "phi3.5-moe-42b-a6.6b", {}))
#: the meshes (data, model) of each world
SERVE_MESHES = {2: ((1, 2), (2, 1)), 4: ((2, 2), (1, 4))}
#: the steps run: 4 rows, prompts of 128 (with experts 512 tokens, two
#: dispatch groups of 256: a rank's rows make whole groups at data=2),
#: 3 decode steps (4 tokens, one group that straddles the ranks)
SERVE_B, SERVE_MAX_LEN, SERVE_DECODE = 4, 256, 3
#: the engine: 4 slots of max_len 128 (a prefill of 4 x 64 tokens is one
#: group of 256, which straddles the ranks at data=2), 6 requests
ENGINE_MAX_LEN, ENGINE_NEW = 128, 4


def serve_cfg(case):
    import dataclasses
    from repro_torch.configs import get_smoke_config
    _, arch, kw = next(c for c in SERVE_CASES if c[0] == case)
    return dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)


def serve_inputs(cfg, b=SERVE_B, max_len=SERVE_MAX_LEN, seed=3):
    """The steps' prefill batch: {"tokens"} (+ whisper's "frames")."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(1, cfg.vocab_size,
                                    (b, max_len // 2)).astype(np.int32)}
    if cfg.encdec:
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def engine_prompts(cfg, n=6, seed=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, int(k)).tolist()
            for k in rng.integers(3, 90, n)]


def serve_steps(cfg, params, batch_np, mesh=None, parallel=None):
    """Prefill and SERVE_DECODE greedy decode steps on ``batch_np``:
    (logits of each step, greedy tokens [b, steps + 1], the cache, its
    placement). ``params`` are whole; over a mesh the rank's rows and
    shards."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import model as M
    from repro_torch.serve.steps import make_decode_step, make_prefill_step
    b = batch_np["tokens"].shape[0]
    rows = np.arange(b)
    pplace = cplace = None
    if mesh is not None:
        smesh = sh.ServeMesh.of(mesh, parallel)
        rows = sh.batch_rows(b, smesh.batch_rank, smesh.batch_size)
        pplace, cplace = M.serve_placement(cfg, parallel, mesh, b,
                                           SERVE_MAX_LEN)
        params = M.place_params(params, pplace)
    params = M.compute_params(params, cfg, "cpu")
    prefill = make_prefill_step(cfg, parallel, mesh)
    decode = make_decode_step(cfg, parallel, mesh)
    cache = M.init_cache(cfg, b, SERVE_MAX_LEN, device="cpu",
                         placement=cplace)
    logits, cache = prefill(params, {k: torch.from_numpy(v[rows])
                                     for k, v in batch_np.items()}, cache)
    out, toks = [logits.numpy().copy()], [logits[:, -1].argmax(-1).numpy()]
    for _ in range(SERVE_DECODE):
        tok = torch.from_numpy(toks[-1][rows].astype(np.int32))[:, None]
        logits, cache = decode(params, cache, {"token": tok})
        out.append(logits.numpy().copy())
        toks.append(logits[:, -1].argmax(-1).numpy())
    return out, np.stack(toks, 1), cache, (params, pplace, cplace)


def serve_engine(cfg, params, mesh=None, parallel=None):
    """ServeEngine.serve of 6 requests over 4 slots: (outputs, span
    counts, the engine)."""
    from repro_torch.serve.engine import Request, ServeEngine
    eng = ServeEngine(cfg, params, mesh=mesh, parallel=parallel, slots=4,
                      max_len=ENGINE_MAX_LEN, device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new=ENGINE_NEW)
            for i, p in enumerate(engine_prompts(cfg))]
    done = eng.serve(reqs)
    spans = {k: len(eng.collector.spans(k)) for k in ("prefill", "decode")}
    return [r.output for r in sorted(done, key=lambda r: r.rid)], spans, eng


def serve_worker(rank, world, params_np):
    """Every serving case over each mesh of this world: the steps'
    logits and tokens, the gathered cache, the rank's bytes, the
    gathered parameters against the whole ones, and the engine's
    outputs."""
    import warnings
    from repro_torch.checkpoint.ckpt import gather_tree
    from repro_torch.config import ParallelConfig
    from repro_torch.convert import model_params_from_arrays
    from repro_torch.models import model as M
    par = ParallelConfig()
    out = {}
    for shape in SERVE_MESHES[world]:
        mesh = cpu_mesh(shape, ("data", "model"))
        for case, _, _ in SERVE_CASES:
            cfg = serve_cfg(case)
            params = model_params_from_arrays(params_np[case], cfg,
                                              device="cpu")
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                logits, toks, cache, (local, pplace, cplace) = serve_steps(
                    cfg, params, serve_inputs(cfg), mesh, par)
            rec = {"logits": logits, "tokens": toks,
                   "cache": {k: cplace[k].gather(v).numpy()
                             for k, v in cache.items()},
                   "param_shapes": {k: tuple(v.shape)
                                    for k, v in local.items()},
                   "cache_shapes": {k: tuple(v.shape)
                                    for k, v in cache.items()},
                   "warnings": [str(w.message) for w in caught
                                if issubclass(w.category, RuntimeWarning)]}
            whole = M.compute_params(params, cfg, "cpu")
            back = gather_tree(local, pplace)
            rec["params_bitwise"] = sorted(back) == sorted(whole) and all(
                torch.equal(back[k], whole[k]) for k in whole)
            if not cfg.encdec:
                rec["engine"], rec["spans"], eng = serve_engine(
                    cfg, params, mesh, par)
                eng_back = gather_tree(eng.params, eng.placement)
                rec["engine_params_bitwise"] = all(
                    torch.equal(eng_back[k], whole[k]) for k in whole)
            out[(shape, case)] = rec
    try:
        from repro_torch.serve.engine import ServeEngine
        cfg = serve_cfg("llama")
        ServeEngine(cfg, model_params_from_arrays(params_np["llama"], cfg,
                                                  device="cpu"),
                    mesh=cpu_mesh((world, 1), ("data", "model")),
                    slots=world + 1, max_len=64, device="cpu")
        out["slots"] = None
    except ValueError as e:
        out["slots"] = str(e)
    return out


def serve_plan_shapes(cfg, mesh_shape, batch=SERVE_B,
                      max_len=SERVE_MAX_LEN):
    """({name: shape} of a rank's parameters, of its cache) by the plan:
    each dim the reference's spec splits over a mesh axis other than the
    FSDP axis (``embed``) divided by that axis, except that where
    ``model`` splits the query heads, does not split the KV heads and is
    a multiple of them (C23) ``wk`` / ``wv`` and the K/V caches keep one
    head."""
    from repro_torch.config import ParallelConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import model as M
    from repro_torch.models.layers import specs_from_schema
    rules = dict(sh.build_rules(ParallelConfig(), mesh_shape), embed=None)
    m = mesh_shape.get("model", 1)
    heads, kv = cfg.attention.num_heads, cfg.attention.num_kv_heads
    cut = m > 1 and heads % m == 0 and kv % m != 0 and m % kv == 0
    out = []
    for schema, kv_names, kv_dim in (
            (M.full_schema(cfg), (".attn.wk", ".attn.wv", ".cross.wk",
                                  ".cross.wv"), -1),
            (M.cache_schema(cfg, batch, max_len), (".attn.k", ".attn.v",
                                                   ".cross.k", ".cross.v"),
             -2)):
        specs = specs_from_schema(schema, rules, mesh_shape)
        shapes = {}
        for name, d in schema.items():
            shape = [n // sh.axis_size(mesh_shape, e)
                     for n, e in zip(d.shape, specs[name])]
            if cut and name.endswith(kv_names):
                shape[kv_dim] = d.shape[kv_dim] // kv
            shapes[name] = tuple(shape)
        out.append(shapes)
    return tuple(out)


# ---------------------------------------------------------------------------
# serving with a cache split along its sequence
# ---------------------------------------------------------------------------

#: (case, arch, overrides): GQA, MLA and Jamba without experts (Mamba
#: beside attention), in float32; the ``_fb`` cases have 3 query heads,
#: which a model axis of 2 does not divide (the fall-back, ROADMAP C19:
#: every head on every rank against its chunk); the ``_mqa`` cases have
#: one KV head, which a model axis of 2 does not divide (the reference's specs then
#: leave it whole, as jamba-1.5-large's 8 over 16: with two KV heads a
#: sequence over ("data", "model") would name model twice, which raises)
SEQ_CASES = (("llama", "llama3.2-1b", {}),
             ("llama_mqa", "llama3.2-1b", {"num_kv_heads": 1}),
             ("llama_fb", "llama3.2-1b", {"num_heads": 3,
                                          "num_kv_heads": 1}),
             ("minicpm3", "minicpm3-4b", {}),
             ("minicpm3_fb", "minicpm3-4b", {"num_heads": 3,
                                             "num_kv_heads": 3}),
             ("jamba", "jamba-1.5-large-398b", {"moe": None}),
             ("jamba_mqa", "jamba-1.5-large-398b",
              {"moe": None, "num_kv_heads": 1}),
             ("jamba_moe_mqa", "jamba-1.5-large-398b", {"num_kv_heads": 1}),
             ("whisper", "whisper-small", {}),
             ("whisper_mqa", "whisper-small", {"num_kv_heads": 1}),
             ("whisper_enc15", "whisper-small", {"encoder_seq": 15}))
#: (layout, world, mesh shape, axes, seq_axis, batch, cases): the
#: sequence over model (whisper's cross-attention cache too: its 16
#: encoder positions in two chunks; with 15 it stays whole); over (data,
#: model) with a batch of one (the reference's long_500k layout; Jamba
#: with experts too, its expert ranks sharing their one row, so every
#: row takes the gathered experts; whisper's cross cache in four
#: chunks); rows over (pod, data), the sequence over a model axis of one
#: (its multi-pod decode_32k layout); the sequence over model with a
#: cache of SEQ_ODD_LEN positions, which 2 does not divide: the
#: self-attention caches stay whole, as the reference's specs leave them
#: (whisper's cross cache still splits)
SEQ_LAYOUTS = (("seq_model", 2, (1, 2), ("data", "model"), "model", 4,
                ("llama", "minicpm3", "jamba", "llama_fb", "minicpm3_fb",
                 "whisper", "whisper_enc15")),
               ("seq_data_model", 4, (2, 2), ("data", "model"),
                ("data", "model"), 1, ("llama_mqa", "minicpm3",
                                       "jamba_mqa", "jamba_moe_mqa",
                                       "whisper_mqa")),
               ("rows_pod_data", 4, (2, 2, 1), ("pod", "data", "model"),
                "model", 4, ("llama", "minicpm3", "jamba")),
               ("seq_model_odd", 2, (1, 2), ("data", "model"), "model", 4,
                ("llama", "minicpm3", "whisper")))
#: a cache of 128 positions, prompts of 64 (the chunk boundary at 2 ranks,
#: two chunks at 4), 4 greedy decode steps
SEQ_MAX_LEN, SEQ_PROMPT, SEQ_DECODE = 128, 64, 4
#: the cache length of the layout ``seq_model_odd``
SEQ_ODD_LEN = 127


def seq_max_len(layout):
    return SEQ_ODD_LEN if layout == "seq_model_odd" else SEQ_MAX_LEN


def seq_parallel(seq_axis):
    from repro_torch.config import ParallelConfig
    return ParallelConfig(fsdp_axis=None, shard_cache_seq=True,
                          seq_axis=seq_axis)


def seq_cfg(case, dtype="float32", get_smoke_config=None):
    """A case's smoke config (of the port, or of ``get_smoke_config``'s
    package)."""
    import dataclasses
    if get_smoke_config is None:
        from repro_torch.configs import get_smoke_config
    _, arch, kw = next(c for c in SEQ_CASES if c[0] == case)
    kw = dict(kw)
    cfg = get_smoke_config(arch)
    heads = {k: kw.pop(k) for k in ("num_heads", "num_kv_heads") if k in kw}
    if heads:
        kw["attention"] = dataclasses.replace(cfg.attention, **heads)
    return dataclasses.replace(cfg, dtype=dtype, **kw)


def seq_tokens(cfg, b, seed=5):
    rng = np.random.default_rng(seed)
    return rng.integers(1, cfg.vocab_size, (b, SEQ_PROMPT)).astype(np.int32)


def seq_batch(cfg, b):
    """The prefill batch: {"tokens"} (+ whisper's "frames")."""
    batch = {"tokens": seq_tokens(cfg, b)}
    if cfg.encdec:
        rng = np.random.default_rng(6)
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def seq_steps(cfg, params, batch_np, mesh=None, parallel=None,
              max_len=SEQ_MAX_LEN):
    """Prefill and SEQ_DECODE greedy steps: (logits of each step, tokens
    [b, steps + 1], the cache, its placement, the serving mesh)."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import model as M
    from repro_torch.serve.steps import make_decode_step, make_prefill_step
    b = batch_np["tokens"].shape[0]
    rows, cplace, smesh = np.arange(b), None, None
    if mesh is not None:
        smesh = M.serve_mesh_of(cfg, parallel, mesh, max_len)
        rows = sh.batch_rows(b, smesh.batch_rank, smesh.batch_size)
        pplace, cplace = M.serve_placement(cfg, parallel, mesh, b, max_len)
        params = M.place_params(params, pplace)
    params = M.compute_params(params, cfg, "cpu")
    prefill = make_prefill_step(cfg, parallel, mesh, max_len)
    decode = make_decode_step(cfg, parallel, mesh, max_len)
    cache = M.init_cache(cfg, b, max_len, device="cpu", placement=cplace)
    logits, cache = prefill(params, {k: torch.from_numpy(v[rows])
                                     for k, v in batch_np.items()}, cache)
    out = [logits.float().numpy().copy()]
    toks = [logits[:, -1].argmax(-1).numpy()]
    for _ in range(SEQ_DECODE):
        tok = torch.from_numpy(toks[-1][rows].astype(np.int32))[:, None]
        logits, cache = decode(params, cache, {"token": tok})
        out.append(logits.float().numpy().copy())
        toks.append(logits[:, -1].argmax(-1).numpy())
    return out, np.stack(toks, 1), cache, cplace, smesh


@contextlib.contextmanager
def expert_slots():
    """Counts the expert slots multiplied while inside: a list of
    ``moe._local_experts``'s E_held x slots, one entry a call (its input
    xe is [E_held, slots, d]); its sum is the count."""
    from repro_torch.models import moe
    calls, local = [], moe._local_experts

    def counting(params, name, xe, *rest):
        calls.append(int(xe.shape[0] * xe.shape[1]))
        return local(params, name, xe, *rest)
    moe._local_experts = counting
    try:
        yield calls
    finally:
        moe._local_experts = local


def seq_worker(rank, world, params_np):
    """Every case over each layout of this world, in float32 (and smoke
    llama3.2 in bf16 over the first): logits, tokens, the gathered
    cache, the cache shapes and the collectives a decode step issues."""
    from repro_torch.convert import model_params_from_arrays
    from repro_torch.distributed import sharding as sh
    from repro_torch.serve.engine import Request, ServeEngine
    import warnings
    out = {}
    for layout, w, shape, axes, seq_axis, b, cases in SEQ_LAYOUTS:
        if w != world:
            continue
        mesh = cpu_mesh(shape, axes)
        par = seq_parallel(seq_axis)
        max_len = seq_max_len(layout)
        runs = [(case, "float32", par) for case in cases]
        if layout == "seq_model":
            runs.append(("llama", "bfloat16", par))
        if layout == "seq_model_odd":
            # the same case served without shard_cache_seq
            runs.append(("llama", "plain", type(par)(fsdp_axis=None)))
        for case, dtype, run_par in runs:
            cfg = seq_cfg(case, "float32" if dtype == "plain" else dtype)
            params = model_params_from_arrays(params_np[case], cfg,
                                              device="cpu")
            sh._REPLICATION_WARNED.clear()      # each run warns afresh
            with sh.tally() as coll, expert_slots() as slots, \
                    warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                logits, toks, cache, cplace, smesh = seq_steps(
                    cfg, params, seq_batch(cfg, b), mesh, run_par, max_len)
            out[(layout, case, dtype)] = {
                "logits": logits, "tokens": toks,
                "expert_slots": sum(slots),
                "cache": {k: cplace[k].gather(v).float().numpy()
                          for k, v in cache.items()},
                "cache_shapes": {k: tuple(v.shape)
                                 for k, v in cache.items()},
                "collectives": coll,
                "split": (smesh.seq_self, smesh.seq_cross),
                "warnings": [str(m.message) for m in caught
                             if issubclass(m.category, RuntimeWarning)]}
        if layout in ("seq_model", "seq_model_odd"):
            cfg = seq_cfg("llama")
            eng = ServeEngine(cfg, model_params_from_arrays(
                params_np["llama"], cfg, device="cpu"), mesh=mesh,
                parallel=par, slots=4, max_len=max_len, device="cpu")
            reqs = [Request(rid=i, prompt=p, max_new=ENGINE_NEW)
                    for i, p in enumerate(engine_prompts(cfg))]
            out[(layout, "engine")] = [
                r.output for r in sorted(eng.serve(reqs),
                                         key=lambda r: r.rid)]
    return out


# ---------------------------------------------------------------------------
# the fall-back over model (ROADMAP C19)
# ---------------------------------------------------------------------------

#: (case, arch, overrides; a dict for a nested config's fields) of the
#: widths a model axis of 2 or 4 does not divide, in float32: 3 query
#: heads over 1 KV head with an odd d_ff (the heads' columns cut across a
#: head, the MLP whole); 12 over 3 (``wq``'s columns split at whole
#: heads, the KV heads not: attention over every head); MLA with 3 heads; whisper with 3 heads (encoder, decoder and
#: cross-attention; its vocabulary odd, whole); Mamba with d_inner 63
#: (in_proj cut into x and z halves at 2, whole at 4); RWKV-6 with 3
#: heads; experts and a shared expert of width 33
FALLBACK_CASES = (
    ("gqa3", "llama3.2-1b", {"attention": {"num_heads": 3,
                                           "num_kv_heads": 1},
                             "d_ff": 129}),
    ("gqa12", "llama3.2-1b", {"attention": {"num_heads": 12,
                                            "num_kv_heads": 3}}),
    ("mla3", "minicpm3-4b", {"attention": {"num_heads": 3,
                                           "num_kv_heads": 3}}),
    ("whisper3", "whisper-small", {"attention": {"num_heads": 3,
                                                 "num_kv_heads": 3},
                                   "vocab_size": 257}),
    ("mamba", "jamba-1.5-large-398b", {"moe": None, "d_model": 63,
                                       "ssm": {"expand": 1}}),
    ("rwkv3", "rwkv6-7b", {"d_model": 48}),
    ("moe_odd", "moonshot-v1-16b-a3b", {"moe": {"d_ff": 33}}),
)
#: experts over the tensor-parallel axis itself (serving): smoke moonshot
#: with ``ParallelConfig(expert_axis="model")``, its 8 experts' dim over
#: model and their widths whole, in float32
EXPERTS_OVER_MODEL = "moonshot-v1-16b-a3b"
#: the cases trained over the mesh (whisper's batch needs frames)
FALLBACK_TRAIN = ("gqa3", "gqa12", "mla3", "mamba", "rwkv3", "moe_odd")
#: the (data, model) mesh of each world
FALLBACK_MESHES = {2: (1, 2), 4: (1, 4)}
#: the (data, model) mesh each world trains EXPERTS_OVER_MODEL over (with
#: ``expert_axis="model"``), and at world 4 smoke moonshot with 6
#: experts over (1, 4), which 4 does not divide (the experts whole on
#: every rank)
EXPERT_TRAIN_MESHES = {2: (1, 2), 4: (2, 2)}
ODD_EXPERTS = 6


def experts_cfg(num_experts=None, get_smoke_config=None):
    """Smoke moonshot in float32 (with ``num_experts``)."""
    import dataclasses
    if get_smoke_config is None:
        from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(EXPERTS_OVER_MODEL)
    if num_experts is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=num_experts))
    return dataclasses.replace(cfg, dtype="float32")


def experts_train(cfg, mesh, params_np, rank):
    """Two steps of ``cfg`` over ``mesh`` with the experts over ``model``
    (remat "full"): the metrics, the first gradients (rank 0, gathered
    whole) and the shape of the first expert leaf a rank computes
    with."""
    from repro_torch.config import OptimizerConfig, ParallelConfig
    par = ParallelConfig(batch_axes=("data",), expert_axis="model",
                         remat="full")
    metrics, _, grads, state, step = mesh_run(
        cfg, OptimizerConfig(**OPT), par, mesh, params_np,
        train_batch(cfg.vocab_size, s=MOE_SEQ))
    leaf = "stack.blk0.moe.w_gate"
    return {"metrics": metrics, "grads": grads if rank == 0 else None,
            "compute_shape": tuple(step.compute_params(state[0])[leaf].shape)}


def fallback_overrides(case, get_smoke_config):
    """(arch, the case's overrides of its smoke config of
    ``get_smoke_config``'s package, as ``dataclasses.replace`` takes
    them)."""
    import dataclasses
    _, arch, kw = next(c for c in FALLBACK_CASES if c[0] == case)
    base = get_smoke_config(arch)
    return arch, {k: dataclasses.replace(getattr(base, k), **v)
                  if isinstance(v, dict) else v for k, v in kw.items()}


def fallback_cfg(case, dtype="float32", get_smoke_config=None):
    import dataclasses
    if get_smoke_config is None:
        from repro_torch.configs import get_smoke_config
    arch, kw = fallback_overrides(case, get_smoke_config)
    return dataclasses.replace(get_smoke_config(arch), dtype=dtype, **kw)


def fallback_batch(case):
    """A training case's batch: an MoE model's rows of MOE_SEQ."""
    cfg = fallback_cfg(case)
    return train_batch(cfg.vocab_size,
                       s=MOE_SEQ if cfg.moe is not None else SEQ)


def fallback_worker(rank, world, params_np):
    """Every fall-back case over (1, world): the serve steps' logits and
    tokens, the gathered cache, the rank's leaf and cache shapes and the
    warnings; then the training cases' first gradients (gathered whole)
    and two steps' metrics, remat "full"."""
    import warnings
    from repro_torch.config import OptimizerConfig, ParallelConfig
    from repro_torch.convert import model_params_from_arrays
    from repro_torch.distributed import sharding as sh
    mesh = cpu_mesh(FALLBACK_MESHES[world], ("data", "model"))
    out = {}
    for case, _, _ in FALLBACK_CASES:
        cfg = fallback_cfg(case)
        params = model_params_from_arrays(params_np[case], cfg, device="cpu")
        sh._REPLICATION_WARNED.clear()      # each case warns afresh
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            logits, toks, cache, (local, _, cplace) = serve_steps(
                cfg, params, serve_inputs(cfg), mesh, ParallelConfig())
        out[("serve", case)] = {
            "logits": logits, "tokens": toks,
            "cache": {k: cplace[k].gather(v).numpy()
                      for k, v in cache.items()},
            "param_shapes": {k: tuple(v.shape) for k, v in local.items()},
            "cache_shapes": {k: tuple(v.shape) for k, v in cache.items()},
            "warnings": [str(m.message) for m in caught
                         if issubclass(m.category, RuntimeWarning)]}
    cfg = smoke("float32", EXPERTS_OVER_MODEL)
    params = model_params_from_arrays(params_np[EXPERTS_OVER_MODEL], cfg,
                                      device="cpu")
    logits, toks, _, (local, _, _) = serve_steps(
        cfg, params, serve_inputs(cfg), mesh,
        ParallelConfig(expert_axis="model"))
    out[("serve", EXPERTS_OVER_MODEL)] = {
        "logits": logits, "tokens": toks,
        "param_shapes": {k: tuple(v.shape) for k, v in local.items()}}
    ocfg = OptimizerConfig(**OPT)
    par = ParallelConfig(batch_axes=("data",), remat="full")
    for case in FALLBACK_TRAIN:
        metrics, _, grads, _, _ = mesh_run(
            fallback_cfg(case), ocfg, par, mesh, params_np[case],
            fallback_batch(case))
        out[("train", case)] = {"metrics": metrics,
                                "grads": grads if rank == 0 else None}
    shape = EXPERT_TRAIN_MESHES[world]
    out[("train", EXPERTS_OVER_MODEL)] = experts_train(
        experts_cfg(), cpu_mesh(shape, ("data", "model")),
        params_np[EXPERTS_OVER_MODEL], rank)
    if world == 4:
        out[("train", "odd_experts")] = experts_train(
            experts_cfg(ODD_EXPERTS), mesh, params_np["odd_experts"], rank)
    return out
