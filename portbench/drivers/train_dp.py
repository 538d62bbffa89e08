"""Data-parallel training cells: the train CLI's step (``train.train.
make_train_step`` on a ("data", "model") mesh of (ranks, 1), as ``--mesh
ranks,1`` runs it) over ``ranks`` processes, one card each, joined over
NCCL (gloo off the card).  The run starts the ranks itself.

Every rank draws the same weights and the same pool of global batches
(``batch`` rows a rank), takes its contiguous rows, and runs the checked
steps, then the window.  The window's length in steps is decided once,
before it: ``seconds`` over rank 0's last checked step, so the ranks run
the same steps with no read-back inside the window and each host enqueues
ahead of its card.  Traced, rank 0 runs the first half of those steps
plain and then profiles ``trace_steps`` steps of its card, as the training
driver does on one card (the program's own spans stay in the rank's
process).  The rates count the tokens of every rank; the peak memory is
the largest rank's; each rank's device time of every window step is
returned as ``step_ms``.

After the window each rank drops the system and runs the plain float32
reference (``reference/``) on its own block of rows (the ranks' rows are
the blocks: ``batch`` rows, the draws of its stream, as the system's rank
draws them), the blocks' gradients summed over the ranks, so that the
reference steps the global batch, computed in blocks.  The comparison is
the training driver's (``drivers/train.py`` ``compare``) on rank 0.  A rank
that loaded a module of the reference package or of JAX fails the run.
"""
from __future__ import annotations

import gc
import json
import math
import os
import socket
import statistics
import tempfile
import time

import torch
import torch.distributed as dist

from portbench import generator, trace, weights
from portbench.drivers import train as single
from portbench.reference import model as ref_model
from portbench.reference.config import from_json as ref_config

# the system's per-rank stream of a step's draws: (seed * SEED_MIX + step +
# rank * STREAM_MIX) mod 2^63 (train/train.py step_generator)
STREAM_MIX = 0xC2B2AE3D27D4EB4F


def step_generator(seed: int, step: int, rank: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (seed * single.SEED_MIX + step + rank * STREAM_MIX) % 2 ** 63)


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _global_traffic(traffic: dict) -> dict:
    return dict(traffic, batch=traffic["batch"] * traffic["ranks"])


def _rank_setup(conf, traffic, seed, device, fault, mesh):
    """This rank's system, driven through the checked steps: (model,
    optimizer, train state, step, this rank's pool, the weights before the
    first step that the reference reads, checked losses, first gradient
    norms, change, the last checked step's host seconds)."""
    from mamba_tts_torch.config import from_json
    from mamba_tts_torch.models.tts import MambaTTS
    from mamba_tts_torch.parallel.mesh import shard_batch
    from mamba_tts_torch.train import state as state_lib
    from mamba_tts_torch.train.train import make_train_step

    cfg = from_json(json.dumps(conf["model"]))
    with torch.device(device):
        model = MambaTTS(cfg, mesh=mesh)
    shapes = {f"tts.{n}": tuple(p.shape) for n, p in model.named_parameters()}
    w = weights.split(weights.make(shapes, seed, device), "tts")
    weights.load_into(model, w)
    tx = state_lib.make_optimizer(cfg.train.lr, cfg.train.grad_clip_norm, mesh=mesh)
    st = state_lib.create_train_state(dict(model.named_parameters()), tx)
    step = make_train_step(model, tx, seed=seed, mesh=mesh)
    if fault is not None:
        step = fault(model, tx, step)
    pool = [shard_batch(single.to_device(b, device), mesh)
            for b in generator.for_traffic(traffic).train_batches(
                _global_traffic(traffic), seed, conf["model"])]
    losses, first = [], None
    for i in range(traffic["checked_steps"]):
        t = time.perf_counter()
        st, out = step(st, pool[i])
        losses.append({k: float(v) for k, v in out.items()})  # waits for the step
        step_s = time.perf_counter() - t
        if i == 0:  # Adam's first moment after one step is (1 - b1) g, g summed over ranks
            mu = st.opt_state["mu"]
            with torch.no_grad():
                first = {n: float(v) / (1 - tx.b1)
                         for n, v in zip(mu, torch._foreach_norm(list(mu.values())))}
    with torch.no_grad():
        change = {n: float((p.detach() - w[n]).norm()) for n, p in st.params.items()}
    start = {k: v for k, v in w.items() if not k.startswith("style_pipe.")}  # the reference's
    return model, tx, st, step, pool, start, losses, first, change, step_s


def no_exchange(model, tx, step):
    """The fault: the step without the gradients' sum over the ranks, so
    that each rank steps on the gradient of its own rows alone."""
    from mamba_tts_torch.train import train as train_lib

    def skipped(*a, **k):
        sync = train_lib.sync_gradients
        train_lib.sync_gradients = lambda grads, group: None
        try:
            return step(*a, **k)
        finally:
            train_lib.sync_gradients = sync

    return skipped


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _window(rank, st, step, pool, n_check, n_plain, n_prof, device):
    """``n_plain`` steps, then (rank 0) ``n_prof`` steps under the profiler:
    (state, window losses, host start and seconds, device ms a step, the
    profile or None)."""
    cuda = device.type == "cuda"
    prof = plain = None
    counters = single._counters() if n_prof and rank == 0 else {}
    events, window_losses = [], []
    dist.barrier()
    t0 = time.perf_counter()
    if cuda:
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    for i in range(n_plain + n_prof):
        if i == n_plain and counters:
            trace.sync(device)
            plain = {"steps": i, "seconds": time.perf_counter() - t0}
            trace.warm_profiler(device)
            prof = trace.Profile(device)
            launches0 = {k: f.launches for k, f in counters.items()}
            prof.start()
        with torch.profiler.record_function("portbench.train_step"):
            st, out = step(st, pool[(n_check + i) % len(pool)])
        window_losses.append(out["loss_total"])
        if cuda:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
    profile = None
    if prof is not None:
        prof.stop()
        launches = {k: f.launches - launches0[k] for k, f in counters.items()}
        kernels, win, pspans = prof.read()
        profile = {"kernels": kernels, "window": win, "spans": pspans, "steps": n_prof,
                   "launches": launches, "unprofiled_steps": plain["steps"],
                   "unprofiled_s": plain["seconds"]}
    trace.sync(device)
    window_s = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return st, window_losses, t0, window_s, step_ms, profile


def reference_block_steps(conf, batches, start, seed, rank, world, device, num=None):
    """The reference's first steps on the global batches, this rank
    computing its block of rows: each loss term weighted as its share of the
    global batch's mean (the duration loss by its valid phonemes), the
    blocks' gradients summed over the ranks, then clipping and Adam as the
    reference's ``adam_steps``, from the weights ``start``.  Returns (global
    losses, first clipped gradient norms by leaf, change of each leaf)."""
    cfg = ref_config(json.dumps(conf["model"]))
    with torch.device(device):
        m = ref_model.MambaTTS(cfg, num)
    weights.load_into(m, start)
    tr = cfg.train
    compute = m.compute_losses
    group_sum = (lambda t: dist.all_reduce(t) or t) if world > 1 else (lambda t: t)

    def blockwise(batch, gen):
        den = batch["text_mask"].float().sum()
        total_den = group_sum(den.clone())
        out = compute(batch, gen)
        share = {"loss_codec": tr.w_codec / world, "loss_smsd": tr.w_smsd / world,
                 "loss_dur": tr.w_dur * den / total_den}
        sum(out[k] * v for k, v in share.items()).backward()
        with torch.no_grad():
            for p in m.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            flat = group_sum(torch.cat([p.grad.reshape(-1) for p in m.parameters()]))
            for p, g in zip(m.parameters(), flat.split([p.numel() for p in m.parameters()])):
                p.grad.copy_(g.view_as(p))
            parts = torch.stack([out["loss_codec"].detach() / world,
                                 out["loss_dur"].detach() * den / total_den,
                                 out["loss_smsd"].detach() / world])
            codec, dur, smsd = group_sum(parts).tolist()
        losses = {"loss_codec": codec, "loss_dur": dur, "loss_smsd": smsd,
                  "loss_total": tr.w_codec * codec + tr.w_dur * dur + tr.w_smsd * smsd}
        # ``adam_steps`` backpropagates its loss_total: the gradients are in place
        return {k: torch.tensor(v, requires_grad=k == "loss_total") for k, v in losses.items()}

    m.compute_losses = blockwise
    gens = [step_generator(seed, i, rank, device) for i in range(len(batches))]
    losses, first, before = ref_model.adam_steps(m, batches, gens, tr.lr, tr.grad_clip_norm)
    with torch.no_grad():
        g1 = {n: float(t.norm()) for n, t in first.items()}
        change = {n: float((p - before[n]).norm()) for n, p in m.named_parameters()}
    del m, first, before
    return losses, g1, change


def _rank(rank, world, port, out_dir, conf, traffic, limits, seed, seconds, traced, fault,
          readings):
    """One rank of the run; rank 0 writes the result dict to ``out_dir``.
    ``readings``: also the float8 reference's and the no-exchange fault's
    numbers (``control.py``)."""
    from mamba_tts_torch.parallel.mesh import make_mesh
    from portbench.run import forbidden_modules

    cuda = torch.cuda.is_available()
    device = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh((world, 1), ("data", "model"), device_type=device.type)
        model, tx, st, step, pool, start, losses, first, change, step_s = _rank_setup(
            conf, traffic, seed, device, fault, mesh)
        n_check = traffic["checked_steps"]
        # the one stop decision: the window's steps, from rank 0's last checked step
        n = torch.tensor([seconds / step_s if rank == 0 else 0.0], device=device)
        dist.all_reduce(n, op=dist.ReduceOp.MAX)
        n_steps = max(1, round(float(n.item())))
        n_plain, n_prof = (max(1, n_steps // 2), traffic["trace_steps"]) if traced else (n_steps, 0)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        st, window_losses, t0, window_s, step_ms, profile = _window(
            rank, st, step, pool, n_check, n_plain, n_prof, device)
        wall_start = time.time() - (time.perf_counter() - t0)
        failed = sum(not math.isfinite(float(x)) for x in window_losses)
        peak = torch.tensor([torch.cuda.max_memory_allocated() if cuda else 0], device=device)
        dist.all_reduce(peak, op=dist.ReduceOp.MAX)
        batches = pool[:n_check]
        del st, step, model, tx, window_losses, pool
        _free(device)
        fault_numbers = None
        if readings:
            broken = _rank_setup(conf, traffic, seed, device, no_exchange, mesh)
            fault_numbers = broken[6:9]  # losses, first gradient norms, change
            del broken
            _free(device)
        ref = reference_block_steps(conf, batches, start, seed, rank, world, device)
        lows = (reference_block_steps(conf, batches, start, seed, rank, world, device,
                                      ref_model.Numerics(fake=ref_model.fp8_e4m3))
                if readings else None)
        gathered = [None] * world
        dist.all_gather_object(gathered, {"step_ms": step_ms, "forbidden": forbidden_modules()})
        if rank == 0:
            torch.save({"window_s": window_s, "wall_start": wall_start, "steps": n_plain + n_prof,
                        "failed": failed, "peak": int(peak.item()), "losses": losses,
                        "first": first, "change": change, "ref": ref, "low": lows,
                        "fault": fault_numbers, "profile": profile,
                        "step_ms": [g["step_ms"] for g in gathered],
                        "forbidden": sorted({m for g in gathered for m in g["forbidden"]})},
                       os.path.join(out_dir, "rank0.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(conf, traffic, limits, seed, seconds, traced=False, fault=None,
           readings=False) -> dict:
    import torch.multiprocessing as mp

    world = traffic["ranks"]
    if torch.cuda.is_available() and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} ranks need {world} cards; found {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory(prefix="portbench_dp_") as tmp:
        mp.start_processes(_rank, args=(world, _port(), tmp, conf, traffic, limits, seed,
                                        seconds, traced, fault, readings),
                           nprocs=world, join=True, start_method="spawn")
        r = torch.load(os.path.join(tmp, "rank0.pt"), weights_only=False)
    if r["forbidden"]:
        raise RuntimeError(f"a rank loaded modules of the reference package or of JAX: "
                           f"{r['forbidden']}")
    return r


def run(conf: dict, traffic: dict, limits: dict, seed: int, seconds: float, traced: bool,
        device, fault=None) -> dict:
    r = _spawn(conf, traffic, limits, seed, seconds, traced, fault)
    checks = single.compare(limits, r["losses"], r["first"], r["change"], r["ref"])
    B, S = traffic["batch"], traffic["frames"]
    Q = conf["model"]["decoder"]["num_quantizers"]
    # the window's start on this process's clock
    window_start = time.perf_counter() - (time.time() - r["wall_start"])
    return {"window_start": window_start, "window_s": r["window_s"], "steps": r["steps"],
            "failed": r["failed"], "attempted": r["steps"],
            "tokens": r["steps"] * B * traffic["ranks"] * S * Q, "peak_bytes": r["peak"],
            "profile": r["profile"], "step_ms": r["step_ms"], "checks": checks}


def step_spread(step_ms: list) -> list:
    """Each rank's window steps in device ms: [least, median, most]."""
    return [[min(ms), statistics.median(ms), max(ms)] if ms else None for ms in step_ms]


def readings(conf, traffic, limits, seed, seconds, device):
    """The sound system's compared numbers and, beside them on the same
    seed, the float8 reference's and the no-exchange fault's; the sound
    row also gives each rank's window steps (``step_spread``) and the
    window's tokens a second."""
    r = _spawn(conf, traffic, limits, seed, seconds, readings=True)
    B, S = traffic["batch"], traffic["frames"]
    Q = conf["model"]["decoder"]["num_quantizers"]
    rows = []
    for what, (losses, first, change) in (("program", (r["losses"], r["first"], r["change"])),
                                          ("control_fp8", r["low"]),
                                          ("fault_no_exchange", r["fault"])):
        c = single.compare(limits, losses, first, change, r["ref"])
        rows.append({"reading": what, **{k: (c[k]["value"] if isinstance(c[k], dict) else c[k])
                                         for k in ("loss_gap", "grad_gap", "change_median_gap",
                                                   "change_p90_gap", "change_component_gap")},
                     "grad_leaf": c["grad_gap"]["leaf"], "correct": c["pass"]})
    rows[0].update(step_ms=step_spread(r["step_ms"]), steps=r["steps"],
                   tokens_per_s=r["steps"] * B * traffic["ranks"] * S * Q / r["window_s"])
    return rows
