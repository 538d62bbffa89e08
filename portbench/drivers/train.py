"""Training cells: the system's train step (``train.train.make_train_step``:
the model's losses, backward, global-norm clipping and Adam, as the train
CLI runs it) over a pool of preprocessed batches, cycled.

Set-up builds the one train state, drives it through its first steps on
distinct batches (the checked steps, which also warm every shape), keeps
what the comparison needs, and hands the same state to the window.  After
the window the plain reference takes the same first steps from the same
weights and batches, with the same dropout and noise draws.
"""
from __future__ import annotations

import gc
import json
import math
import statistics
import time
from typing import Dict

import torch

from portbench import generator, trace, weights
from portbench.reference import model as ref_model
from portbench.reference.config import from_json as ref_config
from portbench.yardstick import leaf_gap, leaf_gaps

# the system's per-step generator seed: (seed * mix + step) mod 2^63, the
# draws of dropout, noise and the style sample (train/train.py step_generator)
SEED_MIX = 0x9E3779B97F4A7C15
# a leaf whose first reference gradient is under this share of the median
# leaf's moves by round-off alone under Adam, and is left out of the change
STILL_LEAF = 1e-3


def step_generator(seed: int, step: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((seed * SEED_MIX + step) % 2 ** 63)


def to_device(batch, device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        t = t.float() if t.dtype.is_floating_point else (t if t.dtype == torch.bool else t.long())
        out[k] = t.to(device)
    return out


def setup(conf: dict, traffic: dict, seed: int, device, fault=None):
    """The system's train state with the benchmark's weights, driven through
    the checked steps.  Returns (model, tx, state, step, pool, weights
    before the first step on the host, the checked steps' losses, the first
    gradient's norm by leaf as the optimizer holds it, the change of each
    leaf over the checked steps).  ``fault(model, tx, step) -> step``
    breaks the step (the benchmark's own tests and its control runs)."""
    from mamba_tts_torch.config import from_json
    from mamba_tts_torch.models.tts import MambaTTS
    from mamba_tts_torch.train import state as state_lib
    from mamba_tts_torch.train.train import make_train_step

    cfg = from_json(json.dumps(conf["model"]))
    with torch.device(device):
        model = MambaTTS(cfg)
    shapes = {f"tts.{n}": tuple(p.shape) for n, p in model.named_parameters()}
    w = weights.split(weights.make(shapes, seed, device), "tts")
    weights.load_into(model, w)
    start = {k: v.cpu() for k, v in w.items()}
    del w
    tx = state_lib.make_optimizer(cfg.train.lr, cfg.train.grad_clip_norm)
    st = state_lib.create_train_state(dict(model.named_parameters()), tx)
    step = make_train_step(model, tx, seed=seed)
    if fault is not None:
        step = fault(model, tx, step)
    pool = [to_device(b, device)
            for b in generator.for_traffic(traffic).train_batches(traffic, seed, conf["model"])]
    losses, first = [], None
    for i in range(traffic["checked_steps"]):
        st, out = step(st, pool[i])
        losses.append({k: float(v) for k, v in out.items()})
        if i == 0:  # Adam's first moment after one step is (1 - b1) g
            mu = st.opt_state["mu"]
            with torch.no_grad():
                first = {n: float(v) / (1 - tx.b1)
                         for n, v in zip(mu, torch._foreach_norm(list(mu.values())))}
    with torch.no_grad():
        change = {n: float((p.detach().cpu() - start[n]).norm()) for n, p in st.params.items()}
    return model, tx, st, step, pool, start, losses, first, change


def run(conf: dict, traffic: dict, limits: dict, seed: int, seconds: float, traced: bool,
        device, fault=None) -> dict:
    model, tx, st, step, pool, start, losses, first, change = setup(conf, traffic, seed,
                                                                     device, fault)
    n_check = traffic["checked_steps"]
    trace.sync(device)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    # traced: the first half of the window runs before any profiler session
    # of the process (whose host cost outlasts it) and gives the plain step
    # time; then the profiler opens over ``trace_steps`` steps
    prof, plain, launches, first_traced = None, None, None, None
    n_prof = traffic["trace_steps"] if traced else 0
    counters = _counters()
    steps, window_losses = 0, []
    t0 = time.perf_counter()
    while True:  # no read-back a step: the host enqueues ahead of the device
        if traced and plain is None and steps >= n_check and \
                time.perf_counter() - t0 >= seconds / 2:
            trace.sync(device)
            plain = {"steps": steps, "seconds": time.perf_counter() - t0}
            trace.warm_profiler(device)
            prof, first_traced = trace.Profile(device), steps
            launches0 = {k: f.launches for k, f in counters.items()}
            prof.start()
        with torch.profiler.record_function("portbench.train_step"):
            st, out = step(st, pool[(n_check + steps) % len(pool)])
        window_losses.append(out["loss_total"])
        steps += 1
        if prof is not None and launches is None and steps - first_traced == n_prof:
            prof.stop()
            launches = {k: f.launches - launches0[k] for k, f in counters.items()}
        if time.perf_counter() - t0 >= seconds and (not traced or launches is not None):
            break
    trace.sync(device)
    window_s = time.perf_counter() - t0
    failed = sum(not math.isfinite(float(x)) for x in window_losses)
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    profile = None
    if prof is not None:
        kernels, win, pspans = prof.read()
        profile = {"kernels": kernels, "window": win, "spans": pspans, "steps": n_prof,
                   "launches": launches, "unprofiled_steps": plain["steps"],
                   "unprofiled_s": plain["seconds"]}
        del prof
    del st, step, model, tx, out, window_losses, pool[n_check:]
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    checks = check(conf, traffic, limits, seed, pool[:n_check], start, losses, first, change,
                   device)
    B, S, Q = traffic["batch"], traffic["frames"], conf["model"]["decoder"]["num_quantizers"]
    return {"window_start": t0, "window_s": window_s, "steps": steps, "failed": failed,
            "attempted": steps, "tokens": steps * B * S * Q, "peak_bytes": peak,
            "profile": profile, "checks": checks}


def _counters():
    """The system's launch counters of its training kernels (wrapper
    functions with a ``launches`` attribute)."""
    from mamba_tts_torch.ops import flash_attention as fa
    from mamba_tts_torch.ops import pallas_scan as ps

    return {"scan_fwd": ps.selective_scan_fwd, "scan_fwd_ckpt": ps.selective_scan_fwd_ckpt,
            "scan_bwd": ps.selective_scan_bwd, "flash_fwd": fa.flash_attention_fwd,
            "flash_bwd": fa.flash_attention_bwd}


def reference_steps(conf, batches, start, seed, device, num=None):
    """The plain reference's first steps from the same weights: (losses,
    first clipped gradient norms by leaf, change of each leaf)."""
    cfg = ref_config(json.dumps(conf["model"]))
    with torch.device(device):
        m = ref_model.MambaTTS(cfg, num)
    weights.load_into(m, {k: v for k, v in start.items() if not k.startswith("style_pipe.")})
    gens = [step_generator(seed, i, device) for i in range(len(batches))]
    losses, first, before = ref_model.adam_steps(m, batches, gens, cfg.train.lr,
                                                 cfg.train.grad_clip_norm)
    with torch.no_grad():
        g1 = {n: float(t.norm()) for n, t in first.items()}
        change = {n: float((p - before[n]).norm()) for n, p in m.named_parameters()}
    del m, first, before
    return losses, g1, change


def check(conf, traffic, limits, seed, batches, start, losses, first, change, device) -> dict:
    return compare(limits, losses, first, change,
                   reference_steps(conf, batches, start, seed, device))


def compare(limits, losses, first, change, ref) -> dict:
    """Each checked step's total loss and the first gradient by its worst
    leaf, and the change over the checked steps of the median leaf, of the
    leaf at the 90th percentile and of the worst component's median leaf,
    against the
    reference's (losses, first gradient norms, changes) ``ref``.  The
    worst leaf's change is read beside, not compared: Adam moves an element
    whose gradient is near nought by its sign, which rounding can flip, so
    the worst leaf's change swings from seed to seed.  Every number that
    ``limits`` names is held to its limit; the others are read beside."""
    rl, rg, rc = ref
    loss = max(abs(a["loss_total"] - b["loss_total"]) / abs(b["loss_total"])
               for a, b in zip(losses, rl))
    leaves = sorted(rg)
    med = statistics.median(rg.values())
    moving = [k for k in leaves if rg[k] >= STILL_LEAF * med]
    grad, grad_leaf = leaf_gap(first, rg, leaves)
    changes = leaf_gaps(change, rc, moving)
    worst = max(changes, key=changes.get)
    ranked = sorted(changes.values())
    numbers = {"loss_gap": loss, "grad_gap": grad,
               "change_median_gap": statistics.median(ranked),
               # the leaf at the 90th percentile (nearest rank): a fault in
               # more than a tenth of the leaves moves it
               "change_p90_gap": ranked[math.ceil(0.9 * len(ranked)) - 1],
               # the worst component's median leaf: a fault in one
               # component (decoder, text encoder, SMSD, duration predictor)
               "change_component_gap": max(
                   statistics.median(v for k, v in changes.items() if k.split(".")[0] == c)
                   for c in {k.split(".")[0] for k in changes})}
    out = {k: {"value": v, "limit": limits[k]} if k in limits else v
           for k, v in numbers.items()}
    out["grad_gap"] = {"value": grad, "limit": limits["grad_gap"], "leaf": grad_leaf}
    out.update(change_worst={"gap": changes[worst], "leaf": worst},
               still_leaves=len(leaves) - len(moving),
               losses=[x["loss_total"] for x in losses],
               reference_losses=[x["loss_total"] for x in rl])
    out["pass"] = all(math.isfinite(numbers[k]) and numbers[k] <= v for k, v in limits.items())
    return out


def half_batch(model, tx, step):
    """The fault: the step's losses over half of each batch (the mean over
    the rest)."""
    orig = model.compute_losses

    def losses(batch, **kw):
        B = batch["phoneme_ids"].shape[0]
        return orig({k: v[:B // 2] for k, v in batch.items()}, **kw)

    model.compute_losses = losses
    return step


def readings(conf, traffic, limits, seed, seconds, device):
    """The sound system's compared numbers, and beside them on the same seed
    the float8 reference's and the half-batch fault's."""
    rows = []

    def program(fault=None):
        model, tx, st, step, pool, start, losses, first, change = setup(
            conf, traffic, seed, device, fault)
        del model, tx, st, step
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        return pool[:traffic["checked_steps"]], start, (losses, first, change)

    batches, start, sound = program()
    ref = reference_steps(conf, batches, start, seed, device)
    low = reference_steps(conf, batches, start, seed, device,
                          ref_model.Numerics(fake=ref_model.fp8_e4m3))
    _, _, half = program(half_batch)
    for what, (losses, first, change) in (("program", sound), ("control_fp8", low),
                                          ("fault_half_batch", half)):
        c = compare(limits, losses, first, change, ref)
        rows.append({"reading": what, **{k: (c[k]["value"] if isinstance(c[k], dict) else c[k])
                                         for k in ("loss_gap", "grad_gap", "change_median_gap",
                                                   "change_p90_gap", "change_component_gap")},
                     "grad_leaf": c["grad_gap"]["leaf"], "change_worst": c["change_worst"],
                     "correct": c["pass"]})
    return rows
