"""The benchmark's fixed arithmetic: the card's peaks, the operations and
bytes of the measured kernels and of the model, and the reductions from
device intervals and samples to numbers.

Each bound is a function of shapes alone.  The kernel bounds are frozen
copies of the ones the system's card smoke test used when the benchmark was
written (``chip_smoke.py``), named beside each, so that a later change to
the system cannot move them.
"""
from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
# (chip_smoke.py:211-212, :1151-1154)
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12  # f32 on the FMA pipe, outside the tensor cores
MUFU_EXPS_PER_S = 132 * 16 * 1.98e9  # 16 exps a clock per SM, 132 SMs, 1.98 GHz
SCAN_OPS = {"fwd": 6, "bwd": 24}  # FMA-pipe f32 operations per (b, t, d, n)
HEAD_DIM = 64


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# ---------------------------------------------------------------- kernels

def scan_bound_ms(kind: str, B: int, T: int, D: int, N: int, chunk: int = 64) -> float:
    """Least ms of one call of a scan wrapper (chip_smoke.py:1242
    ``_scan_bound``): the largest of every input and output once over the
    HBM rate, its FMA-pipe operations over the f32 rate, and one exp per
    (b, t, d, n) on the special-function units.  ``kind`` is ``fwd``,
    ``fwd_ckpt`` or ``bwd``."""
    nc = -(-T // chunk)
    io = B * T * D * (2 + 4) + 2 * B * T * N * 2 + D * N * 4 + D * 4
    nbytes = {"fwd": io + B * T * D * 2 + B * N * D * 4,
              "fwd_ckpt": io + B * T * D * 2 + B * N * D * 4 + B * nc * N * D * 4,
              "bwd": io - D * 4 + B * nc * N * D * 4 + B * T * D * 4 + B * N * D * 4
              + 2 * B * T * D * 4 + 2 * B * T * N * 4 + 2 * B * N * D * 4}[kind]
    elems = B * T * D * N
    return 1e3 * max(nbytes / HBM_BYTES_PER_S,
                     SCAN_OPS["bwd" if kind == "bwd" else "fwd"] * elems / F32_OPS_PER_S,
                     elems / MUFU_EXPS_PER_S)


def flash_flops(kind: str, B: int, H: int, Tq: int, Tk: int) -> int:
    """Operations the attention needs (chip_smoke.py:1395-1398): 2 products
    of B·H·Tq·Tk·64 multiply-adds forward, 5 backward (dS, dP, dQ, dK, dV
    less the recomputed S), two operations each."""
    mac = B * H * Tq * Tk * HEAD_DIM
    return {"fwd": 2 * 2 * mac, "bwd": 2 * 5 * mac}[kind]


def flash_bytes(kind: str, B: int, H: int, Tq: int, Tk: int) -> int:
    """Bytes each input read once and each output written once
    (chip_smoke.py:1397-1400), bf16 q/K/V/O/dO, f32 lse, a byte of mask a key."""
    io = 2 * (B * H * Tq * 64 + 2 * B * H * Tk * 64) + B * Tk
    if kind == "fwd":
        return io + 2 * B * H * Tq * 64 + 4 * B * H * Tq
    return io + 2 * 2 * B * H * Tq * 64 + 4 * B * H * Tq + 2 * (B * H * Tq * 64 + 2 * B * H * Tk * 64)


def flash_bound_ms(kind: str, B: int, H: int, Tq: int, Tk: int) -> float:
    return 1e3 * max(flash_flops(kind, B, H, Tq, Tk) / BF16_OPS_PER_S,
                     flash_bytes(kind, B, H, Tq, Tk) / HBM_BYTES_PER_S)


def decoder_dims(dec: dict) -> dict:
    """Sizes of the decoder from its configuration group."""
    d = dec["d_model"]
    m = dec.get("mamba", {})
    expand, N, dc = m.get("expand", 2), m.get("d_state", 16), m.get("d_conv", 4)
    r = m.get("dt_rank", 0) or -(-d // 16)
    V = dec["codebook_size"] + dec["num_special_tokens"]
    return {"L": dec["n_layers"], "d": d, "di": expand * d, "N": N, "dc": dc, "r": r,
            "dff": dec["d_ff"], "H": dec["n_heads"], "V": V, "Vpad": round_up(V, 128),
            "Q": dec["num_quantizers"]}


def decode_step_flops(dims: dict, B: int, memory_len: int, vocab: int) -> int:
    """Operations of one decode step (chip_smoke.py ``_step_ops``): the
    layer's projections (in, x, dt, out, q, o, the FFN), the attention
    products over ``memory_len`` keys and the vocabulary head, two per
    multiply-add."""
    d, di, r, N, dff = dims["d"], dims["di"], dims["r"], dims["N"], dims["dff"]
    per_layer = (d * 2 * di + di * (r + 2 * N) + r * di + di * d + 2 * d * d
                 + 2 * d * memory_len + 2 * d * dff)
    return 2 * B * (dims["L"] * per_layer + d * vocab)


def megakernel_bytes_once(dims: dict, B: int, memory_len: int, steps: int, wbytes: int = 2,
                          kvbytes: int = 2, grid: int = 128) -> int:
    """Bytes of one megakernel launch with every input read once and every
    output written once (``plan_resident_bytes`` of the system's
    ``ops/decode_megakernel.py`` as chip_smoke.py:801 used it for the
    kernel table's ``bound_ms``): the plan, K/V of the padded memory, the
    logits of every step, the states and the per-step rows."""
    L, d, di, N, r, dc, dff = (dims[k] for k in ("L", "d", "di", "N", "r", "dc", "dff"))
    Vpad, Tmp = dims["Vpad"], round_up(memory_len, 128)
    wb, kb = wbytes, kvbytes
    slices = next(ts for ts in (8, 4, 2, 1) if B * dims["H"] * ts <= grid or ts == 1)
    n = steps * d * 2 + Vpad * d * 2 + L * 6 * d * 4
    n += L * d * 2 * di * wb + L * 2 * di * 4 + L * dc * di * 2 + L * di * 4
    n += L * di * (r + 2 * N) * 2 + L * r * di * 2 + L * di * 4 + L * N * di * 4 + L * di * 4
    n += L * di * d * wb + L * d * 4 + L * d * d * wb + 2 * L * d * 4
    n += 2 * L * B * d * Tmp * kb + 2 * L * B * d * 4 + B * Tmp * 4
    n += L * d * d * wb + 2 * L * d * 4 + 2 * L * B * d * 4
    n += L * d * dff * wb + 2 * L * dff * 4 + L * dff * d * wb + 2 * L * d * 4
    n += 2 * d * 4 + d * Vpad * 2 + Vpad * 4
    n += steps * B * Vpad * 4
    n += L * (dc - 1) * B * di * 2 + L * B * N * di * 4
    n += B * (2 * d + di + dff) * 2 + grid // slices * B * (r + 2 * N) * 4 + 16
    return n


def megakernel_bound_ms(dims: dict, B: int, memory_len: int, steps: int) -> float:
    """Least ms of one bf16/bf16 launch: the larger of every input once over
    the HBM rate and the steps' operations (memory padded to 128 rows, the
    vocabulary to 128 columns) over the bf16 peak."""
    ops = steps * decode_step_flops(dims, B, round_up(memory_len, 128), dims["Vpad"])
    return 1e3 * max(megakernel_bytes_once(dims, B, memory_len, steps) / HBM_BYTES_PER_S,
                     ops / BF16_OPS_PER_S)


# ------------------------------------------------------------------ model

def train_step_flops(dims: dict, text: dict, B: int, Tq: int, Tk: int, Lt: int) -> int:
    """Model operations of one training step: 6 per multiply-add of every
    product with a weight (forward 2, backward 4), for the decoder's Tq
    tokens and the text encoder's Lt, plus the cross-attention's 7 products
    of B·H·Tq·Tk·64 a layer (2 forward, 5 backward), two operations each;
    nothing recomputed is counted."""
    d, di, r, N, dff = dims["d"], dims["di"], dims["r"], dims["N"], dims["dff"]
    per_token = (d * 2 * di + di * (r + 2 * N) + r * di + di * d + 2 * d * d
                 + 2 * d * dff) * dims["L"] + d * dims["V"]
    mem_kv = 2 * d * d * dims["L"] * B * Tk  # K and V of the memory, once a row
    td, tl, th = text["d_model"], text["n_layers"], text["n_heads"]
    text_tok = tl * (3 * td * th * text["d_k"] + th * text["d_v"] * td
                     + td * text["d_inner"] * text["conv_kernel"][0]
                     + text["d_inner"] * td * text["conv_kernel"][1])
    text_attn = tl * 2 * B * th * Lt * Lt * text["d_k"]
    mac = B * Tq * per_token + mem_kv + B * Lt * text_tok + text_attn
    attn = dims["L"] * 7 * B * dims["H"] * Tq * Tk * HEAD_DIM
    return 6 * mac + 2 * attn


# ------------------------------------------------------------- reductions

def union_seconds(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of [start, end) intervals, clipped to [lo, hi)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def percentile(values: Sequence[float], p: float) -> Tuple[float, int]:
    """(the p-th percentile by the nearest rank, the count of samples above
    it)."""
    v = sorted(values)
    k = max(1, math.ceil(p / 100.0 * len(v)))
    x = v[k - 1]
    return x, sum(1 for y in v if y > x)


def spread(values: Sequence[float]) -> float:
    """Interquartile range over the median, with Python's quartiles."""
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def leaf_gaps(prog: dict, ref: dict, keep: List[str]) -> dict:
    """Each leaf of ``keep``: |‖prog‖ - ‖ref‖| over max(‖ref‖ of the leaf,
    the median leaf's ‖ref‖)."""
    med = statistics.median(ref[k] for k in keep)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keep}


def leaf_gap(prog: dict, ref: dict, keep: List[str]) -> Tuple[float, str]:
    """The worst leaf's gap (:func:`leaf_gaps`) and its name."""
    gaps = leaf_gaps(prog, ref, keep)
    name = max(gaps, key=gaps.get)
    return gaps[name], name
