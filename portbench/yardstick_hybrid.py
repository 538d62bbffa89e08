"""Operations and bytes of the jamba decoder (``configs/jamba2-3b-tts.json``,
the system's ``models/hybrid.py``), as functions of its configuration and
of each row's prefix length, for the per-layer metrics of its cell.

Operations count two a multiply-add with a weight (every layer's products,
the Mamba conv's taps, the tied head) and the
attention's two products (q·K and P·V over the valid keys); the selective
scan's recurrence and the elementwise work are not counted.  Bytes of a
decode step count every parameter of the 28 layers once at the dtype the
system holds it in (matrices bf16; biases, norms, A_log and D f32) and the
tied head's f32 table, every Mamba layer's states read and written (SSM
f32, conv window bf16), and each row's valid K/V read once.
"""
from __future__ import annotations

from typing import Dict, Sequence

BF16, F32 = 2, 4


def dims(dec: dict) -> Dict[str, int]:
    """The sizes the counts read, from the configuration's decoder tree."""
    m = dec["mamba"]
    d = dec["d_model"]
    p, o = dec.get("attn_layer_period", 0), dec.get("attn_layer_offset", 0)
    n_attn = sum(1 for i in range(dec["n_layers"]) if p and i % p == o)
    return {"d": d, "di": m["expand"] * d, "N": m["d_state"], "k": m["d_conv"],
            "r": m["dt_rank"] or -(-d // 16), "H": dec["n_heads"],
            "Hkv": dec.get("n_kv_heads") or dec["n_heads"], "hd": d // dec["n_heads"],
            "ff": dec["d_ff"], "V": dec["codebook_size"] + dec["num_special_tokens"],
            "n_attn": n_attn, "n_mamba": dec["n_layers"] - n_attn}


def layer_macs(x: dict) -> int:
    """Multiply-adds with a weight of one token through every layer."""
    mamba = (x["d"] * 2 * x["di"] + x["k"] * x["di"] + x["di"] * (x["r"] + 2 * x["N"])
             + x["r"] * x["di"] + x["di"] * x["d"])
    attn = 2 * x["d"] * x["H"] * x["hd"] + 2 * x["d"] * x["Hkv"] * x["hd"]
    mlp = 3 * x["d"] * x["ff"]
    return x["n_mamba"] * (mamba + mlp) + x["n_attn"] * (attn + mlp)


def prefill_flops(x: dict, lengths: Sequence[int]) -> int:
    """Operations of a prefill: each row's ``lengths[b]`` positions through
    every layer, causal attention over the positions up to each (the prefix
    projections, under 0.1% of it, are left out)."""
    return sum(2 * layer_macs(x) * n + x["n_attn"] * 2 * 2 * x["H"] * x["hd"] * n * (n + 1) // 2
               for n in lengths)


def weight_bytes(x: dict) -> int:
    """Every parameter of the layers at its held dtype, and the f32 head."""
    d, di, N, r, k = x["d"], x["di"], x["N"], x["r"], x["k"]
    mamba = (BF16 * (d * 2 * di + k * di + di * (r + 2 * N) + r * di + di * d)
             + F32 * (di + di + di * N + di + r + 2 * N))  # conv_b, dt bias, A_log, D, norms
    attn = BF16 * (2 * d * x["H"] * x["hd"] + 2 * d * x["Hkv"] * x["hd"])
    mlp = BF16 * 3 * d * x["ff"]
    norms = F32 * 2 * d
    return (x["n_mamba"] * (mamba + mlp + norms) + x["n_attn"] * (attn + mlp + norms)
            + F32 * x["V"] * d)


def kv_bytes(x: dict, valid_keys: int) -> int:
    """The valid K and V of one attention layer, once (bf16)."""
    return 2 * BF16 * valid_keys * x["Hkv"] * x["hd"]


def step_bytes(x: dict, rows: int, valid_keys: int) -> int:
    """Bytes of one decode step: weights, the states read and written, the
    valid K/V of every attention layer."""
    states = x["n_mamba"] * rows * 2 * (F32 * x["N"] * x["di"] + BF16 * (x["k"] - 1) * x["di"])
    return weight_bytes(x) + states + x["n_attn"] * kv_bytes(x, valid_keys)


def attention_call_bytes(x: dict, rows: int, valid_keys: int) -> int:
    """Bytes of one call of the grouped decode-attention kernel: the valid
    K/V once a K/V head, q read and the output written (bf16)."""
    return kv_bytes(x, valid_keys) + 2 * BF16 * rows * x["H"] * x["hd"]


def valid_keys(lengths: Sequence[int], step: int) -> int:
    """Valid keys over the rows at decode step ``step`` (from 0): each row's
    prefix, the steps before and this one's."""
    return sum(n + step + 1 for n in lengths)


def decode_flops(x: dict, lengths: Sequence[int], steps: int) -> int:
    """Operations of ``steps`` decode steps from BOS over rows of prefix
    ``lengths``."""
    keys = sum(steps * n + steps * (steps + 1) // 2 for n in lengths)
    return (2 * (layer_macs(x) + x["V"] * x["d"]) * len(lengths) * steps
            + x["n_attn"] * 2 * 2 * x["H"] * x["hd"] * keys)
