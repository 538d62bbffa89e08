"""Operations and bytes of the granite decoder
(``configs/granite-4.0-h-small-tts.json``, the system's ``models/granite.py``)
as functions of its configuration and of each row's prefix length, for the
per-layer metrics of its cell.

Operations count two a multiply-add with a weight (every layer's products,
the Mamba-2 conv's taps, the router, the tied head) and the attention's two
products (q·K and P·V over the valid keys).  Routed experts count at their
expectation on this card: ``top_k`` experts a token, of which a share
held / n_experts lies here (10 × 9/72 = 1.25 a token), whatever the step
computes beyond the routing (``MoE.step`` runs every held expert on every
row).  The SSD's recurrence and the elementwise work are not counted.

Bytes of a decode step count every parameter of the 40 layers once at the
dtype the system holds it in (matrices bf16, the router's f32; biases,
norms, A_log, D and dt_bias f32) and the tied head's f32 table, every held
expert once, every Mamba-2 layer's state (f32) and conv window (bf16) read
and written, and each row's valid K/V read once.
"""
from __future__ import annotations

from typing import Dict, Sequence

BF16, F32 = 2, 4


def dims(dec: dict) -> Dict[str, int]:
    """The sizes the counts read, from the configuration's decoder tree."""
    m, e = dec["mamba2"], dec["moe"]
    d = dec["d_model"]
    kinds = dec["layer_types"]
    n_e = e["n_experts"]
    held = min(n_e, e.get("first_expert", 0) + (e.get("experts_held") or n_e)) \
        - e.get("first_expert", 0)
    return {"d": d, "H2": m["n_heads"], "P": m["head_dim"], "N": m["d_state"],
            "k": m["d_conv"], "di": m["n_heads"] * m["head_dim"],
            "conv": m["n_heads"] * m["head_dim"] + 2 * m["n_groups"] * m["d_state"],
            "H": dec["n_heads"], "Hkv": dec.get("n_kv_heads") or dec["n_heads"],
            "hd": d // dec["n_heads"], "E": n_e, "top_k": e["top_k"], "held": held,
            "de": e["d_expert"], "ds": e["d_shared"],
            "V": dec["codebook_size"] + dec["num_special_tokens"],
            "n_attn": sum(k == "attention" for k in kinds),
            "n_mamba": sum(k == "mamba" for k in kinds), "n_layers": len(kinds)}


def mamba_macs(x: dict) -> int:
    """A token's multiply-adds with a weight in one Mamba-2 mixer: in_proj,
    the conv's taps, out_proj."""
    return x["d"] * (x["di"] + x["conv"] + x["H2"]) + x["k"] * x["conv"] + x["di"] * x["d"]


def attention_macs(x: dict) -> int:
    return 2 * x["d"] * x["H"] * x["hd"] + 2 * x["d"] * x["Hkv"] * x["hd"]


def moe_macs(x: dict) -> float:
    """A token's multiply-adds in one layer's MoE: the router, the routed
    experts at their expectation here, the shared MLP."""
    routed = x["top_k"] * x["held"] / x["E"]
    return x["d"] * x["E"] + routed * 3 * x["d"] * x["de"] + 3 * x["d"] * x["ds"]


def layer_macs(x: dict) -> float:
    """Multiply-adds with a weight of one token through every layer."""
    return (x["n_mamba"] * mamba_macs(x) + x["n_attn"] * attention_macs(x)
            + x["n_layers"] * moe_macs(x))


def prefill_flops(x: dict, lengths: Sequence[int]) -> float:
    """Operations of a prefill: each row's ``lengths[b]`` positions through
    every layer, causal attention over the positions up to each (the prefix
    projections, under 0.1% of it, are left out)."""
    return sum(2 * layer_macs(x) * n + x["n_attn"] * 2 * 2 * x["H"] * x["hd"] * n * (n + 1) // 2
               for n in lengths)


def decode_flops(x: dict, lengths: Sequence[int], steps: int) -> float:
    """Operations of ``steps`` decode steps from BOS over rows of prefix
    ``lengths``."""
    keys = sum(steps * n + steps * (steps + 1) // 2 for n in lengths)
    return (2 * (layer_macs(x) + x["V"] * x["d"]) * len(lengths) * steps
            + x["n_attn"] * 2 * 2 * x["H"] * x["hd"] * keys)


def expert_bytes(x: dict) -> int:
    """The held experts of every layer, once (bf16)."""
    return x["n_layers"] * x["held"] * BF16 * 3 * x["d"] * x["de"]


def weight_bytes(x: dict) -> int:
    """Every parameter outside the held experts at its held dtype, and the
    f32 head (the tied token table)."""
    d, di, conv, H2 = x["d"], x["di"], x["conv"], x["H2"]
    mamba = (BF16 * (d * (di + conv + H2) + x["k"] * conv + di * d)
             + F32 * (conv + 3 * H2 + di))  # conv bias, dt_bias, A_log, D, the gated norm
    attn = BF16 * attention_macs(x)
    moe = F32 * d * x["E"] + BF16 * 3 * d * x["ds"]
    norms = F32 * 2 * d
    return (x["n_mamba"] * mamba + x["n_attn"] * attn + x["n_layers"] * (moe + norms)
            + F32 * x["V"] * d)


def kv_bytes(x: dict, valid_keys: int) -> int:
    """The valid K and V of one attention layer, once (bf16)."""
    return 2 * BF16 * valid_keys * x["Hkv"] * x["hd"]


def state_bytes(x: dict, rows: int) -> int:
    """One Mamba-2 layer's state (f32) and conv window (bf16), read and
    written."""
    return rows * 2 * (F32 * x["H2"] * x["P"] * x["N"] + BF16 * (x["k"] - 1) * x["conv"])


def step_bytes(x: dict, rows: int, valid_keys: int) -> int:
    """Bytes of one decode step: the weights and the held experts once, the
    states read and written, the valid K/V of every attention layer."""
    return (weight_bytes(x) + expert_bytes(x) + x["n_mamba"] * state_bytes(x, rows)
            + x["n_attn"] * kv_bytes(x, valid_keys))


def mamba2_call_bytes(x: dict, rows: int) -> int:
    """Bytes of one call of the Mamba-2 state kernel: the state read and
    written (f32); x, z (bf16), B, C (bf16) and dt (bf16) read; dt_bias,
    A_log and D (f32) read; y · SiLU(z) written (f32)."""
    state = 2 * F32 * rows * x["H2"] * x["P"] * x["N"]
    acts = BF16 * rows * (2 * x["di"] + 2 * x["N"] + x["H2"]) + F32 * 3 * x["H2"]
    return state + acts + F32 * rows * x["di"]


def attention_call_bytes(x: dict, rows: int, valid_keys: int) -> int:
    """Bytes of one call of the grouped decode-attention kernel: the valid
    K/V once a K/V head (bf16), q read and the output written (bf16)."""
    return kv_bytes(x, valid_keys) + 2 * BF16 * rows * x["H"] * x["hd"]


def valid_keys(lengths: Sequence[int], step: int) -> int:
    """Valid keys over the rows at decode step ``step`` (from 0): each row's
    prefix, the steps before and this one's."""
    return sum(n + step + 1 for n in lengths)
