"""The benchmark's own seeded weights, made on the device.

One rule per kind of parameter, by its name and shape: LeCun-normal
kernels (std 1 / sqrt(fan-in)), zero biases, unit norm scales and Snake
slopes, unit-normal codebooks, the Mamba block's S4D-real A and log-uniform
dt bias, and FACodec's kernels at half the LeCun scale (an assumed init:
at the full scale the untrained codec sits in tanh saturation).  Draws come
from one ``torch.Generator`` on the device in two large calls (one normal,
one uniform), in sorted name order, so the same seed gives the same weights
on any card.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

DT_MIN, DT_MAX, DT_FLOOR = 1e-3, 1e-1, 1e-4
CODEC_SCALE = 0.5


def _rule(name: str, shape: Tuple[int, ...]):
    """(kind, value): ("normal", std), ("uniform", half-width), ("const", v),
    ("a_log", None) or ("dt_bias", None)."""
    leaf = name.rsplit(".", 1)[-1]
    codec = name.startswith("codec.")
    scale = CODEC_SCALE if codec else 1.0
    if leaf == "A_log":
        return "a_log", None
    if leaf == "D" or leaf == "alpha":
        return "const", 1.0
    if leaf == "noise_scale":
        return "const", 0.1
    if leaf == "codebook":
        return "normal", 1.0
    if name.endswith("dt_proj.weight"):
        return "uniform", math.sqrt(3.0 / shape[1])
    if name.endswith("dt_proj.bias"):
        return "dt_bias", None
    if name.endswith("decoder.timbre_linear.bias"):
        return "film_bias", None
    if leaf == "conv_w":
        return "normal", 1.0 / math.sqrt(shape[0])
    if len(shape) <= 1:
        return "const", (1.0 if leaf == "weight" else 0.0)
    if name.endswith("up.weight"):  # transposed conv (in, out, k)
        return "normal", scale / math.sqrt(shape[0] * shape[2])
    return "normal", scale / math.sqrt(math.prod(shape[1:]))


def make(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """Weights for every name of ``shapes`` (prefixed by component: ``tts.``,
    ``bert.``, ``codec.``), f32 on ``device``."""
    names = sorted(shapes)
    rules = {n: _rule(n, tuple(shapes[n])) for n in names}
    count = {"normal": 0, "uniform": 0}
    for n in names:
        k = rules[n][0]
        numel = math.prod(shapes[n])
        if k in count:
            count[k] += numel
        elif k == "dt_bias":
            count["uniform"] += numel
    g = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    pools = {"normal": torch.randn(count["normal"], generator=g, device=device),
             "uniform": torch.rand(count["uniform"], generator=g, device=device)}
    at = {"normal": 0, "uniform": 0}

    def take(kind, numel):
        t = pools[kind][at[kind]:at[kind] + numel]
        at[kind] += numel
        return t

    out = {}
    for n in names:
        shape = tuple(shapes[n])
        numel = math.prod(shape)
        kind, v = rules[n]
        if kind == "normal":
            w = take("normal", numel).reshape(shape) * v
        elif kind == "uniform":
            w = (take("uniform", numel).reshape(shape) * 2 - 1) * v
        elif kind == "const":
            w = torch.full(shape, v, device=device)
        elif kind == "a_log":
            w = torch.log(torch.arange(1, shape[1] + 1, dtype=torch.float32, device=device)
                          ).expand(shape).contiguous()
        elif kind == "film_bias":
            w = torch.cat([torch.ones(shape[0] // 2, device=device),
                           torch.zeros(shape[0] - shape[0] // 2, device=device)])
        else:  # dt_bias: softplus(bias) log-uniform on [DT_MIN, DT_MAX]
            u = take("uniform", numel).reshape(shape)
            dt = torch.exp(u * (math.log(DT_MAX) - math.log(DT_MIN)) + math.log(DT_MIN))
            dt = torch.clamp(dt, min=DT_FLOOR)
            w = dt + torch.log(-torch.expm1(-dt))
        out[n] = w.float()
    return out


def split(weights: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    p = prefix + "."
    return {k[len(p):]: v for k, v in weights.items() if k.startswith(p)}


def load_into(module: torch.nn.Module, weights: Dict[str, torch.Tensor], strict: bool = True):
    """Copy ``weights`` into ``module``'s parameters by name (every
    parameter of the module must be given; extra names are refused when
    ``strict``)."""
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(weights))
    extra = sorted(set(weights) - set(params))
    if missing or (strict and extra):
        raise KeyError(f"weights do not fit the module: missing {missing[:5]}, extra {extra[:5]}")
    with torch.no_grad():
        for n, p in params.items():
            w = weights[n]
            if tuple(w.shape) != tuple(p.shape):
                raise ValueError(f"{n}: shape {tuple(w.shape)} for {tuple(p.shape)}")
            p.copy_(w)
