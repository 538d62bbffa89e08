"""The benchmark's seeded weights for the granite decoder
(``configs/granite-4.0-h-small-tts.json``), drawn on the device a tensor at
a time and copied into a module's parameters.

``weights.py``'s rules where they fit (LeCun-normal matrices and
embeddings, unit norms, zero biases, D = 1, the conv taps by their width);
three of its rules do not fit the block, and are drawn here:

- ``A_log`` is one value a head (H,): A uniform on [1, 16], Mamba-2's
  ``A_init_range``, and A_log = log(A) (``weights.py`` reads a per-channel
  (D, N) table);
- ``dt_bias`` (H,): dt log-uniform on [0.001, 0.1] with floor 1e-4
  through softplus's inverse, Mamba-2's init (``weights.py`` gives a 1-D
  bias 0);
- the stacked experts, ``input_linear`` (E, 2·d_expert, d) and
  ``output_linear`` (E, d, d_expert): LeCun-normal by each product's fan-in,
  the last size (``weights.py`` would take the product of the last two).

And one of its rules needs the block's ``embedding_multiplier``: the
layers' inputs (the token, position and quantizer tables and the prefix's
``style_proj`` and ``text_proj``) are drawn at ``weights.py``'s scale over
the multiplier, so that their sum times the multiplier has the scale
``weights.py`` gives a layers' input.  At ``weights.py``'s own scale the
input, times 12, outweighs what the 40 layers add to the residual (each
times 0.22), and the head, tied to the token table, puts the step's own
input token first by a wide margin: the decoder repeats one token a row
for ever, and the float32 reference and its float8 control agree with it
exactly, so that the comparison could tell nothing.

Each tensor is drawn from a generator seeded by the run's seed and the
tensor's name, so the same seed gives the same weights on any card, the
system and the reference get the same values by name, and no pool of all
8B draws is ever held.
"""
from __future__ import annotations

import math
import zlib
from typing import Tuple

import torch

from portbench import weights

A_MIN, A_MAX = 1.0, 16.0
STREAM = 0x9E3779B1
INPUTS = ("token_embed", "pos_embed", "quant_embed", "style_proj", "text_proj")


def rule(name: str, shape: Tuple[int, ...]):
    """(kind, value) as ``weights._rule`` gives it, or this block's own:
    ("a_head", None), ("dt_head", None), ("normal", std) for an expert
    stack."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "A_log" and len(shape) == 1:
        return "a_head", None
    if leaf == "dt_bias":
        return "dt_head", None
    if leaf in ("input_linear", "output_linear") and len(shape) == 3:
        return "normal", 1.0 / math.sqrt(shape[2])
    return weights._rule(name, shape)


def draw(name: str, shape: Tuple[int, ...], seed: int, device,
         embedding_multiplier: float = 1.0) -> torch.Tensor:
    """The f32 values of the decoder's parameter ``name`` (its full name,
    ``tts.decoder.`` first) for ``seed``; the layers' inputs at their scale
    over ``embedding_multiplier``."""
    kind, v = rule(name, shape)
    if kind == "normal" and name.split(".")[2] in INPUTS:
        v = v / embedding_multiplier
    g = torch.Generator(device=device).manual_seed(
        (int(seed) * STREAM + zlib.crc32(name.encode())) % 2 ** 63)
    if kind == "normal":
        return torch.randn(shape, generator=g, device=device) * v
    if kind == "uniform":
        return (torch.rand(shape, generator=g, device=device) * 2 - 1) * v
    if kind == "const":
        return torch.full(shape, float(v), device=device)
    if kind == "a_head":
        return torch.log(A_MIN + (A_MAX - A_MIN) * torch.rand(shape, generator=g, device=device))
    if kind == "dt_head":
        u = torch.rand(shape, generator=g, device=device)
        lo, hi = math.log(weights.DT_MIN), math.log(weights.DT_MAX)
        dt = torch.clamp(torch.exp(u * (hi - lo) + lo), min=weights.DT_FLOOR)
        return dt + torch.log(-torch.expm1(-dt))
    raise ValueError(f"{name}: no rule {kind!r} for the granite decoder")


@torch.no_grad()
def load_decoder(module: torch.nn.Module, seed: int, device, embedding_multiplier: float):
    """Draw every parameter of ``module`` (the system's decoder or the
    reference's, whose names are the same) and copy it in, rounded to the
    parameter's dtype."""
    for n, p in module.named_parameters():
        p.copy_(draw("tts.decoder." + n, tuple(p.shape), seed, device, embedding_multiplier))
