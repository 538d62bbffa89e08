"""Building blocks that reproduce Flax ``linen`` numerics in PyTorch.

Parameters are float32 (Flax's ``param_dtype``); each layer casts its inputs
and weights to its compute ``dtype`` and returns that dtype, as
``nn.Dense(dtype=...)``, ``nn.Conv(dtype=...)`` and ``nn.Embed(dtype=...)``
do.  ``LayerNorm`` computes its statistics in f32 with Flax's default
epsilon 1e-6 (torch's default is 1e-5) and casts afterwards.

``init_weights(generator)`` gives every layer a seeded random init in the
spirit of Flax's defaults (LeCun-normal kernels, zero biases, unit norm
scales); :func:`seed_init` walks a module tree and calls it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F


def normal_init(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=g) * std)


class Dense(nn.Linear):
    """``nn.Dense``: y = x @ W + b in ``dtype``.  ``weight`` is (out, in), the
    transpose of the Flax ``kernel``."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True, dtype=torch.float32):
        super().__init__(d_in, d_out, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)

    def init_weights(self, g: torch.Generator) -> None:
        normal_init(self.weight, 1.0 / math.sqrt(self.in_features), g)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class Conv(nn.Conv1d):
    """``nn.Conv`` over channels-first (B, C, T) input.  ``padding`` is
    ``"SAME"`` (Flax semantics, stride 1) or an explicit (left, right)."""

    def __init__(
        self, d_in: int, d_out: int, kernel: int, stride: int = 1, dilation: int = 1,
        padding: Union[str, Tuple[int, int]] = "SAME", dtype=torch.float32,
    ):
        super().__init__(d_in, d_out, kernel, stride=stride, dilation=dilation)
        if padding == "SAME":
            total = (kernel - 1) * dilation
            padding = (total // 2, total - total // 2)
        self.pads = tuple(padding)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        left, right = self.pads
        pad = left
        if left != right:
            x = F.pad(x, (left, right))
            pad = 0
        return F.conv1d(
            x.to(dt), self.weight.to(dt), self.bias.to(dt), self.stride, pad, self.dilation)

    def init_weights(self, g: torch.Generator) -> None:
        normal_init(self.weight, 1.0 / math.sqrt(self.in_channels * self.kernel_size[0]), g)
        nn.init.zeros_(self.bias)


class Embed(nn.Embedding):
    """``nn.Embed``: a row gather from the table cast to ``dtype``."""

    def __init__(self, num: int, d: int, dtype=torch.float32):
        super().__init__(num, d)
        self.dtype = dtype

    def forward(self, ids) -> torch.Tensor:
        return self.weight[ids].to(self.dtype)

    def init_weights(self, g: torch.Generator) -> None:
        normal_init(self.weight, 1.0 / math.sqrt(self.embedding_dim), g)


class LayerNorm(nn.Module):
    """``nn.LayerNorm``: f32 statistics, optional scale/bias, output cast to
    ``dtype`` (f32 when None)."""

    def __init__(self, d: int, eps: float = 1e-6, dtype: Optional[torch.dtype] = None,
                 affine: bool = True):
        super().__init__()
        self.d, self.eps, self.dtype = d, eps, dtype
        self.weight = nn.Parameter(torch.ones(d)) if affine else None
        self.bias = nn.Parameter(torch.zeros(d)) if affine else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.to(torch.float32), (self.d,), self.weight, self.bias, self.eps)
        return y.to(self.dtype or torch.float32)

    def init_weights(self, g: torch.Generator) -> None:
        if self.weight is not None:
            nn.init.ones_(self.weight)
            nn.init.zeros_(self.bias)


def seed_init(module: nn.Module, seed: int) -> nn.Module:
    """Seeded random init of every layer of ``module`` that defines
    ``init_weights`` (children before parents, so a parent's special init
    wins).  Deterministic across machines: draws come from a CPU
    generator."""
    g = torch.Generator().manual_seed(seed)
    for m in reversed(list(module.modules())):
        if hasattr(m, "init_weights"):
            m.init_weights(g)
    return module


def parse_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """Config dtype string ("bfloat16", "float32") -> ``torch.dtype``."""
    if isinstance(name, torch.dtype):
        return name
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]
