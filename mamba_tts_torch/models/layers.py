"""Building blocks that reproduce Flax ``linen`` numerics in PyTorch.

Parameters are float32 (Flax's ``param_dtype``); each layer casts its inputs
and weights to its compute ``dtype`` and returns that dtype, as
``nn.Dense(dtype=...)``, ``nn.Conv(dtype=...)`` and ``nn.Embed(dtype=...)``
do.  ``LayerNorm`` computes its statistics in f32 with Flax's default
epsilon 1e-6 (torch's default is 1e-5) and casts afterwards.  A module that
is served may hold its ``Dense`` weights and biases in their compute dtype
instead (:func:`hold_in_compute_dtype`), which leaves every product as it
was and casts nothing.

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

from mamba_tts_torch.parallel.comm import reduce_from_group


def normal_init(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=g) * std)


class Executions:
    """A count of executions, kept as a kernel wrapper keeps its
    ``launches``, so that ``models/decoder.py`` ``run_step_decode`` counts
    a captured graph's replays of them too."""

    def __init__(self):
        self.launches = 0


dense_products = Executions()  # every Dense product, row_parallel's included
dense_casts = Executions()  # those that cast their weight or bias to the compute dtype


def count_product(weight: torch.Tensor, bias: Optional[torch.Tensor], dtype) -> None:
    """Count one product with a weight (``dense_products``), and one cast
    (``dense_casts``) where its weight or bias is wider than ``dtype``."""
    dense_products.launches += 1
    if weight.dtype != dtype or (bias is not None and bias.dtype != dtype):
        dense_casts.launches += 1


class Dense(nn.Linear):
    """``nn.Dense``: y = x @ W + b in ``dtype``.  ``weight`` is (out, in), the
    transpose of the Flax ``kernel``.  A weight or bias wider than ``dtype``
    is cast on every call (``dense_casts`` counts those products);
    :func:`hold_in_compute_dtype` stores them in ``dtype`` once."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True, dtype=torch.float32):
        super().__init__(d_in, d_out, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        count_product(self.weight, self.bias, dt)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)

    def init_weights(self, g: torch.Generator) -> None:
        normal_init(self.weight, 1.0 / math.sqrt(self.in_features), g)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


def row_parallel(dense: Dense, x: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel ``Dense`` over a tensor-parallel ``group``: each rank
    holds the rows of the kernel for its slice of the input features, the
    partial products are summed over the group in f32, the bias (replicated)
    is added once, and the result is rounded to the compute dtype.  The plain
    ``Dense`` without a group."""
    if group is None:
        return dense(x)
    count_product(dense.weight, None, dense.dtype)
    y = reduce_from_group(F.linear(x.to(dense.dtype), dense.weight.to(dense.dtype)).float(),
                          group)
    if dense.bias is not None:
        y = y + dense.bias
    return y.to(dense.dtype)


@torch.no_grad()
def hold_in_compute_dtype(module: nn.Module) -> None:
    """Store each ``Dense`` weight and bias of ``module`` that is wider than
    its layer's compute dtype in that dtype, once, and release the wider
    storage.  These are the values ``Dense.forward`` rounds them to before
    every product, so every product is unchanged bit for bit and casts
    nothing.  For a module that is served, not trained: the optimizer
    updates the float32 parameters."""
    for m in module.modules():
        if isinstance(m, Dense):
            for p in (m.weight, m.bias):
                if p is not None and torch.finfo(p.dtype).bits > torch.finfo(m.dtype).bits:
                    p.data = p.data.to(m.dtype)


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


class Conv2d(nn.Conv2d):
    """2-D ``nn.Conv`` with Flax's ``"SAME"`` padding over channels-first
    (B, C, H, W) input.  At stride s an axis of size n pads
    ``max((ceil(n / s) - 1) * s + k - n, 0)`` in all, ``total // 2`` on the
    low side (``torch.nn.Conv2d(padding="same")`` refuses stride > 1).  The
    Flax kernel (kh, kw, in, out) is ``weight`` (out, in, kh, kw)."""

    def __init__(self, d_in: int, d_out: int, kernel: Tuple[int, int],
                 stride: Tuple[int, int] = (1, 1)):
        super().__init__(d_in, d_out, kernel, stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for n, k, s in reversed(list(zip(x.shape[2:], self.kernel_size, self.stride))):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads += [total // 2, total - total // 2]
        return F.conv2d(F.pad(x, pads), self.weight, self.bias, self.stride)

    def init_weights(self, g: torch.Generator) -> None:
        kh, kw = self.kernel_size
        normal_init(self.weight, 1.0 / math.sqrt(self.in_channels * kh * kw), g)
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


class RMSNorm(nn.Module):
    """RMSNorm (``JambaRMSNorm``): ``x / sqrt(mean(x^2) + eps) * weight`` in
    f32, output cast to ``dtype`` (f32 when None)."""

    def __init__(self, d: int, eps: float = 1e-6, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.d, self.eps, self.dtype = d, eps, dtype
        self.weight = nn.Parameter(torch.ones(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.rms_norm(x.to(torch.float32), (self.d,), self.weight, self.eps)
        return y.to(self.dtype or torch.float32)

    def init_weights(self, g: torch.Generator) -> None:
        nn.init.ones_(self.weight)


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """``nn.Dropout``: keep each element with probability ``1 - rate`` and
    scale the kept ones by ``1 / (1 - rate)``, in ``x``'s dtype.  The mask
    is drawn from ``generator`` (on ``x``'s device); ``F.dropout`` takes no
    generator, so training randomness stays explicit."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


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
