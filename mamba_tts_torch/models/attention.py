"""Cross-attention with a precomputed-K/V decode path — counterpart of
``mamba_tts_tpu/models/attention.py``.

The ``[ref || text]`` memory is fixed during decoding, so K/V are projected
once (:meth:`CrossAttention.project_memory`) and each step runs
:meth:`CrossAttention.attend` against them.

Mask convention: ``memory_mask`` is True for VALID positions; invalid keys
get an additive -1e9 before the softmax.

Long queries (Tq >= 128) are the teacher-forced/training case, which the JAX
package sends to a TPU flash-attention kernel.  On the card that case goes to
the Hopper flash kernels of ``ops/flash_attention.py`` (forward and backward);
shorter queries, as in the decode step, and CPU tensors at any length take
the plain materialized softmax, as the JAX package does off the TPU.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from mamba_tts_torch.device import on_card
from mamba_tts_torch.models.layers import Dense
from mamba_tts_torch.ops.flash_attention import (  # noqa: F401  (mask_bias: shared helper)
    flash_attention,
    flash_attention_ref,
    mask_bias,
)

FLASH_MIN_QUERIES = 128


class CrossAttention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, dtype=torch.bfloat16):
        super().__init__()
        assert d_model % n_heads == 0
        self.d_model, self.n_heads = d_model, n_heads
        self.head_dim = d_model // n_heads
        self.dtype = dtype
        self.q_proj = Dense(d_model, d_model, dtype=dtype)
        self.k_proj = Dense(d_model, d_model, dtype=dtype)
        self.v_proj = Dense(d_model, d_model, dtype=dtype)
        self.o_proj = Dense(d_model, d_model, dtype=dtype)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        return x.reshape(B, T, self.n_heads, self.head_dim).transpose(1, 2)

    def project_memory(self, memory: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """memory (B, Tm, d_model) -> K, V each (B, H, Tm, head_dim)."""
        return self._split(self.k_proj(memory)), self._split(self.v_proj(memory))

    def attend(self, x: torch.Tensor, K: torch.Tensor, V: torch.Tensor,
               memory_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, Tq, d_model) queries against precomputed K/V."""
        B, Tq, _ = x.shape
        q = self._split(self.q_proj(x))  # (B, H, Tq, hd)
        scale = self.head_dim ** -0.5
        if Tq >= FLASH_MIN_QUERIES and on_card(x):
            out = flash_attention(q, K, V, memory_mask, scale)
        else:
            out = flash_attention_ref(q, K, V, memory_mask, scale)
        out = out.transpose(1, 2).reshape(B, Tq, self.d_model)
        return self.o_proj(out)

    def forward(self, x, memory, memory_mask=None):
        K, V = self.project_memory(memory)
        return self.attend(x, K, V, memory_mask)
