"""Cross-attention with a precomputed-K/V decode path — counterpart of
``mamba_tts_tpu/models/attention.py``.

The ``[ref || text]`` memory is fixed during decoding, so K/V are projected
once (:meth:`CrossAttention.project_memory`) and each step runs
:meth:`CrossAttention.attend` against them.

Mask convention: ``memory_mask`` is True for VALID positions; invalid keys
get an additive -1e9 before the softmax.

Long queries (Tq >= 128) are the teacher-forced/training case, which the JAX
package sends to a TPU flash-attention kernel.  On the card that case goes to
the Hopper flash kernels of ``ops/flash_attention.py`` (forward and backward).
One query with no gradient recorded, head size 64 and bf16 K/V, the decode
step, goes on the card to the kernel of ``ops/decode_attention.py``, which
reads the K/V in place (and raises for a layout it does not take); other
short queries, and CPU tensors at any length, take the plain materialized
softmax, as the JAX package does off the TPU.

With ``mesh`` the heads shard over the mesh's "model" axis: q/k/v
column-parallel with their biases, ``o_proj`` row-parallel, and the
attention (the flash kernels on the card) runs on H / tp local heads.

:class:`SelfAttention` is the jamba block's (``models/hybrid.py``): causal,
no positional encoding, no biases, ``n_kv_heads`` K/V heads each serving
``n_heads / n_kv_heads`` query heads (multi-query at one).  Its full
sequence runs ``scaled_dot_product_attention``; its decode step writes the
token's K/V into a static cache at each row's own position and attends over
the cache under the rows' valid-key mask through ``ops/decode_attention.py``
(the grouped kernel on the card, which raises for a layout it does not take).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mamba_tts_torch.device import on_card
from mamba_tts_torch.models.layers import Dense, row_parallel
from mamba_tts_torch.ops import decode_attention as one_query
from mamba_tts_torch.ops.flash_attention import (  # noqa: F401  (mask_bias: shared helper)
    flash_attention,
    flash_attention_ref,
    mask_bias,
)
from mamba_tts_torch.parallel.comm import copy_to_group
from mamba_tts_torch.parallel.mesh import model_group

FLASH_MIN_QUERIES = 128


class CrossAttention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, dtype=torch.bfloat16, mesh=None):
        super().__init__()
        assert d_model % n_heads == 0
        # q/k/v/o split on d_model where it divides (param_shardings); the
        # port splits whole heads
        self.tp_group, tp = model_group(mesh, d_model)
        if n_heads % tp:
            raise ValueError(f"{n_heads} heads do not divide into {tp} model ranks")
        self.head_dim = d_model // n_heads
        self.n_heads = n_heads // tp  # this rank's heads
        self.d_model = self.n_heads * self.head_dim  # this rank's width of q, k, v
        self.dtype = dtype
        self.q_proj = Dense(d_model, self.d_model, dtype=dtype)
        self.k_proj = Dense(d_model, self.d_model, dtype=dtype)
        self.v_proj = Dense(d_model, self.d_model, dtype=dtype)
        self.o_proj = Dense(self.d_model, d_model, dtype=dtype)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        return x.reshape(B, T, self.n_heads, self.head_dim).transpose(1, 2)

    def project_memory(self, memory: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """memory (B, Tm, d_model) -> K, V each (B, H, Tm, head_dim)."""
        memory = copy_to_group(memory, self.tp_group)
        return self._split(self.k_proj(memory)), self._split(self.v_proj(memory))

    def attend(self, x: torch.Tensor, K: torch.Tensor, V: torch.Tensor,
               memory_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, Tq, d_model) queries against precomputed K/V."""
        B, Tq, _ = x.shape
        q = self.q_proj(copy_to_group(x, self.tp_group))  # (B, Tq, H·hd)
        scale = self.head_dim ** -0.5
        records_grad = torch.is_grad_enabled() and (q.requires_grad or K.requires_grad
                                                    or V.requires_grad)
        if (Tq == 1 and on_card(x) and not records_grad and self.head_dim == one_query.HEAD_DIM
                and K.dtype == V.dtype == torch.bfloat16):
            out = one_query.decode_attention(q, K, V, memory_mask, scale)  # (B, 1, H·hd)
        else:
            q = self._split(q)  # (B, H, Tq, hd)
            if Tq >= FLASH_MIN_QUERIES and on_card(x):
                out = flash_attention(q, K, V, memory_mask, scale)
            else:
                out = flash_attention_ref(q, K, V, memory_mask, scale)
            out = out.transpose(1, 2).reshape(B, Tq, self.d_model)
        return row_parallel(self.o_proj, out, self.tp_group)

    def forward(self, x, memory, memory_mask=None):
        K, V = self.project_memory(memory)
        return self.attend(x, K, V, memory_mask)


class SelfAttention(nn.Module):
    """Causal grouped-query self-attention (``JambaAttention``,
    ``GraniteMoeHybridAttention``): q (H heads), k and v (H_kv heads) of
    ``d_model / H`` channels, scale ``scale`` (1/sqrt(head_dim) where None),
    no biases, no positional encoding."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int, dtype=torch.bfloat16,
                 scale: Optional[float] = None):
        super().__init__()
        if d_model % n_heads or n_heads % n_kv_heads:
            raise ValueError(f"{n_heads} heads of d_model {d_model} over {n_kv_heads} K/V heads")
        self.n_heads, self.n_kv_heads = n_heads, n_kv_heads
        self.head_dim = d_model // n_heads
        self.scale = self.head_dim ** -0.5 if scale is None else scale
        self.q_proj = Dense(d_model, n_heads * self.head_dim, bias=False, dtype=dtype)
        self.k_proj = Dense(d_model, n_kv_heads * self.head_dim, bias=False, dtype=dtype)
        self.v_proj = Dense(d_model, n_kv_heads * self.head_dim, bias=False, dtype=dtype)
        self.o_proj = Dense(n_heads * self.head_dim, d_model, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x (B, T, d) -> (out (B, T, d), K, V (B, T, H_kv, head_dim))."""
        B, T, _ = x.shape
        hd = self.head_dim
        q = self.q_proj(x).reshape(B, T, self.n_heads, hd).transpose(1, 2)
        k = self.k_proj(x).reshape(B, T, self.n_kv_heads, hd)
        v = self.v_proj(x).reshape(B, T, self.n_kv_heads, hd)
        out = F.scaled_dot_product_attention(q, k.transpose(1, 2), v.transpose(1, 2),
                                             is_causal=True, scale=self.scale, enable_gqa=True)
        return self.o_proj(out.transpose(1, 2).reshape(B, T, self.n_heads * hd)), k, v

    def step(self, x: torch.Tensor, K: torch.Tensor, V: torch.Tensor, mask: torch.Tensor,
             rows: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """One token x (B, 1, d): its K/V go into the caches K, V (B, Tc,
        H_kv, head_dim) at (rows, pos) and ``mask`` (B, Tc) marks them valid,
        in place; then its queries attend over every valid key."""
        B = x.shape[0]
        q = self.q_proj(x)  # (B, 1, H·hd)
        shape = (B, self.n_kv_heads, self.head_dim)
        K.index_put_((rows, pos), self.k_proj(x).reshape(shape).to(K.dtype))
        V.index_put_((rows, pos), self.v_proj(x).reshape(shape).to(V.dtype))
        mask.index_put_((rows, pos), torch.ones((), dtype=torch.bool, device=mask.device))
        out = one_query.decode_attention(q, K.transpose(1, 2), V.transpose(1, 2), mask,
                                         self.scale)
        return self.o_proj(out)
