"""Style conditioning pipeline, the NAR style branch — counterpart of
``mamba_tts_tpu/models/style.py``.

    z_style --StyleProjection--> single-token style K, V
    text ⊗ style (Cross-Attention #1) --length_regulate--> frames
    frames ⊗ style (Cross-Attention #2, the same style K/V)

:func:`length_regulate` is a vectorised gather: output frame j belongs to
the first phoneme whose cumulative duration exceeds j (a batched
``searchsorted``), so the output has a fixed length.

Numerics follow the Flax modules: each ``Dense`` rounds its output to the
compute dtype, LayerNorm takes Flax's epsilon 1e-6, the attention softmax
runs in f32 and is cast to V's dtype, GELU is the exact erf form.  Dropout
draws from the given ``torch.Generator``.  Mask convention: True = valid.

With ``mesh`` each cross-attention block shards its heads (q/k/v column-,
``o_proj`` row-parallel) and its FFN (``ffn1`` column-, ``ffn2``
row-parallel) over the mesh's "model" axis, as the JAX rules place them.
Dropout on a sharded activation (after ``ffn1``) draws from
``shard_generator``, one stream per model rank; every other draw is
replicated.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mamba_tts_torch.config import StylePipelineConfig
from mamba_tts_torch.models.layers import Dense, LayerNorm, dropout, parse_dtype, row_parallel
from mamba_tts_torch.parallel.comm import copy_to_group
from mamba_tts_torch.parallel.mesh import model_group


class StyleProjection(nn.Module):
    """(B, d_style) -> single-token K, V each (B, 1, d_model)."""

    def __init__(self, cfg: StylePipelineConfig):
        super().__init__()
        c = self.cfg = cfg
        dt = parse_dtype(c.dtype)
        self.key_dense = Dense(c.d_style, c.d_model, dtype=dt)
        self.key_ln = LayerNorm(c.d_model, dtype=dt)
        self.value_dense = Dense(c.d_style, c.d_model, dtype=dt)
        self.value_ln = LayerNorm(c.d_model, dtype=dt)

    def forward(self, style_emb: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        def proj(dense, ln):
            h = dropout(ln(dense(style_emb)), self.cfg.dropout, deterministic, generator)
            return h[:, None, :]

        return proj(self.key_dense, self.key_ln), proj(self.value_dense, self.value_ln)


class StyleCrossAttnBlock(nn.Module):
    """MHA(query = x, key/value = the style token) + residual and LN, then a
    4x FFN + residual and LN: Cross-Attention #1 and #2."""

    def __init__(self, cfg: StylePipelineConfig, mesh=None):
        super().__init__()
        c = self.cfg = cfg
        dt = parse_dtype(c.dtype)
        d = c.d_model
        # q/k/v/o split on d, ffn1/ffn2 on 4d, each where it divides
        # (param_shardings); the port splits whole heads
        self.tp_group, tp = model_group(mesh, d)
        if c.num_heads % tp:
            raise ValueError(f"{c.num_heads} heads do not divide into {tp} model ranks")
        self.ffn_group, tp_ffn = model_group(mesh, 4 * d)
        self.heads = c.num_heads // tp  # this rank's heads
        dl = d // tp
        self.q_proj = Dense(d, dl, dtype=dt)
        self.k_proj = Dense(d, dl, dtype=dt)
        self.v_proj = Dense(d, dl, dtype=dt)
        self.o_proj = Dense(dl, d, dtype=dt)
        self.attn_ln = LayerNorm(d, dtype=dt)
        self.ffn1 = Dense(d, 4 * d // tp_ffn, dtype=dt)
        self.ffn2 = Dense(4 * d // tp_ffn, d, dtype=dt)
        self.ffn_ln = LayerNorm(d, dtype=dt)

    def forward(self, x: torch.Tensor, style_K: torch.Tensor, style_V: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                shard_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        c = self.cfg
        g = self.tp_group
        B, T, _ = x.shape
        H = self.heads
        hd = c.d_model // c.num_heads
        xs = copy_to_group(x, g)
        q = self.q_proj(xs).reshape(B, T, H, hd)
        k = self.k_proj(copy_to_group(style_K, g)).reshape(B, -1, H, hd)
        v = self.v_proj(copy_to_group(style_V, g)).reshape(B, -1, H, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        probs = torch.softmax(logits / math.sqrt(hd), dim=-1).to(v.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, H * hd)
        attn = dropout(row_parallel(self.o_proj, attn, g), c.dropout, deterministic, generator)
        x = self.attn_ln(x + attn)
        gf = self.ffn_group
        h = dropout(F.gelu(self.ffn1(copy_to_group(x, gf)), approximate="none"), c.dropout,
                    deterministic, generator if gf is None else shard_generator or generator)
        h = dropout(row_parallel(self.ffn2, h, gf), c.dropout, deterministic, generator)
        return self.ffn_ln(x + h)


def length_regulate(hidden: torch.Tensor, durations: torch.Tensor, max_len: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Repeat each phoneme ``round(duration)`` times (half to even, negatives
    as 0): hidden (B, T, D), durations (B, T) -> (expanded (B, max_len, D),
    output_lengths (B,) int32).  Frames past a row's total are zero; the
    total is reported unclipped."""
    dur = torch.clamp(torch.round(durations.to(torch.float32)), min=0.0).to(torch.int32)
    ends = torch.cumsum(dur, dim=1, dtype=torch.int32)
    output_lengths = ends[:, -1]
    B, T, D = hidden.shape
    positions = torch.arange(max_len, dtype=torch.int32, device=hidden.device)
    # the phoneme owning each output frame: the first t with end_t > j
    idx = torch.searchsorted(ends.contiguous(), positions.expand(B, max_len).contiguous(),
                             right=True)
    idx = torch.clamp(idx, max=T - 1)
    expanded = torch.gather(hidden, 1, idx[..., None].expand(B, max_len, D))
    valid = positions[None, :] < output_lengths[:, None]
    return expanded * valid[..., None].to(expanded.dtype), output_lengths


class StyleConditioningPipeline(nn.Module):
    """project -> Cross-Attention #1 -> length-regulate -> Cross-Attention #2.
    Returns (styled_frames, output_lengths, style_K, style_V)."""

    def __init__(self, cfg: StylePipelineConfig, mesh=None):
        super().__init__()
        self.style_proj = StyleProjection(cfg)
        self.cross_attn_1 = StyleCrossAttnBlock(cfg, mesh)
        self.cross_attn_2 = StyleCrossAttnBlock(cfg, mesh)

    def forward(self, text_hidden: torch.Tensor, style_emb: torch.Tensor,
                durations: torch.Tensor, text_mask: Optional[torch.Tensor] = None,
                max_frame_len: int = 1024, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                shard_generator: Optional[torch.Generator] = None):
        style_K, style_V = self.style_proj(style_emb, deterministic, generator)
        styled_text = self.cross_attn_1(text_hidden, style_K, style_V, deterministic, generator,
                                        shard_generator)
        if text_mask is not None:
            durations = durations * text_mask.to(durations.dtype)
        upsampled, output_lengths = length_regulate(styled_text, durations, max_frame_len)
        styled_frames = self.cross_attn_2(upsampled, style_K, style_V, deterministic, generator,
                                          shard_generator)
        return styled_frames, output_lengths, style_K, style_V

    def forward_with_target(self, text_hidden: torch.Tensor, style_emb: torch.Tensor,
                            target_durations: torch.Tensor,
                            text_mask: Optional[torch.Tensor] = None, max_frame_len: int = 1024):
        """Training mode with ground-truth (e.g. forced-alignment) durations."""
        return self(text_hidden, style_emb, target_durations, text_mask, max_frame_len)
