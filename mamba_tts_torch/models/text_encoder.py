"""FFT-block text encoder and duration predictor — counterpart of
``mamba_tts_tpu/models/text_encoder.py``.

- :class:`TextEncoder`: phoneme embedding (pad row forced to zero) + fixed
  sinusoidal table + N x :class:`FFTBlock` (post-LN self-attention with
  explicit d_k/d_v heads + a conv1d position-wise FFN), masking padded
  positions after every block.
- :class:`DurationPredictor`: conv1d x2 + LN + linear -> LOG durations.

Inference only: dropout is off.  Mask convention: True = VALID.  Module and
attribute names follow the Flax parameter tree, including Flax's automatic
``LayerNorm_0``/``LayerNorm_1`` names, so the weight bridge maps them
one-to-one.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from mamba_tts_torch.config import DurationPredictorConfig, TextEncoderConfig
from mamba_tts_torch.models.attention import mask_bias
from mamba_tts_torch.models.layers import Conv, Dense, Embed, LayerNorm, parse_dtype


def sinusoid_position_table(n_position: int, d_hid: int) -> np.ndarray:
    """FS2 sinusoids: sin on even channels, cos on odd,
    angle = pos / 10000^(2*(i//2)/d)."""
    pos = np.arange(n_position)[:, None].astype(np.float64)
    i = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000.0, 2 * (i // 2) / d_hid)
    table = np.zeros((n_position, d_hid), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


class _SelfAttention(nn.Module):
    """Post-LN multi-head self-attention with explicit d_k/d_v."""

    def __init__(self, d_model: int, n_heads: int, d_k: int, d_v: int, dtype):
        super().__init__()
        self.n_heads, self.d_k, self.d_v = n_heads, d_k, d_v
        self.w_q = Dense(d_model, n_heads * d_k, dtype=dtype)
        self.w_k = Dense(d_model, n_heads * d_k, dtype=dtype)
        self.w_v = Dense(d_model, n_heads * d_v, dtype=dtype)
        self.w_o = Dense(n_heads * d_v, d_model, dtype=dtype)
        self.LayerNorm_0 = LayerNorm(d_model, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        B, T, _ = x.shape
        H, dk, dv = self.n_heads, self.d_k, self.d_v
        q = self.w_q(x).reshape(B, T, H, dk).transpose(1, 2)
        k = self.w_k(x).reshape(B, T, H, dk).transpose(1, 2)
        v = self.w_v(x).reshape(B, T, H, dv).transpose(1, 2)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        logits = logits / torch.sqrt(torch.tensor(dk, dtype=torch.float32))
        if mask is not None:
            logits = logits + mask_bias(mask)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(B, T, H * dv)
        return self.LayerNorm_0(self.w_o(out) + x)


class FFTBlock(nn.Module):
    """Self-attention + conv1d position-wise FFN, both post-LN residual."""

    def __init__(self, cfg: TextEncoderConfig):
        super().__init__()
        c = cfg
        dt = parse_dtype(c.dtype)
        self.attn = _SelfAttention(c.d_model, c.n_heads, c.d_k, c.d_v, dt)
        self.conv1 = Conv(c.d_model, c.d_inner, c.conv_kernel[0], dtype=dt)
        self.conv2 = Conv(c.d_inner, c.d_model, c.conv_kernel[1], dtype=dt)
        self.LayerNorm_0 = LayerNorm(c.d_model, dtype=dt)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        x = self.attn(x, mask)
        if mask is not None:
            x = x * mask[..., None]
        h = F.relu(self.conv1(x.transpose(1, 2)))
        h = self.conv2(h).transpose(1, 2)
        x = self.LayerNorm_0(h + x)
        if mask is not None:
            x = x * mask[..., None]
        return x


class TextEncoder(nn.Module):
    """(B, T) phoneme ids -> (B, T, d_model)."""

    def __init__(self, cfg: TextEncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = parse_dtype(cfg.dtype)
        self.phoneme_emb = Embed(cfg.vocab_size, cfg.d_model, dtype=self.dtype)
        for i in range(cfg.n_layers):
            self.add_module(f"fft_{i}", FFTBlock(cfg))

    def forward(self, phoneme_ids: torch.Tensor, mask: Optional[torch.Tensor] = None):
        c = self.cfg
        emb = self.phoneme_emb(phoneme_ids)
        emb = emb * (phoneme_ids != c.padding_idx)[..., None].to(emb.dtype)
        T = phoneme_ids.shape[1]
        pos = torch.from_numpy(sinusoid_position_table(T, c.d_model)).to(emb.device, self.dtype)
        x = emb + pos[None]
        for i in range(c.n_layers):
            x = getattr(self, f"fft_{i}")(x, mask)
        return x


class DurationPredictor(nn.Module):
    """(B, T, d) -> (B, T) log-durations."""

    def __init__(self, cfg: DurationPredictorConfig):
        super().__init__()
        c = cfg
        dt = parse_dtype(c.dtype)
        self.conv1 = Conv(c.d_model, c.filter_size, c.kernel_size, dtype=dt)
        self.LayerNorm_0 = LayerNorm(c.filter_size, dtype=dt)
        self.conv2 = Conv(c.filter_size, c.filter_size, c.kernel_size, dtype=dt)
        self.LayerNorm_1 = LayerNorm(c.filter_size, dtype=dt)
        self.linear = Dense(c.filter_size, 1, dtype=torch.float32)

    def forward(self, encoder_output: torch.Tensor, mask: Optional[torch.Tensor] = None):
        h = F.relu(self.conv1(encoder_output.transpose(1, 2))).transpose(1, 2)
        h = self.LayerNorm_0(h)
        h = F.relu(self.conv2(h.transpose(1, 2))).transpose(1, 2)
        h = self.LayerNorm_1(h)
        log_dur = self.linear(h)[..., 0]
        if mask is not None:
            log_dur = log_dur * mask.to(log_dur.dtype)
        return log_dur
