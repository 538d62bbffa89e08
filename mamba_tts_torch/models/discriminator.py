"""Multi-resolution complex-STFT discriminator for adversarial codec
training — counterpart of ``mamba_tts_tpu/models/discriminator.py``.

The wave becomes a complex STFT (real and imaginary parts as two channels)
at several resolutions; each runs a small strided 2-D conv stack (cuDNN on
the card).  The Flax convs are channels-last on (B, frames, bins, 2); these
run channels-first on (B, 2, frames, bins) with the same "SAME" padding
(``layers.Conv2d``), so a feature map here is the JAX one with its channel
axis moved to the front.  Losses: hinge GAN pair and feature matching
(EnCodec/DAC recipe).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mamba_tts_torch.audio.mel import stft
from mamba_tts_torch.models.layers import Conv2d


def stft_complex(wav: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, T) -> (B, frames, n_fft // 2 + 1, 2) real/imag channels."""
    spec = stft(wav, n_fft, hop)
    return torch.stack([spec.real, spec.imag], dim=-1)


class STFTDiscriminator(nn.Module):
    """One resolution: complex STFT -> strided 2-D conv stack -> logits map.
    Returns (logits (B, F', K'), the five feature maps (B, C, F, K') for the
    feature-matching loss)."""

    def __init__(self, n_fft: int, hop: int, channels: int = 32):
        super().__init__()
        self.n_fft, self.hop = n_fft, hop
        ch = channels
        self.conv_in = Conv2d(2, ch, (3, 9))
        for i in range(3):
            self.add_module(f"conv_{i}", Conv2d(ch, ch, (3, 9), stride=(1, 2)))
        self.conv_post = Conv2d(ch, ch, (3, 3))
        self.conv_out = Conv2d(ch, 1, (3, 3))

    def forward(self, wav: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        x = stft_complex(wav, self.n_fft, self.hop).permute(0, 3, 1, 2)
        feats = []
        for conv in (self.conv_in, self.conv_0, self.conv_1, self.conv_2, self.conv_post):
            x = F.leaky_relu(conv(x), 0.2)
            feats.append(x)
        return self.conv_out(x)[:, 0], feats


class MultiSTFTDiscriminator(nn.Module):
    """Discriminators at several STFT resolutions (EnCodec-style); the
    submodule of resolution n_fft is ``d_{n_fft}``, the Flax name."""

    def __init__(self, resolutions: Sequence[Tuple[int, int]] = ((512, 128), (1024, 256), (2048, 512)),
                 channels: int = 32):
        super().__init__()
        self.resolutions = tuple(tuple(r) for r in resolutions)
        for n_fft, hop in self.resolutions:
            self.add_module(f"d_{n_fft}", STFTDiscriminator(n_fft, hop, channels))

    def forward(self, wav: torch.Tensor):
        return [getattr(self, f"d_{n_fft}")(wav) for n_fft, _ in self.resolutions]


# ------------------------------------------------------------- GAN losses


def discriminator_loss(real_outs, fake_outs) -> torch.Tensor:
    """Hinge loss: relu(1 - D(x)) + relu(1 + D(x_hat)), averaged."""
    total = 0.0
    for (lr, _), (lf, _) in zip(real_outs, fake_outs):
        total = total + F.relu(1.0 - lr).mean() + F.relu(1.0 + lf).mean()
    return total / len(real_outs)


def generator_adversarial_loss(fake_outs) -> torch.Tensor:
    """Hinge generator term: -mean(D(x_hat))."""
    total = 0.0
    for lf, _ in fake_outs:
        total = total - lf.mean()
    return total / len(fake_outs)


def feature_matching_loss(real_outs, fake_outs) -> torch.Tensor:
    """L1 between intermediate features, normalised per layer (DAC recipe);
    the real features, and with them the normaliser, are constants."""
    total, n = 0.0, 0
    for (_, fr), (_, ff) in zip(real_outs, fake_outs):
        for r, f in zip(fr, ff):
            r = r.detach()
            total = total + (r - f).abs().mean() / (r.abs().mean() + 1e-5)
            n += 1
    return total / max(n, 1)
