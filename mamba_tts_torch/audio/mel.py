"""Spectral features and the codec's reconstruction losses — counterpart of
``mamba_tts_tpu/audio/mel.py``.

Framed STFT magnitudes (symmetric Hann window, reflect padding of
``n_fft // 2`` on both sides, ``1 + (T + 2 * pad - n_fft) // hop`` frames),
the multi-resolution STFT loss (spectral convergence, one Frobenius norm over
the whole batch, plus log-magnitude L1) and the mel L1 loss.  The filterbank
is numpy, copied; the rest runs on tensors (``torch.fft`` on the card).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def mel_filterbank(
    sr: int, n_fft: int, n_mels: int = 80, fmin: float = 0.0, fmax: float | None = None
) -> np.ndarray:
    """Triangular (HTK-style) mel filterbank (n_mels, n_fft // 2 + 1)."""
    fmax = fmax or sr / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fb = np.zeros((n_mels, n_bins), np.float32)
    for i in range(n_mels):
        lo, ctr, hi = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-9)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-9)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
    return fb


def stft(wav: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Complex STFT of (B, T) -> (B, frames, n_fft // 2 + 1): reflect-padded
    frames times the symmetric Hann window (``np.hanning``, which
    ``torch.hann_window`` gives only with ``periodic=False``)."""
    pad = n_fft // 2
    x = F.pad(wav.to(torch.float32)[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)  # (B, frames, n_fft)
    window = torch.from_numpy(np.hanning(n_fft).astype(np.float32)).to(x.device)
    return torch.fft.rfft(frames * window, dim=-1)


def stft_magnitude(wav: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """|STFT| of (B, T) -> (B, frames, n_fft // 2 + 1)."""
    return stft(wav, n_fft, hop).abs()


def multi_resolution_stft_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    resolutions=((512, 128), (1024, 256), (2048, 512)),
) -> torch.Tensor:
    """Spectral convergence + log-magnitude L1, averaged over resolutions."""
    total = 0.0
    for n_fft, hop in resolutions:
        sp = stft_magnitude(pred, n_fft, hop)
        st = stft_magnitude(target, n_fft, hop)
        sc = torch.linalg.vector_norm(st - sp) / (torch.linalg.vector_norm(st) + 1e-6)
        mag = (torch.log(st + 1e-5) - torch.log(sp + 1e-5)).abs().mean()
        total = total + sc + mag
    return total / len(resolutions)


def mel_l1_loss(
    pred: torch.Tensor, target: torch.Tensor, sr: int = 16000,
    n_fft: int = 1024, hop: int = 256, n_mels: int = 80,
) -> torch.Tensor:
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels)).to(pred.device)
    mp = torch.log(stft_magnitude(pred, n_fft, hop) @ fb.T + 1e-5)
    mt = torch.log(stft_magnitude(target, n_fft, hop) @ fb.T + 1e-5)
    return (mp - mt).abs().mean()
