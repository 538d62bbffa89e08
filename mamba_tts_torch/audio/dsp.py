"""Host-side audio DSP: polyphase resampling, ITU-R BS.1770 loudness,
silence trimming.

Replaces the librosa/pyloudnorm/torchaudio C paths of the reference
(reference: data_utils/audio_encoder.py:49-94, dataset.py:76-79) with
self-contained numpy/scipy implementations.  These run on the host, outside
the jitted TPU hot path (SURVEY §2.2).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
from scipy import signal


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (the soxr/torchaudio role)."""
    if orig_sr == target_sr:
        return wav
    g = math.gcd(int(orig_sr), int(target_sr))
    return signal.resample_poly(wav, target_sr // g, orig_sr // g).astype(np.float32)


# ------------------------------------------------ ITU-R BS.1770 loudness

def _k_weighting_coeffs(fs: float):
    """Design the two K-weighting biquads (shelf + high-pass) for rate fs,
    per the BS.1770 analog prototypes (pyloudnorm-compatible)."""
    # Stage 1: spherical-head high shelf.
    f0, G, Q = 1681.974450955533, 3.999843853973347, 0.7071752369554196
    K = math.tan(math.pi * f0 / fs)
    Vh = 10.0 ** (G / 20.0)
    Vb = Vh**0.4996667741545416
    a0 = 1.0 + K / Q + K * K
    b_shelf = np.array(
        [
            (Vh + Vb * K / Q + K * K) / a0,
            2.0 * (K * K - Vh) / a0,
            (Vh - Vb * K / Q + K * K) / a0,
        ]
    )
    a_shelf = np.array([1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / Q + K * K) / a0])
    # Stage 2: high-pass.
    f0, Q = 38.13547087602444, 0.5003270373238773
    K = math.tan(math.pi * f0 / fs)
    a0 = 1.0 + K / Q + K * K
    b_hp = np.array([1.0, -2.0, 1.0]) / a0 * 1.0
    a_hp = np.array([1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / Q + K * K) / a0])
    return (b_shelf, a_shelf), (b_hp, a_hp)


def integrated_loudness(wav: np.ndarray, sr: int) -> float:
    """Gated integrated loudness in LUFS (mono or (T, C) multichannel).

    Returns -inf for silent audio (reference guards on this —
    audio_encoder.py:77-78).
    """
    x = np.asarray(wav, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    (b1, a1), (b2, a2) = _k_weighting_coeffs(sr)
    y = signal.lfilter(b1, a1, x, axis=0)
    y = signal.lfilter(b2, a2, y, axis=0)

    block = int(round(0.400 * sr))
    hop = int(round(0.100 * sr))  # 75% overlap
    if y.shape[0] < block:
        ms = (y**2).mean(axis=0).sum()
        return -0.691 + 10.0 * math.log10(ms) if ms > 0 else float("-inf")

    n_blocks = 1 + (y.shape[0] - block) // hop
    idx = np.arange(block)[None, :] + hop * np.arange(n_blocks)[:, None]
    ms_blocks = (y[idx] ** 2).mean(axis=1).sum(axis=-1)  # channel weights 1.0
    with np.errstate(divide="ignore"):
        lk = -0.691 + 10.0 * np.log10(ms_blocks)

    gated = lk > -70.0  # absolute gate
    if not gated.any():
        return float("-inf")
    rel_threshold = -0.691 + 10.0 * math.log10(ms_blocks[gated].mean()) - 10.0
    gated &= lk > rel_threshold
    if not gated.any():
        return float("-inf")
    return -0.691 + 10.0 * math.log10(ms_blocks[gated].mean())


def normalize_loudness(wav: np.ndarray, sr: int, target_db: float = -20.0) -> np.ndarray:
    """Normalize to target LUFS, then re-clamp peaks above 1.0
    (reference: audio_encoder.py:64-83)."""
    loudness = integrated_loudness(wav, sr)
    if math.isinf(loudness):
        return wav
    gain = 10.0 ** ((target_db - loudness) / 20.0)
    out = wav * gain
    peak = np.abs(out).max()
    if peak > 1.0:
        out = out / peak
    return out.astype(np.float32)


# ---------------------------------------------------------- silence trimming

def trim_silence(
    wav: np.ndarray,
    top_db: float = 20.0,
    frame_length: int = 2048,
    hop_length: int = 512,
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Trim leading/trailing frames quieter than (max - top_db) dB, RMS-based
    (librosa.effects.trim semantics — reference: audio_encoder.py:90-94)."""
    x = np.asarray(wav, np.float32)
    if x.size == 0:
        return x, (0, 0)
    pad = frame_length // 2
    xp = np.pad(x, (pad, pad))
    n_frames = 1 + (xp.shape[0] - frame_length) // hop_length
    idx = np.arange(frame_length)[None, :] + hop_length * np.arange(n_frames)[:, None]
    rms = np.sqrt((xp[idx] ** 2).mean(axis=1))
    ref = rms.max()
    if ref <= 0:
        return x[:0], (0, 0)
    db = 20.0 * np.log10(np.maximum(rms, 1e-10) / ref)
    keep = np.flatnonzero(db > -top_db)
    if keep.size == 0:
        return x[:0], (0, 0)
    start = int(keep[0]) * hop_length
    end = min(int(keep[-1] + 1) * hop_length, x.shape[0])
    return x[start:end], (start, end)
