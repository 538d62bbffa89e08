"""WAV I/O without external audio libraries (librosa/soundfile are not in
this image).  Reads/writes RIFF WAV via scipy.io.wavfile, normalizes to
float32 in [-1, 1], supports bytes objects (for tar members)."""
from __future__ import annotations

import io
from typing import Tuple, Union

import numpy as np
from scipy.io import wavfile

Source = Union[str, bytes, io.BytesIO]


def read_wav(src: Source) -> Tuple[np.ndarray, int]:
    """Read a WAV file/path/bytes -> (float32 samples (T,) or (T, C), sr)."""
    if isinstance(src, bytes):
        src = io.BytesIO(src)
    sr, data = wavfile.read(src)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return data, int(sr)


def read_wav_mono(src: Source, target_sr: int | None = None) -> Tuple[np.ndarray, int]:
    """Read + downmix to mono (+ optional resample)."""
    from mamba_tts_torch.audio.dsp import resample

    wav, sr = read_wav(src)
    if wav.ndim == 2:
        wav = wav.mean(axis=1)
    if target_sr is not None and sr != target_sr:
        wav = resample(wav, sr, target_sr)
        sr = target_sr
    return wav, sr


def write_wav(path: str, wav: np.ndarray, sr: int, normalize: bool = False) -> None:
    """Write float waveform as 16-bit PCM WAV (reference: audio_encoder.py:117-131)."""
    wav = np.asarray(wav, np.float32)
    if normalize:
        peak = np.abs(wav).max()
        if peak > 0:
            wav = wav / peak
    wav = np.clip(wav, -1.0, 1.0)
    if not path.endswith(".wav"):
        path = path.rsplit(".", 1)[0] + ".wav"
    wavfile.write(path, sr, (wav * 32767.0).astype(np.int16))
