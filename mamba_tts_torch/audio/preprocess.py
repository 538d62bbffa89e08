"""Optional WAV hygiene pipeline — the PyTorch port's own copy of
``mamba_tts_tpu/audio/preprocess.py`` (framework-free; only its imports
point into this package).  Reference: data_utils/audio_encoder.py:30-131.

Load/resample, ITU-R BS.1770 loudness normalization to a target LUFS with a
silent-audio guard + re-peak-clamp, peak normalization, dB-threshold silence
trim, int16 WAV save — all host-side numpy/scipy ("FACodec has built in
preprocessing", so this stays optional, matching the reference)."""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np

from mamba_tts_torch.audio import dsp, wavio


class BaseAudioPreprocessor:
    def __init__(
        self,
        sample_rate: int = 16000,
        loudness_norm: bool = True,
        target_loudness: float = -20.0,
        silence_trim: bool = True,
        trim_top_db: int = 20,
        peak_norm: bool = True,
    ):
        self.sample_rate = sample_rate
        self.loudness_norm = loudness_norm
        self.target_loudness = target_loudness
        self.silence_trim = silence_trim
        self.trim_top_db = trim_top_db
        self.peak_norm = peak_norm

    def load_audio(self, path: str, sr: Optional[int] = None) -> Tuple[np.ndarray, int]:
        sr = sr or self.sample_rate
        wav, _ = wavio.read_wav_mono(path, target_sr=sr)
        return wav, sr

    def resample(self, wav: np.ndarray, orig_sr: int, target_sr: Optional[int] = None):
        target_sr = target_sr or self.sample_rate
        return dsp.resample(wav, orig_sr, target_sr)

    def normalize_loudness(self, wav, sr=None, target_db=None):
        sr = sr or self.sample_rate
        target_db = target_db if target_db is not None else self.target_loudness
        return dsp.normalize_loudness(wav, sr, target_db)

    def normalize_peak(self, wav: np.ndarray) -> np.ndarray:
        peak = np.abs(wav).max()
        return wav / peak if peak > 0 else wav

    def trim_silence(self, wav: np.ndarray, top_db: Optional[int] = None) -> np.ndarray:
        top_db = top_db if top_db is not None else self.trim_top_db
        trimmed, _ = dsp.trim_silence(wav, top_db=top_db)
        return trimmed

    def preprocess(
        self, path_or_wav: Union[str, np.ndarray], sr: Optional[int] = None
    ) -> Tuple[np.ndarray, int]:
        if isinstance(path_or_wav, str):
            wav, sr = self.load_audio(path_or_wav)
        else:
            wav = path_or_wav
            sr = sr or self.sample_rate
            wav = self.resample(wav, sr)
            sr = self.sample_rate
        if self.loudness_norm:
            wav = self.normalize_loudness(wav, sr)
        if self.silence_trim:
            wav = self.trim_silence(wav)
        if self.peak_norm:
            wav = self.normalize_peak(wav)
        return wav, sr

    def save_wav(self, wav, path, sr=None, normalize=False):
        wavio.write_wav(path, wav, sr or self.sample_rate, normalize=normalize)
