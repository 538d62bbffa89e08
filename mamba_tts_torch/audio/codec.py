"""Audio-token codec wrapper: the tokenize/detokenize boundary — counterpart
of ``mamba_tts_tpu/audio/codec.py``.

- ``encode(wavs)``: paths / bytes / float arrays -> 16 kHz mono -> padded to
  a multiple of the 0.8 s bucket -> FACodec encode -> codec ids
  ``(B, max_seq_len, 5)`` in stream order [Qp, Qr1, Qr2, Qr3, Qc] + speaker
  embeddings (B, spk_dim).  80 tokens/s (hop 200 at 16 kHz).
- ``decode(codec, spk)``: codec ids -> waveform.

Codebook ids are shifted by ``ID_OFFSET`` (2) so PAD=0 / BOS=1 never collide
with codebook id 0; frame padding uses PAD=0.  Host-side I/O is numpy; the
codec runs on ``device``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from mamba_tts_torch.audio import wavio
from mamba_tts_torch.bridge import facodec_from_params
from mamba_tts_torch.config import CodecConfig
from mamba_tts_torch.device import resolve_device
from mamba_tts_torch.models.facodec import FACodec, load_torch_facodec
from mamba_tts_torch.models.layers import seed_init

WavSource = Union[str, bytes, np.ndarray]

PAD_ID = 0
BOS_ID = 1
ID_OFFSET = 2  # codebook id k -> token id k + ID_OFFSET


class FACodecTokenizer:
    """Host wrapper around :class:`FACodec` with the (B, T, 5) contract.
    ``module`` carries weights (from the bridge); ``torch_encoder_ckpt`` and
    ``torch_decoder_ckpt`` are local paths of the released
    ``ns3_facodec_{encoder,decoder}.bin`` state dicts, converted on load;
    without either the codec is built at a seeded random init."""

    def __init__(self, cfg: Optional[CodecConfig] = None, module: Optional[FACodec] = None,
                 seed: int = 0, bucket_seconds: float = 0.8, device="cuda",
                 torch_encoder_ckpt: Optional[str] = None,
                 torch_decoder_ckpt: Optional[str] = None):
        self.cfg = cfg or CodecConfig()
        self.device = resolve_device(device)
        self.hop = self.cfg.hop_length
        self.bucket = int(bucket_seconds * self.cfg.sample_rate)
        if self.bucket % self.hop:
            raise ValueError(f"bucket of {self.bucket} samples is not a multiple of hop {self.hop}")
        if module is None and (torch_encoder_ckpt or torch_decoder_ckpt):
            if not (torch_encoder_ckpt and torch_decoder_ckpt):
                raise ValueError("FACodec needs both the encoder and the decoder checkpoint")
            module = facodec_from_params(self.cfg, load_torch_facodec(
                torch_encoder_ckpt, torch_decoder_ckpt, self.cfg))
        if module is None:
            module = seed_init(FACodec(self.cfg), seed)
        self.module = module.to(self.device).eval()

    def _load(self, item: WavSource) -> np.ndarray:
        if isinstance(item, np.ndarray):
            wav = item.astype(np.float32)
            if wav.ndim == 2:  # (C, T) or (T, C) -> mono
                wav = wav.mean(axis=0 if wav.shape[0] < wav.shape[1] else 1)
            return wav
        wav, _ = wavio.read_wav_mono(item, target_sr=self.cfg.sample_rate)
        return wav

    def encode(self, wav, sr: int = 16000) -> Tuple[np.ndarray, np.ndarray]:
        """(codec (B, max_seq_len, num_q) int32 shifted ids, spk (B, spk_dim))."""
        codec, spk, _ = self.encode_with_lengths(wav, sr)
        return codec, spk

    @torch.no_grad()
    def encode_with_lengths(self, wav, sr: int = 16000
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if isinstance(wav, (str, bytes, np.ndarray)):
            wav = [wav]
        waves = [self._load(w) for w in wav]
        max_len = max(w.shape[0] for w in waves)
        cap = self.cfg.max_seq_len * self.hop
        padded_len = min(-(-max_len // self.bucket) * self.bucket, cap)
        batch = np.zeros((len(waves), padded_len), np.float32)
        lengths = np.zeros((len(waves),), np.int32)
        for i, w in enumerate(waves):
            n = min(w.shape[0], padded_len)
            batch[i, :n] = w[:n]
            lengths[i] = -(-n // self.hop)

        ids, spk = self.module.encode(torch.from_numpy(batch).to(self.device))
        ids = ids.cpu().numpy()
        num_q, B, T_f = ids.shape
        S = self.cfg.max_seq_len
        codec = np.full((B, S, num_q), PAD_ID, np.int32)
        t = min(T_f, S)
        codec[:, :t] = ids[:, :, :t].transpose(1, 2, 0) + ID_OFFSET
        frame_idx = np.arange(S)[None, :]
        codec[frame_idx >= np.minimum(lengths, S)[:, None]] = PAD_ID
        return codec, spk.cpu().numpy(), np.minimum(lengths, S)

    @torch.no_grad()
    def decode(self, codec: np.ndarray, spk: Optional[np.ndarray] = None) -> np.ndarray:
        """codec (B, T, num_q) shifted ids -> waveform (B, T * hop) float32.
        PAD frames decode through codebook id 0; callers slice to true
        lengths."""
        ids = np.maximum(np.asarray(codec).astype(np.int64) - ID_OFFSET, 0).transpose(2, 0, 1)
        spk_t = None if spk is None else torch.as_tensor(spk, dtype=torch.float32,
                                                          device=self.device)
        wav = self.module.decode(torch.from_numpy(np.ascontiguousarray(ids)).to(self.device), spk_t)
        return wav.cpu().numpy()

    @property
    def frames_per_second(self) -> float:
        return self.cfg.sample_rate / self.hop

    @property
    def vocab_size_audio(self) -> int:
        return self.cfg.codebook_size + ID_OFFSET
