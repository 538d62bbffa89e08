"""Top-level MambaTTS model, inference surface — counterpart of
``mamba_tts_tpu/models/tts.py``.

Holds the trainable components under the JAX tree's top-level names
(``text_encoder``, ``dur_predictor``, ``smsd``, ``decoder``).  The NAR style
branch (``style_pipe``) is not used when serving and is not ported yet; the
training losses wait for the training slice.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from mamba_tts_torch.config import TTSConfig
from mamba_tts_torch.models.decoder import MambaTTSDecoder
from mamba_tts_torch.models.smsd import SMSD
from mamba_tts_torch.models.text_encoder import DurationPredictor, TextEncoder


class MambaTTS(nn.Module):
    def __init__(self, cfg: TTSConfig):
        super().__init__()
        self.cfg = cfg
        self.text_encoder = TextEncoder(cfg.text_encoder)
        self.dur_predictor = DurationPredictor(cfg.duration)
        self.smsd = SMSD(cfg.smsd)
        self.decoder = MambaTTSDecoder(cfg.decoder.with_mamba_dims())

    def encode_text(self, phoneme_ids, text_mask=None):
        return self.text_encoder(phoneme_ids, text_mask)

    def predict_durations(self, text_hidden, text_mask=None):
        return self.dur_predictor(text_hidden, text_mask)

    def sample_style(self, style_bert, generator: Optional[torch.Generator] = None):
        return self.smsd.sample(style_bert, generator)

    def embed_voice(self, voice_codec: torch.Tensor):
        """(B, S, Q) shifted codec ids -> (ref_hidden (B, Q*S, d), ref_mask)."""
        voice_3d = voice_codec.transpose(1, 2)
        ref_hidden = self.decoder.embed_codec_tokens(voice_3d)
        ref_mask = voice_3d.reshape(voice_codec.shape[0], -1) != self.cfg.decoder.pad_id
        return ref_hidden, ref_mask
