"""Host-side batch preparation: raw dataset batch -> training arrays —
counterpart of ``mamba_tts_tpu/train/pipeline.py``.

Composes the frozen front-ends (FACodec tokenizer, phoneme G2P, style-text
BERT) outside the trainable graph: waveforms go straight into the codec
encoder on ``device`` as arrays.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from mamba_tts_torch.audio.codec import FACodecTokenizer
from mamba_tts_torch.config import TTSConfig
from mamba_tts_torch.models.style_text_encoder import StyleTextEncoder
from mamba_tts_torch.text.processor import PhonemeFrontend


class BatchPreparer:
    def __init__(self, cfg: TTSConfig, tokenizer: Optional[FACodecTokenizer] = None,
                 frontend: Optional[PhonemeFrontend] = None,
                 style_encoder: Optional[StyleTextEncoder] = None, frame_bucket: int = 128,
                 device="cuda"):
        self.cfg = cfg
        self.tokenizer = tokenizer or FACodecTokenizer(cfg.codec, device=device)
        self.frontend = frontend or PhonemeFrontend(vocab_path=cfg.data.phoneme_vocab_path)
        self.style_encoder = style_encoder or StyleTextEncoder(cfg.style_encoder, device=device)
        self.frame_bucket = frame_bucket

    def _bucket(self, codec: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        """Trim frame padding to the batch's longest item, rounded up to the
        bucket: padded positions are masked or ignored everywhere, so the
        loss is unchanged and the flattened sequence is as short as the batch
        allows."""
        max_f = int(lengths.max()) if lengths.size else self.frame_bucket
        bucketed = min(-(-max_f // self.frame_bucket) * self.frame_bucket,
                       self.cfg.codec.max_seq_len)
        return codec[:, :bucketed]

    def __call__(self, inputs: Dict, target_waveform: np.ndarray) -> Dict[str, np.ndarray]:
        """({'voice_waveform', 'text_prompt', 'style_prompt'}, target (B, T))
        -> batch dict of numpy arrays (see ``MambaTTS.compute_losses``)."""
        target_codec, spk_embs, target_frames = self.tokenizer.encode_with_lengths(
            list(target_waveform))
        voice_codec, _, voice_frames = self.tokenizer.encode_with_lengths(
            list(inputs["voice_waveform"]))
        target_codec = self._bucket(target_codec, target_frames)
        voice_codec = self._bucket(voice_codec, voice_frames)
        phoneme_ids, _, text_mask = self.frontend.encode_batch(
            inputs["text_prompt"], pad_to=self.cfg.data.max_text_len)
        style_bert = self.style_encoder.embed(inputs["style_prompt"]).cpu().numpy()
        return {
            "phoneme_ids": phoneme_ids,
            "text_mask": text_mask,
            "style_bert": style_bert,
            "spk_embs": spk_embs,
            "target_codec": target_codec,
            "target_frames": target_frames.astype(np.int32),
            "voice_codec": voice_codec,
        }
