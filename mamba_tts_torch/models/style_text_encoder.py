"""Frozen style-text encoder (BERT-base) — counterpart of
``mamba_tts_tpu/models/style_text_encoder.py``.

Style prompt string -> (B, d_model) [CLS] embedding through a post-LN BERT
encoder (exact-erf GELU, LayerNorm eps 1e-12).  Without a checkpoint it runs
at a seeded random init; loading the released HF weights waits until those
files are in the repository (ROADMAP queue 1).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mamba_tts_torch.config import StyleEncoderConfig
from mamba_tts_torch.device import resolve_device
from mamba_tts_torch.models.attention import mask_bias
from mamba_tts_torch.models.layers import Dense, Embed, LayerNorm, parse_dtype, seed_init
from mamba_tts_torch.text.wordpiece import BertTokenizer

_LN_EPS = 1e-12


class _BertLayer(nn.Module):
    def __init__(self, cfg: StyleEncoderConfig):
        super().__init__()
        c = self.cfg = cfg
        dt = parse_dtype(c.dtype)
        self.q = Dense(c.d_model, c.d_model, dtype=dt)
        self.k = Dense(c.d_model, c.d_model, dtype=dt)
        self.v = Dense(c.d_model, c.d_model, dtype=dt)
        self.attn_out = Dense(c.d_model, c.d_model, dtype=dt)
        self.attn_ln = LayerNorm(c.d_model, eps=_LN_EPS, dtype=dt)
        self.ffn_in = Dense(c.d_model, c.d_ff, dtype=dt)
        self.ffn_out = Dense(c.d_ff, c.d_model, dtype=dt)
        self.ffn_ln = LayerNorm(c.d_model, eps=_LN_EPS, dtype=dt)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        B, T, _ = x.shape
        H = c.n_heads
        hd = c.d_model // H

        def heads(t):
            return t.reshape(B, T, H, hd).transpose(1, 2)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        logits = logits / math.sqrt(hd) + mask_bias(mask)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        attn = torch.matmul(probs, v).transpose(1, 2).reshape(B, T, c.d_model)
        x = self.attn_ln(x + self.attn_out(attn))
        h = self.ffn_out(F.gelu(self.ffn_in(x), approximate="none"))
        return self.ffn_ln(x + h)


class BertEncoder(nn.Module):
    """BERT encoder returning the [CLS] hidden state (B, d_model)."""

    def __init__(self, cfg: StyleEncoderConfig):
        super().__init__()
        c = self.cfg = cfg
        dt = parse_dtype(c.dtype)
        self.word_emb = Embed(c.vocab_size, c.d_model, dtype=dt)
        self.pos_emb = Embed(c.max_position, c.d_model, dtype=dt)
        self.type_emb = Embed(c.type_vocab_size, c.d_model, dtype=dt)
        self.emb_ln = LayerNorm(c.d_model, eps=_LN_EPS, dtype=dt)
        for i in range(c.n_layers):
            self.add_module(f"layer_{i}", _BertLayer(c))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        T = input_ids.shape[1]
        pos = torch.arange(T, device=input_ids.device)[None]
        x = self.word_emb(input_ids) + self.pos_emb(pos) + self.type_emb(torch.zeros_like(input_ids))
        x = self.emb_ln(x)
        for i in range(self.cfg.n_layers):
            x = getattr(self, f"layer_{i}")(x, attention_mask)
        return x[:, 0, :]


class StyleTextEncoder:
    """Host-side wrapper: style prompt strings -> (B, d_model) embeddings on
    ``device``.  ``module`` carries weights (from the bridge); without one
    the encoder is built at a seeded random init."""

    def __init__(self, cfg: Optional[StyleEncoderConfig] = None, vocab_path: Optional[str] = None,
                 module: Optional[BertEncoder] = None, seed: int = 0, device="cuda"):
        self.cfg = cfg or StyleEncoderConfig()
        self.device = resolve_device(device)
        self.max_length = min(self.cfg.max_length, self.cfg.max_position)
        if vocab_path is None:
            vocab_path = self.cfg.bert_vocab
        self.tokenizer = BertTokenizer(vocab_path, vocab_size=self.cfg.vocab_size)
        if module is None:
            module = seed_init(BertEncoder(self.cfg), seed)
        self.module = module.to(self.device).eval()

    @torch.no_grad()
    def embed(self, texts: Sequence[str]) -> torch.Tensor:
        if isinstance(texts, str):
            texts = [texts]
        ids, mask = self.tokenizer.encode_batch(texts, self.max_length)
        return self.module(torch.as_tensor(ids, dtype=torch.long, device=self.device),
                           torch.as_tensor(mask, device=self.device))
