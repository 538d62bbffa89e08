"""Mamba TTS decoder stack — counterpart of ``mamba_tts_tpu/models/decoder.py``.

Per layer:

    x += Mamba(LN(x))                       # selective scan over audio tokens
    x += CrossAttn(LN(x), [ref || text])    # conditioning memory
    x += FFN(FiLM_{z_style}(LN(x)))         # gamma, beta = tanh(MLP(z_style))

Token ids: PAD=0, BOS=1, codebook ids shifted by 2.  A (B, Q, T) grid is
flattened quantizer-major with ``pos = tile(arange(T), Q)`` and
``quant = repeat(arange(Q), T)``; the decode step recovers
``q_id = min(step // F, Q-1)`` and ``pos_id = step % F``.

:func:`greedy_decode` projects every layer's memory K/V and FiLM parameters
once, then loops over the Q*F steps in Python over device tensors with no
host synchronisation per token.  ``forward`` (teacher forcing) runs only on
CPU tensors in this slice: its scan and long-query attention have no Hopper
kernels yet and raise on the card.

Mask convention: True = VALID.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mamba_tts_torch.config import DecoderConfig
from mamba_tts_torch.models.attention import CrossAttention
from mamba_tts_torch.models.layers import Dense, Embed, LayerNorm, parse_dtype
from mamba_tts_torch.models.mamba import MambaBlock, MambaState, init_mamba_state


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        c = cfg
        dt = parse_dtype(c.dtype)
        self.norm_mamba = LayerNorm(c.d_model, dtype=dt)
        self.mamba = MambaBlock(c.with_mamba_dims().mamba, dtype=dt)
        self.norm_cross = LayerNorm(c.d_model, dtype=dt)
        self.cross_attn = CrossAttention(c.d_model, c.n_heads, dtype=dt)
        self.norm_ff = LayerNorm(c.d_model, dtype=dt)
        self.style_mlp = Dense(c.d_style, 2 * c.d_model, dtype=dt)
        self.ff1 = Dense(c.d_model, c.d_ff, dtype=dt)
        self.ff2 = Dense(c.d_ff, c.d_model, dtype=dt)

    def film_params(self, z_style: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """z_style (B, d_style) -> (gamma, beta) each (B, d_model)."""
        return torch.tanh(self.style_mlp(z_style)).chunk(2, dim=-1)

    def _film_ffn_with(self, x, gamma, beta):
        h = self.norm_ff(x)
        h = gamma[:, None, :] * h + beta[:, None, :]
        return self.ff2(F.gelu(self.ff1(h), approximate="none"))

    def forward(self, x, memory, z_style, memory_mask=None, mamba_state=None):
        h, new_state = self.mamba(self.norm_mamba(x), mamba_state)
        x = x + h
        x = x + self.cross_attn(self.norm_cross(x), memory, memory_mask)
        x = x + self._film_ffn_with(x, *self.film_params(z_style))
        return x, new_state

    def project_memory(self, memory):
        return self.cross_attn.project_memory(memory)

    def step(self, x, K, V, film, memory_mask, mamba_state):
        """One token with precomputed memory K/V and FiLM; x (B, 1, d)."""
        h, new_state = self.mamba.step(self.norm_mamba(x), mamba_state)
        x = x + h
        x = x + self.cross_attn.attend(self.norm_cross(x), K, V, memory_mask)
        x = x + self._film_ffn_with(x, *film)
        return x, new_state


class MambaTTSDecoder(nn.Module):
    """forward(audio_tokens (B,T)|(B,Q,T), text_hidden (B,Tt,d), z_style
    (B,d_style), text_mask, ref_hidden (B,Tr,d), ref_mask) -> logits
    (B, T_flat, vocab_size_audio); step_with_kv for decoding."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        c = self.cfg = cfg
        dt = self.dtype = parse_dtype(c.dtype)
        self.token_embed = Embed(c.vocab_size_audio, c.d_model, dtype=dt)
        self.pos_embed = Embed(c.max_len, c.d_model, dtype=dt)
        self.quant_embed = Embed(c.num_quantizers, c.d_model, dtype=dt)
        for i in range(c.n_layers):
            self.add_module(f"layer_{i}", DecoderLayer(c))
        self.norm_out = LayerNorm(c.d_model, dtype=dt)
        self.head = Dense(c.d_model, c.vocab_size_audio, dtype=torch.float32)

    @property
    def layers(self) -> List[DecoderLayer]:
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.n_layers)]

    def _flatten_ids(self, audio_tokens: torch.Tensor):
        dev = audio_tokens.device
        if audio_tokens.dim() == 3:
            B, Q, T = audio_tokens.shape
            flat = audio_tokens.reshape(B, Q * T)
            quant_ids = torch.arange(Q, device=dev).repeat_interleave(T)[None]
            pos_ids = torch.arange(T, device=dev).repeat(Q)[None]
        elif audio_tokens.dim() == 2:
            B, T = audio_tokens.shape
            flat = audio_tokens
            quant_ids = torch.zeros((1, T), dtype=torch.long, device=dev)
            pos_ids = torch.arange(T, device=dev)[None]
        else:
            raise ValueError("audio_tokens must be (B, T) or (B, Q, T)")
        return flat, quant_ids, pos_ids

    def _build_memory(self, text_hidden, text_mask, ref_hidden, ref_mask):
        B = text_hidden.shape[0]
        if text_mask is None:
            text_mask = torch.ones(text_hidden.shape[:2], dtype=torch.bool, device=text_hidden.device)
        if ref_hidden is None:
            return text_hidden, text_mask
        if ref_mask is None:
            ref_mask = torch.ones((B, ref_hidden.shape[1]), dtype=torch.bool, device=ref_hidden.device)
        memory = torch.cat([ref_hidden.to(text_hidden.dtype), text_hidden], dim=1)
        return memory, torch.cat([ref_mask, text_mask], dim=1)

    def embed_codec_tokens(self, tokens_3d: torch.Tensor) -> torch.Tensor:
        """(B, Q, T) codec ids -> (B, Q*T, d_model) reference hidden states."""
        flat, quant_ids, pos_ids = self._flatten_ids(tokens_3d)
        return self.token_embed(flat) + self.pos_embed(pos_ids) + self.quant_embed(quant_ids)

    def forward(self, audio_tokens, text_hidden, z_style, text_mask=None, ref_hidden=None,
                ref_mask=None, quant_ids=None, pos_ids=None) -> torch.Tensor:
        flat, auto_quant, auto_pos = self._flatten_ids(audio_tokens)
        quant_ids = auto_quant if quant_ids is None else quant_ids
        pos_ids = auto_pos if pos_ids is None else pos_ids
        memory, memory_mask = self._build_memory(text_hidden, text_mask, ref_hidden, ref_mask)
        x = self.token_embed(flat) + self.pos_embed(pos_ids) + self.quant_embed(quant_ids)
        for layer in self.layers:
            x, _ = layer(x, memory, z_style, memory_mask)
        return self.head(self.norm_out(x).to(torch.float32))

    def _embed_step(self, last_token: torch.Tensor, step: int, frames_per_stream: int):
        q_id = min(step // frames_per_stream, self.cfg.num_quantizers - 1)
        pos_id = step % frames_per_stream
        return (self.token_embed(last_token) + self.pos_embed(pos_id)
                + self.quant_embed(q_id))

    def project_memories(self, text_hidden, text_mask=None, ref_hidden=None, ref_mask=None,
                         z_style=None):
        """Everything constant across decode steps: per-layer memory (K, V),
        the memory mask and, given ``z_style``, per-layer FiLM (gamma, beta)."""
        memory, memory_mask = self._build_memory(text_hidden, text_mask, ref_hidden, ref_mask)
        KV = [layer.project_memory(memory) for layer in self.layers]
        films = None if z_style is None else [layer.film_params(z_style) for layer in self.layers]
        return KV, memory_mask, films

    def step_with_kv(self, last_token, KV, memory_mask, films, mamba_states, step: int,
                     frames_per_stream: int):
        """One decode step; last_token (B, 1) -> (logits (B, 1, V), states)."""
        x = self._embed_step(last_token, step, frames_per_stream)
        new_states = []
        for layer, (K, V), film, st in zip(self.layers, KV, films, mamba_states):
            x, ns = layer.step(x, K, V, film, memory_mask, st)
            new_states.append(ns)
        return self.head(self.norm_out(x).to(torch.float32)), new_states

    def init_states(self, batch: int) -> List[MambaState]:
        c = self.cfg.with_mamba_dims()
        dev = self.head.weight.device
        return [init_mamba_state(c.mamba, batch, self.dtype, dev) for _ in range(c.n_layers)]


class DecodeResult(NamedTuple):
    tokens: torch.Tensor  # (B, total_steps) generated token ids
    logits: torch.Tensor  # (B, total_steps, V) per-step logits, or (B, 0)


def next_token(step_logits: torch.Tensor, num_special: int, temperature: float, top_k: int,
               generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask the specials, then argmax (``temperature == 0``) or sample.
    Returns (masked logits (B, V), next token (B, 1))."""
    step_logits = step_logits.clone()
    step_logits[:, :num_special] = -1e9
    if temperature > 0.0:
        logits = step_logits
        if 0 < top_k < logits.shape[-1]:
            kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
            logits = torch.where(logits >= kth, logits, torch.full_like(logits, -1e9))
        probs = torch.softmax(logits / temperature, dim=-1)
        nxt = torch.multinomial(probs, 1, generator=generator)
    else:
        nxt = torch.argmax(step_logits, dim=-1, keepdim=True)
    return step_logits, nxt


def run_decode_loop(step_fn, batch: int, total: int, bos_id: int, num_special: int,
                    temperature: float, top_k: int, generator, collect_logits: bool,
                    device) -> DecodeResult:
    """The autoregressive loop shared by the plain and int8 decodes.
    ``step_fn(token (B, 1), step) -> logits (B, 1, V)`` carries its own state.
    Tokens and logits stay on the device; nothing syncs with the host."""
    token = torch.full((batch, 1), bos_id, dtype=torch.long, device=device)
    tokens = torch.empty((batch, total), dtype=torch.long, device=device)
    logits_out = []
    for step in range(total):
        step_logits, token = next_token(
            step_fn(token, step)[:, 0], num_special, temperature, top_k, generator)
        tokens[:, step] = token[:, 0]
        if collect_logits:
            logits_out.append(step_logits)
    logits = (torch.stack(logits_out, dim=1) if collect_logits
              else torch.zeros((batch, 0), device=device))
    return DecodeResult(tokens=tokens, logits=logits)


@torch.no_grad()
def greedy_decode(
    decoder: MambaTTSDecoder,
    text_hidden: torch.Tensor,
    z_style: torch.Tensor,
    frames_per_stream: int,
    text_mask: Optional[torch.Tensor] = None,
    ref_hidden: Optional[torch.Tensor] = None,
    ref_mask: Optional[torch.Tensor] = None,
    num_streams: Optional[int] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    generator: Optional[torch.Generator] = None,
    collect_logits: bool = False,
) -> DecodeResult:
    """Autoregressive decode over Q * frames_per_stream steps from BOS.
    ``temperature == 0`` -> greedy argmax; otherwise sampling with
    ``generator``."""
    c = decoder.cfg
    B = text_hidden.shape[0]
    Q = num_streams if num_streams is not None else c.num_quantizers
    KV, memory_mask, films = decoder.project_memories(
        text_hidden, text_mask, ref_hidden, ref_mask, z_style)
    states = decoder.init_states(B)

    def step_fn(token, step):
        nonlocal states
        logits, states = decoder.step_with_kv(
            token, KV, memory_mask, films, states, step, frames_per_stream)
        return logits

    return run_decode_loop(step_fn, B, Q * frames_per_stream, c.bos_id, c.num_special_tokens,
                           temperature, top_k, generator, collect_logits, text_hidden.device)
