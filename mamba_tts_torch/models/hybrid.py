"""The jamba block as the codec-token decoder (``DecoderConfig.block ==
"jamba"``): AI21's Jamba layers (Hugging Face ``modeling_jamba``) over a
prefix that carries the TTS conditioning.  The JAX package has no
counterpart.

Per layer, with the kind given by the layer pattern (``layer_kinds``:
attention where ``i % attn_layer_period == attn_layer_offset``)::

    x += Mamba(RMSNorm(x))   or   x += SelfAttention(RMSNorm(x))
    x += down(silu(gate(RMSNorm(x))) * up(RMSNorm(x)))

The Mamba mixer is Mamba-1 with RMSNorms over dt, B and C
(``MambaBlock(inner_norm_eps=...)``); the attention is causal, grouped-query
(``n_kv_heads``), with no positional encoding; a final RMSNorm feeds a head
tied to the token embedding.

Conditioning is a prefix, each row's ``[style || voice || text]``: the
style sample projected from ``d_style`` (one position), the voice prompt's
codec grid embedded by the token, frame-position and quantizer tables
(``embed_codec_tokens``, quantizer-major, as the MAVE decoder embeds it)
and the text encoder's output projected from its width.  Each row keeps
only its valid positions, packed to the front, so no padding enters its
scans, convs or attention; the decoded tokens follow from BOS, embedded as
the voice grid is.  The vocabulary is the codec's ids.

- :meth:`HybridDecoder.forward` — teacher forcing over prefix + tokens,
  the logits of the token positions (the signature of
  ``MambaTTSDecoder.forward``, so ``MambaTTS.compute_losses`` trains it).
  Off the card only: on the card a recorded gradient raises.
- :meth:`HybridDecoder.prefill` — the prefix through every layer: each
  Mamba layer's state and each attention layer's K/V at each row's own
  length (``MambaBlock.forward(lengths=...)``; the scan kernel on the card).
- :meth:`HybridDecoder.step_with_cache` — one token for every row: Mamba
  states returned, K/V written into the cache at each row's position.
- :func:`hybrid_greedy_decode` — prefill, then the captured decode
  (``models/decoder.py`` ``run_captured``) over a carry that holds the
  Mamba states and the K/V caches side by side.

Mask convention: True = VALID.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mamba_tts_torch.config import DecoderConfig
from mamba_tts_torch.device import on_card
from mamba_tts_torch.models.attention import SelfAttention
from mamba_tts_torch.models.decoder import (
    DecodeCarry,
    DecodeResult,
    decode_step_,
    run_captured,
    run_eager,
)
from mamba_tts_torch.models.layers import Dense, Embed, RMSNorm, parse_dtype
from mamba_tts_torch.models.mamba import MambaBlock, MambaState
from mamba_tts_torch.ops import mamba_step
from mamba_tts_torch.ops.decode_attention import decode_attention
from mamba_tts_torch.utils.profiling import annotate, count


NORM_EPS = 1e-6  # every RMSNorm's (Jamba2-3B's rms_norm_eps)


def layer_param_counts(cfg: DecoderConfig) -> dict:
    """Parameters of one layer of each kind, counted from the configuration
    (the modules below, without building them): ``mamba`` and ``attention``
    with their mixer and MLP parts, and ``layers``, the whole stack's."""
    d, m = cfg.d_model, cfg.with_mamba_dims().mamba
    di, r, n = m.d_inner, m.dt_rank_actual, m.d_state
    mixer = (d * 2 * di + (2 * di if m.use_bias else 0)            # in_proj
             + m.d_conv * di + (di if m.conv_bias else 0)           # conv
             + di * (r + 2 * n)                                     # x_proj
             + r * di + di                                          # dt_proj
             + di * n + di                                          # A_log, D
             + di * d + (d if m.use_bias else 0)                    # out_proj
             + r + 2 * n)                                           # dt, B, C norms
    hd = d // cfg.n_heads
    attn = d * cfg.n_heads * hd + 2 * d * cfg.kv_heads * hd + cfg.n_heads * hd * d
    mlp = 3 * d * cfg.d_ff
    norms = 2 * d
    kinds = cfg.layer_kinds()
    out = {"mamba_mixer": mixer, "attention_mixer": attn, "mlp": mlp,
           "mamba": mixer + mlp + norms, "attention": attn + mlp + norms}
    out["layers"] = sum(out[k] for k in kinds)
    return out


class GatedMLP(nn.Module):
    """``JambaMLP``: down(silu(gate(x)) * up(x)), no biases."""

    def __init__(self, d_model: int, d_ff: int, dtype=torch.bfloat16):
        super().__init__()
        self.gate_proj = Dense(d_model, d_ff, bias=False, dtype=dtype)
        self.up_proj = Dense(d_model, d_ff, bias=False, dtype=dtype)
        self.down_proj = Dense(d_ff, d_model, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class HybridLayer(nn.Module):
    """One Jamba layer: a Mamba or a self-attention mixer, then the MLP."""

    def __init__(self, cfg: DecoderConfig, kind: str):
        super().__init__()
        dt = parse_dtype(cfg.dtype)
        self.kind = kind
        self.norm_mixer = RMSNorm(cfg.d_model, NORM_EPS, dt)
        if kind == "mamba":
            self.mamba = MambaBlock(cfg.with_mamba_dims().mamba, dtype=dt,
                                    inner_norm_eps=NORM_EPS)
        else:
            self.attn = SelfAttention(cfg.d_model, cfg.n_heads, cfg.kv_heads, dtype=dt)
        self.norm_mlp = RMSNorm(cfg.d_model, NORM_EPS, dt)
        self.mlp = GatedMLP(cfg.d_model, cfg.d_ff, dtype=dt)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None):
        """x (B, T, d) -> (x, the mixer's state: a ``MambaState`` or (K, V))."""
        h = self.norm_mixer(x)
        if self.kind == "mamba":
            h, state = self.mamba(h, lengths=lengths)
        else:
            h, k, v = self.attn(h)
            state = (k, v)
        x = x + h
        return x + self.mlp(self.norm_mlp(x)), state

    def step(self, x: torch.Tensor, state, cache, rows, pos):
        """One token: a Mamba layer writes its new state over ``state`` and
        returns it, an attention layer writes into ``cache`` = (K, V, mask)
        and returns None."""
        h = self.norm_mixer(x)
        if self.kind == "mamba":
            h, state = self.mamba.step(h, state, inplace=True)
        else:
            h, state = self.attn.step(h, *cache, rows, pos), None
        x = x + h
        return x + self.mlp(self.norm_mlp(x)), state


class HybridDecoder(nn.Module):
    """The jamba decoder; see the module's docstring.  ``d_text``: the
    width of the text encoder's output.  Every product's matrix (the Dense
    weights, the Mamba conv taps) is held in the compute dtype, as served;
    embeddings, biases, norms, A_log and D stay f32."""

    def __init__(self, cfg: DecoderConfig, d_text: int):
        super().__init__()
        c = self.cfg = cfg
        dt = self.dtype = parse_dtype(c.dtype)
        self.token_embed = Embed(c.vocab_size_audio, c.d_model, dtype=dt)
        self.pos_embed = Embed(c.max_len, c.d_model, dtype=dt)
        self.quant_embed = Embed(c.num_quantizers, c.d_model, dtype=dt)
        self.style_proj = Dense(c.d_style, c.d_model, dtype=dt)
        self.text_proj = Dense(d_text, c.d_model, dtype=dt)
        for i, kind in enumerate(c.layer_kinds()):
            self.add_module(f"layer_{i}", HybridLayer(c, kind))
        self.norm_out = RMSNorm(c.d_model, NORM_EPS)
        for m in self.modules():
            if isinstance(m, Dense):
                m.weight.data = m.weight.data.to(dt)
            elif isinstance(m, MambaBlock):
                m.conv_w.data = m.conv_w.data.to(dt)

    @property
    def layers(self) -> List[HybridLayer]:
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.n_layers)]

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm, then the head tied to the token embedding, in f32."""
        return F.linear(self.norm_out(x), self.token_embed.weight.float())

    # ------------------------------------------------------------ embedding

    def embed_codec_tokens(self, tokens_3d: torch.Tensor) -> torch.Tensor:
        """(B, Q, T) codec ids -> (B, Q*T, d): token + frame position +
        quantizer, quantizer-major (the voice prompt's grid)."""
        B, Q, T = tokens_3d.shape
        dev = tokens_3d.device
        quant = torch.arange(Q, device=dev).repeat_interleave(T)[None]
        pos = torch.arange(T, device=dev).repeat(Q)[None]
        return self.embed_tokens(tokens_3d.reshape(B, Q * T), quant, pos)

    def embed_tokens(self, ids, quant_ids, pos_ids) -> torch.Tensor:
        return self.token_embed(ids) + self.pos_embed(pos_ids) + self.quant_embed(quant_ids)

    def prefix(self, text_hidden, text_mask, z_style, ref_hidden, ref_mask
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each row's ``[style || voice || text]`` with its valid positions
        packed to the front in order: (prefix (B, P, d), lengths (B,)), P the
        longest row's length."""
        B, dev = text_hidden.shape[0], text_hidden.device
        if text_mask is None:
            text_mask = torch.ones(text_hidden.shape[:2], dtype=torch.bool, device=dev)
        parts = [self.style_proj(z_style)[:, None]]
        valid = [torch.ones((B, 1), dtype=torch.bool, device=dev)]
        if ref_hidden is not None:
            parts.append(ref_hidden.to(self.dtype))
            valid.append(ref_mask if ref_mask is not None else
                         torch.ones(ref_hidden.shape[:2], dtype=torch.bool, device=dev))
        parts.append(self.text_proj(text_hidden))
        valid.append(text_mask)
        x, valid = torch.cat(parts, dim=1), torch.cat(valid, dim=1)
        lengths = valid.sum(dim=1)
        order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
        P = int(lengths.max())
        packed = torch.gather(x, 1, order[:, :P, None].expand(-1, -1, x.shape[-1]))
        return packed, lengths

    # ------------------------------------------------------------ teacher forcing

    def forward(self, audio_tokens, text_hidden, z_style, text_mask=None, ref_hidden=None,
                ref_mask=None, quant_ids=None, pos_ids=None) -> torch.Tensor:
        """Teacher-forced logits (B, T, V) of the token positions: row b runs
        over its prefix, then the tokens (BOS first) from position
        ``lengths[b]``; what follows a row's last token is never read."""
        if torch.is_grad_enabled() and on_card(text_hidden):
            raise NotImplementedError(
                "the jamba decoder trains only off the card: its causal self-attention at "
                "head_dim 128 with grouped K/V heads has no flash kernel yet")
        if audio_tokens.dim() == 3:
            B, Q, T = audio_tokens.shape
            flat = audio_tokens.reshape(B, Q * T)
            dev = flat.device
            quant_ids = torch.arange(Q, device=dev).repeat_interleave(T)[None]
            pos_ids = torch.arange(T, device=dev).repeat(Q)[None]
        else:
            flat = audio_tokens
        B, T = flat.shape
        prefix, lengths = self.prefix(text_hidden, text_mask, z_style, ref_hidden, ref_mask)
        tokens = self.embed_tokens(flat, quant_ids, pos_ids)
        at = lengths[:, None] + torch.arange(T, device=flat.device)[None]  # (B, T)
        x = torch.cat([prefix, prefix.new_zeros((B, T, prefix.shape[-1]))], dim=1)
        x = x.scatter(1, at[..., None].expand(-1, -1, x.shape[-1]), tokens.to(x.dtype))
        for layer in self.layers:
            x, _ = layer(x)
        return self.head(torch.gather(x, 1, at[..., None].expand(-1, -1, x.shape[-1])))

    # ------------------------------------------------------------ decoding

    def prefill(self, prefix: torch.Tensor, lengths: torch.Tensor):
        """The prefix through every layer: (each Mamba layer's state after
        its row's ``lengths[b]`` positions, each attention layer's (K, V)
        (B, P, H_kv, head_dim))."""
        states, kvs = [], []
        x = prefix
        for layer in self.layers:
            x, st = layer(x, lengths)
            (states if layer.kind == "mamba" else kvs).append(st)
        return states, kvs

    def _embed_step(self, token: torch.Tensor, step: torch.Tensor, frames_per_stream: int):
        q_id = torch.clamp(step // frames_per_stream, max=self.cfg.num_quantizers - 1)[None]
        pos_id = (step % frames_per_stream)[None]
        return self.embed_tokens(token, q_id, pos_id)

    def step_with_cache(self, token, states: List[MambaState], cache: "HybridCache",
                        step: torch.Tensor, frames_per_stream: int):
        """One decode step at device index ``step`` (1,): token (B, 1) ->
        (logits (B, 1, V), the Mamba layers' new states, written over
        ``states``' tensors, which are returned: the captured decode's
        carry).  The attention layers write the token's K/V at each row's
        position ``lengths + step`` of ``cache`` and attend over its valid
        keys."""
        x = self._embed_step(token, step, frames_per_stream)
        pos = cache.lengths + step
        new, it_s, it_c = [], iter(states), iter(zip(cache.K, cache.V))
        for layer in self.layers:
            if layer.kind == "mamba":
                x, st = layer.step(x, next(it_s), None, None, None)
                new.append(st)
            else:
                K, V = next(it_c)
                x, _ = layer.step(x, None, (K, V, cache.mask), cache.rows, pos)
        return self.head(x), new


class HybridCache(NamedTuple):
    """The attention layers' static K/V caches (B, Tc, H_kv, head_dim) in
    the compute dtype, the valid-key mask (B, Tc), each row's prefix length
    (B,) and the row indices (B,): written in place by the decode steps."""
    K: List[torch.Tensor]
    V: List[torch.Tensor]
    mask: torch.Tensor
    lengths: torch.Tensor
    rows: torch.Tensor


def init_cache(kvs, lengths: torch.Tensor, capacity: int) -> HybridCache:
    """Caches of ``capacity`` positions holding the prefill's K/V, the mask
    valid below each row's length."""
    B, P = kvs[0][0].shape[:2] if kvs else (lengths.shape[0], 0)
    Ks, Vs = [], []
    for k, v in kvs:
        for src, out in ((k, Ks), (v, Vs)):
            buf = src.new_zeros((B, capacity) + tuple(src.shape[2:]))
            buf[:, :P] = src
            out.append(buf)
    dev = lengths.device
    mask = torch.arange(capacity, device=dev)[None] < lengths[:, None]
    return HybridCache(Ks, Vs, mask, lengths, torch.arange(lengths.shape[0], device=dev))


@torch.no_grad()
def hybrid_greedy_decode(
    decoder: HybridDecoder,
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
    """Prefill every row's prefix, then decode Q * frames_per_stream steps
    from BOS, all rows in lockstep (greedy, or sampled at ``temperature``
    with ``generator``).  On the card the steps replay a captured CUDA graph
    (``run_captured``, traced as ``decode.run`` with ``path="hybrid"``) and
    the self-attention kernel's executions count as
    ``decode.self_attention_launches``, those of the Mamba step's two
    kernels (the carry's states updated in place) as
    ``decode.mamba_step_launches``; on the CPU they run eagerly."""
    c = decoder.cfg
    B = text_hidden.shape[0]
    total = (num_streams or c.num_quantizers) * frames_per_stream
    with annotate("decode.prefill", device_time=True, rows=B) as span:
        prefix, lengths = decoder.prefix(text_hidden, text_mask, z_style, ref_hidden, ref_mask)
        states, kvs = decoder.prefill(prefix, lengths)
        if span is not None:  # the longest row's positions, and each row's
            span.attrs.update(positions=prefix.shape[1], lengths=lengths)
    dev = text_hidden.device
    with annotate("decode.plan"):
        cache = init_cache(kvs, lengths, prefix.shape[1] + total)
        del kvs, prefix
        carry = DecodeCarry(
            step=torch.zeros((1,), dtype=torch.long, device=dev),
            token=torch.full((B, 1), c.bos_id, dtype=torch.long, device=dev),
            tokens=torch.zeros((B, total), dtype=torch.long, device=dev),
            logits=(torch.zeros((B, total, c.vocab_size_audio), dtype=torch.float32, device=dev)
                    if collect_logits else None),
            states=states, cache=cache)

    def step(token, sts, index):
        return decoder.step_with_cache(token, sts, carry.cache, index, frames_per_stream)

    def step_fn():
        decode_step_(step, carry, c.num_special_tokens, temperature, top_k, generator)

    if on_card(text_hidden):
        before = decode_attention.launches, mamba_step.launches
        run_captured(step_fn, total, generator if temperature > 0.0 else None,
                     counters=(decode_attention, mamba_step), path="hybrid")
        count("decode.self_attention_launches", decode_attention.launches - before[0])
        count("decode.mamba_step_launches", mamba_step.launches - before[1])
    else:
        run_eager(step_fn, total)
    logits = carry.logits if collect_logits else torch.zeros((B, 0), device=dev)
    return DecodeResult(tokens=carry.tokens, logits=logits)
