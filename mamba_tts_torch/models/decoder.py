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
once, then runs the Q*F steps as the JAX package's jitted ``lax.scan`` does
in one device program: on the card a CUDA graph of four in-place steps
(:func:`decode_step_`: the step index is a device tensor, token, logits and
states are written into fixed buffers) captured once per call and replayed
(:func:`run_captured`); on the CPU the same in-place step runs eagerly.
The functional ``step_with_kv`` (returned states) is the step it runs and
the reference it is held to.  ``forward`` (teacher forcing, training) runs
its scans and long-query attention through the Hopper kernels on the card;
with ``DecoderConfig.remat`` each layer is recomputed in the backward
(``torch.utils.checkpoint``), as ``nn.remat`` does in the JAX package.

Parallelism: ``mesh`` shards each layer's Mamba block, cross-attention and
FFN (``ff1`` column-, ``ff2`` row-parallel) over the mesh's "model" axis;
``sp_mesh`` time-shards the Mamba scans (``DecoderConfig.use_sp_scan``
requires it, as in JAX).

Mask convention: True = VALID.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from mamba_tts_torch.config import DecoderConfig
from mamba_tts_torch.device import on_card
from mamba_tts_torch.models.attention import CrossAttention
from mamba_tts_torch.models.layers import Dense, Embed, LayerNorm, parse_dtype, row_parallel
from mamba_tts_torch.models.mamba import MambaBlock, MambaState, init_mamba_state
from mamba_tts_torch.ops import mamba_step
from mamba_tts_torch.ops.decode_attention import decode_attention
from mamba_tts_torch.parallel.comm import copy_to_group
from mamba_tts_torch.parallel.mesh import axis_size, model_group
from mamba_tts_torch.utils.profiling import annotate, count


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DecoderConfig, mesh=None, sp_mesh=None, sp_batch_sharded=False):
        super().__init__()
        c = cfg
        dt = parse_dtype(c.dtype)
        self.tp_group, tp = model_group(mesh, c.d_ff)
        self.norm_mamba = LayerNorm(c.d_model, dtype=dt)
        self.mamba = MambaBlock(c.with_mamba_dims().mamba, dtype=dt, mesh=mesh, sp_mesh=sp_mesh,
                                sp_axis=c.sp_axis, sp_batch_sharded=sp_batch_sharded)
        self.norm_cross = LayerNorm(c.d_model, dtype=dt)
        self.cross_attn = CrossAttention(c.d_model, c.n_heads, dtype=dt, mesh=mesh)
        self.norm_ff = LayerNorm(c.d_model, dtype=dt)
        self.style_mlp = Dense(c.d_style, 2 * c.d_model, dtype=dt)
        self.ff1 = Dense(c.d_model, c.d_ff // tp, dtype=dt)
        self.ff2 = Dense(c.d_ff // tp, c.d_model, dtype=dt)

    def film_params(self, z_style: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """z_style (B, d_style) -> (gamma, beta) each (B, d_model)."""
        return torch.tanh(self.style_mlp(z_style)).chunk(2, dim=-1)

    def _film_ffn_with(self, x, gamma, beta):
        h = self.norm_ff(x)
        h = copy_to_group(gamma[:, None, :] * h + beta[:, None, :], self.tp_group)
        return row_parallel(self.ff2, F.gelu(self.ff1(h), approximate="none"), self.tp_group)

    def forward(self, x, memory, z_style, memory_mask=None, mamba_state=None):
        h, new_state = self.mamba(self.norm_mamba(x), mamba_state)
        x = x + h
        x = x + self.cross_attn(self.norm_cross(x), memory, memory_mask)
        x = x + self._film_ffn_with(x, *self.film_params(z_style))
        return x, new_state

    def project_memory(self, memory):
        return self.cross_attn.project_memory(memory)

    def step(self, x, K, V, film, memory_mask, mamba_state, inplace=False):
        """One token with precomputed memory K/V and FiLM; x (B, 1, d);
        ``inplace`` as in ``MambaBlock.step``."""
        h, new_state = self.mamba.step(self.norm_mamba(x), mamba_state, inplace)
        x = x + h
        x = x + self.cross_attn.attend(self.norm_cross(x), K, V, memory_mask)
        x = x + self._film_ffn_with(x, *film)
        return x, new_state


class MambaTTSDecoder(nn.Module):
    """forward(audio_tokens (B,T)|(B,Q,T), text_hidden (B,Tt,d), z_style
    (B,d_style), text_mask, ref_hidden (B,Tr,d), ref_mask) -> logits
    (B, T_flat, vocab_size_audio); step_with_kv for decoding.

    ``mesh``: tensor parallelism over its "model" axis, the batch rows split
    over its "data" axis.  ``sp_mesh``: time-sharded scans over
    ``sp_mesh[cfg.sp_axis]``; when it is ``mesh`` and the sp axis is
    "data", the scan gathers the rows split over that axis first."""

    def __init__(self, cfg: DecoderConfig, sp_mesh=None, mesh=None):
        super().__init__()
        c = self.cfg = cfg
        if c.use_sp_scan and sp_mesh is None:
            raise ValueError(
                "DecoderConfig.use_sp_scan=True requires constructing the model with the "
                "mesh: MambaTTSDecoder(cfg, sp_mesh=mesh) / MambaTTS(cfg, sp_mesh=mesh)")
        if sp_mesh is not None and mesh is not None and sp_mesh is not mesh:
            raise ValueError("sp_mesh must be the model's mesh when both are given")
        if sp_mesh is not None and c.sp_axis == "model" and axis_size(sp_mesh, "model") > 1:
            raise ValueError("the scan's time axis cannot shard over the tensor-parallel "
                             "'model' axis; use sp_axis='data'")
        batch_sharded = mesh is not None and c.sp_axis == "data"
        dt = self.dtype = parse_dtype(c.dtype)
        self.token_embed = Embed(c.vocab_size_audio, c.d_model, dtype=dt)
        self.pos_embed = Embed(c.max_len, c.d_model, dtype=dt)
        self.quant_embed = Embed(c.num_quantizers, c.d_model, dtype=dt)
        for i in range(c.n_layers):
            self.add_module(f"layer_{i}", DecoderLayer(c, mesh, sp_mesh, batch_sharded))
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
            if self.cfg.remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(
                    lambda x, layer=layer: layer(x, memory, z_style, memory_mask)[0], x,
                    use_reentrant=False)
            else:
                x, _ = layer(x, memory, z_style, memory_mask)
        return self.head(self.norm_out(x).to(torch.float32))

    def _embed_step(self, last_token: torch.Tensor, step: torch.Tensor, frames_per_stream: int):
        """``step`` is a (1,) integer tensor on the device (the captured
        decode's index, read without a host sync)."""
        q_id = torch.clamp(step // frames_per_stream, max=self.cfg.num_quantizers - 1)[None]
        pos_id = (step % frames_per_stream)[None]
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

    def step_with_kv(self, last_token, KV, memory_mask, films, mamba_states,
                     step: torch.Tensor, frames_per_stream: int, inplace: bool = False):
        """One decode step; last_token (B, 1) -> (logits (B, 1, V), states).
        ``step`` is a (1,) integer tensor on the device.  ``inplace``: each
        layer's new state is written over ``mamba_states``' tensors, which
        are returned (the captured decode's carry)."""
        x = self._embed_step(last_token, step, frames_per_stream)
        new_states = []
        for layer, (K, V), film, st in zip(self.layers, KV, films, mamba_states):
            x, ns = layer.step(x, K, V, film, memory_mask, st, inplace)
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


DECODE_GRAPH_STEPS = 4  # steps per captured CUDA graph: the JAX scan's unroll=4


class DecodeCarry(NamedTuple):
    """The decode's static buffers, updated in place by :func:`decode_step_`
    (the JAX scan's carry and outputs): the step index (1,) and the last
    token (B, 1) on the device, the output tokens (B, total), the per-step
    logits (B, total, V) or None, and every Mamba layer's state.  ``cache``:
    the jamba decoder's K/V caches beside the states (``models/hybrid.py``
    ``HybridCache``, written in place by its step), else None."""
    step: torch.Tensor
    token: torch.Tensor
    tokens: torch.Tensor
    logits: Optional[torch.Tensor]
    states: List[MambaState]
    cache: Optional[NamedTuple] = None


def init_carry(cfg: DecoderConfig, batch: int, total: int, dtype, device,
               collect_logits: bool) -> DecodeCarry:
    cc = cfg.with_mamba_dims()
    return DecodeCarry(
        step=torch.zeros((1,), dtype=torch.long, device=device),
        token=torch.full((batch, 1), cfg.bos_id, dtype=torch.long, device=device),
        tokens=torch.zeros((batch, total), dtype=torch.long, device=device),
        logits=(torch.zeros((batch, total, cfg.vocab_size_audio), dtype=torch.float32,
                            device=device) if collect_logits else None),
        states=[init_mamba_state(cc.mamba, batch, dtype, device) for _ in range(cfg.n_layers)])


def decode_step_(step_fn, carry: DecodeCarry, num_special: int, temperature: float = 0.0,
                 top_k: int = 0, generator: Optional[torch.Generator] = None) -> None:
    """One decode step at the device index ``carry.step``, written into
    ``carry`` in place.  ``step_fn(token (B, 1), states, step (1,))`` returns
    (logits (B, 1, V), new states): ``MambaTTSDecoder.step_with_kv`` or the
    int8 ``quant_step_with_kv`` with the request's constants bound.  The next
    token and the masked logits go to column ``step`` by ``index_copy_``, the
    states are copied over (not where ``step_fn`` returned the carry's own
    tensors, having updated them in place), the index advances.  The JAX step is pure and
    carries its state through ``lax.scan``; the port updates in place so that
    a captured CUDA graph can replay the step on fixed buffers, with no host
    sync."""
    logits, new_states = step_fn(carry.token, carry.states, carry.step)
    step_logits, nxt = next_token(logits[:, 0], num_special, temperature, top_k, generator)
    carry.tokens.index_copy_(1, carry.step, nxt)
    if carry.logits is not None:
        carry.logits.index_copy_(1, carry.step, step_logits[:, None])
    carry.token.copy_(nxt)
    for st, ns in zip(carry.states, new_states):
        for old, new in zip(st, ns):
            if new is not old:
                old.copy_(new)
    carry.step.add_(1)


def graph_split(total: int, steps_per_graph: int = DECODE_GRAPH_STEPS) -> Tuple[int, int]:
    """(eager warm-up steps, graph replays) of a captured ``total``-step
    decode: 1 to ``steps_per_graph`` eager steps, then whole graphs."""
    r = max(0, (total - 1) // steps_per_graph)
    return total - steps_per_graph * r, r


_SIDE_STREAMS: Dict[int, torch.cuda.Stream] = {}  # device index -> the decode's side stream


def _side_stream() -> torch.cuda.Stream:
    """The current device's one side stream for the decode's warm-up and
    capture, made once.  PyTorch keeps a cuBLAS workspace for every (handle,
    stream) pair it has run a product on and frees none, so a new stream
    each call left 33 MiB of device memory behind every request."""
    dev = torch.cuda.current_device()
    if dev not in _SIDE_STREAMS:
        _SIDE_STREAMS[dev] = torch.cuda.Stream()
    return _SIDE_STREAMS[dev]


def run_captured(step_fn, total: int, generator: Optional[torch.Generator] = None,
                 steps_per_graph: int = DECODE_GRAPH_STEPS, counters: Sequence = (),
                 path: str = "graph") -> None:
    """Run ``step_fn`` (one in-place step on static buffers) ``total`` times
    on the card: the first ``total - steps_per_graph * r`` steps (1 to
    ``steps_per_graph``) run eagerly on the device's side stream, which is
    also the warm-up that capture needs; then ``steps_per_graph`` steps are
    captured on that stream into one CUDA graph and replayed ``r`` times.
    This is the counterpart of the JAX package's ``jax.lax.scan(body, ...,
    unroll=4)`` under ``jit``.
    ``generator`` (sampled decode) is registered with the graph, so every
    replay draws fresh numbers from it.  A failed capture raises.

    ``counters`` are kernel wrappers whose ``launches`` count executions:
    the calls made while capturing are taken back, and each replay adds the
    graph's count.  Traced: the warm-up and the capture are the span
    ``decode.capture`` (its ``steps``: the warm-up's; each capture counts
    one ``decode.graph_captures``), the replays ``decode.run`` (its
    ``path``)."""
    warm, r = graph_split(total, steps_per_graph)
    with annotate("decode.capture", steps=warm):
        side = _side_stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(warm):
                step_fn()
        torch.cuda.current_stream().wait_stream(side)
        if r == 0:
            return
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        before = [c.launches for c in counters]
        with torch.cuda.graph(graph, stream=side):
            for _ in range(steps_per_graph):
                step_fn()
        count("decode.graph_captures")
    per_graph = [c.launches - b for c, b in zip(counters, before)]
    for c, b in zip(counters, before):
        c.launches = b
    with annotate("decode.run", device_time=True, steps=steps_per_graph * r, path=path):
        for _ in range(r):
            graph.replay()
    for c, n in zip(counters, per_graph):
        c.launches += n * r


def run_eager(step_fn, total: int) -> None:
    """Run ``step_fn`` ``total`` times in a host loop (the decode off the
    card), traced as ``decode.run``."""
    with annotate("decode.run", device_time=True, steps=total, path="eager"):
        for _ in range(total):
            step_fn()


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
    ``generator``.  On the card the step loop replays a captured CUDA graph
    (:func:`run_captured`), and the one-query attention kernel's executions
    (the warm-up's and the replays') are counted as
    ``decode.attention_launches``, and those of the Mamba step's two kernels
    (``ops/mamba_step.py``, updating the carry's states in place) as
    ``decode.mamba_step_launches``, while tracing is on; on the CPU it runs
    :func:`decode_step_` eagerly."""
    c = decoder.cfg
    B = text_hidden.shape[0]
    Q = num_streams if num_streams is not None else c.num_quantizers
    total = Q * frames_per_stream
    with annotate("decode.memory"):
        KV, memory_mask, films = decoder.project_memories(
            text_hidden, text_mask, ref_hidden, ref_mask, z_style)
    with annotate("decode.plan"):
        carry = init_carry(c, B, total, decoder.dtype, text_hidden.device, collect_logits)

    def step(token, states, index):
        return decoder.step_with_kv(token, KV, memory_mask, films, states, index,
                                    frames_per_stream, inplace=True)

    def step_fn():
        decode_step_(step, carry, c.num_special_tokens, temperature, top_k, generator)

    if on_card(text_hidden):
        before = decode_attention.launches, mamba_step.launches
        run_captured(step_fn, total, generator if temperature > 0.0 else None,
                     counters=(decode_attention, mamba_step))
        # a decode that does not take a kernel counts nothing for it
        for name, op, b in (("decode.attention_launches", decode_attention, before[0]),
                            ("decode.mamba_step_launches", mamba_step, before[1])):
            if op.launches - b:
                count(name, op.launches - b)
    else:
        run_eager(step_fn, total)
    logits = (carry.logits if collect_logits
              else torch.zeros((B, 0), device=text_hidden.device))
    return DecodeResult(tokens=carry.tokens, logits=logits)
