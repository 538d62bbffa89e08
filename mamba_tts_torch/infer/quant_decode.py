"""Int8 weight-streaming greedy decode (the serving path) — counterpart of
``mamba_tts_tpu/infer/quant_decode.py``.

Every large per-step product (Mamba in/out projections, attention q/o, the
two FFN layers: 6 per layer per token) streams its weights as int8 through
:func:`mamba_tts_torch.ops.int8_matvec.int8_matvec`, the hand-written Hopper
kernel on the card.  The numerically sensitive small tensors stay full
precision: x_proj/dt_proj, conv taps, A/D, LayerNorms, embeddings and the
f32 vocab head.  ``int8_kv`` also stores the per-layer cross-attention K/V
as int8 with per-(batch, head, channel) scales.

The step follows ``MambaTTSDecoder.step_with_kv`` with the JAX int8 step's
f32 accumulation and bf16 rounding points, which depart from the default
step in two places: the ``dt_proj`` bias is added in f32 after the product,
and the attention is plain f32 matmuls over the K/V.

The JAX package runs the whole decode as one ``jax.lax.scan`` under ``jit``:
one device program per request.  The port's counterpart, on the card, is a
CUDA graph of four steps captured once per call and replayed
(``models.decoder.run_step_decode``, shared with the other step decodes):
the step reads its index from a device tensor and writes its token, logits
and states into fixed buffers in place (``models.decoder.decode_step_``,
also shared, given :func:`quant_step_with_kv`), so a replay
needs no host work beyond the launch.  On the CPU the same in-place step
runs eagerly.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from mamba_tts_torch.config import DecoderConfig
from mamba_tts_torch.models.attention import mask_bias
from mamba_tts_torch.models.decoder import (
    DecodeResult,
    MambaTTSDecoder,
    init_carry,
    run_step_decode,
)
from mamba_tts_torch.models.mamba import MambaState
from mamba_tts_torch.ops.int8_matvec import int8_matvec, quantize_weight
from mamba_tts_torch.ops.selective_scan import selective_scan_step
from mamba_tts_torch.utils.profiling import annotate

F32 = torch.float32


def _q(dense) -> dict:
    w_q, scale = quantize_weight(dense.weight.detach().T)  # kernel layout (K, N)
    return {"w_q": w_q.contiguous(), "scale": scale.contiguous()}


def _qb(dense) -> dict:
    return {**_q(dense), "bias": dense.bias.detach().to(F32)}


@torch.no_grad()
def quantize_decoder_params(decoder: MambaTTSDecoder) -> dict:
    """Decoder module -> int8 decode tree.  Non-quantized tensors are stored
    at the decoder compute dtype, on the decoder's device."""
    cfg = decoder.cfg
    bf = decoder.dtype

    def ln(m):
        return {"scale": m.weight.detach().to(F32), "bias": m.bias.detach().to(F32)}

    layers = []
    for layer in decoder.layers:
        m, ca = layer.mamba, layer.cross_attn
        layers.append({
            "norm_mamba": ln(layer.norm_mamba),
            "norm_cross": ln(layer.norm_cross),
            "norm_ff": ln(layer.norm_ff),
            "in_proj": _q(m.in_proj),
            "conv_w": m.conv_w.detach().to(bf),
            "conv_b": None if m.conv_b is None else m.conv_b.detach().to(bf),
            "x_proj_k": m.x_proj.weight.detach().T.to(bf).contiguous(),
            "dt_proj_k": m.dt_proj.weight.detach().T.to(bf).contiguous(),
            "dt_proj_b": m.dt_proj.bias.detach().to(F32),
            "A": -torch.exp(m.A_log.detach().to(F32)),
            "D": m.D.detach().to(F32),
            "out_proj": _q(m.out_proj),
            "q_proj": _qb(ca.q_proj),
            "o_proj": _qb(ca.o_proj),
            "ff1": _qb(layer.ff1),
            "ff2": _qb(layer.ff2),
        })
    return {
        "token_embed": decoder.token_embed.weight.detach().to(bf),
        "pos_embed": decoder.pos_embed.weight.detach().to(bf),
        "quant_embed": decoder.quant_embed.weight.detach().to(bf),
        "layers": layers,
        "norm_out": ln(decoder.norm_out),
        "head_k": decoder.head.weight.detach().T.to(F32).contiguous(),
        "head_b": decoder.head.bias.detach().to(F32),
    }


def _layer_norm(x: torch.Tensor, p: dict, eps: float = 1e-6) -> torch.Tensor:
    """f32 statistics, eps 1e-6, output in ``x.dtype``."""
    y = F.layer_norm(x.to(F32), (x.shape[-1],), p["scale"], p["bias"], eps)
    return y.to(x.dtype)


def _mv(x, q, dtype):
    return int8_matvec(x, q["w_q"], q["scale"], bias=q.get("bias"), out_dtype=dtype)


def _mamba_step(lp, x_t, state: MambaState, cfg: DecoderConfig):
    """MambaBlock.step with int8 in/out projections; x_t (B, d)."""
    dt_c = lp["conv_w"].dtype
    m = cfg.with_mamba_dims().mamba
    xin, z = _mv(x_t, lp["in_proj"], dt_c).chunk(2, dim=-1)
    window = torch.cat([state.conv.to(xin.dtype), xin[:, None]], dim=1)
    conv_out = torch.einsum("bkd,kd->bd", window, lp["conv_w"].to(xin.dtype))
    if lp["conv_b"] is not None:
        conv_out = conv_out + lp["conv_b"].to(xin.dtype)
    x_conv = F.silu(conv_out)
    r = m.dt_rank_actual
    dt_raw, Bm, Cm = torch.split(x_conv @ lp["x_proj_k"], [r, m.d_state, m.d_state], dim=-1)
    dt = F.softplus((dt_raw @ lp["dt_proj_k"]).to(F32) + lp["dt_proj_b"])
    y, ssm_state = selective_scan_step(x_conv, dt, lp["A"], Bm, Cm, lp["D"], state.ssm)
    y = y * F.silu(z)
    return _mv(y, lp["out_proj"], dt_c), MambaState(conv=window[:, 1:], ssm=ssm_state)


def quantize_kv(KV) -> List[dict]:
    """Per-(batch, head, channel) symmetric int8 over the memory axis: K's
    scale folds into the query before q.K, V's applies after probs.V."""
    out = []
    for K, V in KV:
        Kf, Vf = K.to(F32), V.to(F32)
        ks = torch.clamp(Kf.abs().amax(dim=2, keepdim=True), min=1e-8) / 127.0
        vs = torch.clamp(Vf.abs().amax(dim=2, keepdim=True), min=1e-8) / 127.0
        k_q = torch.clamp(torch.round(Kf / ks), -127, 127).to(torch.int8)
        v_q = torch.clamp(torch.round(Vf / vs), -127, 127).to(torch.int8)
        out.append({"k_q": k_q, "k_s": ks, "v_q": v_q, "v_s": vs})
    return out


def _attend_step(lp, x_t, KVe, memory_mask, cfg: DecoderConfig):
    """1-query attention against precomputed K/V (full-precision (K, V) or an
    int8 dict from :func:`quantize_kv`), int8 q/o projections; x_t (B, d)."""
    B, d = x_t.shape
    dt_c = x_t.dtype
    H = cfg.n_heads
    hd = d // H
    q = _mv(x_t, lp["q_proj"], dt_c).reshape(B, H, 1, hd)
    scale = hd ** -0.5
    if isinstance(KVe, dict):
        qk = (q.to(F32) * KVe["k_s"]).to(dt_c)
        logits = torch.matmul(qk.to(F32), KVe["k_q"].to(F32).transpose(-1, -2)) * scale
    else:
        K, _ = KVe
        logits = torch.matmul(q.to(F32), K.to(F32).transpose(-1, -2)) * scale
    if memory_mask is not None:
        logits = logits + mask_bias(memory_mask)
    if isinstance(KVe, dict):
        probs = torch.softmax(logits, dim=-1).to(dt_c)
        out = torch.matmul(probs, KVe["v_q"].to(dt_c))
        out = (out.to(F32) * KVe["v_s"]).to(dt_c).reshape(B, d)
    else:
        _, V = KVe
        probs = torch.softmax(logits, dim=-1).to(V.dtype)
        out = torch.matmul(probs, V).reshape(B, d)
    return _mv(out, lp["o_proj"], dt_c)


def _step_embed(qparams: dict, cfg: DecoderConfig, last_token: torch.Tensor,
                step: torch.Tensor, frames_per_stream: int) -> torch.Tensor:
    """Token + position + quantizer embedding of a step, (B, d).  ``step`` is
    a (1,) integer tensor on the device (the captured decode's index:
    ``q_id`` and ``pos_id`` are found without a host sync, by
    ``index_select``)."""
    F_, Q = frames_per_stream, cfg.num_quantizers
    tok = qparams["token_embed"][last_token[:, 0]]
    pos = qparams["pos_embed"].index_select(0, step % F_)
    quant = qparams["quant_embed"].index_select(0, torch.clamp(step // F_, max=Q - 1))
    return (tok + pos + quant).to(qparams["token_embed"].dtype)


def quant_step_with_kv(qparams: dict, cfg: DecoderConfig, last_token: torch.Tensor, KV,
                       memory_mask, films, states: List[MambaState], step: torch.Tensor,
                       frames_per_stream: int) -> Tuple[torch.Tensor, List[MambaState]]:
    """Int8 mirror of ``MambaTTSDecoder.step_with_kv``; logits (B, 1, V).
    ``step`` is a (1,) integer tensor on the device."""
    dt_c = qparams["token_embed"].dtype
    x = _step_embed(qparams, cfg, last_token, step, frames_per_stream)  # (B, d)
    new_states = []
    for lp, KVe, (gamma, beta), st in zip(qparams["layers"], KV, films, states):
        h, ns = _mamba_step(lp, _layer_norm(x, lp["norm_mamba"]), st, cfg)
        x = x + h
        x = x + _attend_step(lp, _layer_norm(x, lp["norm_cross"]), KVe, memory_mask, cfg)
        h = _layer_norm(x, lp["norm_ff"])
        h = gamma.to(h.dtype) * h + beta.to(h.dtype)  # FiLM (B, d)
        h = F.gelu(_mv(h, lp["ff1"], dt_c), approximate="none")
        x = x + _mv(h, lp["ff2"], dt_c)
        new_states.append(ns)
    xf = _layer_norm(x, qparams["norm_out"]).to(F32)
    logits = xf @ qparams["head_k"] + qparams["head_b"]
    return logits[:, None, :], new_states


@torch.no_grad()
def greedy_decode_int8(
    decoder: MambaTTSDecoder,
    qparams: dict,
    text_hidden: torch.Tensor,
    z_style: torch.Tensor,
    frames_per_stream: int,
    text_mask: Optional[torch.Tensor] = None,
    ref_hidden: Optional[torch.Tensor] = None,
    ref_mask: Optional[torch.Tensor] = None,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    collect_logits: bool = False,
    int8_kv: bool = False,
) -> DecodeResult:
    """``greedy_decode`` with the int8 step.  Memory K/V, mask and FiLM are
    projected once at full precision; ``int8_kv`` then stores K/V as int8.
    The steps run through ``models.decoder.run_step_decode``, which keeps
    ``int8_matvec.launches`` to the kernel's executions and records no
    counter."""
    c = decoder.cfg
    B = text_hidden.shape[0]
    total = c.num_quantizers * frames_per_stream
    with annotate("decode.memory"):
        KV, memory_mask, films = decoder.project_memories(
            text_hidden, text_mask, ref_hidden, ref_mask, z_style)
        if int8_kv:
            KV = quantize_kv(KV)
    with annotate("decode.plan"):
        carry = init_carry(c, B, total, decoder.dtype, text_hidden.device, collect_logits)

    def step(token, states, index):
        return quant_step_with_kv(qparams, c, token, KV, memory_mask, films, states, index,
                                  frames_per_stream)

    return run_step_decode(step, carry, c.num_special_tokens, temperature, 0, generator,
                           counted=((int8_matvec, None),))
