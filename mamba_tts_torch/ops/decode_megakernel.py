"""One-launch autoregressive decode ("megakernel") — counterpart of
``mamba_tts_tpu/ops/decode_megakernel.py``.

The step decodes (``models/decoder.py`` ``greedy_decode``,
``infer/quant_decode.py``) launch hundreds of small device kernels per token
from a Python loop, and the card idles while the host dispatches them.  Here
the whole decode of ``Q * frames`` steps is ONE launch of the hand-written
Hopper kernel ``csrc/decode_megakernel.cu`` (which replaces the TPU kernel
``mamba_tts_tpu/ops/decode_megakernel.py:532`` ``_make_kernel``): a
persistent grid of thread-block clusters loops over steps and layers, grid
barriers separate dependent stages (7 a layer and one for the head), each
block owns a fixed set of d_inner channels (their conv ring and SSM state
stay in its shared memory for the whole launch) and fixed output columns of
every product (kept in its shared memory where they fit), a cluster per
(row, head) computes one query's attention, and each step's argmax (or
Gumbel-max sample) feeds the next step's embedding on the device with no
host round trip.

Host side, same contract as the JAX module:

- :func:`build_weight_plan` / :func:`_build_plan` stack the int8 decode tree
  (``infer.quant_decode.quantize_decoder_params``) and the per-utterance
  conditioning (``MambaTTSDecoder.project_memories``) into a :class:`_Plan`
  whose fields, shapes and dtypes equal the JAX plan's.
- :func:`launch_plan` lays one launch out (pure Python): cluster size, grid,
  channel and column owners, resident weight slices, shared-memory bytes.
- :func:`_kernel_operands` re-lays a plan out for the CUDA kernel (weights
  transposed so that one output column's inputs are contiguous, in_proj's
  rows block-major).
- :func:`decode_megakernel_ref` is the plain PyTorch version: the same
  arithmetic with the same bf16 rounding points, op for op.
- :func:`plan_resident_bytes`, :func:`megakernel_fit`,
  :func:`megakernel_max_batch` plan device memory for one call.
- :func:`_megakernel_call` launches the kernel for CUDA tensors (or raises)
  and runs the plain version for CPU tensors; ``_megakernel_call.launches``
  counts kernel launches.
- :func:`megakernel_greedy_decode` is the decode entry point.

What bounds the kernel on an H100: every step reads the whole plan (weights
and K/V) once; what is not resident in shared memory streams from L2 or, where
the plan exceeds the 50 MB L2, from device memory, so the least time per step
is ``plan bytes / 3.35 TB/s`` without residency.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

import torch

from mamba_tts_torch.config import DecoderConfig
from mamba_tts_torch.device import on_card
from mamba_tts_torch.models.decoder import DecodeResult, MambaTTSDecoder
from mamba_tts_torch.utils.profiling import annotate

BF16, F32, I8 = torch.bfloat16, torch.float32, torch.int8

# Largest batch one launch takes: the kernel keeps one f32 accumulator per
# batch row per thread and stages the batch's activation rows in shared memory.
MEGAKERNEL_MAX_BATCH = 8
# Share of an H100's 80 GB that one decode call may plan for; the rest is
# left to the encoders, FACodec, the f32 K/V projections that feed the plan
# and PyTorch's caching allocator.
H100_HBM_BYTES = 80 * 10 ** 9
MEGAKERNEL_BUDGET_BYTES = H100_HBM_BYTES // 2
_MAX_SMEM_BYTES = 232_448  # shared memory one H100 block may use
_STATIC_SMEM = 1024  # the kernel's static shared variables fit in this (kStaticSmem)
_WARPS = 8  # warps per block of the kernel (kWarps in the CUDA source)
_SMS = 132  # streaming multiprocessors of an H100
_GRID = _SMS // 8 * 8  # 128 blocks: whole clusters of up to 8, one block per SM
_ONE_BLOCK_SMEM = 120 * 1024  # a block asks at least this much: one block per SM


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class _Plan(NamedTuple):
    """Everything one decode call reads, in the JAX plan's layout."""

    emb_pq: torch.Tensor       # (total, d) bf16: pos+quant embedding per step
    token_embed: torch.Tensor  # (Vpad, d) bf16
    norms: torch.Tensor        # (L, 6, d) f32: [m_s, m_b, c_s, c_b, f_s, f_b]
    in_w: torch.Tensor         # (L, d, 2*di) int8 (or bf16, scale folded)
    in_s: torch.Tensor         # (L, 1, 2*di) f32
    conv_w: torch.Tensor       # (L, dc, di) bf16
    conv_b: torch.Tensor       # (L, 1, di) f32
    xp_dt: torch.Tensor        # (L, di, r) bf16
    xp_B: torch.Tensor         # (L, di, N) bf16
    xp_C: torch.Tensor         # (L, di, N) bf16
    dt_w: torch.Tensor         # (L, r, di) bf16
    dt_b: torch.Tensor         # (L, 1, di) f32
    A: torch.Tensor            # (L, N, di) f32 (= -exp(A_log), transposed)
    D: torch.Tensor            # (L, 1, di) f32
    out_w: torch.Tensor        # (L, di, d) int8
    out_s: torch.Tensor        # (L, 1, d) f32
    q_w: torch.Tensor          # (L, d, d) int8
    q_s: torch.Tensor          # (L, 1, d) f32
    q_b: torch.Tensor          # (L, 1, d) f32
    headmask: torch.Tensor     # (H, d) bf16: 1 where channel c belongs to head h
    K: torch.Tensor            # (L, B, d, Tmp) bf16 or int8: heads on channels
    V: torch.Tensor            # (L, B, Tmp, d) bf16 or int8
    k_scale: torch.Tensor      # (L, B, 1, d) f32 per-channel K scale (1s if bf16)
    v_scale: torch.Tensor      # (L, B, 1, d) f32 per-channel V scale (1s if bf16)
    mask_row: torch.Tensor     # (B, Tmp) f32 additive bias (0 valid / -1e9)
    o_w: torch.Tensor          # (L, d, d) int8
    o_s: torch.Tensor          # (L, 1, d) f32
    o_b: torch.Tensor          # (L, 1, d) f32
    gamma: torch.Tensor        # (L, B, d) f32 FiLM scale
    beta: torch.Tensor         # (L, B, d) f32 FiLM shift
    ff1_w: torch.Tensor        # (L, d, dff) int8
    ff1_s: torch.Tensor        # (L, 1, dff) f32
    ff1_b: torch.Tensor        # (L, 1, dff) f32
    ff2_w: torch.Tensor        # (L, dff, d) int8
    ff2_s: torch.Tensor        # (L, 1, d) f32
    ff2_b: torch.Tensor        # (L, 1, d) f32
    norm_out: torch.Tensor     # (2, d) f32
    head_w: torch.Tensor       # (d, Vpad) bf16
    head_b: torch.Tensor       # (1, Vpad) f32, -1e9 at specials and pad columns


class _WeightPlan(NamedTuple):
    """The weight-side :class:`_Plan` fields: a pure function of (cfg,
    qparams, weight_dtype), independent of the utterance.  Serving builds
    one per weight dtype when it starts, so a decode call does no weight
    stacking, casting or scale folding."""

    token_embed: torch.Tensor  # (Vpad, d) bf16
    pos_embed: torch.Tensor    # (max_len, d): emb_pq gathers per frame budget
    quant_embed: torch.Tensor  # (Q, d)
    norms: torch.Tensor
    in_w: torch.Tensor
    in_s: torch.Tensor
    conv_w: torch.Tensor
    conv_b: torch.Tensor
    xp_dt: torch.Tensor
    xp_B: torch.Tensor
    xp_C: torch.Tensor
    dt_w: torch.Tensor
    dt_b: torch.Tensor
    A: torch.Tensor
    D: torch.Tensor
    out_w: torch.Tensor
    out_s: torch.Tensor
    q_w: torch.Tensor
    q_s: torch.Tensor
    q_b: torch.Tensor
    headmask: torch.Tensor
    o_w: torch.Tensor
    o_s: torch.Tensor
    o_b: torch.Tensor
    ff1_w: torch.Tensor
    ff1_s: torch.Tensor
    ff1_b: torch.Tensor
    ff2_w: torch.Tensor
    ff2_s: torch.Tensor
    ff2_b: torch.Tensor
    norm_out: torch.Tensor
    head_w: torch.Tensor
    head_b: torch.Tensor


class MegakernelOut(NamedTuple):
    logits: torch.Tensor      # (total, B, Vpad) f32, -1e9 at specials and pads
    conv_state: torch.Tensor  # (L, dc-1, B, di) bf16 after the last step
    ssm_state: torch.Tensor   # (L, B, N, di) f32 after the last step


@torch.no_grad()
def build_weight_plan(cfg: DecoderConfig, qparams: dict,
                      weight_dtype: str = "bfloat16") -> _WeightPlan:
    """Stack per-layer decode params into (L, ...) tensors.

    ``qparams`` is ``infer.quant_decode.quantize_decoder_params`` output.
    ``weight_dtype="bfloat16"`` folds each int8 weight's per-channel scale
    into a bf16 weight (no per-use dequantization, twice the bytes);
    ``"int8"`` keeps the int8 weights and their scales.
    """
    c = cfg
    m = c.with_mamba_dims().mamba
    L, d, di, N, r = c.n_layers, c.d_model, m.d_inner, m.d_state, m.dt_rank_actual
    H = c.n_heads
    hd = d // H
    dev = qparams["token_embed"].device
    layers = qparams["layers"]

    Vreal = c.vocab_size_audio
    Vpad = _round_up(Vreal, 128)
    te = torch.zeros((Vpad, d), dtype=BF16, device=dev)
    te[:Vreal] = qparams["token_embed"].to(BF16)

    def stack(fn):
        return torch.stack([fn(layers[i]) for i in range(L)])

    norms = stack(lambda lp: torch.stack([
        lp["norm_mamba"]["scale"], lp["norm_mamba"]["bias"],
        lp["norm_cross"]["scale"], lp["norm_cross"]["bias"],
        lp["norm_ff"]["scale"], lp["norm_ff"]["bias"],
    ]).to(F32))
    xp = stack(lambda lp: lp["x_proj_k"].to(BF16))  # (L, di, r+2N)
    ar = torch.arange(d, device=dev)
    headmask = (ar[None, :] // hd == torch.arange(H, device=dev)[:, None]).to(BF16)
    head_w = torch.zeros((d, Vpad), dtype=BF16, device=dev)
    head_w[:, :Vreal] = qparams["head_k"].to(BF16)
    head_b = torch.full((Vpad,), -1e9, dtype=F32, device=dev)
    head_b[:Vreal] = qparams["head_b"].to(F32)
    head_b[: c.num_special_tokens] = -1e9

    def row(name, key):  # (L, 1, n) f32
        return stack(lambda lp: lp[name][key].to(F32))[:, None, :]

    wp = _WeightPlan(
        token_embed=te,
        pos_embed=qparams["pos_embed"],
        quant_embed=qparams["quant_embed"],
        norms=norms,
        in_w=stack(lambda lp: lp["in_proj"]["w_q"]),
        in_s=row("in_proj", "scale"),
        conv_w=stack(lambda lp: lp["conv_w"].to(BF16)),
        conv_b=stack(lambda lp: (lp["conv_b"] if lp["conv_b"] is not None
                                 else torch.zeros((di,), device=dev)).to(F32))[:, None, :],
        xp_dt=xp[:, :, :r].contiguous(),
        xp_B=xp[:, :, r:r + N].contiguous(),
        xp_C=xp[:, :, r + N:].contiguous(),
        dt_w=stack(lambda lp: lp["dt_proj_k"].to(BF16)),
        dt_b=stack(lambda lp: lp["dt_proj_b"].to(F32))[:, None, :],
        A=stack(lambda lp: lp["A"].T.to(F32)).contiguous(),
        D=stack(lambda lp: lp["D"].to(F32))[:, None, :],
        out_w=stack(lambda lp: lp["out_proj"]["w_q"]),
        out_s=row("out_proj", "scale"),
        q_w=stack(lambda lp: lp["q_proj"]["w_q"]),
        q_s=row("q_proj", "scale"),
        q_b=row("q_proj", "bias"),
        headmask=headmask,
        o_w=stack(lambda lp: lp["o_proj"]["w_q"]),
        o_s=row("o_proj", "scale"),
        o_b=row("o_proj", "bias"),
        ff1_w=stack(lambda lp: lp["ff1"]["w_q"]),
        ff1_s=row("ff1", "scale"),
        ff1_b=row("ff1", "bias"),
        ff2_w=stack(lambda lp: lp["ff2"]["w_q"]),
        ff2_s=row("ff2", "scale"),
        ff2_b=row("ff2", "bias"),
        norm_out=torch.stack([qparams["norm_out"]["scale"],
                              qparams["norm_out"]["bias"]]).to(F32),
        head_w=head_w,
        head_b=head_b[None],
    )
    if weight_dtype == "bfloat16":
        def fold(w, s):  # (L, K, Nc) int8, (L, 1, Nc) f32 -> bf16, pre-scaled
            return (w.to(F32) * s).to(BF16)

        wp = wp._replace(
            in_w=fold(wp.in_w, wp.in_s), out_w=fold(wp.out_w, wp.out_s),
            q_w=fold(wp.q_w, wp.q_s), o_w=fold(wp.o_w, wp.o_s),
            ff1_w=fold(wp.ff1_w, wp.ff1_s), ff2_w=fold(wp.ff2_w, wp.ff2_s),
        )
    elif weight_dtype != "int8":
        raise ValueError(f"weight_dtype must be bfloat16|int8: {weight_dtype}")
    return wp


@torch.no_grad()
def _build_plan(cfg: DecoderConfig, qparams: dict, KV, memory_mask, films,
                frames_per_stream: int, weight_dtype: str = "bfloat16",
                kv_dtype: str = "bfloat16",
                weight_plan: Optional[_WeightPlan] = None) -> _Plan:
    """Merge the weight plan with the per-utterance conditioning (K/V
    memories, memory mask, FiLM rows, per-step pos+quant embedding).

    ``KV``/``memory_mask``/``films`` come from
    ``MambaTTSDecoder.project_memories``.  ``weight_plan=None`` rebuilds the
    weight side inline from ``qparams``.
    """
    c = cfg
    wp = (build_weight_plan(cfg, qparams, weight_dtype)
          if weight_plan is None else weight_plan)
    # A precomputed plan of the other dtype would bypass the planner's choice.
    want = I8 if weight_dtype == "int8" else BF16
    if wp.in_w.dtype != want:
        raise ValueError(f"weight_plan dtype {wp.in_w.dtype} does not match "
                         f"weight_dtype={weight_dtype!r}")
    d, L = c.d_model, c.n_layers
    total = c.num_quantizers * frames_per_stream
    dev = wp.in_w.device

    steps = torch.arange(total, device=dev)
    q_id = torch.clamp(steps // frames_per_stream, max=c.num_quantizers - 1)
    pos_id = steps % frames_per_stream
    emb_pq = (wp.pos_embed[pos_id] + wp.quant_embed[q_id]).to(BF16)

    # heads-on-channels layout:
    #   K (L, B, d, Tmp): channel h*hd+j, position t  <- KV[l][0][b, h, t, j]
    #   V (L, B, Tmp, d)
    Bsz, _, Tm, _ = KV[0][0].shape
    Tmp = _round_up(Tm, 128)
    Kst = torch.stack([kv[0] for kv in KV]).to(BF16)  # (L, B, H, Tm, hd)
    Vst = torch.stack([kv[1] for kv in KV]).to(BF16)
    pad = (0, 0, 0, Tmp - Tm)  # last dim untouched, Tm padded at its end
    Kst = torch.nn.functional.pad(Kst, pad)
    Vst = torch.nn.functional.pad(Vst, pad)
    Kst = Kst.permute(0, 1, 2, 4, 3).reshape(L, Bsz, d, Tmp)
    Vst = Vst.permute(0, 1, 3, 2, 4).reshape(L, Bsz, Tmp, d)
    if kv_dtype == "int8":
        # per-channel symmetric int8, quantized from the bf16-rounded values
        # with amax + 1e-8 and no clip.  The kernel never dequantizes the big
        # tensors: K's scale folds into q before the score product, V's into
        # the attention output row.
        k_amax = Kst.to(F32).abs().amax(dim=3) + 1e-8  # (L, B, d)
        v_amax = Vst.to(F32).abs().amax(dim=2) + 1e-8
        k_scale = (k_amax / 127.0)[:, :, None, :]
        v_scale = (v_amax / 127.0)[:, :, None, :]
        Kst = torch.round(Kst.to(F32) / k_scale.permute(0, 1, 3, 2)).to(I8)
        Vst = torch.round(Vst.to(F32) / v_scale).to(I8)
    elif kv_dtype == "bfloat16":
        k_scale = torch.ones((L, Bsz, 1, d), dtype=F32, device=dev)
        v_scale = torch.ones((L, Bsz, 1, d), dtype=F32, device=dev)
    else:
        raise ValueError(f"kv_dtype must be bfloat16|int8: {kv_dtype}")

    if memory_mask is None:
        valid = torch.ones((Bsz, Tm), dtype=torch.bool, device=dev)
    else:
        valid = memory_mask
    valid = torch.nn.functional.pad(valid, (0, Tmp - Tm))
    mask_row = torch.where(valid, 0.0, -1e9).to(F32)

    gamma = torch.stack([g.to(F32) for g, _ in films])  # (L, B, d)
    beta = torch.stack([b.to(F32) for _, b in films])

    return _Plan(
        emb_pq=emb_pq,
        K=Kst.contiguous(), V=Vst.contiguous(), k_scale=k_scale, v_scale=v_scale,
        mask_row=mask_row, gamma=gamma, beta=beta,
        **{f: getattr(wp, f) for f in _WeightPlan._fields
           if f not in ("pos_embed", "quant_embed")},
    )


# --------------------------------------------------------------------------
# the plain version


def _ln(x, scale, bias, eps=1e-6):
    """f32 LayerNorm statistics, output in ``x.dtype``."""
    xf = x.to(F32)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def _dq_dot(x, w, scale, bias=None):
    """x (B, K) bf16 @ w (K, N): exact products, f32 accumulation.  int8
    weights: ``(acc * scale) -> bf16``; bf16 weights (scale folded by the
    plan): ``acc -> bf16``.  The bias is added in bf16."""
    acc = x.to(F32) @ w.to(F32)
    y = (acc * scale).to(BF16) if w.dtype == I8 else acc.to(BF16)
    if bias is not None:
        y = y + bias.to(BF16)
    return y


def _dot_bf16(a, w):
    return (a.to(F32) @ w.to(F32)).to(BF16)


def _silu(x):
    """x * sigmoid(x) with the sigmoid in f32."""
    xf = x.to(F32)
    return (xf / (1.0 + torch.exp(-xf))).to(x.dtype)


def _softplus(x):
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def _gelu_exact(x):
    """0.5 x (1 + erf(x / sqrt 2)) with the Abramowitz & Stegun 7.1.26 erf
    (max abs error 1.5e-7), as the TPU kernel evaluates it."""
    xf = x.to(F32)
    u = xf.abs() * (2.0 ** -0.5)
    t = 1.0 / (1.0 + 0.3275911 * u)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    erf = torch.sign(xf) * (1.0 - poly * torch.exp(-u * u))
    return (0.5 * xf * (1.0 + erf)).to(x.dtype)


def _first_argmax(choice):
    """(B, V) -> (B,) index of the first maximum of each row."""
    mx = choice.max(dim=1, keepdim=True).values
    iota = torch.arange(choice.shape[1], device=choice.device)[None, :]
    return torch.where(choice == mx, iota, 2 ** 30).min(dim=1).values


@torch.no_grad()
def decode_megakernel_ref(cfg: DecoderConfig, plan: _Plan, frames_per_stream: int,
                          forced_tokens: Optional[torch.Tensor] = None,
                          gumbel: Optional[torch.Tensor] = None) -> MegakernelOut:
    """Plain PyTorch version of the kernel: ``total = Q * frames`` steps from
    BOS, each the TPU kernel's ``_decode_one`` op for op with its bf16
    rounding points.  ``forced_tokens`` (total, B) switches to teacher
    forcing; ``gumbel`` (total, B, Vpad) f32 is added before the argmax that
    feeds the next step.  f32 products here must run in full f32 (PyTorch's
    default: no TF32)."""
    c = cfg
    m = c.with_mamba_dims().mamba
    L, d, di, N = c.n_layers, c.d_model, m.d_inner, m.d_state
    H, dc = c.n_heads, m.d_conv
    hd = d // H
    p = plan
    B, Tmp = p.K.shape[1], p.K.shape[3]
    total = c.num_quantizers * frames_per_stream
    dev = p.K.device
    att_scale = hd ** -0.5

    conv_s = torch.zeros((L, dc - 1, B, di), dtype=BF16, device=dev)
    ssm_s = torch.zeros((L, B, N, di), dtype=F32, device=dev)
    token = torch.full((B,), c.bos_id, dtype=torch.long, device=dev)
    logits_out = []
    for t in range(total):
        if forced_tokens is not None:
            token = forced_tokens[t].to(torch.long)
        # a row gather equals the TPU kernel's one-hot product exactly
        x = p.token_embed[token] + p.emb_pq[t]  # (B, d) bf16
        for l in range(L):
            nb = p.norms[l]
            # ---- Mamba step
            h = _ln(x, nb[0], nb[1])
            xz = _dq_dot(h, p.in_w[l], p.in_s[l])
            xin, z = xz[:, :di], xz[:, di:]
            conv_out = xin * p.conv_w[l, dc - 1]
            for k in range(dc - 1):
                conv_out = conv_out + conv_s[l, k] * p.conv_w[l, k]
            conv_out = conv_out + p.conv_b[l].to(BF16)
            for k in range(dc - 2):
                conv_s[l, k] = conv_s[l, k + 1]
            conv_s[l, dc - 2] = xin
            xc = _silu(conv_out)
            dt_raw = _dot_bf16(xc, p.xp_dt[l])
            Bm = _dot_bf16(xc, p.xp_B[l]).to(F32)
            Cm = _dot_bf16(xc, p.xp_C[l]).to(F32)
            dt = _softplus(_dot_bf16(dt_raw, p.dt_w[l]).to(F32) + p.dt_b[l])
            dtx = dt * xc.to(F32)
            a = torch.exp(dt[:, None, :] * p.A[l][None])
            h_new = a * ssm_s[l] + Bm[:, :, None] * dtx[:, None, :]
            ssm_s[l] = h_new
            y = (Cm[:, :, None] * h_new).sum(dim=1)
            y = (y + xc.to(F32) * p.D[l]).to(BF16)
            y = y * _silu(z)
            x = x + _dq_dot(y, p.out_w[l], p.out_s[l])
            # ---- 1-query cross-attention, every head at once
            h = _ln(x, nb[2], nb[3])
            q_all = _dq_dot(h, p.q_w[l], p.q_s[l], p.q_b[l])
            qk = (q_all.to(F32) * p.k_scale[l, :, 0]).to(BF16)
            S = torch.einsum("bhj,bhjt->bht", qk.to(F32).view(B, H, hd),
                             p.K[l].to(F32).view(B, H, hd, Tmp))
            S = S * att_scale + p.mask_row[:, None, :]
            P = torch.softmax(S, dim=-1).to(BF16)
            O = torch.einsum("bht,bthj->bhj", P.to(F32),
                             p.V[l].to(F32).view(B, Tmp, H, hd)).reshape(B, d)
            attn = (O * p.v_scale[l, :, 0]).to(BF16)
            x = x + _dq_dot(attn, p.o_w[l], p.o_s[l], p.o_b[l])
            # ---- FiLM FFN
            h = _ln(x, nb[4], nb[5])
            h = p.gamma[l].to(BF16) * h + p.beta[l].to(BF16)
            h1 = _gelu_exact(_dq_dot(h, p.ff1_w[l], p.ff1_s[l], p.ff1_b[l]))
            x = x + _dq_dot(h1, p.ff2_w[l], p.ff2_s[l], p.ff2_b[l])
        xf = _ln(x, p.norm_out[0], p.norm_out[1])
        logits = xf.to(F32) @ p.head_w.to(F32) + p.head_b
        logits_out.append(logits)
        if forced_tokens is None:
            token = _first_argmax(logits if gumbel is None else logits + gumbel[t])
    return MegakernelOut(torch.stack(logits_out), conv_s, ssm_s)


# --------------------------------------------------------------------------
# what one call holds on the device


def _kernel_operands(plan: _Plan, grid: int = _GRID) -> Dict[str, torch.Tensor]:
    """Re-lay a :class:`_Plan` out for the CUDA kernel.

    A block of the kernel computes its own output columns of each product as
    dots over contiguous memory, so every (K, N) weight becomes (N, K); the
    three x-projections become one (r + 2N, di) matrix.  in_proj's rows go
    block-major: the x and then the z columns of block 0's d_inner channels
    (:func:`launch_plan`'s ``chan`` for ``grid`` blocks), then block 1's, so
    that each block's slice is contiguous; its scales follow them.  Everything
    else is read as the plan lays it (``headmask`` is not read at all: the
    kernel walks each head's own channels).  Byte counts equal the plan's."""
    p = plan

    def t(w):  # (L, K, N) -> (L, N, K)
        return w.transpose(1, 2).contiguous()

    def flat(s):  # (L, 1, n) -> (L, n)
        return s[:, 0].contiguous()

    di = p.in_w.shape[2] // 2
    chan = _bounds(di, grid)
    order = torch.cat([torch.cat([torch.arange(lo, hi), torch.arange(di + lo, di + hi)])
                       for lo, hi in zip(chan[:-1], chan[1:])]).to(p.in_w.device)
    return {
        "emb_pq": p.emb_pq.contiguous(), "token_embed": p.token_embed.contiguous(),
        "norms": p.norms.contiguous(),
        "in_w": t(p.in_w)[:, order].contiguous(), "in_s": flat(p.in_s)[:, order].contiguous(),
        "conv_w": p.conv_w.contiguous(), "conv_b": flat(p.conv_b),
        "xp_w": t(torch.cat([p.xp_dt, p.xp_B, p.xp_C], dim=2)),
        "dt_w": p.dt_w.contiguous(), "dt_b": flat(p.dt_b),
        "A": p.A.contiguous(), "D": flat(p.D),
        "out_w": t(p.out_w), "out_s": flat(p.out_s),
        "q_w": t(p.q_w), "q_s": flat(p.q_s), "q_b": flat(p.q_b),
        "K": p.K.contiguous(), "V": p.V.contiguous(),
        "k_scale": p.k_scale[:, :, 0].contiguous(), "v_scale": p.v_scale[:, :, 0].contiguous(),
        "mask_row": p.mask_row.contiguous(),
        "o_w": t(p.o_w), "o_s": flat(p.o_s), "o_b": flat(p.o_b),
        "gamma": p.gamma.contiguous(), "beta": p.beta.contiguous(),
        "ff1_w": t(p.ff1_w), "ff1_s": flat(p.ff1_s), "ff1_b": flat(p.ff1_b),
        "ff2_w": t(p.ff2_w), "ff2_s": flat(p.ff2_s), "ff2_b": flat(p.ff2_b),
        "norm_out": p.norm_out.contiguous(),
        "head_w": p.head_w.T.contiguous(), "head_b": p.head_b[0].contiguous(),
    }


def memory_slices(batch: int, n_heads: int, grid: int = _GRID) -> int:
    """Slices the kernel cuts the attention memory into, which is also the
    launch's cluster size: as many (8 at most) as keep every (row, head,
    slice) on its own block of a ``grid``-block launch."""
    return next(ts for ts in (8, 4, 2, 1) if batch * n_heads * ts <= grid or ts == 1)


# ---------------------------------------------------------------- the launch plan

# Products whose per-block slices the kernel can keep in shared memory, in
# the order of their regions there and of the bits of MKParams::resident.
_PRODUCTS = ("in_w", "out_w", "q_w", "o_w", "ff1_w", "ff2_w", "head_w")
# The order in which :func:`launch_plan` makes them resident while they fit.
_RESIDENT_ORDER = ("o_w", "q_w", "out_w", "ff2_w", "in_w", "ff1_w", "head_w")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _bounds(n: int, parts: int) -> tuple:
    """Part g of ``n`` split over ``parts`` is ``[b[g], b[g + 1])`` (the CUDA
    source's ``split_lo``)."""
    return tuple(n * g // parts for g in range(parts + 1))


def _tile(batch: int) -> int:
    return next(t for t in (1, 2, 4, 8) if batch <= t) if batch <= 8 else batch


class LaunchPlan(NamedTuple):
    """How one launch is laid out (:func:`launch_plan`)."""

    batch: int
    tile: int              # the kernel's batch tile (1, 2, 4 or 8)
    grid: int              # blocks, one per SM
    cluster: int           # blocks per cluster = memory slices of an attention unit
    clusters: int
    units: int             # (row, head) attention units, unit u on cluster u % clusters
    chan: tuple            # block g owns d_inner channels [chan[g], chan[g+1])
    cols: Dict[str, tuple]  # block g owns rows [cols[w][g], cols[w][g+1]) of weight w (N, K)
    q_cols: int            # q columns of the unit's head per rank of its cluster
    resident: tuple        # weights whose block slices stay in shared memory
    smem_bytes: int


def _geometry(cfg: DecoderConfig, grid: int, cluster: int, weight_dtype: str) -> dict:
    """Per product: (rows a block holds at most, K, bytes per element, layers)."""
    c = cfg
    m = c.with_mamba_dims().mamba
    L, d, di, dff = c.n_layers, c.d_model, m.d_inner, c.d_ff
    wb = 1 if weight_dtype == "int8" else 2
    ncd = _cdiv(d, grid)
    Vpad = _round_up(c.vocab_size_audio, 128)
    return {
        "in_w": (2 * _cdiv(di, grid), d, wb, L), "out_w": (ncd, di, wb, L),
        "q_w": ((d // c.n_heads) // cluster, d, wb, L), "o_w": (ncd, d, wb, L),
        "ff1_w": (_cdiv(dff, grid), d, wb, L), "ff2_w": (ncd, dff, wb, L),
        "head_w": (_cdiv(Vpad, grid), d, 2, 1),
    }


def _smem_layout(cfg: DecoderConfig, batch: int, Tmp: int, weight_dtype: str, grid: int,
                 cluster: int, resident) -> tuple:
    """(bytes one block asks for, at least ``_ONE_BLOCK_SMEM``; bytes its
    regions take) of its dynamic shared memory, each region 16-byte aligned.
    Mirrors ``make_layout`` in the CUDA source, which refuses a launch whose
    size differs."""
    c = cfg
    m = c.with_mamba_dims().mamba
    L, d, di, N, r, dc, dff = (c.n_layers, c.d_model, m.d_inner, m.d_state, m.dt_rank_actual,
                               m.d_conv, c.d_ff)
    BT, hd, nx = _tile(batch), d // c.n_heads, r + 2 * N
    nc = _cdiv(di, grid)
    geo = _geometry(c, grid, cluster, weight_dtype)
    segs = max(rows * _cdiv(K, 32 * (16 // eb)) for rows, K, eb, _ in geo.values())
    sizes = [
        ("xrow", 4 * BT * d),                       # the residual row as of the last barrier
        ("xs", 4 * BT * max(d, di, dff)),           # a product's input rows
        ("part", 4 * BT * segs),                    # a product's segment sums
        ("red", 4 * _WARPS * max(BT, 2)),           # block reductions
        ("mamba", 4 * 3 * BT * nc),                 # x, z and conv output of the owned channels
        ("xrecv", 4 * (BT * nx + 8)),               # the cluster's x-projection partials pushed here
        ("dbc", 4 * BT * nx),                       # the x-projection row (dt | B | C)
        ("scores", 4 * (Tmp // cluster)),           # this slice's scores, then probabilities
        ("qk", 4 * hd), ("smax", 4 * 8), ("ssum", 4 * 8),  # pushed by the cluster's ranks
        ("orecv", 4 * hd), ("wpart", 4 * _WARPS * hd),  # P @ V parts pushed here; per warp
        ("ring", 4 * L * (dc - 1) * BT * nc),       # conv ring of the owned channels
        ("ssm", 4 * L * BT * N * nc),               # SSM state of the owned channels
        ("conv_w", 4 * L * dc * nc), ("conv_b", 4 * L * nc), ("xp_w", 2 * L * nx * nc),
        ("dt_w", 2 * L * r * nc), ("dt_b", 4 * L * nc), ("A", 4 * L * N * nc), ("D", 4 * L * nc),
    ]
    sizes += [(w, rows * K * eb * layers) for w, (rows, K, eb, layers) in geo.items()
              if w in resident]
    off = sum((n + 15) & ~15 for _, n in sizes)
    return max(off, _ONE_BLOCK_SMEM), off


def launch_plan(cfg: DecoderConfig, batch: int, Tmp: int, weight_dtype: str = "bfloat16",
                kv_dtype: str = "bfloat16", grid: Optional[int] = None) -> LaunchPlan:
    """Lay one launch out: the cluster size (``memory_slices``), ``grid``
    blocks (default 128, whole clusters on an H100's 132 SMs; the wrapper
    lowers it to what the card fits), the owners of every d_inner channel and
    of every output column of every product, and which weight slices stay in
    shared memory: in ``_RESIDENT_ORDER``, each that still fits beside the
    working set (q_w only when every cluster has at most one attention unit,
    so that its slice is fixed).  ``kv_dtype`` does not change the layout
    (scores are f32 either way)."""
    del kv_dtype
    c = cfg
    m = c.with_mamba_dims().mamba
    d, di, dff, H = c.d_model, m.d_inner, c.d_ff, c.n_heads
    G = _GRID if grid is None else grid
    TS = memory_slices(batch, H, G)
    G -= G % TS
    clusters, units = G // TS, batch * H
    resident = []
    for w in _RESIDENT_ORDER:
        if w == "q_w" and units > clusters:
            continue
        if (_smem_layout(c, batch, Tmp, weight_dtype, G, TS, resident + [w])[1]
                <= _MAX_SMEM_BYTES - _STATIC_SMEM):
            resident.append(w)
    resident = tuple(w for w in _PRODUCTS if w in resident)
    smem, _ = _smem_layout(c, batch, Tmp, weight_dtype, G, TS, resident)
    dcols = _bounds(d, G)
    return LaunchPlan(
        batch=batch, tile=_tile(batch), grid=G, cluster=TS, clusters=clusters, units=units,
        chan=_bounds(di, G),
        cols={"in_w": tuple(2 * b for b in _bounds(di, G)), "out_w": dcols, "o_w": dcols,
              "ff2_w": dcols, "ff1_w": _bounds(dff, G),
              "head_w": _bounds(_round_up(c.vocab_size_audio, 128), G)},
        q_cols=(d // H) // TS, resident=resident, smem_bytes=smem)


def _call_buffers(cfg: DecoderConfig, batch: int, total: int, device,
                  grid: int = _GRID) -> Dict[str, torch.Tensor]:
    """Outputs, state and per-step scratch of one call (uninitialised: the
    kernel keeps the state in shared memory and writes it at the end), plus
    the zeroed barrier/error words."""
    c = cfg
    m = c.with_mamba_dims().mamba
    L, d, di, N, r = c.n_layers, c.d_model, m.d_inner, m.d_state, m.dt_rank_actual
    B = batch
    Vpad = _round_up(c.vocab_size_audio, 128)
    clusters = grid // memory_slices(B, c.n_heads, grid)

    def e(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    return {
        "logits": e((total, B, Vpad), F32),
        "conv_state": e((L, m.d_conv - 1, B, di), BF16),
        "ssm_state": e((L, B, N, di), F32),
        # activation rows handed from one stage of a step to the next
        "x": e((B, d), BF16), "y": e((B, di), BF16), "attn": e((B, d), BF16),
        "h1": e((B, c.d_ff), BF16),
        # each cluster's sum of its blocks' x-projection partials
        "xpart": e((clusters, B, r + 2 * N), F32),
        "sync": torch.zeros((2,), dtype=torch.int64, device=device),
    }


def plan_resident_bytes(
    cfg: DecoderConfig,
    batch: int,
    memory_len: int,
    weight_dtype: str = "bfloat16",
    kv_dtype: str = "bfloat16",
    unroll_steps: int = 1,
    sampled: bool = False,
    teacher_force: bool = False,
    *,
    total_steps: Optional[int] = None,
) -> int:
    """Device bytes one megakernel call allocates: the plan as the kernel
    reads it (:func:`_kernel_operands`), the logits, the optional Gumbel
    noise and forced tokens (all whole in device memory), the conv/SSM state
    and the per-step scratch (:func:`_call_buffers`), at the default grid.

    ``memory_len`` is the unpadded cross-attention memory length (ref + text
    tokens).  ``total_steps`` defaults to the longest decode the position
    table allows, ``num_quantizers * max_len``.  ``unroll_steps`` is
    accepted for signature parity and changes nothing here.  Pinned byte
    for byte against the real tensors by tests/test_torch_megakernel.py.
    """
    del unroll_steps
    c = cfg
    m = c.with_mamba_dims().mamba
    L, d, di, N = c.n_layers, c.d_model, m.d_inner, m.d_state
    r, dc, dff = m.dt_rank_actual, m.d_conv, c.d_ff
    B = batch
    total = c.num_quantizers * c.max_len if total_steps is None else total_steps
    Vpad = _round_up(c.vocab_size_audio, 128)
    Tmp = _round_up(memory_len, 128)
    wb = 1 if weight_dtype == "int8" else 2
    kb = 1 if kv_dtype == "int8" else 2

    n = total * d * 2                          # emb_pq
    n += Vpad * d * 2                          # token_embed
    n += L * 6 * d * 4                         # norms
    n += L * d * 2 * di * wb + L * 2 * di * 4  # in_w, in_s
    n += L * dc * di * 2 + L * di * 4          # conv_w, conv_b
    n += L * di * (r + 2 * N) * 2              # xp_w (dt | B | C)
    n += L * r * di * 2 + L * di * 4           # dt_w, dt_b
    n += L * N * di * 4 + L * di * 4           # A, D
    n += L * di * d * wb + L * d * 4           # out_w, out_s
    n += L * d * d * wb + 2 * L * d * 4        # q_w, q_s, q_b
    n += 2 * L * B * d * Tmp * kb              # K, V
    n += 2 * L * B * d * 4                     # k_scale, v_scale
    n += B * Tmp * 4                           # mask_row
    n += L * d * d * wb + 2 * L * d * 4        # o_w, o_s, o_b
    n += 2 * L * B * d * 4                     # gamma, beta
    n += L * d * dff * wb + 2 * L * dff * 4    # ff1_w, ff1_s, ff1_b
    n += L * dff * d * wb + 2 * L * d * 4      # ff2_w, ff2_s, ff2_b
    n += 2 * d * 4                             # norm_out
    n += d * Vpad * 2 + Vpad * 4               # head_w, head_b

    n += total * B * Vpad * 4                  # logits out
    if sampled:
        n += total * B * Vpad * 4              # gumbel noise
    if teacher_force:
        n += total * B * 4                     # forced token ids (int32)

    n += L * (dc - 1) * B * di * 2             # conv state
    n += L * B * N * di * 4                    # SSM state
    n += B * (2 * d + di + dff) * 2            # x, attn | y | h1
    n += _GRID // memory_slices(B, c.n_heads) * B * (r + 2 * N) * 4  # x-projection sum per cluster
    n += 2 * 8                                 # barrier and error words
    return n


# Dtype ladder, in the JAX package's order (bf16 weights need no per-use
# dequantization; int8 K/V folds its scales into the query / output rows).
# On this card fewer bytes may be faster: PERF.md has the measured times.
_DTYPE_LADDER = (
    ("bfloat16", "bfloat16"),
    ("int8", "bfloat16"),
    ("int8", "int8"),
)


def megakernel_fit(
    cfg: DecoderConfig,
    batch: int,
    memory_len: int,
    unroll_steps: int = 1,
    sampled: bool = False,
    budget_bytes: Optional[int] = None,
    *,
    total_steps: Optional[int] = None,
) -> Optional[tuple]:
    """First (weight_dtype, kv_dtype) of the ladder whose call fits the
    budget, else None (the caller then takes the int8 step decode).

    The budget is ``MEGAKERNEL_BUDGET_BYTES`` (a fixed share of an H100's
    device memory) unless ``budget_bytes`` overrides it; a batch beyond
    ``MEGAKERNEL_MAX_BATCH`` fits no rung."""
    if batch > MEGAKERNEL_MAX_BATCH:
        return None
    budget = MEGAKERNEL_BUDGET_BYTES if budget_bytes is None else budget_bytes
    for wd, kvd in _DTYPE_LADDER:
        if plan_resident_bytes(cfg, batch, memory_len, wd, kvd, unroll_steps, sampled,
                               total_steps=total_steps) <= budget:
            return (wd, kvd)
    return None


def megakernel_max_batch(
    cfg: DecoderConfig,
    memory_len: int,
    unroll_steps: int = 1,
    sampled: bool = False,
    cap: int = 64,
) -> int:
    """Largest batch one megakernel call serves at ``memory_len`` (0 if
    none); never above ``MEGAKERNEL_MAX_BATCH``.  Serving chunks bigger
    batches by this (``infer.synthesize._run_chunked``)."""
    b = 0
    while b < cap and megakernel_fit(cfg, b + 1, memory_len, unroll_steps, sampled) is not None:
        b += 1
    return b


# --------------------------------------------------------------------------
# the kernel's wrapper

_POINTERS = (  # order of the pointer members of MKParams in the CUDA source
    "emb_pq", "token_embed", "norms", "in_w", "in_s", "conv_w", "conv_b", "xp_w", "dt_w",
    "dt_b", "A", "D", "out_w", "out_s", "q_w", "q_s", "q_b", "K", "V", "k_scale", "v_scale",
    "mask_row", "o_w", "o_s", "o_b", "gamma", "beta", "ff1_w", "ff1_s", "ff1_b", "ff2_w",
    "ff2_s", "ff2_b", "norm_out", "head_w", "head_b", "forced", "gumbel",
    "logits", "conv_state", "ssm_state", "x", "y", "attn", "h1", "xpart", "sync", "stage_clock",
)
_INTS = ("total", "B", "L", "d", "di", "N", "r", "dc", "H", "dff", "Vpad", "Tmp", "bos",
         "w_int8", "kv_int8", "grid", "TS", "resident", "smem_bytes")


class _MKParams(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in _POINTERS]
                + [(n, ctypes.c_int) for n in _INTS]
                + [("att_scale", ctypes.c_float), ("clock_step", ctypes.c_int)])


def check_kernel_args(cfg: DecoderConfig, ops: Dict[str, torch.Tensor],
                      lp: Optional[LaunchPlan] = None) -> None:
    """Raise ``ValueError`` for anything the CUDA kernel does not take; ``lp``
    (default: :func:`launch_plan` of the operands) is checked too."""
    c = cfg
    m = c.with_mamba_dims().mamba
    d, di, dff, H, N = c.d_model, m.d_inner, c.d_ff, c.n_heads, m.d_state
    B, Tmp = ops["K"].shape[1], ops["K"].shape[3]
    if not 1 <= B <= MEGAKERNEL_MAX_BATCH:
        raise ValueError(f"decode megakernel takes 1 <= B <= {MEGAKERNEL_MAX_BATCH}, got B={B}")
    if d % 16 or di % 16 or dff % 16:
        raise ValueError("decode megakernel needs d_model, d_inner and d_ff to be multiples "
                         f"of 16 (16-byte weight loads), got {d}, {di}, {dff}")
    hd = d // H
    if d % H or hd % 8 or 32 % (hd // 8):
        raise ValueError("decode megakernel needs a head width of 8, 16, 32, 64, 128 or 256 "
                         f"(8 channels per lane, lanes per head a power of two), got {d}/{H}")
    if N > 32 or N & (N - 1):
        raise ValueError(f"decode megakernel needs d_state a power of two <= 32 (a lane per "
                         f"state), got {N}")
    if not 2 <= m.d_conv <= 4:
        raise ValueError(f"decode megakernel needs 2 <= d_conv <= 4, got {m.d_conv}")
    if Tmp % 128:
        raise ValueError(f"decode megakernel needs the memory padded to 128, got {Tmp}")
    w_dt, kv_dt = ops["in_w"].dtype, ops["K"].dtype
    if w_dt not in (I8, BF16) or kv_dt not in (I8, BF16) or ops["V"].dtype != kv_dt:
        raise ValueError(f"decode megakernel takes int8|bf16 weights and K/V, got {w_dt}, {kv_dt}")
    for name in ("out_w", "q_w", "o_w", "ff1_w", "ff2_w"):
        if ops[name].dtype != w_dt:
            raise ValueError(f"decode megakernel: {name} is {ops[name].dtype}, in_w is {w_dt}")
    dev = ops["K"].device
    for name, t in ops.items():
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"decode megakernel: operand {name} must be contiguous on {dev}")
    if lp is None:
        lp = launch_plan(c, B, Tmp, "int8" if w_dt == I8 else "bfloat16")
    TS = lp.cluster
    if (TS != memory_slices(B, H, lp.grid) or lp.grid % TS or hd % TS or (Tmp // TS) % 8
            or lp.batch != B):
        raise ValueError(f"decode megakernel: cluster size {TS} of a {lp.grid}-block launch does "
                         f"not fit B={B}, {H} heads of {hd}, memory {Tmp}")
    if lp.smem_bytes > _MAX_SMEM_BYTES - _STATIC_SMEM:
        raise ValueError(f"decode megakernel: B={B}, memory {Tmp} exceed a block's shared memory")


_STAGES = ("mamba_in", "ssm_gate", "out_proj", "attention", "o_proj", "ff1", "ff2")


def stage_names(cfg: DecoderConfig) -> list:
    """The stages of one step, one per grid barrier, in order: 7 a layer
    (LN + in_proj + conv + x-partials | dt + SSM + gate | out_proj | LN + q +
    attention | o_proj | LN + FiLM + ff1 | ff2) and the head.  The argmax and
    the next embedding need none: every block takes them for itself."""
    return [f"L{l}.{s}" for l in range(cfg.n_layers) for s in _STAGES] + ["head"]


def stage_clock_count(cfg: DecoderConfig) -> int:
    """Stamps of the ``stage_clocks`` diagnostic: the step's start, then both
    sides of every grid barrier."""
    return 1 + 2 * len(stage_names(cfg))


def _library() -> ctypes.CDLL:
    from mamba_tts_torch.ops._build import load_library

    lib = load_library("decode_megakernel")
    if not getattr(lib, "_argtypes_set", False):
        lib.decode_megakernel_launch.argtypes = [ctypes.POINTER(_MKParams), ctypes.c_void_p]
        lib.decode_megakernel_launch.restype = ctypes.c_int
        lib.decode_megakernel_max_grid.argtypes = [ctypes.POINTER(_MKParams),
                                                   ctypes.POINTER(ctypes.c_int)]
        lib.decode_megakernel_max_grid.restype = ctypes.c_int
        lib.decode_megakernel_error_string.argtypes = [ctypes.c_int]
        lib.decode_megakernel_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"decode megakernel {what} failed: "
                           f"{lib.decode_megakernel_error_string(err).decode()}")


def _params(cfg: DecoderConfig, lp: LaunchPlan, total: int, Tmp: int, w_int8: bool,
            kv_int8: bool, tensors: Optional[Dict[str, Optional[torch.Tensor]]] = None
            ) -> _MKParams:
    c = cfg
    m = c.with_mamba_dims().mamba
    t = tensors or {}
    return _MKParams(
        **{n: (None if t.get(n) is None else t[n].data_ptr()) for n in _POINTERS},
        total=total, B=lp.batch, L=c.n_layers, d=c.d_model, di=m.d_inner, N=m.d_state,
        r=m.dt_rank_actual, dc=m.d_conv, H=c.n_heads, dff=c.d_ff,
        Vpad=_round_up(c.vocab_size_audio, 128), Tmp=Tmp, bos=c.bos_id, w_int8=int(w_int8),
        kv_int8=int(kv_int8), grid=lp.grid, TS=lp.cluster,
        resident=sum(1 << i for i, w in enumerate(_PRODUCTS) if w in lp.resident),
        smem_bytes=lp.smem_bytes, att_scale=(c.d_model // c.n_heads) ** -0.5,
        clock_step=total // 2)


_MAX_GRID: Dict[tuple, int] = {}


def _card_plan(cfg: DecoderConfig, B: int, Tmp: int, wd: str, kvd: str, dev) -> LaunchPlan:
    """:func:`launch_plan` at the largest grid of whole clusters that the card
    keeps resident at once (asked of the CUDA occupancy calculator; 128 blocks
    on an H100 when 16 clusters of 8 fit)."""
    lib = _library()
    lp = launch_plan(cfg, B, Tmp, wd, kvd)
    for _ in range(4):
        key = (str(dev), wd, lp.tile, lp.cluster, lp.smem_bytes)
        if key not in _MAX_GRID:
            got = ctypes.c_int(0)
            with torch.cuda.device(dev):
                _check(lib, lib.decode_megakernel_max_grid(
                    ctypes.byref(_params(cfg, lp, 1, Tmp, wd == "int8", kvd == "int8")),
                    ctypes.byref(got)), "occupancy query")
            _MAX_GRID[key] = got.value
        if _MAX_GRID[key] >= lp.grid:
            return lp
        lp = launch_plan(cfg, B, Tmp, wd, kvd, grid=_MAX_GRID[key])
    raise RuntimeError(f"decode megakernel: the card keeps no grid of clusters resident for B={B}")


def _launch(cfg: DecoderConfig, plan: _Plan, total: int, forced, gumbel,
            stage_clocks=None) -> MegakernelOut:
    c = cfg
    dev = plan.K.device
    B, Tmp = plan.K.shape[1], plan.K.shape[3]
    Vpad = plan.token_embed.shape[0]
    w_int8, kv_int8 = plan.in_w.dtype == I8, plan.K.dtype == I8
    wd, kvd = ("int8" if w_int8 else "bfloat16"), ("int8" if kv_int8 else "bfloat16")
    if not 1 <= B <= MEGAKERNEL_MAX_BATCH:
        raise ValueError(f"decode megakernel takes 1 <= B <= {MEGAKERNEL_MAX_BATCH}, got B={B}")
    lp = _card_plan(c, B, Tmp, wd, kvd, dev)
    ops = _kernel_operands(plan, lp.grid)
    check_kernel_args(c, ops, lp)
    bufs = _call_buffers(c, B, total, dev, lp.grid)
    if forced is not None:
        if tuple(forced.shape) != (total, B):
            raise ValueError(f"forced tokens must be (total, B) = ({total}, {B}), "
                             f"got {tuple(forced.shape)}")
        if int(forced.min()) < 0 or int(forced.max()) >= Vpad:
            raise ValueError("forced tokens outside the vocabulary")
        forced = forced.to(device=dev, dtype=torch.int32).contiguous()
    if gumbel is not None:
        if tuple(gumbel.shape) != (total, B, Vpad):
            raise ValueError(f"gumbel noise must be (total, B, Vpad) = ({total}, {B}, {Vpad}), "
                             f"got {tuple(gumbel.shape)}")
        gumbel = gumbel.to(device=dev, dtype=F32).contiguous()
    if stage_clocks is not None:
        need = stage_clock_count(c)
        if (stage_clocks.dtype != torch.int64 or stage_clocks.device != dev
                or not stage_clocks.is_contiguous() or stage_clocks.numel() < need):
            raise ValueError(f"stage_clocks must be a contiguous int64 tensor of >= {need} "
                             f"entries on {dev}")
    tensors = {**ops, **bufs, "forced": forced, "gumbel": gumbel, "stage_clock": stage_clocks}
    params = _params(c, lp, total, Tmp, w_int8, kv_int8, tensors)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check(lib, lib.decode_megakernel_launch(ctypes.byref(params), stream), "launch")
    _megakernel_call.launches += 1
    # The error word is the one thing read back here: a grid barrier that
    # waited past its limit sets it and every block leaves the kernel.
    if int(bufs["sync"][1]):
        raise RuntimeError("decode megakernel: a grid barrier timed out; the results are invalid")
    return MegakernelOut(bufs["logits"], bufs["conv_state"], bufs["ssm_state"])


def _megakernel_call(cfg: DecoderConfig, plan: _Plan, frames_per_stream: int,
                     forced_tokens: Optional[torch.Tensor] = None,
                     unroll_steps: int = 1,
                     gumbel: Optional[torch.Tensor] = None,
                     stage_clocks: Optional[torch.Tensor] = None) -> MegakernelOut:
    """Decode ``Q * frames_per_stream`` steps of ``plan`` in one launch.

    ``forced_tokens`` (total, B) int teacher-forces step t with
    ``forced_tokens[t]`` (token ids where the TPU kernel takes one-hot rows:
    the gathered row equals the one-hot product exactly).  ``gumbel``
    (total, B, Vpad) f32, already temperature-scaled, is added to each
    step's logits before the argmax that feeds the next step.
    ``unroll_steps`` must divide the step count, as in the JAX package; the
    kernel loops over steps itself, so results do not depend on it.
    ``stage_clocks`` (int64, on the card) is a diagnostic: the kernel's block
    0 writes its cycle counter at the start of the middle step and on entering
    and leaving each of its grid barriers (``stage_clock_count(cfg)`` stamps),
    which splits a step into each stage's work and each barrier's wait.

    CUDA tensors launch the Hopper kernel or raise; CPU tensors run
    :func:`decode_megakernel_ref`.
    """
    total = cfg.num_quantizers * frames_per_stream
    if unroll_steps < 1 or total % unroll_steps:
        raise ValueError(f"unroll_steps={unroll_steps} must divide total={total}")
    if on_card(plan.K):
        return _launch(cfg, plan, total, forced_tokens, gumbel, stage_clocks)
    if plan.K.device.type == "cpu":
        return decode_megakernel_ref(cfg, plan, frames_per_stream, forced_tokens, gumbel)
    raise ValueError(f"decode megakernel: unsupported device {plan.K.device}")


_megakernel_call.launches = 0


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel draws ``-log(-log U)``, U uniform on (0, 1)."""
    tiny = torch.finfo(F32).tiny
    u = torch.rand(shape, generator=generator, device=device, dtype=F32).clamp_(min=tiny)
    return -torch.log(-torch.log(u))


@torch.no_grad()
def megakernel_greedy_decode(
    decoder: MambaTTSDecoder,
    qparams: dict,
    text_hidden: torch.Tensor,
    z_style: torch.Tensor,
    frames_per_stream: int,
    text_mask: Optional[torch.Tensor] = None,
    ref_hidden: Optional[torch.Tensor] = None,
    ref_mask: Optional[torch.Tensor] = None,
    collect_logits: bool = False,
    forced_tokens: Optional[torch.Tensor] = None,
    unroll_steps: int = 1,
    weight_dtype: str = "bfloat16",
    kv_dtype: str = "bfloat16",
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    weight_plan: Optional[_WeightPlan] = None,
    gumbel: Optional[torch.Tensor] = None,
) -> DecodeResult:
    """Greedy (or Gumbel-max sampled) decode of the whole utterance in one
    kernel launch; same contract as ``infer.quant_decode.greedy_decode_int8``.

    ``temperature > 0`` samples categorically: ``argmax(logits / T + g)``
    equals ``argmax(logits + T g)``, so the kernel adds a pre-scaled noise
    row per step.  The noise is one (total, B, Vpad) draw from ``generator``
    or, for tests that feed both packages the same numbers, the standard
    Gumbel draws handed in as ``gumbel``.  ``forced_tokens`` (total,) or
    (B, total) switches to teacher forcing.  Traced on the card, the launch
    (span ``decode.run``) also writes the kernel's stage stamps of the
    middle step (``stage_clocks``), kept as the span's attribute.
    """
    c = decoder.cfg
    B = text_hidden.shape[0]
    total = c.num_quantizers * frames_per_stream
    while total % unroll_steps:  # largest feasible unroll <= requested
        unroll_steps -= 1

    with annotate("decode.memory"):
        KV, memory_mask, films = decoder.project_memories(
            text_hidden, text_mask, ref_hidden, ref_mask, z_style)
    with annotate("decode.plan"):
        plan = _build_plan(c, qparams, KV, memory_mask, films, frames_per_stream,
                           weight_dtype=weight_dtype, kv_dtype=kv_dtype, weight_plan=weight_plan)
        Vpad = plan.token_embed.shape[0]
        dev = text_hidden.device
        forced = None
        if forced_tokens is not None:
            ft = torch.atleast_2d(torch.as_tensor(forced_tokens, device=dev))  # (B, total)
            forced = ft.T.expand(total, B).to(torch.int32).contiguous()
        noise = None
        if temperature > 0.0:
            if gumbel is None:
                if generator is None:
                    raise ValueError("temperature > 0 requires a generator (or gumbel noise)")
                gumbel = gumbel_noise((total, B, Vpad), generator, dev)
            noise = temperature * gumbel.to(device=dev, dtype=F32)
    with annotate("decode.run", device_time=True, steps=total, path="megakernel") as span:
        clocks = None
        if span is not None and on_card(plan.K):
            # torch.empty launches no kernel; the launch writes every stamp
            clocks = span.attrs["stage_clocks"] = torch.empty(
                stage_clock_count(c), dtype=torch.int64, device=dev)
        logits = _megakernel_call(c, plan, frames_per_stream, forced, unroll_steps=unroll_steps,
                                  gumbel=noise, stage_clocks=clocks).logits  # (total, B, Vpad)
    choice = logits if noise is None else logits + noise
    tokens = torch.argmax(choice, dim=2).T.contiguous()  # (B, total)
    if collect_logits:
        return DecodeResult(tokens=tokens,
                            logits=logits.transpose(0, 1)[:, :, : c.vocab_size_audio])
    return DecodeResult(tokens=tokens, logits=torch.zeros((B, 0), device=dev))
