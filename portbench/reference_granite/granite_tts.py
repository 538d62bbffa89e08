"""Plain float32 reference of the granite codec-token decoder (the system's
``models/granite.py``), written from Hugging Face's
``modeling_granitemoehybrid`` (IBM granite-4.0-h: ``GraniteMoeHybridMambaLayer``'s
slow path, ``GraniteMoeHybridAttention``, ``GraniteMoeHybridMoE`` with its
``TopKGating`` and ``ParallelExperts``, ``GraniteMoeHybridMLP``,
``GraniteMoeHybridRMSNorm`` and ``RMSNormGated``) for clarity, not speed.

No kernel, no cache, no batching: one row at a time, every product in
float32 with TF32 off, attention materialized in blocks of queries.  It
imports nothing of the program; parameter names equal the program's, so one
set of weights serves both.

Per layer (kind by ``layer_types``), r = ``residual_multiplier``::

    x = x + r · Mamba2(RMSNorm(x))  or  x = x + r · Attention(RMSNorm(x))
    x = x + r · (MoE(RMSNorm(x)) + SharedMLP(RMSNorm(x)))

Mamba-2 (one group): in_proj -> [z || xBC || dt]; causal depthwise conv
(bias) over xBC, SiLU -> [x || B || C]; delta = softplus(dt + dt_bias);
h_t = exp(delta_t A) h_{t-1} + delta_t x_t B_t^T with A = -exp(A_log) a head,
y_t = h_t C_t + D x_t; out_proj(RMSNorm(y · SiLU(z))) over all d_inner
channels.  The recurrence runs in chunks (:func:`ssd_chunks`, the quadratic
form within a chunk from the segment sums of log-decays, the state carried
between chunks); :func:`ssd_steps` is the recurrence one step at a time, and
the repository's CPU tests hold the two together.  Attention: H query heads
on H_kv K/V heads, causal, scores scaled by ``attention_multiplier``, no
positional encoding, no biases.  MoE: router logits over all ``n_experts``,
the softmax over the top_k of them, each expert output_linear(SiLU(a) · b)
with [a || b] = input_linear(x), weighted by its gate; the shared MLP the
same form.  Inputs times ``embedding_multiplier``; final RMSNorm; head tied
to the token embedding, divided by ``logits_scaling``.

Departures from ``modeling_granitemoehybrid`` (the TTS around the block, and
one device's share of it):

- the experts: only those of [first, first + held) (``moe``'s
  ``first_expert``, ``experts_held``) add their part; the router keeps all
  ``n_experts`` outputs and its top_k, and the gates of experts held
  elsewhere are dropped, not renormalised (one card of an expert-parallel
  deployment, as the system);
- the conditioning is a prefix ``[style || voice || text]`` before the
  tokens: ``style_proj(z_style)`` (one position), the voice prompt's codec
  grid (its non-PAD ids, quantizer-major) embedded by the token, frame
  position and quantizer tables, and ``text_proj`` of the text encoder's
  valid positions; the tokens follow from BOS, embedded as the voice grid;
  ``embedding_multiplier`` multiplies every position of that input;
- the vocabulary is the codec's ids (codebook ids shifted past PAD and
  BOS), and the tied head covers those ids;
- ``style_proj``, ``text_proj`` and the position and quantizer tables are
  the system's own (assumed sizes), not part of the published model;
- the router's logits and gates, the expert outputs' weighting and every
  norm are float32 here as everything else (the published model computes
  its router in its own dtype and casts the logits to float32).

``fake`` (the precision control): a function that rounds both operands of
every product with a weight (the router's, float32 in the system, excepted),
and of the attention's, before the product; :func:`set_fake` puts one in a
built model for a while.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

QUERY_BLOCK = 1024
EXPERT_ROWS = 4096  # tokens an expert's products take at once


@dataclass(frozen=True)
class Mamba2Sizes:
    n_heads: int = 128
    head_dim: int = 64
    d_state: int = 128
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 256
    conv_bias: bool = True
    use_bias: bool = False


@dataclass(frozen=True)
class MoESizes:
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    d_shared: int = 0
    experts_held: int = 0
    first_expert: int = 0

    @property
    def held(self) -> Tuple[int, int]:
        n = self.experts_held or self.n_experts
        return self.first_expert, min(self.n_experts, self.first_expert + n)


@dataclass(frozen=True)
class GraniteConfig:
    """The sizes the reference reads (the program's ``DecoderConfig`` keys)."""
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_style: int
    d_text: int
    layer_types: Tuple[str, ...]
    norm_eps: float = 1e-5
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: float = 0.0
    logits_scaling: float = 1.0
    codebook_size: int = 1024
    num_special_tokens: int = 2
    num_quantizers: int = 5
    max_len: int = 1024
    pad_id: int = 0
    bos_id: int = 1
    mamba2: Mamba2Sizes = field(default_factory=Mamba2Sizes)
    moe: MoESizes = field(default_factory=MoESizes)

    @classmethod
    def from_dict(cls, d: dict, d_text: int) -> "GraniteConfig":
        """From the program's decoder tree and the text encoder's width."""
        keys = set(cls.__dataclass_fields__) - {"mamba2", "moe", "d_text", "layer_types"}

        def sub(k, c):
            return c(**{a: v for a, v in d.get(k, {}).items() if a in c.__dataclass_fields__})

        return cls(**{k: v for k, v in d.items() if k in keys}, d_text=d_text,
                   layer_types=tuple(d["layer_types"]), mamba2=sub("mamba2", Mamba2Sizes),
                   moe=sub("moe", MoESizes))

    @property
    def vocab(self) -> int:
        return self.codebook_size + self.num_special_tokens

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads


@contextlib.contextmanager
def set_fake(model: nn.Module, fake: Optional[Callable]):
    """``model`` with ``fake`` in every product while the block runs."""
    mods = [m for m in model.modules() if hasattr(m, "fake")]
    saved = [m.fake for m in mods]
    for m in mods:
        m.fake = fake
    try:
        yield model
    finally:
        for m, f in zip(mods, saved):
            m.fake = f


def _straight(x, fake):
    """``fake(x)`` in value, the identity in the gradient."""
    return x + (fake(x) - x).detach()


class Linear(nn.Module):
    def __init__(self, d_in: int, d_out: int, bias: bool, fake=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out)) if bias else None
        self.fake = fake

    def forward(self, x):
        w = self.weight
        if self.fake is not None:
            w, x = _straight(w, self.fake), _straight(x, self.fake)
        return F.linear(x, w, self.bias)


class Router(nn.Module):
    """The router's product, float32 in the system too: no ``fake``."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(d_out, d_in))

    def forward(self, x):
        return F.linear(x, self.weight)


class Table(nn.Module):
    def __init__(self, n: int, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n, d))

    def forward(self, ids):
        return self.weight[ids]


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) * self.weight


def ssd_steps(x, delta, A, Bm, Cm):
    """The recurrence one step at a time: x (T, H, P), delta (T, H), A (H,),
    Bm and Cm (T, N); h_0 = 0.  Returns y (T, H, P) = h_t C_t (D's part
    excluded)."""
    T, H, P = x.shape
    h = x.new_zeros((H, P, Bm.shape[1]))
    ys = []
    for t in range(T):
        h = torch.exp(delta[t] * A)[:, None, None] * h \
            + (delta[t, :, None] * x[t])[..., None] * Bm[t]
        ys.append(h @ Cm[t])
    return torch.stack(ys)


def segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., L) -> (..., L, L): [t, s] = a[s+1] + ... + a[t] for s <= t,
    -inf above the diagonal (as Mamba-2's reference ``segsum``: a masked
    cumulative sum, not a difference of two)."""
    L = a.shape[-1]
    x = a[..., None].expand(*a.shape, L)  # [.., t, s] = a[t]
    below = torch.tril(torch.ones(L, L, dtype=torch.bool, device=a.device), -1)
    x = torch.cumsum(x.masked_fill(~below, 0), dim=-2)
    return x.masked_fill(~torch.tril(torch.ones_like(below)), -math.inf)


def ssd_chunks(x, delta, A, Bm, Cm, chunk: int):
    """:func:`ssd_steps` by chunks of ``chunk`` positions: within a chunk
    y_t = sum_{s<=t} (C_t . B_s) exp(segsum)[t, s] delta_s x_s, plus the
    chunk's start state decayed to t; between chunks the state is carried."""
    T, H, P = x.shape
    N = Bm.shape[1]
    h = x.new_zeros((H, P, N))
    ys = []
    for t0 in range(0, T, chunk):
        xc, dc, Bc, Cc = (v[t0:t0 + chunk] for v in (x, delta, Bm, Cm))
        a = (dc * A).T  # (H, L)
        decay = torch.exp(segsum(a))  # (H, t, s)
        scores = (Cc @ Bc.T)[None] * decay * dc.T[:, None, :]  # (H, t, s)
        y = torch.einsum("hts,shp->thp", scores, xc)
        start = torch.exp(torch.cumsum(a, dim=1))  # (H, t): decay from the chunk's start
        y = y + torch.einsum("hpn,tn->thp", h, Cc) * start.T[..., None]
        ys.append(y)
        to_end = torch.exp(segsum(F.pad(a, (0, 1)))[:, -1, :-1]) * dc.T  # (H, s): to the end
        h = h * start[:, -1, None, None] + torch.einsum("hs,shp,sn->hpn", to_end, xc, Bc)
    return torch.cat(ys)


class Mamba2(nn.Module):
    def __init__(self, c: GraniteConfig, fake):
        super().__init__()
        m = self.m = c.mamba2
        if m.n_groups != 1:
            raise ValueError("one group only")
        di = m.n_heads * m.head_dim
        self.di, self.conv_dim = di, di + 2 * m.d_state
        self.in_proj = Linear(c.d_model, 2 * di + 2 * m.d_state + m.n_heads, m.use_bias, fake)
        self.conv_w = nn.Parameter(torch.zeros(m.d_conv, self.conv_dim))
        self.conv_b = nn.Parameter(torch.zeros(self.conv_dim)) if m.conv_bias else None
        self.dt_bias = nn.Parameter(torch.zeros(m.n_heads))
        self.A_log = nn.Parameter(torch.zeros(m.n_heads))
        self.D = nn.Parameter(torch.ones(m.n_heads))
        self.norm = RMSNorm(di, c.norm_eps)
        self.out_proj = Linear(di, c.d_model, m.use_bias, fake)

    def forward(self, u):  # (T, d)
        m = self.m
        z, xBC, dt = torch.split(self.in_proj(u), [self.di, self.conv_dim, m.n_heads], dim=-1)
        T = u.shape[0]
        xp = F.pad(xBC, (0, 0, m.d_conv - 1, 0))
        conv = sum(xp[i:i + T] * self.conv_w[i] for i in range(m.d_conv))
        if self.conv_b is not None:
            conv = conv + self.conv_b
        x, Bm, Cm = torch.split(F.silu(conv), [self.di, m.d_state, m.d_state], dim=-1)
        delta = F.softplus(dt + self.dt_bias)
        x = x.reshape(T, m.n_heads, m.head_dim)
        y = ssd_chunks(x, delta, -torch.exp(self.A_log), Bm, Cm, m.chunk)
        y = (y + x * self.D[:, None]).reshape(T, self.di)
        return self.out_proj(self.norm(y * F.silu(z)))


class Attention(nn.Module):
    def __init__(self, c: GraniteConfig, fake):
        super().__init__()
        self.h, self.hkv = c.n_heads, c.kv_heads
        self.hd = c.d_model // c.n_heads
        self.scale = c.attention_multiplier or self.hd ** -0.5
        self.fake = fake
        self.q_proj = Linear(c.d_model, self.h * self.hd, False, fake)
        self.k_proj = Linear(c.d_model, self.hkv * self.hd, False, fake)
        self.v_proj = Linear(c.d_model, self.hkv * self.hd, False, fake)
        self.o_proj = Linear(self.h * self.hd, c.d_model, False, fake)

    def forward(self, x):  # (T, d)
        T = x.shape[0]
        g = self.h // self.hkv
        q = self.q_proj(x).reshape(T, self.h, self.hd).transpose(0, 1)
        k = self.k_proj(x).reshape(T, self.hkv, self.hd).transpose(0, 1).repeat_interleave(g, 0)
        v = self.v_proj(x).reshape(T, self.hkv, self.hd).transpose(0, 1).repeat_interleave(g, 0)
        if self.fake is not None:
            q, k, v = (_straight(t, self.fake) for t in (q, k, v))
        outs = []
        for lo in range(0, T, QUERY_BLOCK):
            hi = min(T, lo + QUERY_BLOCK)
            s = q[:, lo:hi] @ k[:, :hi].transpose(1, 2) * self.scale
            later = torch.arange(hi, device=x.device)[None] > torch.arange(lo, hi,
                                                                          device=x.device)[:, None]
            p = torch.softmax(s.masked_fill(later, float("-inf")), dim=-1)
            if self.fake is not None:
                p = _straight(p, self.fake)
            outs.append(p @ v[:, :hi])
        return self.o_proj(torch.cat(outs, dim=1).transpose(0, 1).reshape(T, self.h * self.hd))


class SharedMLP(nn.Module):
    def __init__(self, d: int, ff: int, fake):
        super().__init__()
        self.input_linear = Linear(d, 2 * ff, False, fake)
        self.output_linear = Linear(ff, d, False, fake)

    def forward(self, x):
        a, b = self.input_linear(x).chunk(2, dim=-1)
        return self.output_linear(F.silu(a) * b)


class MoE(nn.Module):
    def __init__(self, c: GraniteConfig, fake):
        super().__init__()
        e = self.e = c.moe
        self.lo, self.hi = e.held
        self.router = Router(c.d_model, e.n_experts)
        self.input_linear = nn.Parameter(torch.zeros(self.hi - self.lo, 2 * e.d_expert, c.d_model))
        self.output_linear = nn.Parameter(torch.zeros(self.hi - self.lo, c.d_model, e.d_expert))
        self.shared_mlp = SharedMLP(c.d_model, e.d_shared, fake) if e.d_shared else None
        self.fake = fake

    def gates(self, x):
        """(T, n_experts): the softmax over each token's top_k logits, 0 elsewhere."""
        top, idx = self.router(x).topk(self.e.top_k, dim=-1)
        return torch.zeros((x.shape[0], self.e.n_experts), device=x.device).scatter(
            -1, idx, torch.softmax(top, dim=-1))

    def _product(self, x, w):
        if self.fake is not None:
            x, w = _straight(x, self.fake), _straight(w, self.fake)
        return x @ w.T

    def forward(self, x):  # (T, d)
        g = self.gates(x)
        out = torch.zeros_like(x)
        for j in range(self.hi - self.lo):
            rows = torch.nonzero(g[:, self.lo + j] > 0)[:, 0]
            for r0 in range(0, rows.numel(), EXPERT_ROWS):
                r = rows[r0:r0 + EXPERT_ROWS]
                a, b = self._product(x[r], self.input_linear[j]).chunk(2, dim=-1)
                o = self._product(F.silu(a) * b, self.output_linear[j])
                out.index_add_(0, r, o * g[r, self.lo + j, None])
        return out if self.shared_mlp is None else out + self.shared_mlp(x)


class Layer(nn.Module):
    def __init__(self, c: GraniteConfig, kind: str, fake):
        super().__init__()
        self.r = c.residual_multiplier
        self.norm_mixer = RMSNorm(c.d_model, c.norm_eps)
        if kind == "mamba":
            self.mamba = Mamba2(c, fake)
        else:
            self.attn = Attention(c, fake)
        self.norm_mlp = RMSNorm(c.d_model, c.norm_eps)
        self.moe = MoE(c, fake)

    def forward(self, x):
        mixer = self.mamba if hasattr(self, "mamba") else self.attn
        x = x + self.r * mixer(self.norm_mixer(x))
        return x + self.r * self.moe(self.norm_mlp(x))


class GraniteTTSDecoder(nn.Module):
    """The granite decoder of one row: ``logits(...)`` over the prefix and
    the tokens."""

    def __init__(self, c: GraniteConfig, fake: Optional[Callable] = None):
        super().__init__()
        self.cfg = c
        self.token_embed = Table(c.vocab, c.d_model)
        self.pos_embed = Table(c.max_len, c.d_model)
        self.quant_embed = Table(c.num_quantizers, c.d_model)
        self.style_proj = Linear(c.d_style, c.d_model, True, fake)
        self.text_proj = Linear(c.d_text, c.d_model, True, fake)
        for i, kind in enumerate(c.layer_types):
            self.add_module(f"layer_{i}", Layer(c, kind, fake))
        self.norm_out = RMSNorm(c.d_model, c.norm_eps)

    def embed_grid(self, ids_qt: torch.Tensor) -> torch.Tensor:
        """(Q, T) codec ids -> (Q*T, d), quantizer-major."""
        Q, T = ids_qt.shape
        dev = ids_qt.device
        q = torch.arange(Q, device=dev).repeat_interleave(T)
        p = torch.arange(T, device=dev).repeat(Q)
        return self.token_embed(ids_qt.reshape(-1)) + self.pos_embed(p) + self.quant_embed(q)

    def prefix(self, text_hidden, z_style, voice_ids) -> torch.Tensor:
        """``[style || voice || text]`` of one row: ``text_hidden`` (L, d_text)
        its valid positions, ``z_style`` (d_style,), ``voice_ids`` (S, Q) the
        voice prompt's shifted codec ids with PAD past its frames."""
        grid = voice_ids.T.long()  # (Q, S)
        voice = self.embed_grid(grid)[grid.reshape(-1) != self.cfg.pad_id]
        return torch.cat([self.style_proj(z_style.float())[None], voice,
                          self.text_proj(text_hidden.float())])

    def logits(self, text_hidden, z_style, voice_ids, tokens: torch.Tensor) -> torch.Tensor:
        """Logits (Q*F, V) of one row's tokens (Q*F,) (quantizer-major; F =
        frames): position j is fed BOS (j = 0) or token j - 1 and predicts
        token j."""
        c = self.cfg
        inputs = torch.cat([tokens.new_full((1,), c.bos_id), tokens[:-1]]).long()
        x = torch.cat([self.prefix(text_hidden, z_style, voice_ids),
                       self.embed_grid(inputs.reshape(c.num_quantizers, -1))])
        x = x * c.embedding_multiplier
        for i in range(c.n_layers):
            x = getattr(self, f"layer_{i}")(x)
        x = self.norm_out(x[-tokens.shape[0]:])
        return F.linear(x, self.token_embed.weight) / c.logits_scaling
