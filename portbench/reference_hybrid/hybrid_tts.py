# A frozen copy of reference/hybrid_tts.py, so that the benchmark's plain
# reference of the jamba decoder does not move with the repository's.
"""Plain float32 reference of the jamba codec-token decoder
(``mamba_tts_torch.models.hybrid``), written from Hugging Face's
``modeling_jamba`` (AI21 Jamba: ``JambaMambaMixer``'s slow path,
``JambaAttention``, ``JambaMLP``, ``JambaRMSNorm``) for clarity, not speed.

No kernel, no cache, no batching: one row at a time, every product in
float32 with TF32 off, the selective scan one step at a time within chunks
of 64 (all chunks at once, then a carry over the chunks), causal attention
materialized.  It imports nothing of the program; parameter names equal the
program's, so one set of weights serves both.

Per layer (kind by ``i % attn_layer_period == attn_layer_offset``)::

    x += Mamba(RMSNorm(x))  or  x += Attention(RMSNorm(x))
    x += down(silu(gate(RMSNorm(x))) * up(RMSNorm(x)))

Mamba: in_proj -> (x, z); causal depthwise conv (bias) -> SiLU; x_proj ->
(dt, B, C), each RMSNorm'd; dt = softplus(dt_proj(dt)); the selective scan
with A = -exp(A_log) and D; times SiLU(z); out_proj.  Attention: H query
heads, H_kv K/V heads (each serving H / H_kv), causal, scale
1/sqrt(head_dim), no positional encoding, no biases.  Final RMSNorm, head
tied to the token embedding.

Departures from ``modeling_jamba`` (the TTS around the block):

- the conditioning is a prefix ``[style || voice || text]`` before the
  tokens: ``style_proj(z_style)`` (one position), the voice prompt's codec
  grid (its non-PAD ids, quantizer-major) embedded by the token, frame
  position and quantizer tables, and ``text_proj`` of the text encoder's
  valid positions; the tokens follow from BOS, embedded as the voice grid;
- the vocabulary is the codec's ids (codebook ids shifted past PAD and
  BOS), not the text tokens, and the tied head covers those ids;
- ``style_proj``, ``text_proj`` and the position and quantizer tables are
  the system's own (assumed sizes), not part of the published model.

``fake`` (the precision control): a function that rounds both operands of
every product with a weight, and of the attention's, before the product;
:func:`set_fake` puts one in a built model for a while.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SCAN_CHUNK = 64
QUERY_BLOCK = 1024


@dataclass(frozen=True)
class MambaSizes:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0
    conv_bias: bool = True
    use_bias: bool = False


@dataclass(frozen=True)
class HybridConfig:
    """The sizes the reference reads (the program's ``DecoderConfig`` keys)."""
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    d_style: int
    d_text: int
    attn_layer_offset: int
    attn_layer_period: int
    norm_eps: float = 1e-6
    codebook_size: int = 1024
    num_special_tokens: int = 2
    num_quantizers: int = 5
    max_len: int = 1024
    pad_id: int = 0
    bos_id: int = 1
    mamba: MambaSizes = field(default_factory=MambaSizes)

    @classmethod
    def from_dict(cls, d: dict, d_text: int) -> "HybridConfig":
        """From the program's decoder tree and the text encoder's width."""
        keys = set(cls.__dataclass_fields__) - {"mamba", "d_text"}
        m = d.get("mamba", {})
        return cls(**{k: v for k, v in d.items() if k in keys}, d_text=d_text,
                   mamba=MambaSizes(**{k: v for k, v in m.items()
                                       if k in MambaSizes.__dataclass_fields__}))

    @property
    def vocab(self) -> int:
        return self.codebook_size + self.num_special_tokens

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    def kind(self, i: int) -> str:
        p = self.attn_layer_period
        return "attention" if p and i % p == self.attn_layer_offset else "mamba"


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


def chunked_scan(u, delta, A, Bm, Cm, D, chunk: int = SCAN_CHUNK):
    """y_t = <C_t, h_t> + D u_t, h_t = exp(delta_t A) h_{t-1} + delta_t u_t B_t,
    h_0 = 0.  u, delta (T, d); A (d, n); B, C (T, n).  Each chunk runs from a
    zero state (all at once), the chunk start states follow by a carry, and
    a second sweep adds each start state's part."""
    T, d = u.shape
    n = A.shape[1]
    pad = (-T) % chunk
    if pad:
        u, delta, Bm, Cm = (F.pad(t, (0, 0, 0, pad)) for t in (u, delta, Bm, Cm))
    nc = (T + pad) // chunk
    u, dl = u.reshape(nc, chunk, d), delta.reshape(nc, chunk, d)
    Bc, Cc = Bm.reshape(nc, chunk, n), Cm.reshape(nc, chunk, n)
    At = A.T[None]  # (1, n, d)
    h = u.new_zeros((nc, n, d))
    decay = u.new_ones((nc, n, d))
    ys = []
    for t in range(chunk):
        a = torch.exp(dl[:, t, None, :] * At)
        h = a * h + (dl[:, t] * u[:, t])[:, None, :] * Bc[:, t, :, None]
        decay = decay * a
        ys.append(torch.einsum("cnd,cn->cd", h, Cc[:, t]))
    starts, s = [], u.new_zeros((n, d))
    for c in range(nc):
        starts.append(s)
        s = decay[c] * s + h[c]
    g = torch.stack(starts)
    for t in range(chunk):
        g = torch.exp(dl[:, t, None, :] * At) * g
        ys[t] = ys[t] + torch.einsum("cnd,cn->cd", g, Cc[:, t])
    y = torch.stack(ys, dim=1).reshape(nc * chunk, d)[:T]
    return y + u.reshape(nc * chunk, d)[:T] * D


class Mamba(nn.Module):
    def __init__(self, c: HybridConfig, fake):
        super().__init__()
        m = c.mamba
        di = m.expand * c.d_model
        self.r = m.dt_rank or -(-c.d_model // 16)
        self.n, self.k = m.d_state, m.d_conv
        self.in_proj = Linear(c.d_model, 2 * di, m.use_bias, fake)
        self.conv_w = nn.Parameter(torch.zeros(m.d_conv, di))
        self.conv_b = nn.Parameter(torch.zeros(di)) if m.conv_bias else None
        self.x_proj = Linear(di, self.r + 2 * m.d_state, False, fake)
        self.dt_proj = Linear(self.r, di, True, fake)
        self.A_log = nn.Parameter(torch.zeros(di, m.d_state))
        self.D = nn.Parameter(torch.ones(di))
        self.out_proj = Linear(di, c.d_model, m.use_bias, fake)
        self.dt_norm = RMSNorm(self.r, c.norm_eps)
        self.b_norm = RMSNorm(m.d_state, c.norm_eps)
        self.c_norm = RMSNorm(m.d_state, c.norm_eps)

    def forward(self, x):  # (T, d)
        xin, z = self.in_proj(x).chunk(2, dim=-1)
        T = xin.shape[0]
        xp = F.pad(xin, (0, 0, self.k - 1, 0))
        conv = sum(xp[i:i + T] * self.conv_w[i] for i in range(self.k))
        if self.conv_b is not None:
            conv = conv + self.conv_b
        xc = F.silu(conv)
        dt, Bm, Cm = torch.split(self.x_proj(xc), [self.r, self.n, self.n], dim=-1)
        dt = F.softplus(self.dt_proj(self.dt_norm(dt)))
        y = chunked_scan(xc, dt, -torch.exp(self.A_log), self.b_norm(Bm), self.c_norm(Cm),
                         self.D)
        return self.out_proj(y * F.silu(z))


class Attention(nn.Module):
    def __init__(self, c: HybridConfig, fake):
        super().__init__()
        self.h, self.hkv = c.n_heads, c.kv_heads
        self.hd = c.d_model // c.n_heads
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
            s = q[:, lo:hi] @ k[:, :hi].transpose(1, 2) * self.hd ** -0.5
            later = torch.arange(hi, device=x.device)[None] > torch.arange(lo, hi,
                                                                          device=x.device)[:, None]
            p = torch.softmax(s.masked_fill(later, float("-inf")), dim=-1)
            if self.fake is not None:
                p = _straight(p, self.fake)
            outs.append(p @ v[:, :hi])
        return self.o_proj(torch.cat(outs, dim=1).transpose(0, 1).reshape(T, self.h * self.hd))


class MLP(nn.Module):
    def __init__(self, c: HybridConfig, fake):
        super().__init__()
        self.gate_proj = Linear(c.d_model, c.d_ff, False, fake)
        self.up_proj = Linear(c.d_model, c.d_ff, False, fake)
        self.down_proj = Linear(c.d_ff, c.d_model, False, fake)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Layer(nn.Module):
    def __init__(self, c: HybridConfig, kind: str, fake):
        super().__init__()
        self.norm_mixer = RMSNorm(c.d_model, c.norm_eps)
        if kind == "mamba":
            self.mamba = Mamba(c, fake)
        else:
            self.attn = Attention(c, fake)
        self.norm_mlp = RMSNorm(c.d_model, c.norm_eps)
        self.mlp = MLP(c, fake)

    def forward(self, x):
        mixer = self.mamba if hasattr(self, "mamba") else self.attn
        x = x + mixer(self.norm_mixer(x))
        return x + self.mlp(self.norm_mlp(x))


class HybridTTSDecoder(nn.Module):
    """The jamba decoder of one row: ``logits(...)`` over the prefix and the
    tokens, ``loss(rows)`` over rows."""

    def __init__(self, c: HybridConfig, fake: Optional[Callable] = None):
        super().__init__()
        self.cfg = c
        self.token_embed = Table(c.vocab, c.d_model)
        self.pos_embed = Table(c.max_len, c.d_model)
        self.quant_embed = Table(c.num_quantizers, c.d_model)
        self.style_proj = Linear(c.d_style, c.d_model, True, fake)
        self.text_proj = Linear(c.d_text, c.d_model, True, fake)
        for i in range(c.n_layers):
            self.add_module(f"layer_{i}", Layer(c, c.kind(i), fake))
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
        Q = c.num_quantizers
        inputs = torch.cat([tokens.new_full((1,), c.bos_id), tokens[:-1]]).long()
        x = torch.cat([self.prefix(text_hidden, z_style, voice_ids),
                       self.embed_grid(inputs.reshape(Q, -1))])
        for i in range(c.n_layers):
            x = getattr(self, f"layer_{i}")(x)
        x = self.norm_out(x[-tokens.shape[0]:])
        return F.linear(x, self.token_embed.weight)

    def loss(self, rows: List[Dict[str, torch.Tensor]]) -> torch.Tensor:
        """Cross-entropy over every non-PAD target token of the rows (each a
        dict: ``text_hidden``, ``z_style``, ``voice_ids``, ``tokens``), the
        mean over those tokens, as the system's codec loss."""
        total, count = 0.0, 0.0
        for r in rows:
            lg = self.logits(r["text_hidden"], r["z_style"], r["voice_ids"], r["tokens"])
            nll = -torch.log_softmax(lg, dim=-1).gather(-1, r["tokens"].long()[:, None])[:, 0]
            valid = (r["tokens"] != self.cfg.pad_id).float()
            total = total + (nll * valid).sum()
            count = count + valid.sum()
        return total / count
