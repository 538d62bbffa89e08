"""The Mamba-2 (SSD) mixer of the granite decoder (``models/granite.py``),
after Hugging Face's ``GraniteMoeHybridMambaLayer``.  The JAX package has no
counterpart.

    in_proj(x) -> [z (d_inner) || xBC (d_inner + 2·G·N) || dt (H)]
    xBC -> causal depthwise conv (bias) -> SiLU -> [x || B || C]
    delta = softplus(dt + dt_bias) a head;  A = -exp(A_log) a head
    h_t = exp(delta_t·A)·h_{t-1} + delta_t·x_t ⊗ B_t;  y_t = h_t·C_t + D·x_t
    out_proj(RMSNorm(y · SiLU(z)))          (the norm over all d_inner channels)

with H heads of P channels (x is (H, P) a position), a state of N values a
channel, and one group (B and C shared by every head; ``n_groups`` 1 is
what the block publishes and all this module takes).

- :meth:`Mamba2Mixer.forward` — a whole sequence, each row to its own
  length (``lengths``: delta is 0 past it, so the state carries through the
  padding unchanged, and the conv window ends at it), by the chunked SSD
  (:func:`ssd_chunked`: within a chunk the quadratic form, between chunks
  the state; torch products, f32); returns the conv window and the f32
  state after each row's length.
- :meth:`Mamba2Mixer.step` — one token: ``ops/mamba_step.py``'s
  ``conv_step`` over xBC, then its ``mamba2_step`` (the state in place on
  the card), then the gated norm and ``out_proj``.

State layout:
    conv: (B, d_conv-1, conv_dim)  the conv window of xBC, compute dtype
    ssm:  (B, H, P, N)             float32
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mamba_tts_torch.config import Mamba2Config
from mamba_tts_torch.models.layers import Dense, RMSNorm, normal_init
from mamba_tts_torch.ops.mamba_step import check_state2, conv_step, mamba2_step


A_INIT_RANGE = (1.0, 16.0)  # Mamba-2's init: A uniform on it, a head
DT_MIN, DT_MAX, DT_FLOOR = 1e-3, 1e-1, 1e-4  # dt log-uniform on [min, max], floored


class Mamba2State(NamedTuple):
    conv: torch.Tensor  # (B, d_conv-1, conv_dim), compute dtype
    ssm: torch.Tensor  # (B, H, P, N), float32


def ssd_chunked(x: torch.Tensor, delta: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD recurrence from a zero state, chunk by chunk, all f32: x (B,
    T, H, P), delta (B, T, H), A (H,), Bm and Cm (B, T, N).  Returns (y (B,
    T, H, P) = C_t·h_t, the state after T steps (B, H, P, N)).

    Within a chunk, y_t = Σ_{s<=t} (C_t·B_s) exp(Σ_{s<r<=t} delta_r A)
    delta_s x_s plus the chunk's start state decayed to t and read by C_t;
    the start state of the next chunk is the last one decayed over the
    chunk plus each step's input decayed to the chunk's end.  The tests hold
    it to the recurrence one step at a time (the reference's ``ssd_steps``)."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    h = x.new_zeros((Bsz, H, P, N))
    ys = []
    for t0 in range(0, T, chunk):
        xc, dc = x[:, t0:t0 + chunk], delta[:, t0:t0 + chunk]
        Bc, Cc = Bm[:, t0:t0 + chunk], Cm[:, t0:t0 + chunk]
        L = xc.shape[1]
        acs = torch.cumsum(dc * A, dim=1)  # (B, L, H): log of the decay from the chunk's start
        seg = acs[:, :, None] - acs[:, None]  # (B, t, s, H)
        later = torch.ones((L, L), dtype=torch.bool, device=x.device).triu(1)
        w = torch.exp(seg.masked_fill_(later[None, :, :, None], -math.inf))
        w.mul_(torch.einsum("btn,bsn->bts", Cc, Bc)[..., None]).mul_(dc[:, None])
        y = torch.einsum("btsh,bshp->bthp", w, xc)
        del seg, w
        y += torch.einsum("btn,bhpn->bthp", Cc, h) * torch.exp(acs)[..., None]
        ys.append(y)
        tail = torch.exp(acs[:, -1:] - acs) * dc  # (B, L, H)
        h = (h * torch.exp(acs[:, -1])[..., None, None]
             + torch.einsum("bsh,bshp,bsn->bhpn", tail, xc, Bc))
    return torch.cat(ys, dim=1), h


class Mamba2Mixer(nn.Module):
    """One Mamba-2 mixer of width ``d_model``; its norm's ``eps``; matrices
    in ``dtype``.  Parameters: ``in_proj``, ``conv_w`` (d_conv, conv_dim),
    ``conv_b``, ``dt_bias``, ``A_log``, ``D`` (H,), ``norm`` (the gated
    RMSNorm over d_inner), ``out_proj``."""

    def __init__(self, cfg: Mamba2Config, d_model: int, eps: float, dtype=torch.bfloat16):
        super().__init__()
        if cfg.n_groups != 1:
            raise ValueError(f"the Mamba-2 mixer takes one group, not {cfg.n_groups}")
        c = self.cfg = cfg
        self.dtype = dtype
        di = c.d_inner
        self.in_proj = Dense(d_model, 2 * di + 2 * c.d_state + c.n_heads, bias=c.use_bias,
                             dtype=dtype)
        self.conv_w = nn.Parameter(torch.zeros(c.d_conv, c.conv_dim))
        self.conv_b = nn.Parameter(torch.zeros(c.conv_dim)) if c.conv_bias else None
        self.dt_bias = nn.Parameter(torch.zeros(c.n_heads))
        self.A_log = nn.Parameter(torch.zeros(c.n_heads))
        self.D = nn.Parameter(torch.ones(c.n_heads))
        self.norm = RMSNorm(di, eps, dtype)
        self.out_proj = Dense(di, d_model, bias=c.use_bias, dtype=dtype)

    def init_weights(self, g: torch.Generator) -> None:
        """Mamba-2's init: A uniform on ``A_INIT_RANGE``, dt log-uniform on
        [DT_MIN, DT_MAX] (floor DT_FLOOR) through softplus's inverse into
        ``dt_bias``, D = 1, LeCun-normal conv taps, zero bias."""
        c = self.cfg
        with torch.no_grad():
            normal_init(self.conv_w, 1.0 / math.sqrt(c.d_conv), g)
            if self.conv_b is not None:
                self.conv_b.zero_()
            lo, hi = A_INIT_RANGE
            self.A_log.copy_(torch.log(lo + (hi - lo) * torch.rand(c.n_heads, generator=g)))
            u = torch.rand(c.n_heads, generator=g)
            dt = torch.exp(u * (math.log(DT_MAX) - math.log(DT_MIN)) + math.log(DT_MIN))
            dt = torch.clamp(dt, min=DT_FLOOR)
            self.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
            self.D.fill_(1.0)

    def _split(self, proj: torch.Tensor):
        """in_proj's output -> (z, xBC, dt)."""
        c = self.cfg
        return torch.split(proj, [c.d_inner, c.conv_dim, c.n_heads], dim=-1)

    def forward(self, u: torch.Tensor, lengths: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Mamba2State]:
        """A whole sequence u (B, T, d) -> (out (B, T, d), the state after
        each row's ``lengths[b]`` positions, all T where None); outputs past
        a row's length are not meaningful."""
        c = self.cfg
        Bsz, T, _ = u.shape
        z, xBC, dt = self._split(self.in_proj(u))
        k = c.d_conv
        xp = torch.cat([xBC.new_zeros((Bsz, k - 1, c.conv_dim)), xBC], dim=1)
        w = self.conv_w.to(xBC.dtype).float()
        conv = sum(xp[:, i:i + T].float() * w[i] for i in range(k))
        if self.conv_b is not None:
            conv = conv + self.conv_b.to(xBC.dtype).float()
        xc = F.silu(conv.to(xBC.dtype))
        xs, Bm, Cm = torch.split(xc.float(), [c.d_inner, c.d_state, c.d_state], dim=-1)
        delta = F.softplus(dt.float() + self.dt_bias)  # (B, T, H)
        if lengths is None:
            lengths = torch.full((Bsz,), T, dtype=torch.long, device=u.device)
        else:
            delta = delta * (torch.arange(T, device=u.device)[None] < lengths[:, None])[..., None]
        idx = lengths[:, None] + torch.arange(k - 1, device=u.device)[None]
        window = torch.gather(xp, 1, idx[..., None].expand(-1, -1, c.conv_dim))
        x4 = xs.reshape(Bsz, T, c.n_heads, c.head_dim)
        y, h = ssd_chunked(x4, delta, -torch.exp(self.A_log), Bm, Cm, c.chunk)
        y = (y + x4 * self.D[:, None]).reshape(Bsz, T, c.d_inner) * F.silu(z.float())
        return self.out_proj(self.norm(y)), Mamba2State(conv=window, ssm=h.contiguous())

    def step(self, u: torch.Tensor, state: Mamba2State, inplace: bool = False
             ) -> Tuple[torch.Tensor, Mamba2State]:
        """One token u (B, 1, d) -> (out (B, 1, d), new state): in_proj,
        ``conv_step`` over xBC, ``mamba2_step`` (the kernels on the card,
        which raise for what they do not take, a recorded gradient
        included; the plain versions on the CPU), the gated norm, out_proj.
        ``inplace``: the new window and state are written over ``state``'s
        tensors, which are returned (the captured decode's carry)."""
        c = self.cfg
        z, xBC, dt = self._split(self.in_proj(u)[:, 0])
        check_state2(self.dt_bias, self.A_log, self.D, state.ssm)
        xc, conv = conv_step(xBC, state.conv, self.conv_w, self.conv_b, inplace)
        xs, Bm, Cm = torch.split(xc, [c.d_inner, c.d_state, c.d_state], dim=-1)
        y, ssm = mamba2_step(xs, Bm, Cm, z, dt, self.dt_bias, self.A_log, self.D, state.ssm,
                             inplace)
        return self.out_proj(self.norm(y))[:, None], Mamba2State(conv=conv, ssm=ssm)

    def init_state(self, batch: int) -> Mamba2State:
        c, dev = self.cfg, self.A_log.device
        return Mamba2State(
            conv=torch.zeros((batch, c.d_conv - 1, c.conv_dim), dtype=self.dtype, device=dev),
            ssm=torch.zeros((batch, c.n_heads, c.head_dim, c.d_state), dtype=torch.float32,
                            device=dev))
