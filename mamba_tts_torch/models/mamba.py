"""Mamba (selective-SSM) block — counterpart of ``mamba_tts_tpu/models/mamba.py``.

    x -> in_proj -> (x, z)
    x -> causal depthwise conv(d_conv) -> SiLU
      -> x_proj -> (dt_raw, B, C);  dt = softplus(dt_proj(dt_raw))
      -> selective_scan(x, dt, A=-exp(A_log), B, C, D)
    y = scan_out * SiLU(z) -> out_proj

With ``inner_norm_eps`` (Jamba's mixer) dt_raw, B and C each pass an
RMSNorm after ``x_proj``.

Decode carries :class:`MambaState` = (conv ring buffer, SSM state), O(1) per
step; ``step`` runs its conv and state update through the two kernels of
``ops/mamba_step.py`` on the card (in place on the decode's carry) and their
plain versions on the CPU.  ``forward`` (the full-sequence path, with
gradients in training) runs its scan through the Hopper scan kernels on the
card and the plain scan on the CPU.

Parallelism (``parallel/``): with ``mesh`` the block shards ``d_inner`` over
the mesh's "model" axis (``in_proj`` column-parallel, each rank taking its
slice of the x half and of the z half; ``x_proj`` row-parallel and summed
before dt/B/C; ``dt_proj``, the conv, ``A_log`` and ``D`` local;
``out_proj`` row-parallel), so the scan runs on d_inner / tp channels.
With ``sp_mesh`` the full-sequence scan without an incoming state shards
its time axis over ``sp_mesh[sp_axis]`` (``parallel/sp_scan.py``), as the
JAX block does; decode steps and state-carrying calls use the regular scan.

State layout:
    conv: (B, d_conv-1, d_inner)  last inputs of the conv window, compute dtype
    ssm:  (B, d_state, d_inner)   float32
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mamba_tts_torch.config import MambaConfig
from mamba_tts_torch.models.layers import Dense, RMSNorm, normal_init, row_parallel
from mamba_tts_torch.ops.mamba_step import check_state, conv_step, ssm_step
from mamba_tts_torch.ops.selective_scan import selective_scan
from mamba_tts_torch.parallel import comm
from mamba_tts_torch.parallel.mesh import model_group
from mamba_tts_torch.parallel.sp_scan import sp_selective_scan


class MambaState(NamedTuple):
    conv: torch.Tensor  # (B, d_conv-1, d_inner), compute dtype
    ssm: torch.Tensor  # (B, d_state, d_inner), float32


def _softplus_inverse(x: torch.Tensor) -> torch.Tensor:
    return x + torch.log(-torch.expm1(-x))


class MambaBlock(nn.Module):
    """``sp_batch_sharded``: the batch rows are split over the sp axis too."""

    def __init__(self, cfg: MambaConfig, dtype=torch.bfloat16, mesh=None, sp_mesh=None,
                 sp_axis: str = "data", sp_batch_sharded: bool = False,
                 inner_norm_eps: Optional[float] = None):
        super().__init__()
        c = self.cfg = cfg
        self.dtype = dtype
        self.tp_group, tp = model_group(mesh, c.d_inner)
        self.sp_mesh, self.sp_axis, self.sp_batch_sharded = sp_mesh, sp_axis, sp_batch_sharded
        d_in = c.d_inner // tp
        self.in_proj = Dense(c.d_model, 2 * d_in, bias=c.use_bias, dtype=dtype)
        self.conv_w = nn.Parameter(torch.zeros(c.d_conv, d_in))
        self.conv_b = nn.Parameter(torch.zeros(d_in)) if c.conv_bias else None
        self.x_proj = Dense(d_in, c.dt_rank_actual + 2 * c.d_state, bias=False, dtype=dtype)
        self.dt_proj = Dense(c.dt_rank_actual, d_in, bias=True, dtype=dtype)
        self.A_log = nn.Parameter(torch.zeros(d_in, c.d_state))
        self.D = nn.Parameter(torch.ones(d_in))
        self.out_proj = Dense(d_in, c.d_model, bias=c.use_bias, dtype=dtype)
        self.inner_norms = inner_norm_eps is not None  # Jamba's mixer
        if self.inner_norms:
            self.dt_norm = RMSNorm(c.dt_rank_actual, inner_norm_eps, dtype)
            self.b_norm = RMSNorm(c.d_state, inner_norm_eps, dtype)
            self.c_norm = RMSNorm(c.d_state, inner_norm_eps, dtype)

    def init_weights(self, g: torch.Generator) -> None:
        """mamba-ssm's init: S4D-real ``A[d, n] = -(n + 1)``; dt_proj weights
        uniform with variance 1/dt_rank and a bias with softplus(bias) ~
        log-uniform on [dt_min, dt_max]; D = 1; LeCun-normal conv taps."""
        c = self.cfg
        d_in = self.D.shape[0]
        with torch.no_grad():
            normal_init(self.conv_w, 1.0 / math.sqrt(c.d_conv), g)
            if self.conv_b is not None:
                self.conv_b.zero_()
            lim = math.sqrt(3.0 / c.dt_rank_actual)
            self.dt_proj.weight.copy_(
                (torch.rand(self.dt_proj.weight.shape, generator=g) * 2 - 1) * lim)
            u = torch.rand(d_in, generator=g)
            dt = torch.exp(u * (math.log(c.dt_max) - math.log(c.dt_min)) + math.log(c.dt_min))
            self.dt_proj.bias.copy_(_softplus_inverse(torch.clamp(dt, min=c.dt_init_floor)))
            n = torch.arange(1, c.d_state + 1, dtype=torch.float32)
            self.A_log.copy_(torch.log(n).expand(d_in, c.d_state))
            self.D.fill_(1.0)

    def _conv_full(self, x: torch.Tensor, conv_init: Optional[torch.Tensor]):
        """Causal depthwise conv over (B, T, d_inner) with an optional
        (B, d_conv-1, d_inner) history; returns (out, new conv state)."""
        B, T, D = x.shape
        k = self.cfg.d_conv
        if conv_init is None:
            conv_init = x.new_zeros((B, k - 1, D))
        xp = torch.cat([conv_init.to(x.dtype), x], dim=1)
        w = self.conv_w.to(x.dtype)
        out = torch.zeros_like(x)
        for i in range(k):
            out = out + xp[:, i:i + T] * w[i]
        if self.conv_b is not None:
            out = out + self.conv_b.to(x.dtype)
        return out, xp[:, T:]

    def _x_proj(self, x_conv: torch.Tensor):
        """``x_proj``'s dt_raw (after ``dt_norm`` where the block has it), B
        and C slices, the latter two before their norms."""
        c = self.cfg
        r = c.dt_rank_actual
        # row-parallel, then replicated input to the local dt_proj and scan
        proj = comm.copy_to_group(row_parallel(self.x_proj, x_conv, self.tp_group), self.tp_group)
        dt_raw, Bm, Cm = torch.split(proj, [r, c.d_state, c.d_state], dim=-1)
        if self.inner_norms:
            dt_raw = self.dt_norm(dt_raw)
        return dt_raw, Bm, Cm

    def _ssm_inputs(self, x_conv: torch.Tensor):
        dt_raw, Bm, Cm = self._x_proj(x_conv)
        if self.inner_norms:
            Bm, Cm = self.b_norm(Bm), self.c_norm(Cm)
        dt = F.softplus(self.dt_proj(dt_raw).to(torch.float32))
        return dt, Bm, Cm

    def forward(self, x: torch.Tensor, state: Optional[MambaState] = None,
                lengths: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, MambaState]:
        """Full sequence: x (B, T, d_model) -> (y, new state).  ``lengths``
        (B,): row b's state is the one after its first ``lengths[b]``
        positions (its conv window ends there, and dt is 0 beyond it, so
        that the scan carries the state unchanged through the padding);
        outputs past a row's length are not meaningful."""
        xin, z = self._in_proj(x)
        x_conv, conv_state = self._conv_full(xin, state.conv if state is not None else None)
        x_conv = F.silu(x_conv)
        dt, Bm, Cm = self._ssm_inputs(x_conv)
        if lengths is not None:
            T, k = x.shape[1], self.cfg.d_conv
            valid = torch.arange(T, device=x.device)[None] < lengths[:, None]
            dt = dt * valid[..., None]
            xp = torch.cat([xin.new_zeros((xin.shape[0], k - 1, xin.shape[2])), xin], dim=1)
            idx = lengths[:, None] + torch.arange(k - 1, device=x.device)[None]
            conv_state = torch.gather(xp, 1, idx[..., None].expand(-1, -1, xin.shape[2]))
        A = -torch.exp(self.A_log)
        if self.sp_mesh is not None and state is None:
            y, ssm_state = sp_selective_scan(
                x_conv, dt, A, Bm, Cm, self.D, self.sp_mesh, self.sp_axis,
                batch_sharded=self.sp_batch_sharded)
        else:
            y, ssm_state = selective_scan(
                x_conv, dt, A, Bm, Cm, self.D, h0=state.ssm if state is not None else None)
        y = y * F.silu(z)
        return row_parallel(self.out_proj, y, self.tp_group), MambaState(conv=conv_state, ssm=ssm_state)

    def _in_proj(self, x: torch.Tensor):
        """Column-parallel: this rank's channels of the x half and the z half."""
        return self.in_proj(comm.copy_to_group(x.to(self.dtype), self.tp_group)).chunk(2, dim=-1)

    def step(self, x_t: torch.Tensor, state: MambaState, inplace: bool = False
             ) -> Tuple[torch.Tensor, MambaState]:
        """One token: x_t (B, 1, d_model) -> (y (B, 1, d_model), new state).
        Between the projections, ``ops/mamba_step.py``'s ``conv_step`` and
        ``ssm_step``: the two kernels on the card (which raise where they do
        not take the tensors, a recorded gradient included), the plain
        versions on the CPU.  ``inplace``: the new conv window and SSM state
        are written over ``state``'s tensors, which are returned (the
        captured decode's carry)."""
        xin, z = (t[:, 0] for t in self._in_proj(x_t))
        norms = (self.b_norm, self.c_norm) if self.inner_norms else None
        check_state(self.A_log, self.D, state.ssm, norms)
        x_conv, conv = conv_step(xin, state.conv, self.conv_w, self.conv_b, inplace)
        dt_raw, Bm, Cm = self._x_proj(x_conv)
        y, ssm = ssm_step(self.dt_proj(dt_raw), self.A_log, x_conv, z, Bm, Cm, self.D,
                          state.ssm, norms, inplace)
        return row_parallel(self.out_proj, y, self.tp_group)[:, None], MambaState(conv=conv, ssm=ssm)

    def init_state(self, batch: int) -> MambaState:
        return init_mamba_state(self.cfg, batch, self.dtype, self.A_log.device)


def init_mamba_state(cfg: MambaConfig, batch: int, dtype=torch.bfloat16,
                     device: Optional[torch.device] = None) -> MambaState:
    """A zeroed :class:`MambaState`."""
    return MambaState(
        conv=torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), dtype=dtype, device=device),
        ssm=torch.zeros((batch, cfg.d_state, cfg.d_inner), dtype=torch.float32, device=device),
    )
