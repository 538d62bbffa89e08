"""Selective-scan (Mamba SSM) reference and decode step, plain PyTorch.

Counterpart of ``mamba_tts_tpu/ops/selective_scan.py``:

    h_t = exp(delta_t * A) * h_{t-1} + (delta_t * u_t) * B_t
    y_t = <C_t, h_t> + D * u_t

- :func:`selective_scan_ref`  — exact sequential scan over time; the plain
  path for CPU tensors and the reference of the Hopper scan kernels.
- :func:`selective_scan_step` — one recurrence step for the decode loop.
- :func:`selective_scan`      — the full-sequence dispatch: CPU tensors take
  the plain scan (autograd through it); CUDA tensors go to the Hopper scan
  kernels of ``ops/pallas_scan.py`` (forward, checkpointing forward and
  backward), which launch or raise.

State layout: ``h`` is (B, N, D) float32; accumulation is float32 whatever
the input dtype.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from mamba_tts_torch.device import on_card


def selective_scan_ref(
    u: torch.Tensor,
    delta: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """u, delta (Bz, T, D); A (D, N); B, C (Bz, T, N); D (D,); h0 (Bz, N, D).

    Returns y (Bz, T, D) in ``u.dtype`` and h_T (Bz, N, D) float32.
    """
    out_dtype = u.dtype
    f32 = torch.float32
    u, delta, B, C, D = u.to(f32), delta.to(f32), B.to(f32), C.to(f32), D.to(f32)
    A_nd = A.to(f32).T  # (N, D)
    Bz, T, Dm = u.shape
    h = (
        torch.zeros((Bz, A_nd.shape[0], Dm), dtype=f32, device=u.device)
        if h0 is None else h0.to(f32)
    )
    ys = []
    for t in range(T):
        d_t = delta[:, t]
        a = torch.exp(d_t[:, None, :] * A_nd[None])
        b = (d_t * u[:, t])[:, None, :] * B[:, t, :, None]
        h = a * h + b
        ys.append(torch.einsum("bnd,bn->bd", h, C[:, t]))
    y = torch.stack(ys, dim=1) + u * D[None, None, :]
    return y.to(out_dtype), h


def selective_scan_step(
    u_t: torch.Tensor,
    delta_t: torch.Tensor,
    A: torch.Tensor,
    B_t: torch.Tensor,
    C_t: torch.Tensor,
    D: torch.Tensor,
    h: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step: u_t, delta_t (Bz, D); A (D, N); B_t, C_t (Bz, N); h (Bz, N, D).

    Returns y_t (Bz, D) in ``u_t.dtype`` and the new state (Bz, N, D) float32.
    """
    out_dtype = u_t.dtype
    f32 = torch.float32
    u32, d32 = u_t.to(f32), delta_t.to(f32)
    A_nd = A.to(f32).T
    a = torch.exp(d32[:, None, :] * A_nd[None])
    b = (d32 * u32)[:, None, :] * B_t.to(f32)[:, :, None]
    h_new = a * h.to(f32) + b
    y = torch.einsum("bnd,bn->bd", h_new, C_t.to(f32)) + u32 * D.to(f32)[None]
    return y.to(out_dtype), h_new


def selective_scan(u, delta, A, B, C, D, h0=None, output: bool = True
                   ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Full-sequence scan used by ``MambaBlock.forward``: the Hopper kernels
    for CUDA tensors (:func:`~mamba_tts_torch.ops.pallas_scan.selective_scan_pallas`),
    the plain scan for CPU tensors.  ``output=False`` asks for the
    final state only, (None, h_T): the kernels then skip the output pass."""
    if on_card(u):
        from mamba_tts_torch.ops.pallas_scan import selective_scan_pallas

        return selective_scan_pallas(u, delta, A, B, C, D, h0, output=output)
    if u.device.type != "cpu":
        raise ValueError(f"selective_scan: unsupported device {u.device}")
    y, hT = selective_scan_ref(u, delta, A, B, C, D, h0)
    return (y if output else None), hT
