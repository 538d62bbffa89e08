"""Sequence-parallel selective scan — counterpart of ``mamba_tts_tpu/parallel/sp_scan.py``.

The time axis is sharded over one mesh axis and each rank scans its slice;
the recurrence is a first-order affine map, so the hand-off between slices
is exact:

  1. each rank scans its slice from h0 = 0 and keeps only the final state
     h_r (on the card only the summary and carry launches run, no output
     pass), with its transition P_r = exp(Aᵀ · Σ dt) over the slice, in f32;
  2. every rank all-gathers the (P, h) pairs and folds its predecessors in
     rank order: h0_r = P_{r-1}(...(P_0 · 0 + h_0)...) + h_{r-1};
  3. each rank scans its slice again from h0_r: its y, and the last rank's
     final state is h_final.

The time axis is sharded only inside the scan, as JAX's ``shard_map``
in/out specs do: y is gathered back over the axis.  Gradients flow through
the gathered (P, h), so the scan backward of pass 1 runs with a nonzero
dh_T and that of pass 2 gives a dh0 that is consumed.

When the batch rows are themselves sharded over the same axis (data
parallelism with the scan on the "data" axis), JAX's ``in_specs`` leave the
batch whole, so the rows are gathered first; here that is explicit: gather
the rows, scan this rank's time slice of the whole batch, gather y, keep
this rank's rows.
"""
from __future__ import annotations

from typing import Tuple

import torch

from mamba_tts_torch.ops.selective_scan import selective_scan
from mamba_tts_torch.parallel import comm
from mamba_tts_torch.parallel.mesh import axis_group, axis_rank, axis_size


def _combine(left, right):
    a_l, b_l = left
    a_r, b_r = right
    return a_r * a_l, a_r * b_l + b_r


def sp_selective_scan(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                      C: torch.Tensor, D: torch.Tensor, mesh, axis: str = "data",
                      batch_sharded: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan with the time axis sharded over ``mesh[axis]``.

    Shapes as :func:`~mamba_tts_torch.ops.selective_scan.selective_scan`; T
    must divide by the axis size.  Returns (y (B, T, D), h_final (B, N, D)),
    both whole on every rank.  ``batch_sharded``: this rank holds only its
    rows of a batch split over ``axis`` (and gets back only those)."""
    group, S, r = axis_group(mesh, axis), axis_size(mesh, axis), axis_rank(mesh, axis)
    T = u.shape[1]
    if T % S:
        raise ValueError(f"sp_selective_scan: T={T} must divide across {S} shards of {axis!r}")
    Tl = T // S
    if batch_sharded:
        rows = u.shape[0]
        u, delta, B, C = (comm.all_gather(t, 0, group) for t in (u, delta, B, C))
        u, delta, B, C = (t.narrow(1, r * Tl, Tl) for t in (u, delta, B, C))
    else:
        # every rank holds the whole batch: A and D feed a part on each rank
        u, delta, B, C = (comm.slice_of_group(t, 1, group) for t in (u, delta, B, C))
        A, D = comm.copy_to_group(A, group), comm.copy_to_group(D, group)

    # pass 1: this slice's final state from zero (no output pass)
    _, h_local = selective_scan(u, delta, A, B, C, D, output=False)
    P_local = torch.exp(A.to(torch.float32).T[None] * delta.to(torch.float32).sum(1)[:, None, :])
    P_all = comm.all_gather(P_local[None], 0, group)  # (S, B, N, D)
    h_all = comm.all_gather(h_local[None], 0, group)
    # every rank folds every pair, masked to its predecessors, so that every
    # rank's graph (and the order of its backward's collectives) is the same
    carry = (torch.ones_like(P_local), torch.zeros_like(h_local))
    for i in range(S):
        take = torch.tensor(i < r, device=u.device)
        carry = _combine(carry, (torch.where(take, P_all[i], 1.0),
                                 torch.where(take, h_all[i], 0.0)))
    # pass 2: the real scan from the carried-in state
    y, h_l = selective_scan(u, delta, A, B, C, D, h0=carry[1])
    if batch_sharded:
        y = comm.all_gather(y, 1, group).narrow(0, r * rows, rows)
        h_final = comm.all_gather(h_l[None], 0, group)[-1].narrow(0, r * rows, rows)
    else:
        y = comm.gather_from_group(y, 1, group)
        h_final = comm.gather_from_group(h_l[None], 0, group)[-1]
    return y, h_final
