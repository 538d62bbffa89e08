"""Device mesh and sharding rules — counterpart of ``mamba_tts_tpu/parallel/mesh.py``.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
an initialised process group, with named dims: ``"data"`` splits the batch
rows, ``"model"`` the tensor-parallel dims (Megatron style, adapted to
Mamba, as in the JAX package):

- the Mamba inner path shards ``d_inner``: ``in_proj`` column-parallel (each
  rank takes its slice of the x half and of the z half), ``conv_w``,
  ``conv_b``, ``dt_proj``, ``A_log`` and ``D`` local, ``x_proj`` and
  ``out_proj`` row-parallel;
- cross-attention shards heads: q/k/v column-parallel with their biases,
  ``o_proj`` row-parallel;
- the FFNs: ``ff1``/``ffn1`` column-, ``ff2``/``ffn2`` row-parallel;
- everything else (embeddings, norms, heads, the biases of row-parallel
  products, the style MLP, the text encoder, SMSD) is replicated.

Where JAX places a parameter with a ``NamedSharding`` and lets GSPMD move
data, the port's modules are built at their local shapes
(``MambaTTS(cfg, mesh=...)``) and call the collectives of ``comm.py``;
:func:`shard_params` cuts full tensors to a rank's pieces and
:func:`gather_params` joins them back.  A torch ``Linear.weight`` is the
transpose of the Flax kernel, so JAX's ``P(None, "model")`` on a kernel
(in, out) is dim 0 of the weight here.
"""
from __future__ import annotations

import math
import re
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from mamba_tts_torch.parallel import comm

AXES = ("data", "model")


class Split(NamedTuple):
    """A parameter sharded on the "model" axis along ``dim``.  With
    ``blocks`` > 1 the dim holds that many equal blocks (``in_proj``'s x and
    z halves) and a rank takes its slice of each."""
    dim: int
    blocks: int = 1


# Ordered (regex over the port's parameter names, split) rules; first match
# wins, no match means replicated.  The same logical split as the JAX
# package's ``_PARTITION_RULES`` for every leaf of its parameter tree; an
# ``in_proj`` bias (``use_bias``, off by default), which JAX replicates and
# GSPMD splits on the fly, is split with its kernel here.
_PARTITION_RULES = [
    (r".*mamba\.in_proj\.(weight|bias)", Split(0, blocks=2)),
    (r".*mamba\.conv_w", Split(1)),
    (r".*mamba\.conv_b", Split(0)),
    (r".*mamba\.x_proj\.weight", Split(1)),
    (r".*mamba\.dt_proj\.(weight|bias)", Split(0)),
    (r".*mamba\.A_log", Split(0)),
    (r".*mamba\.D", Split(0)),
    (r".*mamba\.out_proj\.weight", Split(1)),
    (r".*(q_proj|k_proj|v_proj)\.(weight|bias)", Split(0)),
    (r".*o_proj\.weight", Split(1)),
    (r".*(ff1|ffn1)\.(weight|bias)", Split(0)),
    (r".*(ff2|ffn2)\.weight", Split(1)),
]


def make_mesh(shape: Optional[Sequence[int]] = None, axes: Tuple[str, ...] = AXES,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``device_type`` over every rank of the initialised
    process group (``parallel.distributed.initialize_multihost``), rank
    order row-major.  Default: all ranks on the first axis ("data")."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(mamba_tts_torch.parallel.distributed.initialize_multihost)")
    n = dist.get_world_size()
    shape = tuple(shape) if shape is not None else (n,) + (1,) * (len(axes) - 1)
    if len(shape) != len(axes) or math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} over axes {axes} does not cover {n} ranks")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=tuple(axes))


def axis_group(mesh, axis: str):
    """The process group of ``mesh``'s ``axis`` for this rank, or None when
    there is no mesh, no such axis, or the axis holds one rank."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return None
    return mesh.get_group(axis) if axis_size(mesh, axis) > 1 else None


def axis_size(mesh, axis: str) -> int:
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    return 0 if axis_size(mesh, axis) == 1 else mesh.get_local_rank(axis)


def model_group(mesh, size: int):
    """(group, shards) of a dim of ``size`` on ``mesh``'s "model" axis, by
    the rule of :func:`param_shardings`: the axis's group and size where
    the size divides, else (None, 1), the dim replicated.  Modules built on
    a mesh take their local widths from this."""
    tp = axis_size(mesh, "model")
    return (None, 1) if size % tp else (axis_group(mesh, "model"), tp)


def partition_spec_for_path(name: str) -> Optional[Split]:
    """The rule for a parameter name (``decoder.layer_0.mamba.in_proj.weight``):
    its split on "model", or None (replicated)."""
    for pattern, split in _PARTITION_RULES:
        if re.fullmatch(pattern, name):
            return split
    return None


def param_shardings(params: Dict[str, torch.Tensor], mesh) -> Dict[str, Optional[Split]]:
    """Each full parameter's split on ``mesh``'s "model" axis; a dim that
    does not divide into the axis size (per block) is replicated, as in JAX.
    The one source of the splits: a model built on ``mesh`` holds these
    (``MambaTTS.shardings``), and :func:`gather_params` and the optimizer's
    global norm read them."""
    tp = axis_size(mesh, "model")
    out = {}
    for name, t in params.items():
        split = partition_spec_for_path(name)
        if split is not None and (split.dim >= t.dim()
                                  or t.shape[split.dim] % (split.blocks * tp) != 0):
            split = None
        out[name] = split
    return out


def _local(t: torch.Tensor, split: Split, rank: int, tp: int) -> torch.Tensor:
    return torch.cat([b.chunk(tp, split.dim)[rank] for b in t.chunk(split.blocks, split.dim)],
                     dim=split.dim)


def shard_params(params: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """Full tensors -> this rank's pieces on ``mesh``'s "model" axis."""
    tp, rank = axis_size(mesh, "model"), axis_rank(mesh, "model")
    shardings = param_shardings(params, mesh)
    return {n: t if shardings[n] is None or tp == 1 else _local(t, shardings[n], rank, tp)
            for n, t in params.items()}


def gather_params(params: Dict[str, torch.Tensor], mesh,
                  shardings: Optional[Dict[str, Optional[Split]]]) -> Dict[str, torch.Tensor]:
    """This rank's pieces (of a model built on ``mesh``, whose
    ``shardings`` they follow) -> full tensors, on every rank.  Inverse of
    :func:`shard_params`."""
    group, tp = axis_group(mesh, "model"), axis_size(mesh, "model")
    out = {}
    for n, t in params.items():
        split = shardings[n] if tp > 1 else None
        if split is None:
            out[n] = t.detach()
            continue
        full = comm.gather(t.detach(), split.dim, group)  # (rank0 blocks, rank1 blocks, ...)
        pieces = [p.chunk(split.blocks, split.dim) for p in full.chunk(tp, split.dim)]
        out[n] = torch.cat([pieces[r][b] for b in range(split.blocks) for r in range(tp)],
                           dim=split.dim)
    return out


def replicate(params: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """Every rank takes rank 0's tensors (in place)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        for t in params.values():
            dist.broadcast(t.data, src=0)
    return params


def batch_sharding(mesh, axis: str = "data") -> Tuple[int, int]:
    """(this rank's index, the number of row shards) on ``axis``."""
    return axis_rank(mesh, axis), axis_size(mesh, axis)


def shard_batch(batch: Dict[str, torch.Tensor], mesh, axis: str = "data"
                ) -> Dict[str, torch.Tensor]:
    """This rank's contiguous rows of every array of a global batch.  Rows
    that do not divide by the axis size raise (a replicated batch would
    count each row once per rank in the data-parallel gradient sum)."""
    rank, n = batch_sharding(mesh, axis)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch {k} has {v.shape[0]} rows, not a multiple of the "
                             f"{n} ranks of mesh axis {axis!r}")
        rows = v.shape[0] // n
        out[k] = v[rank * rows:(rank + 1) * rows]
    return out
