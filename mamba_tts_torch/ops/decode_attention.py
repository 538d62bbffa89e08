"""One-query cross-attention for the decode step: the Hopper kernel, its
plain version and its launch plan.

``CrossAttention.attend`` sends a call here when one query attends to the
projected memory on the card with no gradient recorded (every step of the
captured default decode).  The JAX package computes the same attention in XLA
(``mamba_tts_tpu/models/attention.py`` ``_naive``): no TPU kernel is
replaced.  The plain version :func:`flash_attention_ref` casts K to f32,
lays the transposed copy out again and copies V on every call; the kernel
``csrc/decode_attention.cu`` reads the bf16 K and V where ``_split`` leaves
them, once, with the plain version's rounding points (see the note at its
top).

- :func:`decode_attention` — ``softmax(q K^T * scale + bias) V`` for q
  (B, 1, H·64) and K, V (B, H, Tm, 64) views of (B, Tm, H·64) tensors, any
  Tm; returns (B, 1, H·64) bf16, the layout ``o_proj`` reads.  Card tensors
  go through the kernel (one launch a call) or raise; CPU tensors take the
  plain version.  ``decode_attention.launches`` counts kernel launches.
- :func:`launch_plan` — the cluster size, keys a block and a tile, and
  shared memory of a call, as the CUDA source lays them out.

Grouped K/V heads (the jamba block's self-attention over its cache): q
(B, 1, H·128) against K, V (B, H_kv, Tm, 128) with H = G·H_kv go to the
grouped kernel of the same source, one cluster a (row, K/V
head, group of its query heads) (:func:`grouped_launch_plan`).  The head_dim-64
call with one K/V head a query head keeps the kernel above.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from mamba_tts_torch.device import on_card
from mamba_tts_torch.ops.flash_attention import flash_attention_ref

HEAD_DIM = 64  # the cross-attention kernel's head size
GROUPED_HEAD_DIM = 128  # the grouped kernel's head size
KEY_GROUPS = 4  # the grouped kernel's P V accumulators a (head, channel)
THREADS = 256  # threads a block
WARPS = THREADS // 32
MAX_CLUSTER = 8  # portable thread-block cluster size
KEY_ALIGN = 16  # a slice's and a tile's length are multiples of this
MIN_KEYS = 32  # least keys a slice, where the memory is short
TARGET_BLOCKS = 4 * 132  # about four blocks on each SM of an H100
MAX_SMEM_BYTES = 232_448  # shared memory one H100 block may use
MAX_GRID_YZ = 65_535  # the grid's rows (B) and heads (H)


class LaunchPlan(NamedTuple):
    """One call's launch: a cluster of ``cluster`` blocks for each (row,
    head), block ``rank`` scoring keys [rank·keys, (rank+1)·keys) in tiles
    of ``tile`` keys; ``blocks`` in all; ``smem_bytes`` of dynamic shared
    memory a block; ``workspace`` f32 scores in device memory (B·H·cluster·
    keys where a slice is longer than a tile, else 0)."""
    cluster: int
    keys: int
    tile: int
    blocks: int
    smem_bytes: int
    workspace: int


def smem_bytes(tile: int) -> int:
    """A block's shared memory, as ``csrc/decode_attention.cu`` lays it out:
    a tile of K and of V (128 bytes a key each) and its scores (4 bytes a
    key); the warps' reductions and the received maxima and sums; the
    warps' and the received P V partials; three mbarriers in 32 bytes."""
    return (tile * (4 * HEAD_DIM + 4) + 4 * (WARPS + 2 * MAX_CLUSTER)
            + 4 * HEAD_DIM * (WARPS + MAX_CLUSTER) + 32)


MAX_TILE = (MAX_SMEM_BYTES - smem_bytes(0)) // (4 * HEAD_DIM + 4) // KEY_ALIGN * KEY_ALIGN


def launch_plan(B: int, H: int, Tm: int) -> LaunchPlan:
    """The launch for B rows of H heads over Tm keys.  As many slices as put
    about ``TARGET_BLOCKS`` blocks on the card (at most a portable cluster,
    at least ``MIN_KEYS`` keys each), each a whole number of ``KEY_ALIGN``
    keys, and no empty slice; a slice longer than ``MAX_TILE`` keys is read
    in equal tiles and keeps its scores in the workspace."""
    units = B * H
    S = max(1, min(MAX_CLUSTER, -(-TARGET_BLOCKS // units), -(-Tm // MIN_KEYS)))
    keys = -(-Tm // S)
    keys = -(-keys // KEY_ALIGN) * KEY_ALIGN
    S = -(-Tm // keys)
    tiles = -(-keys // MAX_TILE)
    tile = -(-keys // tiles)
    tile = -(-tile // KEY_ALIGN) * KEY_ALIGN
    return LaunchPlan(cluster=S, keys=keys, tile=tile, blocks=units * S,
                      smem_bytes=smem_bytes(tile), workspace=units * S * keys if tile < keys else 0)


class GroupedPlan(NamedTuple):
    """The grouped kernel's launch: clusters of ``cluster`` blocks for each
    (row, K/V head, group of ``G / head_groups`` query heads), block
    ``rank`` scoring keys [rank·keys, (rank+1)·keys), its scores in shared
    memory, K and V read in tiles of ``tile`` keys; ``blocks`` in all;
    ``smem_bytes`` of dynamic shared memory a block."""
    cluster: int
    keys: int
    tile: int
    blocks: int
    smem_bytes: int
    head_groups: int


GROUPED_SMEM_BYTES = 115_200  # under half an SM's shared memory: two blocks an SM


def grouped_smem_bytes(hd: int, Gb: int, S: int, keys: int, tile: int) -> int:
    """A block's shared memory in the grouped kernel, for ``Gb`` query heads:
    K and V tiles (4·hd bytes a key), the slice's scores [Gb][keys], q
    [Gb][hd], the received maxima and sums [Gb][8] each, the P V
    accumulators [4][Gb][hd], the received partials [Gb][8][ceil(hd / S)]
    (f32), rounded to 8 bytes, then three mbarriers in 32 bytes."""
    own = -(-hd // S)
    floats = (Gb * keys + Gb * hd + 2 * Gb * MAX_CLUSTER + KEY_GROUPS * Gb * hd
              + Gb * MAX_CLUSTER * own)
    return tile * hd * 4 + -(-floats * 4 // 8) * 8 + 32


def grouped_launch_plan(B: int, H_kv: int, G: int, hd: int, Tm: int) -> GroupedPlan:
    """The grouped kernel's launch for B rows of H_kv K/V heads, each serving
    G query heads, over Tm keys: the G heads split into the fewest groups
    (a divisor of G) that give ``TARGET_BLOCKS`` blocks at full clusters;
    slices as :func:`launch_plan` picks them for the units; tiles as long as
    ``GROUPED_SMEM_BYTES`` allows beside the slice's scores.  A slice whose
    scores leave no room for a tile raises."""
    HG = next((d for d in range(1, G + 1)
               if G % d == 0 and B * H_kv * d * MAX_CLUSTER >= TARGET_BLOCKS), G)
    Gb, units = G // HG, B * H_kv * HG
    S = max(1, min(MAX_CLUSTER, -(-TARGET_BLOCKS // units), -(-Tm // MIN_KEYS)))
    keys = -(-Tm // S)
    keys = -(-keys // KEY_ALIGN) * KEY_ALIGN
    S = -(-Tm // keys)
    fixed = grouped_smem_bytes(hd, Gb, S, keys, 0)
    max_tile = (GROUPED_SMEM_BYTES - fixed) // (4 * hd) // KEY_ALIGN * KEY_ALIGN
    if max_tile < KEY_ALIGN:
        raise ValueError(f"grouped decode attention: {Gb} heads over {keys} keys a slice "
                         f"leave no shared memory for a tile")
    tiles = -(-keys // max_tile)
    tile = -(-keys // tiles)
    tile = -(-tile // KEY_ALIGN) * KEY_ALIGN
    return GroupedPlan(cluster=S, keys=keys, tile=tile, blocks=units * S,
                       smem_bytes=grouped_smem_bytes(hd, Gb, S, keys, tile), head_groups=HG)


def _split_strides(K: torch.Tensor) -> tuple:
    B, H, Tm, hd = K.shape
    return (Tm * H * hd, hd, H * hd, 1)


def _refusal(q: torch.Tensor, K: torch.Tensor, V: torch.Tensor,
             memory_mask: Optional[torch.Tensor]) -> Optional[str]:
    """Why the kernels cannot take these tensors, or None: they take q (B,
    1, G·H·hd) contiguous, K and V (B, H, Tm, hd) with ``_split``'s strides
    (hd 64 at G = 1, or 128 at any G), all bf16 on one device and 16-byte
    aligned, a bool (B, Tm) mask or none, and no gradient recorded."""
    if K.dim() != 4 or V.shape != K.shape or q.dim() != 3:
        return "shapes"
    B, H, Tm, hd = K.shape
    d = q.shape[-1]
    if (hd not in (HEAD_DIM, GROUPED_HEAD_DIM) or d % (H * hd)
            or (hd == HEAD_DIM and d != H * hd) or tuple(q.shape) != (B, 1, d)
            or not q.is_contiguous()):
        return "head size or query layout"
    if B > MAX_GRID_YZ or H > MAX_GRID_YZ or Tm < 1:
        return "grid"
    if any(t.dtype != torch.bfloat16 or t.device != q.device for t in (q, K, V)):
        return "dtype or device"
    if any(t.data_ptr() % 16 for t in (q, K, V)):
        return "alignment"
    if K.stride() != _split_strides(K) or V.stride() != _split_strides(V):
        return "K/V strides"
    if memory_mask is not None and (memory_mask.dtype != torch.bool or memory_mask.device != q.device
                                    or tuple(memory_mask.shape) != (B, Tm)
                                    or not memory_mask.is_contiguous()):
        return "mask"
    if torch.is_grad_enabled() and (q.requires_grad or K.requires_grad or V.requires_grad):
        return "a gradient is recorded (the kernel has no backward)"
    return None


def decode_attention_ref(q, K, V, memory_mask: Optional[torch.Tensor], scale: float):
    """The plain version: :func:`flash_attention_ref` on q's heads, each K/V
    head repeated for its group of query heads, back in the (B, 1, H·hd)
    layout."""
    B, _, d = q.shape
    hd = K.shape[-1]
    H = d // hd
    G = H // K.shape[1]
    if G > 1:
        K, V = K.repeat_interleave(G, dim=1), V.repeat_interleave(G, dim=1)
    out = flash_attention_ref(q.reshape(B, 1, H, hd).transpose(1, 2), K, V, memory_mask, scale)
    return out.transpose(1, 2).reshape(B, 1, d)


def _library() -> ctypes.CDLL:
    from mamba_tts_torch.ops._build import load_library

    lib = load_library("decode_attention")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention_launch.argtypes = ([p] * 6 + [i] * 6
                                                + [ctypes.c_longlong, ctypes.c_float, p])
        lib.decode_attention_launch.restype = i
        lib.decode_attention_grouped_launch.argtypes = ([p] * 5 + [i] * 9
                                                        + [ctypes.c_longlong, ctypes.c_float, p])
        lib.decode_attention_grouped_launch.restype = i
        lib.decode_attention_error_string.argtypes = [i]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def decode_attention(q: torch.Tensor, K: torch.Tensor, V: torch.Tensor,
                     memory_mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """softmax(q K^T * scale + bias) V, (B, 1, H·hd) in q's dtype, each K/V
    head serving H / H_kv query heads.  Card tensors go through a kernel, one
    launch (``launches`` counts them): the cross-attention kernel at head
    size 64 with a K/V head a query head, else the grouped kernel; or raise
    ``ValueError`` for what neither takes.  CPU tensors take the plain
    version."""
    if not on_card(q):
        if q.device.type == "cpu":
            return decode_attention_ref(q, K, V, memory_mask, scale)
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    why = _refusal(q, K, V, memory_mask)
    if why is not None:
        raise ValueError(
            f"decode_attention kernel does not take these tensors ({why}): q {q.dtype} "
            f"{tuple(q.shape)}, K/V {K.dtype} {tuple(K.shape)} strides {K.stride()} / "
            f"{V.stride()}, mask "
            f"{None if memory_mask is None else (memory_mask.dtype, tuple(memory_mask.shape))}")
    B, H, Tm, hd = K.shape
    G = q.shape[-1] // (H * hd)
    if G == 1 and hd == HEAD_DIM:
        return _launch(q, K, V, memory_mask, scale, launch_plan(B, H, Tm))
    return _launch(q, K, V, memory_mask, scale, grouped_launch_plan(B, H, G, hd, Tm), G)


def _launch(q, K, V, memory_mask, scale: float, plan, G: int = 0) -> torch.Tensor:
    """One launch: the cross-attention kernel (a :class:`LaunchPlan`), or
    with ``G`` query heads a K/V head the grouped one (a
    :class:`GroupedPlan`)."""
    B, H, Tm, hd = K.shape
    out = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    lib = _library()
    ptrs = (q.data_ptr(), K.data_ptr(), V.data_ptr(),
            None if memory_mask is None else memory_mask.data_ptr(), out.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if G:
            err = lib.decode_attention_grouped_launch(
                *ptrs, B, H, plan.head_groups, G // plan.head_groups, hd, Tm, plan.cluster,
                plan.keys, plan.tile, plan.smem_bytes, float(scale), stream)
        else:
            ws = (torch.empty((plan.workspace,), dtype=torch.float32, device=q.device)
                  if plan.workspace else None)
            err = lib.decode_attention_launch(
                *ptrs, None if ws is None else ws.data_ptr(), B, H, Tm, plan.cluster, plan.keys,
                plan.tile, plan.smem_bytes, float(scale), stream)
    if err:
        raise RuntimeError(
            f"decode_attention launch failed: {lib.decode_attention_error_string(err).decode()}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
