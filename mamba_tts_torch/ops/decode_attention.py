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
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from mamba_tts_torch.device import on_card
from mamba_tts_torch.ops.flash_attention import flash_attention_ref

HEAD_DIM = 64
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


def _split_strides(K: torch.Tensor) -> tuple:
    B, H, Tm, hd = K.shape
    return (Tm * H * hd, hd, H * hd, 1)


def _refusal(q: torch.Tensor, K: torch.Tensor, V: torch.Tensor,
             memory_mask: Optional[torch.Tensor]) -> Optional[str]:
    """Why the kernel cannot take these tensors, or None: it takes q (B, 1,
    H·64) contiguous, K and V (B, H, Tm, 64) with ``_split``'s strides, all
    bf16 on one device and 16-byte aligned, a bool (B, Tm) mask or none, and
    no gradient recorded."""
    if K.dim() != 4 or V.shape != K.shape or q.dim() != 3:
        return "shapes"
    B, H, Tm, hd = K.shape
    if hd != HEAD_DIM or tuple(q.shape) != (B, 1, H * hd) or not q.is_contiguous():
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
    """The plain version: :func:`flash_attention_ref` on q's heads, back in
    the (B, 1, H·64) layout."""
    B, _, d = q.shape
    H = K.shape[1]
    out = flash_attention_ref(q.reshape(B, 1, H, d // H).transpose(1, 2), K, V, memory_mask, scale)
    return out.transpose(1, 2).reshape(B, 1, d)


def _library() -> ctypes.CDLL:
    from mamba_tts_torch.ops._build import load_library

    lib = load_library("decode_attention")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention_launch.argtypes = ([p] * 6 + [i] * 6
                                                + [ctypes.c_longlong, ctypes.c_float, p])
        lib.decode_attention_launch.restype = i
        lib.decode_attention_error_string.argtypes = [i]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def decode_attention(q: torch.Tensor, K: torch.Tensor, V: torch.Tensor,
                     memory_mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """softmax(q K^T * scale + bias) V, (B, 1, H·64) in q's dtype.  Card
    tensors go through the kernel, one launch (``launches`` counts them), or
    raise ``ValueError`` for what it does not take; CPU tensors take the
    plain version."""
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
    B, H, Tm, _ = K.shape
    return _launch(q, K, V, memory_mask, scale, launch_plan(B, H, Tm))


def _launch(q, K, V, memory_mask, scale: float, plan: LaunchPlan) -> torch.Tensor:
    B, H, Tm, _ = K.shape
    out = torch.empty((B, 1, H * HEAD_DIM), dtype=torch.bfloat16, device=q.device)
    ws = (torch.empty((plan.workspace,), dtype=torch.float32, device=q.device)
          if plan.workspace else None)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention_launch(
            q.data_ptr(), K.data_ptr(), V.data_ptr(),
            None if memory_mask is None else memory_mask.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), B, H, Tm, plan.cluster, plan.keys,
            plan.tile, plan.smem_bytes, float(scale), stream)
    if err:
        raise RuntimeError(
            f"decode_attention launch failed: {lib.decode_attention_error_string(err).decode()}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
