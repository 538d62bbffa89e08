"""Flash cross-attention: the Hopper kernels, their plain version and the
autograd binding.

Replaces the TPU flash attention that ``mamba_tts_tpu/models/attention.py:25``
(``_flash_attend``) takes from jax's ``pallas.ops.tpu.flash_attention``: the
long-query (Tq >= 128) cross-attention of the teacher-forced forward and of
every training step.  Two wrappers of ``csrc/flash_attention.cu``, each
counting its launches:

- :func:`flash_attention_fwd` — O and the row log-sum-exp;
- :func:`flash_attention_bwd` — dQ, dK, dV (one call runs the Delta, dK/dV
  and dQ kernels and counts once).

:class:`FlashAttentionFn` joins them; :func:`flash_attention` is the card's
entry.  The plain version :func:`flash_attention_ref` is the materialized
softmax of ``CrossAttention.attend`` (the JAX package's ``_naive``): f32
logits from the inputs' products, -1e9 on masked keys, an f32 softmax, the
probabilities cast to V's dtype before the product with V.

Layouts: q (B, H, Tq, 64), K and V (B, H, Tk, 64) bf16; memory_mask (B, Tk)
bool, True = valid.

:func:`flash_launch_plan` holds the host-side numbers of the kernels (tiles,
grids, shared memory, the padded row count of the backward's workspace); the
C launchers check what they are given against their own layouts and refuse
anything else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

NEG_INF = -1e9
HEAD_DIM = 64
TILE = 128  # rows of a block's tile (queries: forward, dQ; keys: dK/dV) and of a key tile
BWD_Q_TILE = 64  # query rows per step of the dK/dV block
STAGES = 3  # depth of each kernel's ring of tiles in shared memory
SMEM_PER_BLOCK = 232_448  # the most shared memory an H100 block may take


def mask_bias(mask: torch.Tensor) -> torch.Tensor:
    """(B, Tk) bool, True = valid -> (B, 1, 1, Tk) f32 additive bias."""
    return torch.where(mask[:, None, None, :], 0.0, NEG_INF).to(torch.float32)


def flash_attention_ref(q, K, V, memory_mask: Optional[torch.Tensor], scale: float):
    """softmax(q K^T * scale + bias) V with the plain path's rounding points."""
    logits = torch.matmul(q.to(torch.float32), K.to(torch.float32).transpose(-1, -2)) * scale
    if memory_mask is not None:
        logits = logits + mask_bias(memory_mask)
    probs = torch.softmax(logits, dim=-1).to(V.dtype)
    return torch.matmul(probs, V)


def _smem_bytes(tile_bytes: int, vector_floats: int) -> int:
    """A kernel's shared memory, as its C struct lays it out: the 1024-byte
    aligned tiles, then f32 vectors, then one barrier for the resident tiles
    and a full and an empty barrier per stage, the whole padded to 1024
    bytes; plus 1024 for moving the start to a 1024-byte boundary."""
    raw = tile_bytes + 4 * vector_floats + 8 * (1 + 2 * STAGES)
    return -(-raw // 1024) * 1024 + 1024


def flash_launch_plan(Bz: int, H: int, Tq: int, Tk: int) -> dict:
    """Launch numbers of the forward, dK/dV and dQ kernels.  Each kernel's
    ``grid`` is (tiles, B·H) with ``rows`` rows a tile; ``tq_pad`` is the row
    count per (batch, head) of the backward's (2, B·H, tq_pad) f32 workspace
    (lse · log2 e and Delta), a whole number of dQ tiles."""
    row_bytes = 2 * HEAD_DIM
    tile = TILE * row_bytes
    q_tiles, k_tiles = -(-Tq // TILE), -(-Tk // TILE)
    return {
        "tq_pad": q_tiles * TILE,
        "fwd": {"grid": (q_tiles, Bz * H), "rows": TILE,
                "smem": _smem_bytes((1 + 2 * STAGES) * tile, STAGES * TILE)},
        "dkdv": {"grid": (k_tiles, Bz * H), "rows": TILE, "q_rows": BWD_Q_TILE,
                 "smem": _smem_bytes(2 * tile + 2 * STAGES * BWD_Q_TILE * row_bytes,
                                     2 * STAGES * BWD_Q_TILE)},
        "dq": {"grid": (q_tiles, Bz * H), "rows": TILE,
               "smem": _smem_bytes((2 + 2 * STAGES) * tile, STAGES * TILE)},
    }


def _library() -> ctypes.CDLL:
    from mamba_tts_torch.ops._build import load_library

    lib = load_library("flash_attention")
    if not getattr(lib, "_argtypes_set", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_fwd_launch.argtypes = [p] * 6 + [i] * 4 + [f] + [i] * 2 + [p]
        lib.flash_attention_fwd_launch.restype = i
        lib.flash_attention_bwd_launch.argtypes = [p] * 11 + [i] * 4 + [f] + [i] * 5 + [p]
        lib.flash_attention_bwd_launch.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def check_flash_args(q, K, V, memory_mask, **more) -> None:
    """Raise ``ValueError`` for anything the flash kernels do not take."""
    if q.dim() != 4 or K.dim() != 4 or V.shape != K.shape:
        raise ValueError(f"flash kernel takes q (B, H, Tq, 64), K and V (B, H, Tk, 64); got "
                         f"{tuple(q.shape)}, {tuple(K.shape)}, {tuple(V.shape)}")
    Bz, H, Tq, hd = q.shape
    if K.shape[:2] != (Bz, H) or hd != HEAD_DIM or K.shape[3] != HEAD_DIM:
        raise ValueError(f"flash kernel takes head_dim {HEAD_DIM} and matching (B, H); got "
                         f"{tuple(q.shape)}, {tuple(K.shape)}")
    Tk = K.shape[2]
    if Tq < 1 or Tk < 1:
        raise ValueError(f"flash kernel needs Tq, Tk >= 1, got {Tq}, {Tk}")
    if memory_mask is not None and (memory_mask.dtype != torch.bool
                                    or tuple(memory_mask.shape) != (Bz, Tk)):
        raise ValueError(f"flash kernel takes a bool memory_mask (B, Tk) = {(Bz, Tk)}; got "
                         f"{memory_mask.dtype} {tuple(memory_mask.shape)}")
    for name, t in dict(q=q, K=K, V=V, memory_mask=memory_mask, **more).items():
        if t is None:
            continue
        if name != "memory_mask" and name != "lse" and t.dtype != torch.bfloat16:
            raise ValueError(f"flash kernel takes bf16 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash kernel takes a contiguous {name}")
        if t.device != q.device:
            raise ValueError(f"flash kernel: {name} lies on {t.device}, q on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash kernel needs a 16-byte-aligned {name}")
    lse = more.get("lse")
    if lse is not None and (lse.dtype != torch.float32 or tuple(lse.shape) != (Bz, H, Tq)):
        raise ValueError(f"flash kernel takes an f32 lse (B, H, Tq), got {lse.dtype} {tuple(lse.shape)}")
    for name in ("O", "dO"):
        if more.get(name) is not None and more[name].shape != q.shape:
            raise ValueError(f"flash kernel takes {name} shaped like q")


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           f"{_library().flash_attention_error_string(err).decode()}")


def flash_attention_fwd(q, K, V, memory_mask, scale: float):
    """Forward kernel: (O bf16 (B, H, Tq, 64), lse f32 (B, H, Tq))."""
    check_flash_args(q, K, V, memory_mask)
    Bz, H, Tq, _ = q.shape
    plan = flash_launch_plan(Bz, H, Tq, K.shape[2])["fwd"]
    O = torch.empty_like(q)
    lse = torch.empty((Bz, H, Tq), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd_launch(
            q.data_ptr(), K.data_ptr(), V.data_ptr(),
            None if memory_mask is None else memory_mask.data_ptr(), O.data_ptr(),
            lse.data_ptr(), Bz, H, Tq, K.shape[2], float(scale), plan["grid"][0], plan["smem"],
            stream)
    _raise_on(err, "flash_attention forward kernel")
    flash_attention_fwd.launches += 1
    return O, lse


def flash_attention_bwd(q, K, V, memory_mask, O, lse, dO, scale: float):
    """Backward kernels: (dq, dK, dV) bf16 in the layouts of q, K, V."""
    check_flash_args(q, K, V, memory_mask, O=O, lse=lse, dO=dO)
    Bz, H, Tq, _ = q.shape
    plan = flash_launch_plan(Bz, H, Tq, K.shape[2])
    work = torch.empty((2, Bz * H, plan["tq_pad"]), dtype=torch.float32, device=q.device)
    dq, dK, dV = torch.empty_like(q), torch.empty_like(K), torch.empty_like(V)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), K.data_ptr(), V.data_ptr(),
            None if memory_mask is None else memory_mask.data_ptr(), O.data_ptr(),
            lse.data_ptr(), dO.data_ptr(), work.data_ptr(), dq.data_ptr(), dK.data_ptr(),
            dV.data_ptr(), Bz, H, Tq, K.shape[2], float(scale), plan["tq_pad"],
            plan["dq"]["grid"][0], plan["dkdv"]["grid"][0], plan["dkdv"]["smem"],
            plan["dq"]["smem"], stream)
    _raise_on(err, "flash_attention backward kernels")
    flash_attention_bwd.launches += 1
    return dq, dK, dV


flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with the kernels as forward and backward."""

    @staticmethod
    def forward(ctx, q, K, V, memory_mask, scale):
        O, lse = flash_attention_fwd(q, K, V, memory_mask, scale)
        ctx.save_for_backward(q, K, V, memory_mask, O, lse)
        ctx.scale = scale
        return O

    @staticmethod
    def backward(ctx, dO):
        q, K, V, memory_mask, O, lse = ctx.saved_tensors
        dq, dK, dV = flash_attention_bwd(q, K, V, memory_mask, O, lse,
                                         dO.to(torch.bfloat16).contiguous(), ctx.scale)
        return dq, dK, dV, None, None


def flash_attention(q, K, V, memory_mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """The card's long-query attention: :class:`FlashAttentionFn` on
    contiguous operands.  Raises for what the kernels do not take."""
    return FlashAttentionFn.apply(q.contiguous(), K.contiguous(), V.contiguous(),
                                  None if memory_mask is None else memory_mask.contiguous(), scale)
