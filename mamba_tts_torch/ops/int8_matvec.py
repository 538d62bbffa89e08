"""Int8 weight-streaming matvec: the decode hot path's one kernel.

Counterpart of ``mamba_tts_tpu/ops/int8_matvec.py``.  Small-batch decode
re-reads every large weight matrix each step, so it is bound by weight
bytes; streaming the weights as int8 with per-output-channel f32 scales
halves that traffic against bf16.

- :func:`quantize_weight` — (K, N) float -> ((K, N) int8, (N,) f32), symmetric
  per column, bit-identical to the JAX package's.
- :func:`int8_matvec`     — ``y = (x @ (w_q * scale)) [+ bias]``.  For CUDA
  tensors it launches the hand-written Hopper kernel
  ``csrc/int8_matvec.cu`` (which replaces the TPU kernel at
  ``mamba_tts_tpu/ops/int8_matvec.py:38``), one launch per call with the
  bias in its epilogue, or raises; for CPU tensors it runs the plain
  version.  ``int8_matvec.launches`` counts kernel launches.
- :func:`launch_plan`     — the kernel's cluster size, strip width, block
  count and shared memory for a call, as the CUDA source lays them out.
- :func:`int8_matvec_ref` — the plain version, mirroring the JAX package's
  ``int8_matvec_ref``.

The kernel is bound by the K*N int8 weight bytes of each call; see the note
at the top of ``csrc/int8_matvec.cu`` for its design.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from mamba_tts_torch.device import on_card

MAX_BATCH = 16
MAX_SMEM_BYTES = 232_448  # dynamic shared memory one H100 block may use
TARGET_BLOCKS = 128  # about one block per SM of an H100 (132 SMs)
MAX_CLUSTER = 8  # portable thread-block cluster size
STRIPS = (128, 64, 32)  # output columns per block, widest first
MIN_ROWS = 32  # least weight rows per block
THREADS = 256  # threads per block


class LaunchPlan(NamedTuple):
    """One call's launch: ``cluster`` blocks split K and share a strip of
    ``strip`` output columns; ``blocks`` in all; ``smem_bytes`` of dynamic
    shared memory a block; ``batch_tile`` rows of x padded per block."""
    cluster: int
    strip: int
    blocks: int
    smem_bytes: int
    batch_tile: int


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, N) float -> ((K, N) int8, (N,) f32 scale), symmetric per column."""
    w = w.to(torch.float32)
    amax = w.abs().amax(dim=0)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    w_q = torch.clamp(torch.round(w / scale[None, :]), -127, 127).to(torch.int8)
    return w_q, scale


def int8_matvec_ref(x, w_q, scale, bias=None, out_dtype=torch.bfloat16):
    """Plain version: dequantize to f32, f32 product, round to ``out_dtype``,
    then add the bias in ``out_dtype``."""
    w = w_q.to(torch.float32) * scale[None, :].to(torch.float32)
    y = (x.to(torch.float32) @ w).to(out_dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def launch_plan(B: int, K: int, N: int) -> LaunchPlan:
    """The kernel's launch for x (B, K) and w_q (K, N): the widest strip
    whose strips, times a full cluster, reach about one block per SM, then
    as many K-splits (at most a portable cluster, at least 32 weight rows
    each) as that count needs.  Mirrors ``smem_bytes`` and ``batch_tile`` in
    ``csrc/int8_matvec.cu``, which refuses a plan it would lay out otherwise."""
    strip = next((s for s in STRIPS if -(-N // s) * MAX_CLUSTER >= TARGET_BLOCKS), STRIPS[-1])
    strips = -(-N // strip)
    S = max(1, min(MAX_CLUSTER, -(-TARGET_BLOCKS // strips), -(-K // MIN_ROWS)))
    bt = next(t for t in (1, 2, 4, 8, 16) if B <= t)
    stage = max(-(-K // S) * bt * 2, THREADS // 32 * bt * strip * 4)
    stage = -(-stage // 16) * 16
    mine = -(-bt * strip // THREADS)  # outputs each thread of a block finishes
    return LaunchPlan(cluster=S, strip=strip, blocks=S * strips,
                      smem_bytes=stage + mine * S * THREADS * 4, batch_tile=bt)


def check_kernel_args(x, w_q, scale, out_dtype, bias=None) -> None:
    """Raise ``ValueError`` for anything the CUDA kernel does not take."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"int8_matvec kernel takes bf16 x, got {x.dtype}")
    if w_q.dtype != torch.int8:
        raise ValueError(f"int8_matvec kernel takes int8 w_q, got {w_q.dtype}")
    if scale.dtype != torch.float32:
        raise ValueError(f"int8_matvec kernel takes f32 scale, got {scale.dtype}")
    if out_dtype != torch.bfloat16:
        raise ValueError(f"int8_matvec kernel writes bf16, got out_dtype={out_dtype}")
    if x.dim() != 2 or w_q.dim() != 2 or scale.dim() != 1:
        raise ValueError(
            f"int8_matvec takes x (B, K), w_q (K, N), scale (N,); got "
            f"{tuple(x.shape)}, {tuple(w_q.shape)}, {tuple(scale.shape)}")
    B, K = x.shape
    K2, N = w_q.shape
    if K != K2 or scale.shape[0] != N:
        raise ValueError(
            f"int8_matvec shape mismatch: x {tuple(x.shape)}, w_q {tuple(w_q.shape)}, "
            f"scale {tuple(scale.shape)}")
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"int8_matvec kernel takes 1 <= B <= {MAX_BATCH}, got B={B}")
    if N % 4 or K < 1:
        raise ValueError(f"int8_matvec kernel needs N % 4 == 0 and K >= 1, got K={K}, N={N}")
    if not (x.is_contiguous() and w_q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("int8_matvec kernel takes contiguous x, w_q and scale")
    if w_q.data_ptr() % 4:
        raise ValueError("int8_matvec kernel needs a 4-byte-aligned w_q")
    if launch_plan(B, K, N).smem_bytes > MAX_SMEM_BYTES:
        raise ValueError(f"int8_matvec kernel: K={K} at B={B} exceeds the shared memory of a block")
    if bias is not None:
        if bias.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"int8_matvec kernel takes an f32 or bf16 bias, got {bias.dtype}")
        if bias.shape != (N,) or not bias.is_contiguous():
            raise ValueError(f"int8_matvec kernel takes a contiguous ({N},) bias, "
                             f"got {tuple(bias.shape)}")
    if not all(t.device == x.device for t in (w_q, scale, bias) if t is not None):
        raise ValueError("int8_matvec: x, w_q, scale and bias must lie on one device")


def _library() -> ctypes.CDLL:
    from mamba_tts_torch.ops._build import load_library

    lib = load_library("int8_matvec")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.int8_matvec_launch.argtypes = [p, p, p, p, i, p, i, i, i, i, i, ctypes.c_longlong, p]
        lib.int8_matvec_launch.restype = ctypes.c_int
        lib.int8_matvec_error_string.argtypes = [ctypes.c_int]
        lib.int8_matvec_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


_BIAS_KIND = {torch.float32: 1, torch.bfloat16: 2}


def _launch(x, w_q, scale, bias) -> torch.Tensor:
    B, K = x.shape
    N = w_q.shape[1]
    plan = launch_plan(B, K, N)
    lib = _library()
    y = torch.empty((B, N), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.int8_matvec_launch(
            x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(),
            0 if bias is None else _BIAS_KIND[bias.dtype], y.data_ptr(),
            B, K, N, plan.cluster, plan.strip, plan.smem_bytes, stream)
    if err:
        raise RuntimeError(
            f"int8_matvec kernel launch failed: {lib.int8_matvec_error_string(err).decode()}")
    int8_matvec.launches += 1
    return y


def int8_matvec(
    x: torch.Tensor,
    w_q: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """y = (x @ (w_q * scale)) [+ bias], (B, N) in ``out_dtype``.

    x (B, K); w_q (K, N) int8; scale (N,) f32; bias (N,).  The bias is added
    after the product, in ``out_dtype``.  CUDA tensors go through the Hopper
    kernel (bf16 x and output, B <= 16, the bias in its epilogue: one launch
    per call) or raise; CPU tensors take the plain version.
    """
    if on_card(x):
        check_kernel_args(x, w_q, scale, out_dtype, bias)
        return _launch(x, w_q, scale, bias)
    if x.device.type == "cpu":
        return int8_matvec_ref(x, w_q, scale, bias, out_dtype=out_dtype)
    raise ValueError(f"int8_matvec: unsupported device {x.device}")


int8_matvec.launches = 0
