"""Selective scan for training: the Hopper kernels, their plain versions and
the autograd binding.

Counterpart of ``mamba_tts_tpu/ops/pallas_scan.py`` (the name is kept so a
reader finds the TPU kernels this module replaces).  The kernels of
``csrc/selective_scan.cu`` are chunk-parallel over the checkpoints: each
direction is a summary, a carry and an output (forward) or gradient
(backward) launch, laid out by :func:`scan_launch_plan`.  Three wrappers run
them and count their calls:

- :func:`selective_scan_fwd`      — forward without checkpoints (replaces
  ``_scan_kernel``, ``pallas_scan.py:36``): the no-gradient forward.
- :func:`selective_scan_fwd_ckpt` — forward that also writes the chunk-start
  states (replaces ``_scan_kernel_ckpt``, ``:121``): every training forward.
- :func:`selective_scan_bwd`      — the reverse adjoint scan (replaces
  ``_scan_bwd_kernel``, ``:160``): every training backward.

:class:`SelectiveScanFn` joins the last two as ``custom_vjp`` does
(``:306-356``); :func:`selective_scan_pallas` picks the plain forward kernel
when no gradient is needed.  The plain versions :func:`scan_ckpt_ref` and
:func:`scan_bwd_ref` compute the same outputs in the kernels' layouts; the
tests and ``chip_smoke.py`` hold the kernels to them.  Every wrapper launches
its kernel for CUDA tensors or raises; nothing here falls back.

Layouts: u, delta (B, T, D); A (D, N); B, C (B, T, N); D (D,); states
(B, N, D) f32; ckpt (B, ceil(T / chunk), N, D) f32, ``ckpt[:, 0] == h0``.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

CHUNK = 64  # time steps between checkpoints (the JAX package's default)
CHUNKS = (16, 64)  # the chunk sizes the kernels are built for
SLICE = 16  # channels per block of the gradient pass: one dB/dC slice
ROW_THREADS = 256  # channels per block of the summaries and the output pass
SEGMENT = 8  # backward: steps whose recomputed states a thread holds at once
STATE_SIZES = (2, 4, 8, 16)  # d_state values the kernels take
MAX_CLUSTER = 8  # portable thread-block cluster size
SMEM_PER_SM = 233_472  # shared memory of an H100 SM (228 KB)
CARRY_THREADS = 256


def _f32(*ts):
    return [None if t is None else t.to(torch.float32) for t in ts]


def scan_ckpt_ref(u, delta, A, B, C, D, h0=None, chunk: int = CHUNK, output: bool = True):
    """Plain forward with checkpoints: (y in ``u.dtype``, h_T f32, ckpt f32);
    y None with ``output=False``, as the kernels give it."""
    out_dtype = u.dtype
    u, delta, B, C, D, h0 = _f32(u, delta, B, C, D, h0)
    A_nd = A.to(torch.float32).T
    Bz, T, Dm = u.shape
    h = torch.zeros((Bz, A_nd.shape[0], Dm), dtype=torch.float32, device=u.device) \
        if h0 is None else h0
    ckpt, ys = [], []
    for t in range(T):
        if t % chunk == 0:
            ckpt.append(h)
        d_t = delta[:, t]
        h = torch.exp(d_t[:, None, :] * A_nd[None]) * h + (d_t * u[:, t])[:, None, :] * B[:, t, :, None]
        ys.append(torch.einsum("bnd,bn->bd", h, C[:, t]))
    y = (torch.stack(ys, dim=1) + u * D[None, None, :]).to(out_dtype) if output else None
    return y, h, torch.stack(ckpt, dim=1)


def scan_bwd_ref(u, delta, A, B, C, ckpt, dy, dhT, chunk: int = CHUNK):
    """Plain backward in the kernel's layout, written as the reverse
    recurrence: recompute each chunk's states from ``ckpt``, then
    ``hhat_t = dy_t C_t + a_{t+1} hhat_{t+1}``.  Returns (du, ddt, dB, dC,
    dA_b, dh0), all f32; du leaves out the D-skip term and dA_b (B, N, D) is
    per batch row, as the kernel gives them."""
    u, delta, B, C, ckpt, dy, dhT = _f32(u, delta, B, C, ckpt, dy, dhT)
    A_nd = A.to(torch.float32).T
    Bz, T, Dm = u.shape
    du, ddt = torch.zeros_like(u), torch.zeros_like(u)
    dB, dC = torch.zeros_like(B), torch.zeros_like(C)
    dA_b = torch.zeros_like(dhT)
    g = dhT
    for c in reversed(range(ckpt.shape[1])):
        t0, t1 = c * chunk, min(T, (c + 1) * chunk)
        hs = [ckpt[:, c]]
        for t in range(t0, t1):
            d_t = delta[:, t]
            hs.append(torch.exp(d_t[:, None, :] * A_nd[None]) * hs[-1]
                      + (d_t * u[:, t])[:, None, :] * B[:, t, :, None])
        for t in reversed(range(t0, t1)):
            d_t, u_t, Bt = delta[:, t], u[:, t], B[:, t, :, None]
            a = torch.exp(d_t[:, None, :] * A_nd[None])
            hhat = dy[:, t, None, :] * C[:, t, :, None] + g
            h_prev, h_t = hs[t - t0], hs[t - t0 + 1]
            ddt[:, t] = (hhat * (a * h_prev * A_nd[None] + u_t[:, None, :] * Bt)).sum(1)
            du[:, t] = d_t * (hhat * Bt).sum(1)
            dB[:, t] = (hhat * (d_t * u_t)[:, None, :]).sum(2)
            dC[:, t] = (h_t * dy[:, t, None, :]).sum(2)
            dA_b = dA_b + hhat * h_prev * a * d_t[:, None, :]
            g = a * hhat
    return du, ddt, dB, dC, dA_b, g


# ------------------------------------------------------------------ kernels


def _library() -> ctypes.CDLL:
    from mamba_tts_torch.ops._build import load_library

    lib = load_library("selective_scan")
    if not getattr(lib, "_argtypes_set", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.selective_scan_fwd_launch.argtypes = [p] * 11 + [i] * 6 + [ll] * 2 + [p]
        lib.selective_scan_fwd_launch.restype = i
        lib.selective_scan_bwd_launch.argtypes = [p] * 16 + [i] * 7 + [ll] * 2 + [p]
        lib.selective_scan_bwd_launch.restype = i
        lib.selective_scan_error_string.argtypes = [i]
        lib.selective_scan_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


@dataclass(frozen=True)
class ScanPass:
    """One launch of a scan direction: its grid (x, y, z), threads a block,
    thread-block cluster along x, dynamic shared memory a block and blocks
    resident on an SM."""
    grid: Tuple[int, int, int]
    threads: int
    cluster: int
    smem_bytes: int
    resident: int


@dataclass(frozen=True)
class ScanPlan:
    """Both directions' launches (``csrc/selective_scan.cu``): summary, carry
    and output (forward) or gradient (backward) passes.  ``partial_slices``
    is the number of dB/dC partials the backward writes (one per cluster of
    channel slices); it writes one dA partial per chunk."""
    fwd_summary: ScanPass
    fwd_carry: ScanPass
    fwd_output: ScanPass
    bwd_summary: ScanPass
    bwd_carry: ScanPass
    bwd_grad: ScanPass
    partial_slices: int


def _pass_smem(kind: str, N: int, chunk: int, cluster: int = 1) -> int:
    """Dynamic shared memory of a chunk-parallel pass, in bytes; mirrors the
    ``*_floats`` layouts of the CUDA source."""
    if kind in ("fwd_summary", "bwd_summary"):  # B (or C) of a chunk
        floats = chunk * N
    elif kind == "fwd_output":  # B and C
        floats = 2 * chunk * N
    elif kind == "bwd_grad":
        row = chunk + 4  # padded [channel][t] tile stride
        units = SEGMENT * 2 * N // 4
        slot = 4 * -(-units // cluster)
        floats = (3 * SLICE * row + 2 * chunk * N + (chunk // SEGMENT) * SLICE * N
                  + SEGMENT * N * N + 2 * SEGMENT * SLICE + 2 * N * SLICE + 2 * cluster * slot)
    else:
        raise ValueError(kind)
    return 4 * floats


def _resident(threads: int, smem: int, reg_cap: bool = True) -> int:
    """Blocks an H100 SM keeps resident: 2,048 threads, 32 blocks, 228 KB of
    shared memory (1 KB reserved a block) and, for the chunk-parallel passes
    (``__launch_bounds__(256, 4)``: at most 64 registers a thread), 64 K
    registers."""
    by_regs = 65536 // (64 * threads) if reg_cap else 32
    return min(2048 // threads, 32, by_regs, SMEM_PER_SM // (smem + 1024))


def scan_launch_plan(B: int, T: int, D: int, N: int, chunk: int = CHUNK) -> ScanPlan:
    """The launches of both scan directions at this shape.  The summaries
    and the forward's output pass give each thread one channel and its N
    states (``ROW_THREADS`` channels a block).  The backward's gradient pass
    gives each thread one (channel, n) of ``SLICE`` channels and puts the
    blocks of consecutive slices of one (row, chunk) in a cluster of at
    most 8 (``cluster`` = ceil(slices / ceil(slices / 8))).  Every block of
    these passes takes one chunk (grid y); the carries walk the chunks in
    series, one thread per (n, channel)."""
    if N not in STATE_SIZES or chunk not in CHUNKS:
        raise ValueError(f"scan kernel takes d_state in {STATE_SIZES} and chunk in {CHUNKS}")
    nc, slices, cols = -(-T // chunk), -(-D // SLICE), -(-D // ROW_THREADS)
    groups = -(-slices // MAX_CLUSTER)
    cluster = -(-slices // groups)

    def chunk_pass(kind, width, threads, S=1):
        smem = _pass_smem(kind, N, chunk, S)
        return ScanPass((width, nc, B), threads, S, smem, _resident(threads, smem))

    carry = ScanPass((-(-N * D // CARRY_THREADS), B, 1), CARRY_THREADS, 1, 0,
                     _resident(CARRY_THREADS, 0, reg_cap=False))
    return ScanPlan(chunk_pass("fwd_summary", cols, ROW_THREADS), carry,
                    chunk_pass("fwd_output", cols, ROW_THREADS),
                    chunk_pass("bwd_summary", cols, ROW_THREADS), carry,
                    chunk_pass("bwd_grad", groups * cluster, SLICE * N, cluster), groups)


def check_scan_args(u, delta, A, B, C, chunk, **states) -> None:
    """Raise ``ValueError`` for anything the scan kernels do not take."""
    if u.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"scan kernel takes bf16 or f32 u, got {u.dtype}")
    if B.dtype != u.dtype or C.dtype != u.dtype:
        raise ValueError(f"scan kernel takes B and C in u's dtype {u.dtype}, got {B.dtype}, {C.dtype}")
    if delta.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"scan kernel takes f32 delta and A, got {delta.dtype}, {A.dtype}")
    if u.dim() != 3 or delta.shape != u.shape:
        raise ValueError(f"scan kernel takes u, delta (B, T, D); got {tuple(u.shape)}, {tuple(delta.shape)}")
    Bz, T, Dm = u.shape
    if A.dim() != 2 or A.shape[0] != Dm:
        raise ValueError(f"scan kernel takes A (D, N); got {tuple(A.shape)} for D={Dm}")
    N = A.shape[1]
    if N not in STATE_SIZES:
        raise ValueError(f"scan kernel takes d_state in {STATE_SIZES}, got {N}")
    if B.shape != (Bz, T, N) or C.shape != (Bz, T, N):
        raise ValueError(f"scan kernel takes B, C (B, T, N); got {tuple(B.shape)}, {tuple(C.shape)}")
    if T < 1 or chunk not in CHUNKS:
        raise ValueError(f"scan kernel needs T >= 1 and chunk in {CHUNKS}, got T={T}, chunk={chunk}")
    for name, t in dict(u=u, delta=delta, A=A, B=B, C=C, **states).items():
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError(f"scan kernel takes a contiguous {name}")
        if t.device != u.device:
            raise ValueError(f"scan kernel: {name} lies on {t.device}, u on {u.device}")
        if name in ("D", "h0", "dhT", "ckpt", "dy") and t.dtype != torch.float32:
            raise ValueError(f"scan kernel takes f32 {name}, got {t.dtype}")
    for name, shape in (("D", (Dm,)), ("h0", (Bz, N, Dm)), ("dhT", (Bz, N, Dm)),
                        ("dy", (Bz, T, Dm)), ("ckpt", (Bz, -(-T // chunk), N, Dm))):
        t = states.get(name)
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"scan kernel takes {name} {shape}, got {tuple(t.shape)}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           f"{_library().selective_scan_error_string(err).decode()}")


def _forward(u, delta, A, B, C, D, h0, chunk, with_ckpt, output=True):
    check_scan_args(u, delta, A, B, C, chunk, D=D, h0=h0)
    Bz, T, Dm = u.shape
    N = A.shape[1]
    plan = scan_launch_plan(Bz, T, Dm, N, chunk)
    nc = -(-T // chunk)
    f32 = dict(dtype=torch.float32, device=u.device)
    y = torch.empty_like(u) if output else None
    hT = torch.empty((Bz, N, Dm), **f32)
    ws = torch.empty((Bz, nc, N, Dm), **f32)  # the chunk-start states: ckpt when asked for
    sdt = torch.empty((Bz, nc, Dm), **f32)
    lib = _library()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.selective_scan_fwd_launch(
            u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            D.data_ptr(), _ptr(h0), _ptr(y), hT.data_ptr(), ws.data_ptr(), sdt.data_ptr(),
            Bz, T, Dm, N, chunk, int(u.dtype == torch.bfloat16),
            plan.fwd_summary.smem_bytes, plan.fwd_output.smem_bytes, stream)
    _raise_on(err, "selective_scan forward kernels")
    return y, hT, ws if with_ckpt else None


def selective_scan_fwd(u, delta, A, B, C, D, h0=None, chunk: int = CHUNK, output: bool = True):
    """Forward kernels without checkpoints: (y in ``u.dtype``, h_T f32).
    ``output=False`` runs the summary and the carry only: (None, h_T)."""
    y, hT, _ = _forward(u, delta, A, B, C, D, h0, chunk, with_ckpt=False, output=output)
    selective_scan_fwd.launches += 1
    return y, hT


def selective_scan_fwd_ckpt(u, delta, A, B, C, D, h0=None, chunk: int = CHUNK,
                            output: bool = True):
    """Forward kernels with checkpoints: (y, h_T, ckpt); y None with
    ``output=False`` (summary and carry only)."""
    out = _forward(u, delta, A, B, C, D, h0, chunk, with_ckpt=True, output=output)
    selective_scan_fwd_ckpt.launches += 1
    return out


def selective_scan_bwd(u, delta, A, B, C, ckpt, dy, dhT, chunk: int = CHUNK):
    """Backward kernels: (du, ddt, dB, dC, dA_b, dh0) as :func:`scan_bwd_ref`.
    The kernels write dB and dC per cluster of channel slices and dA per
    chunk; they are summed here in a fixed order."""
    check_scan_args(u, delta, A, B, C, chunk, ckpt=ckpt, dy=dy, dhT=dhT)
    Bz, T, Dm = u.shape
    N = A.shape[1]
    plan = scan_launch_plan(Bz, T, Dm, N, chunk)
    nc = -(-T // chunk)
    f32 = dict(dtype=torch.float32, device=u.device)
    du, ddt = torch.empty((Bz, T, Dm), **f32), torch.empty((Bz, T, Dm), **f32)
    G = plan.partial_slices
    dBp, dCp = torch.empty((Bz, G, T, N), **f32), torch.empty((Bz, G, T, N), **f32)
    dAp = torch.empty((Bz, nc, N, Dm), **f32)
    dh0 = torch.empty((Bz, N, Dm), **f32)
    ws, sdt = torch.empty((Bz, nc, N, Dm), **f32), torch.empty((Bz, nc, Dm), **f32)
    lib = _library()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.selective_scan_bwd_launch(
            u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            ckpt.data_ptr(), dy.data_ptr(), dhT.data_ptr(), du.data_ptr(), ddt.data_ptr(),
            dBp.data_ptr(), dCp.data_ptr(), dAp.data_ptr(), dh0.data_ptr(), ws.data_ptr(),
            sdt.data_ptr(), Bz, T, Dm, N, chunk, int(u.dtype == torch.bfloat16),
            plan.bwd_grad.cluster, plan.bwd_summary.smem_bytes, plan.bwd_grad.smem_bytes, stream)
    _raise_on(err, "selective_scan backward kernels")
    selective_scan_bwd.launches += 1
    return du, ddt, dBp.sum(dim=1), dCp.sum(dim=1), dAp.sum(dim=1), dh0


selective_scan_fwd.launches = 0
selective_scan_fwd_ckpt.launches = 0
selective_scan_bwd.launches = 0


class SelectiveScanFn(torch.autograd.Function):
    """The scan with the kernels as forward and backward: the checkpointing
    forward kernel, then the backward kernel on the saved checkpoints.  The
    D-skip terms and the casts to each input's dtype stay outside the
    kernels, as in ``_scan_vjp_bwd`` (``pallas_scan.py:318-353``).  With
    ``output=False`` the forward runs no output pass and returns h_T alone
    (its backward has no dy)."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, h0, chunk, output=True):
        y, hT, ckpt = selective_scan_fwd_ckpt(u, delta, A, B, C, D, h0, chunk, output=output)
        ctx.save_for_backward(u, delta, A, B, C, D, ckpt)
        ctx.chunk, ctx.has_h0, ctx.output = chunk, h0 is not None, output
        return (y, hT) if output else hT

    @staticmethod
    def backward(ctx, *grads):
        dy, dhT = grads if ctx.output else (None, grads[0])
        u, delta, A, B, C, D, ckpt = ctx.saved_tensors
        Bz, T, Dm = u.shape
        N = A.shape[1]
        dy = (torch.zeros((Bz, T, Dm), dtype=torch.float32, device=u.device) if dy is None
              else dy.to(torch.float32).contiguous())
        dhT = (torch.zeros((Bz, N, Dm), dtype=torch.float32, device=u.device) if dhT is None
               else dhT.to(torch.float32).contiguous())
        du, ddt, dB, dC, dA_b, dh0 = selective_scan_bwd(u, delta, A, B, C, ckpt, dy, dhT, ctx.chunk)
        du = du + D.to(torch.float32)[None, None, :] * dy
        dD = (dy * u.to(torch.float32)).sum(dim=(0, 1))
        dA = dA_b.sum(dim=0).T
        return (du.to(u.dtype), ddt.to(delta.dtype), dA.to(A.dtype), dB.to(B.dtype),
                dC.to(C.dtype), dD.to(D.dtype), dh0 if ctx.has_h0 else None, None, None)


def selective_scan_pallas(u, delta, A, B, C, D, h0=None, chunk: int = CHUNK, output: bool = True
                          ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """The card's full-sequence scan: :class:`SelectiveScanFn` when a
    gradient is needed (checkpointing forward + backward kernel), the plain
    forward kernel otherwise, as ``custom_vjp`` runs the primal kernel
    outside differentiation.  Makes the kernels' operands contiguous (B and C
    arrive as views of one projection) and f32 where the kernels read f32.
    ``output=False`` gives (None, h_T) from the summary and carry launches
    alone."""
    u, B, C = u.contiguous(), B.contiguous(), C.contiguous()
    delta = delta.to(torch.float32).contiguous()
    A, D = A.to(torch.float32).contiguous(), D.to(torch.float32).contiguous()
    h0 = None if h0 is None else h0.to(torch.float32).contiguous()
    inputs = (u, delta, A, B, C, D) + (() if h0 is None else (h0,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        out = SelectiveScanFn.apply(u, delta, A, B, C, D, h0, chunk, output)
        return out if output else (None, out)
    return selective_scan_fwd(u, delta, A, B, C, D, h0, chunk, output=output)
