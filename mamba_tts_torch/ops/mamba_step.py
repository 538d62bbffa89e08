"""The Mamba decode step between its projections: two Hopper kernels and
their plain versions.

``MambaBlock.step`` runs ``in_proj``, then :func:`conv_step`, then ``x_proj``
and ``dt_proj`` (the jamba block's ``dt_norm`` ahead of it), then
:func:`ssm_step`, then ``out_proj``.  The JAX package leaves the same chain
to XLA (``mamba_tts_tpu/models/mamba.py`` ``MambaBlock.step``): no TPU
kernel is replaced.  On the card the two calls are the kernels of
``csrc/mamba_step.cu``, one launch each, which read the conv window and the
SSM state once and write them once, in place where the caller passes
``inplace=True`` (the captured decode's carry); the plain step ran about 30
small PyTorch kernels a layer, and the decode copied its new states back.

- :func:`conv_step` — the depthwise causal conv over the window and the
  new input, its bias and SiLU: (x_conv (B, D), the new window).
- :func:`ssm_step` — softplus(dt), A = -exp(A_log), the norms of B and C
  where the block has them, one recurrence step of the f32 state, and the
  gate: (y (B, D) for ``out_proj``, the new state).
- :func:`conv_step_ref`, :func:`ssm_step_ref` — the plain versions, the
  step's PyTorch code as it ran before the kernels (``selective_scan_step``
  from ``ops/selective_scan.py``); the CPU path, and what the kernels are
  held to.
- :func:`mamba2_step` — the Mamba-2 mixer's state step
  (``models/mamba2.py`` ``Mamba2Mixer.step``, after :func:`conv_step` over
  its x, B and C): softplus(dt + dt_bias) and exp(dt·A) a head, one
  recurrence step of the (B, H, P, N) f32 state, y = h·C + D·x, times
  SiLU(z); the kernel of ``csrc/mamba2_step.cu`` (d_state 128, head_dim 64,
  one group), a source of its own so that the other decoders never build
  it; :func:`mamba2_step_ref` its plain version.

Card tensors go through the kernels or raise ``ValueError`` for what they
do not take; CPU tensors take the plain versions.  ``launches`` counts the
kernels' launches, two a layer a step (``conv_step`` and ``ssm_step``, or
``conv_step`` and ``mamba2_step``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from mamba_tts_torch.device import on_card
from mamba_tts_torch.ops.selective_scan import selective_scan_step

CHANNELS = 8  # channels a thread of the conv kernel: 16 bytes of bf16
D_STATES = (4, 8, 16)  # the SSM kernel's instances
MAX_CONV = 64  # the conv kernel's largest window
MAX_ROWS = 65_535  # the grids' rows (B)
COMPUTE_DTYPES = (torch.bfloat16, torch.float32)  # the kernels' activations
MAMBA2_D_STATE, MAMBA2_HEAD_DIM = 128, 64  # the Mamba-2 kernel's one instance

launches = 0  # kernel launches: conv_step's and ssm_step's on the card


def conv_step_ref(xin: torch.Tensor, window: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: x_conv = silu(sum_k [window, xin][:, k] * w[k] + b)
    in ``xin``'s dtype, and the new window [window[:, 1:], xin]."""
    full = torch.cat([window.to(xin.dtype), xin[:, None]], dim=1)
    conv_out = torch.einsum("bkd,kd->bd", full, w.to(xin.dtype))
    if b is not None:
        conv_out = conv_out + b.to(xin.dtype)
    return F.silu(conv_out), full[:, 1:]


def ssm_step_ref(dt: torch.Tensor, A_log: torch.Tensor, x_conv: torch.Tensor, z: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor, h: torch.Tensor,
                 norms: Optional[Sequence] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: dt is ``dt_proj``'s output (B, D), Bm and Cm (B, N)
    ``x_proj``'s slices, ``norms`` the block's (b_norm, c_norm) or None, h
    (B, N, D) f32.  Returns (y * silu(z) in ``x_conv``'s dtype, the new
    state)."""
    if norms is not None:
        Bm, Cm = norms[0](Bm), norms[1](Cm)
    delta = F.softplus(dt.to(torch.float32))
    y, h_new = selective_scan_step(x_conv, delta, -torch.exp(A_log), Bm, Cm, D, h)
    return y * F.silu(z), h_new


def _library() -> ctypes.CDLL:
    from mamba_tts_torch.ops._build import load_library

    lib = load_library("mamba_step")
    if not getattr(lib, "_argtypes_set", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mamba_conv_step_launch.argtypes = [p, ll, p, p, p, i, p, i, p, i, i, i, i, p]
        lib.mamba_conv_step_launch.restype = i
        lib.mamba_ssm_step_launch.argtypes = ([p] * 4 + [ll, p, ll, p, ll, p, p, ctypes.c_float]
                                              + [p] * 4 + [i, i, i, i, p])
        lib.mamba_ssm_step_launch.restype = i
        lib.mamba_step_error_string.argtypes = [i]
        lib.mamba_step_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _rows(t: torch.Tensor, B: int, D: int) -> bool:
    """(B, D) with unit stride along D."""
    return t.dim() == 2 and tuple(t.shape) == (B, D) and (D == 1 or t.stride(1) == 1)


def _gradient(*ts) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


def _conv_refusal(xin, window, w, b) -> Optional[str]:
    """Why the conv kernel cannot take these tensors, or None: xin (B, D) in
    the compute dtype (bf16 or f32) with unit stride and rows of whole
    8-value groups, the window (B, K-1, D) in the same dtype, contiguous, the
    taps (K, D) f32 or bf16 contiguous, the bias (D,) f32, bf16 or none, D a
    multiple of 8, all on one device, 16-byte aligned and with no gradient
    recorded."""
    if xin.dim() != 2 or window.dim() != 3 or w.dim() != 2:
        return "shapes"
    B, D = xin.shape
    K = w.shape[0]
    if (tuple(window.shape) != (B, K - 1, D) or tuple(w.shape) != (K, D)
            or (b is not None and tuple(b.shape) != (D,))):
        return "shapes"
    if D % CHANNELS or not 1 <= K <= MAX_CONV or not 1 <= B <= MAX_ROWS:
        return "size"
    if xin.dtype not in COMPUTE_DTYPES or window.dtype != xin.dtype:
        return "dtype"
    if w.dtype not in (torch.float32, torch.bfloat16) or (
            b is not None and b.dtype not in (torch.float32, torch.bfloat16)):
        return "dtype"
    if any(t.device != xin.device for t in (window, w) + ((b,) if b is not None else ())):
        return "device"
    if not _rows(xin, B, D) or xin.stride(0) % CHANNELS:
        return "layout"
    if not (window.is_contiguous() and w.is_contiguous() and (b is None or b.is_contiguous())):
        return "layout"
    if any(t.data_ptr() % 16 for t in (xin, window, w) + ((b,) if b is not None else ())):
        return "alignment"
    if _gradient(xin, window, w, b):
        return "a gradient is recorded (the kernel has no backward)"
    return None


def conv_step(xin: torch.Tensor, window: torch.Tensor, w: torch.Tensor,
              b: Optional[torch.Tensor], inplace: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_conv (B, D) in ``xin``'s dtype and the new window, for xin (B, D),
    the window (B, K-1, D), the taps w (K, D) and the bias b (D,) or None.
    With ``inplace`` the new window is written over ``window``, which is
    returned.  Card tensors go through the kernel, one launch, or raise;
    CPU tensors take :func:`conv_step_ref`."""
    if not on_card(xin):
        if xin.device.type != "cpu":
            raise ValueError(f"conv_step: unsupported device {xin.device}")
        x_conv, new = conv_step_ref(xin, window, w, b)
        return (x_conv, window.copy_(new)) if inplace else (x_conv, new)
    why = _conv_refusal(xin, window, w, b)
    if why is not None:
        raise ValueError(
            f"mamba conv_step kernel does not take these tensors ({why}): xin {xin.dtype} "
            f"{tuple(xin.shape)} strides {xin.stride()}, window {window.dtype} "
            f"{tuple(window.shape)}, taps {w.dtype} {tuple(w.shape)}, bias "
            f"{None if b is None else (b.dtype, tuple(b.shape))}")
    B, D = xin.shape
    K = w.shape[0]
    out = window if inplace else torch.empty_like(window)
    x_conv = torch.empty((B, D), dtype=xin.dtype, device=xin.device)
    bias_kind = 0 if b is None else (2 if b.dtype == torch.bfloat16 else 1)
    _launch("mamba_conv_step_launch", xin.device,
            xin.data_ptr(), xin.stride(0), window.data_ptr(), out.data_ptr(), w.data_ptr(),
            int(w.dtype == torch.bfloat16), None if b is None else b.data_ptr(), bias_kind,
            x_conv.data_ptr(), B, D, K, int(xin.dtype == torch.float32))
    return x_conv, out


def _norm_weights(norms) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], float]:
    if norms is None:
        return None, None, 0.0
    return norms[0].weight, norms[1].weight, float(norms[0].eps)


def _state_refusal(A_log, D, h, norms) -> Optional[str]:
    """Why the SSM kernel cannot take the block's A_log (D, N) f32 with N one
    of ``D_STATES``, D (D,) f32, its norms (where given: f32 (N,) weights,
    one eps, rounding to the compute dtype) and the state h (B, N, D) f32, all
    contiguous on one device, A_log 16-byte aligned; or None."""
    if A_log.dim() != 2 or h.dim() != 3:
        return "shapes"
    Dm, N = A_log.shape
    if tuple(h.shape[1:]) != (N, Dm) or tuple(D.shape) != (Dm,):
        return "shapes"
    if N not in D_STATES or not 1 <= h.shape[0] <= MAX_ROWS:
        return "size"
    wB, wC, _ = _norm_weights(norms)
    if norms is not None and (any(n.dtype not in COMPUTE_DTYPES for n in norms)
                              or norms[0].dtype != norms[1].dtype or norms[0].eps != norms[1].eps
                              or tuple(wB.shape) != (N,) or tuple(wC.shape) != (N,)):
        return "norms"
    f32 = (A_log, D, h) + ((wB, wC) if norms is not None else ())
    if any(t.dtype != torch.float32 for t in f32):
        return "dtype"
    if any(t.device != h.device for t in f32):
        return "device"
    if not all(t.is_contiguous() for t in f32):
        return "layout"
    if A_log.data_ptr() % 16:
        return "alignment"
    return None


def check_state(A_log: torch.Tensor, D: torch.Tensor, h: torch.Tensor,
                norms: Optional[Sequence] = None) -> None:
    """Raise ``ValueError`` where the SSM kernel cannot take the block's
    A_log, D and norms or the card state h (a CPU state takes the plain
    version).  ``MambaBlock.step`` asks before the conv kernel shifts the
    window, so that a refused in-place step leaves the carry as it was."""
    if not on_card(h):
        return
    why = _state_refusal(A_log, D, h, norms)
    if why is not None:
        raise ValueError(
            f"mamba ssm_step kernel does not take these tensors ({why}): A_log {A_log.dtype} "
            f"{tuple(A_log.shape)}, D {D.dtype} {tuple(D.shape)}, h {h.dtype} {tuple(h.shape)} "
            f"strides {h.stride()}, norms {norms is not None}")


def _ssm_refusal(dt, A_log, x_conv, z, Bm, Cm, D, h, norms) -> Optional[str]:
    """Why the SSM kernel cannot take these tensors, or None: dt, x_conv
    (B, D) contiguous and z, Bm, Cm with unit inner stride, all in one
    compute dtype (bf16 or f32, the norms' where the block has them) on the
    state's device; A_log, D, the norms and h as :func:`check_state` takes
    them; no gradient recorded."""
    why = _state_refusal(A_log, D, h, norms)
    if why is not None:
        return why
    B, N, Dm = h.shape
    if not (all(_rows(t, B, Dm) for t in (dt, x_conv, z)) and _rows(Bm, B, N)
            and _rows(Cm, B, N)):
        return "shapes"
    acts = (dt, x_conv, z, Bm, Cm)
    if (dt.dtype not in COMPUTE_DTYPES or any(t.dtype != dt.dtype for t in acts)
            or (norms is not None and norms[0].dtype != dt.dtype)):
        return "dtype"
    if any(t.device != h.device for t in acts):
        return "device"
    if not (dt.is_contiguous() and x_conv.is_contiguous()):
        return "layout"
    wB, wC, _ = _norm_weights(norms)
    if _gradient(*acts, A_log, D, h, wB, wC):
        return "a gradient is recorded (the kernel has no backward)"
    return None


def ssm_step(dt: torch.Tensor, A_log: torch.Tensor, x_conv: torch.Tensor, z: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor, h: torch.Tensor,
             norms: Optional[Sequence] = None, inplace: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y * silu(z) (B, D) in ``x_conv``'s dtype, the new state) for ``dt_proj``'s
    output dt (B, D), A_log (D, N), x_conv and z (B, D), ``x_proj``'s slices
    Bm and Cm (B, N), D (D,), the state h (B, N, D) f32 and the block's
    (b_norm, c_norm) or None.  With ``inplace`` the new state is written over
    ``h``, which is returned.  Card tensors go through the kernel, one
    launch, or raise; CPU tensors take :func:`ssm_step_ref`."""
    if not on_card(dt):
        if dt.device.type != "cpu":
            raise ValueError(f"ssm_step: unsupported device {dt.device}")
        y, new = ssm_step_ref(dt, A_log, x_conv, z, Bm, Cm, D, h, norms)
        return (y, h.copy_(new)) if inplace else (y, new)
    why = _ssm_refusal(dt, A_log, x_conv, z, Bm, Cm, D, h, norms)
    if why is not None:
        raise ValueError(
            f"mamba ssm_step kernel does not take these tensors ({why}): dt {dt.dtype} "
            f"{tuple(dt.shape)}, A_log {A_log.dtype} {tuple(A_log.shape)}, x_conv "
            f"{x_conv.dtype} {tuple(x_conv.shape)}, z {z.dtype} strides {z.stride()}, B/C "
            f"{Bm.dtype} {tuple(Bm.shape)} strides {Bm.stride()} / {Cm.stride()}, h {h.dtype} "
            f"{tuple(h.shape)} strides {h.stride()}, norms {norms is not None}")
    B, Dm = dt.shape
    wB, wC, eps = _norm_weights(norms)
    out = h if inplace else torch.empty_like(h)
    y = torch.empty((B, Dm), dtype=dt.dtype, device=dt.device)
    _launch("mamba_ssm_step_launch", dt.device,
            dt.data_ptr(), A_log.data_ptr(), x_conv.data_ptr(), z.data_ptr(), z.stride(0),
            Bm.data_ptr(), Bm.stride(0), Cm.data_ptr(), Cm.stride(0),
            None if wB is None else wB.data_ptr(), None if wC is None else wC.data_ptr(), eps,
            D.data_ptr(), h.data_ptr(), out.data_ptr(), y.data_ptr(), B, Dm, A_log.shape[1],
            int(dt.dtype == torch.float32))
    return y, out


def _launch(fn: str, device: torch.device, *args, lib: Optional[ctypes.CDLL] = None) -> None:
    """One launch of ``fn`` (of ``lib``, ``csrc/mamba_step.cu``'s by default)
    on the device's current stream; raises on a launch the library refuses."""
    global launches
    lib = lib or _library()
    with torch.cuda.device(device):
        err = getattr(lib, fn)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{fn} failed: {lib.mamba_step_error_string(err).decode()}")
    launches += 1


# ---------------------------------------------------------------- Mamba-2


def mamba2_step_ref(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, z: torch.Tensor,
                    dt: torch.Tensor, dt_bias: torch.Tensor, A_log: torch.Tensor,
                    D: torch.Tensor, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of one Mamba-2 state step (one group): x and z
    (B, H·P), Bm and Cm (B, N), dt (B, H) before its bias, dt_bias, A_log
    and D (H,) f32, h (B, H, P, N) f32.  Returns (y · silu(z) (B, H·P) f32,
    the new state)::

        delta = softplus(dt + dt_bias);  dA = exp(delta · -exp(A_log))
        h'    = h · dA + (delta · x) ⊗ B;  y = h'·C + x · D
    """
    Bsz, H, P, N = h.shape
    delta = F.softplus(dt.float() + dt_bias)  # (B, H)
    dA = torch.exp(delta * -torch.exp(A_log))
    xf = x.float().reshape(Bsz, H, P)
    dx = delta[..., None] * xf
    h_new = h * dA[..., None, None] + dx[..., None] * Bm.float()[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h_new, Cm.float()) + xf * D[:, None]
    return y.reshape(Bsz, H * P) * F.silu(z.float()), h_new


def _library2() -> ctypes.CDLL:
    from mamba_tts_torch.ops._build import load_library

    lib = load_library("mamba2_step")
    if not getattr(lib, "_argtypes_set", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mamba2_ssm_step_launch.argtypes = ([p] * 3 + [ll, p, ll, p, ll] + [p] * 6
                                               + [i] * 5 + [p])
        lib.mamba2_ssm_step_launch.restype = i
        lib.mamba_step_error_string.argtypes = [i]
        lib.mamba_step_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _state2_refusal(dt_bias, A_log, D, h) -> Optional[str]:
    """Why the Mamba-2 kernel cannot take dt_bias, A_log, D (H,) f32 and the
    state h (B, H, 64, 128) f32, all contiguous on one device, h 16-byte
    aligned; or None."""
    if h.dim() != 4 or any(t.dim() != 1 for t in (dt_bias, A_log, D)):
        return "shapes"
    Bsz, H, P, N = h.shape
    if any(tuple(t.shape) != (H,) for t in (dt_bias, A_log, D)):
        return "shapes"
    if (N, P) != (MAMBA2_D_STATE, MAMBA2_HEAD_DIM) or not 1 <= Bsz <= MAX_ROWS:
        return "size"
    f32 = (dt_bias, A_log, D, h)
    if any(t.dtype != torch.float32 for t in f32):
        return "dtype"
    if any(t.device != h.device for t in f32):
        return "device"
    if not all(t.is_contiguous() for t in f32) or h.data_ptr() % 16:
        return "layout"
    return None


def check_state2(dt_bias: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor,
                 h: torch.Tensor) -> None:
    """Raise ``ValueError`` where the Mamba-2 kernel cannot take the mixer's
    parameters or the card state h (a CPU state takes the plain version), so
    that a refused in-place step leaves the carry as it was."""
    if not on_card(h):
        return
    why = _state2_refusal(dt_bias, A_log, D, h)
    if why is not None:
        raise ValueError(
            f"mamba2_step kernel does not take these tensors ({why}): dt_bias/A_log/D "
            f"{[(t.dtype, tuple(t.shape)) for t in (dt_bias, A_log, D)]}, h {h.dtype} "
            f"{tuple(h.shape)} strides {h.stride()}")


def _mamba2_refusal(x, Bm, Cm, z, dt, dt_bias, A_log, D, h) -> Optional[str]:
    """Why the Mamba-2 kernel cannot take these tensors, or None: x, z (B,
    H·P), Bm, Cm (B, N), dt (B, H) with unit inner strides, x, B and C one
    row stride, all in one compute dtype on the state's device; the rest as
    :func:`check_state2` takes it; no gradient recorded."""
    why = _state2_refusal(dt_bias, A_log, D, h)
    if why is not None:
        return why
    Bsz, H, P, N = h.shape
    if not (_rows(x, Bsz, H * P) and _rows(z, Bsz, H * P) and _rows(Bm, Bsz, N)
            and _rows(Cm, Bsz, N) and _rows(dt, Bsz, H)):
        return "shapes"
    if not (x.stride(0) == Bm.stride(0) == Cm.stride(0)):
        return "layout"
    acts = (x, Bm, Cm, z, dt)
    if x.dtype not in COMPUTE_DTYPES or any(t.dtype != x.dtype for t in acts):
        return "dtype"
    if any(t.device != h.device for t in acts):
        return "device"
    if _gradient(*acts, dt_bias, A_log, D, h):
        return "a gradient is recorded (the kernel has no backward)"
    return None


def mamba2_step(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, z: torch.Tensor,
                dt: torch.Tensor, dt_bias: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor,
                h: torch.Tensor, inplace: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y · silu(z) (B, H·P) f32, the new state) of one Mamba-2 step; the
    arguments as :func:`mamba2_step_ref` takes them.  With ``inplace`` the
    new state is written over ``h``, which is returned.  Card tensors go
    through the kernel, one launch (counted in ``launches``), or raise; CPU
    tensors take :func:`mamba2_step_ref`."""
    if not on_card(h):
        if h.device.type != "cpu":
            raise ValueError(f"mamba2_step: unsupported device {h.device}")
        y, new = mamba2_step_ref(x, Bm, Cm, z, dt, dt_bias, A_log, D, h)
        return (y, h.copy_(new)) if inplace else (y, new)
    why = _mamba2_refusal(x, Bm, Cm, z, dt, dt_bias, A_log, D, h)
    if why is not None:
        raise ValueError(
            f"mamba2_step kernel does not take these tensors ({why}): x {x.dtype} "
            f"{tuple(x.shape)} strides {x.stride()}, B/C {tuple(Bm.shape)} strides "
            f"{Bm.stride()} / {Cm.stride()}, z strides {z.stride()}, dt {dt.dtype} "
            f"{tuple(dt.shape)} strides {dt.stride()}, h {h.dtype} {tuple(h.shape)}")
    Bsz, H, P, N = h.shape
    out = h if inplace else torch.empty_like(h)
    y = torch.empty((Bsz, H * P), dtype=torch.float32, device=h.device)
    _launch("mamba2_ssm_step_launch", h.device,
            x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), x.stride(0), z.data_ptr(), z.stride(0),
            dt.data_ptr(), dt.stride(0), dt_bias.data_ptr(), A_log.data_ptr(), D.data_ptr(),
            h.data_ptr(), out.data_ptr(), y.data_ptr(), Bsz, H, P, N,
            int(x.dtype == torch.float32), lib=_library2())
    return y, out
