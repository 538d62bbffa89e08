"""Port ops against the JAX package: selective scan, int8 quantization and
matvec, and the dispatch that keeps CUDA tensors off the plain paths (scan,
int8 matvec and flash attention).

Inputs come from a seeded numpy generator and go through both packages; all
comparisons are float32 unless a test says otherwise.  The card branch is
reached without a card by replacing ``on_card`` with a stub."""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mamba_tts_tpu.ops import int8_matvec as jq
from mamba_tts_tpu.ops.selective_scan import selective_scan_ref as j_scan_ref
from mamba_tts_tpu.ops.selective_scan import selective_scan_step as j_scan_step
from mamba_tts_torch.models import attention as t_attention
from mamba_tts_torch.config import MambaConfig
from mamba_tts_torch.models.attention import CrossAttention
from mamba_tts_torch.models.mamba import MambaBlock
from mamba_tts_torch.ops import flash_attention as fa
from mamba_tts_torch.ops import int8_matvec as tq
from mamba_tts_torch.ops import pallas_scan as ps
from mamba_tts_torch.ops import selective_scan as ts

SCAN_TOL = 2e-4  # tests/test_pallas_scan.py:28


def _scan_inputs(rng, Bz=2, T=11, D=24, N=4):
    u = rng.standard_normal((Bz, T, D)).astype(np.float32)
    delta = np.log1p(np.exp(rng.standard_normal((Bz, T, D)))).astype(np.float32) * 0.5
    A = -np.exp(rng.standard_normal((D, N)).astype(np.float32) * 0.5)
    B = rng.standard_normal((Bz, T, N)).astype(np.float32)
    C = rng.standard_normal((Bz, T, N)).astype(np.float32)
    Dv = rng.standard_normal((D,)).astype(np.float32)
    h0 = rng.standard_normal((Bz, N, D)).astype(np.float32) * 0.1
    return u, delta, A, B, C, Dv, h0


def test_selective_scan_ref_matches_jax():
    args = _scan_inputs(np.random.default_rng(0))
    y_j, h_j = j_scan_ref(*map(jnp.asarray, args))
    y_t, h_t = ts.selective_scan_ref(*map(torch.from_numpy, args))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=SCAN_TOL, rtol=SCAN_TOL)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=SCAN_TOL, rtol=SCAN_TOL)


def test_selective_scan_step_matches_jax():
    u, delta, A, B, C, Dv, h0 = _scan_inputs(np.random.default_rng(1), T=1)
    step = (u[:, 0], delta[:, 0], A, B[:, 0], C[:, 0], Dv, h0)
    y_j, h_j = j_scan_step(*map(jnp.asarray, step))
    y_t, h_t = ts.selective_scan_step(*map(torch.from_numpy, step))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=SCAN_TOL, rtol=SCAN_TOL)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=SCAN_TOL, rtol=SCAN_TOL)


def test_quantize_weight_is_bit_identical():
    w = np.random.default_rng(2).standard_normal((96, 40)).astype(np.float32) * 0.3
    w[:, 3] = 0.0  # an all-zero column takes the 1e-8 floor
    q_j, s_j = jq.quantize_weight(jnp.asarray(w))
    q_t, s_t = tq.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


@pytest.mark.parametrize("with_bias", [False, True])
def test_int8_matvec_plain_matches_jax_ref(with_bias):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    w = rng.standard_normal((64, 48)).astype(np.float32) * 0.1
    b = rng.standard_normal((48,)).astype(np.float32) if with_bias else None
    q, s = jq.quantize_weight(jnp.asarray(w))
    y_j = jq.int8_matvec_ref(jnp.asarray(x), q, s, None if b is None else jnp.asarray(b),
                             out_dtype=jnp.float32)
    y_t = tq.int8_matvec(torch.from_numpy(x), torch.from_numpy(np.array(q)),
                         torch.from_numpy(np.array(s)),
                         None if b is None else torch.from_numpy(b), out_dtype=torch.float32)
    assert y_t.dtype == torch.float32
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5, rtol=1e-5)


def test_int8_matvec_plain_bf16_output_matches_jax_ref():
    """The on-card dtypes (bf16 x and output) through the plain version."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 64)).astype(np.float32)
    w = rng.standard_normal((64, 32)).astype(np.float32) * 0.1
    q, s = jq.quantize_weight(jnp.asarray(w))
    y_j = jq.int8_matvec_ref(jnp.asarray(x, jnp.bfloat16), q, s)
    y_t = tq.int8_matvec(torch.from_numpy(x).bfloat16(), torch.from_numpy(np.array(q)),
                         torch.from_numpy(np.array(s)))
    assert y_t.dtype == torch.bfloat16
    # one bf16 ulp: both round the same f32 sum, up to summation order
    np.testing.assert_allclose(y_t.float().numpy(), np.asarray(y_j, np.float32),
                               rtol=2 ** -7, atol=1e-6)


def _kernel_args(B=2, K=64, N=32):
    x = torch.zeros((B, K), dtype=torch.bfloat16)
    return x, torch.zeros((K, N), dtype=torch.int8), torch.ones(N)


@pytest.mark.parametrize("case", [
    "x_f32", "w_f32", "scale_bf16", "out_f32", "batch_17", "n_not_mult4", "k_mismatch",
    "noncontig", "x_3d", "k_empty", "two_devices",
])
def test_int8_matvec_kernel_rejects_unsupported_args(case, monkeypatch):
    monkeypatch.setattr(tq, "on_card", lambda t: True)
    x, w, s = _kernel_args()
    out = torch.bfloat16
    if case == "x_f32":
        x = x.float()
    elif case == "w_f32":
        w = w.float()
    elif case == "scale_bf16":
        s = s.bfloat16()
    elif case == "out_f32":
        out = torch.float32
    elif case == "batch_17":
        x = torch.zeros((17, 64), dtype=torch.bfloat16)
    elif case == "n_not_mult4":
        x, w, s = _kernel_args(N=30)
    elif case == "k_mismatch":
        w = torch.zeros((63, 32), dtype=torch.int8)
    elif case == "noncontig":
        w = torch.zeros((32, 64), dtype=torch.int8).T
    elif case == "x_3d":
        x = x[None]
    elif case == "k_empty":
        x, w, s = _kernel_args(K=0)
    elif case == "two_devices":
        s = s.to("meta")
    with pytest.raises(ValueError):
        tq.int8_matvec(x, w, s, out_dtype=out)


def test_int8_matvec_card_branch_launches_never_plain(monkeypatch):
    """For a card tensor the wrapper goes to the kernel (here: a stub
    library that records the call) and never to the plain version.  The
    bias goes to the one launch as an operand (f32 or bf16, by its kind
    code), and no torch op runs after the launch: the wrapper returns the
    very tensor the kernel wrote."""
    monkeypatch.setattr(tq, "on_card", lambda t: True)

    def no_plain(*a, **k):
        raise AssertionError("plain version used for a card tensor")

    class Reached(Exception):
        pass

    def fake_library():
        raise Reached

    monkeypatch.setattr(tq, "int8_matvec_ref", no_plain)
    monkeypatch.setattr(tq, "_library", fake_library)
    before = tq.int8_matvec.launches
    with pytest.raises(Reached):
        tq.int8_matvec(*_kernel_args())
    assert tq.int8_matvec.launches == before

    events = []

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            events.append(str(func))
            return func(*args, **(kwargs or {}))

    class Lib:
        def int8_matvec_launch(self, *args):
            events.append(("launch", args))
            return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(tq, "_library", Lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: Stream())
    x, w, s = _kernel_args()
    for bias, kind in ((None, 0), (torch.ones(32), 1), (torch.ones(32, dtype=torch.bfloat16), 2)):
        events.clear()
        before = tq.int8_matvec.launches
        with Ops():
            y = tq.int8_matvec(x, w, s, bias)
        assert tq.int8_matvec.launches == before + 1
        assert isinstance(events[-1], tuple), f"torch ops after the launch: {events}"
        args = events[-1][1]
        assert sum(isinstance(e, tuple) for e in events) == 1
        assert args[3] == (None if bias is None else bias.data_ptr()) and args[4] == kind
        assert args[5] == y.data_ptr() and y.shape == (2, 32) and y.dtype == torch.bfloat16
        plan = tq.launch_plan(2, 64, 32)
        assert args[9:12] == (plan.cluster, plan.strip, plan.smem_bytes)


DECODE_SHAPES = [(512, 2048), (1024, 512), (512, 512), (512, 512), (512, 2048), (2048, 512)]


@pytest.mark.parametrize("K,N", sorted(set(DECODE_SHAPES)))
@pytest.mark.parametrize("B", [1, 4, 16])
def test_int8_matvec_ref_with_bias_is_bit_identical_to_jax(K, N, B):
    """The plain version with a bias, at a decode shape, in the card's
    dtypes (bf16 x, f32 bias, bf16 out), equals JAX's bit for bit.  The
    weights are built so that every column's scale is a power of two and x
    holds small multiples of 1/8: every product and partial sum is then
    exact in f32 whatever the summation order, and the only roundings left
    are the two the kernel's epilogue copies (the product to bf16, then
    product + bf16(bias) to bf16)."""
    rng = np.random.default_rng(K + N + B)
    exp = rng.integers(-9, -4, N)
    w = rng.integers(-127, 128, (K, N)).astype(np.float32)
    w[0] = 127.0  # each column's largest magnitude is 127: scale = 2**exp exactly
    w *= np.exp2(exp)[None].astype(np.float32)
    x = (rng.integers(-8, 9, (B, K)) / 8.0).astype(np.float32)
    bias = (rng.standard_normal(N) * 0.5).astype(np.float32)
    q, sc = jq.quantize_weight(jnp.asarray(w))
    np.testing.assert_array_equal(np.asarray(sc), np.exp2(exp).astype(np.float32))
    y_j = jq.int8_matvec_ref(jnp.asarray(x, jnp.bfloat16), q, sc, jnp.asarray(bias))
    y_t = tq.int8_matvec_ref(torch.from_numpy(x).bfloat16(), torch.from_numpy(np.array(q)),
                             torch.from_numpy(np.array(sc)), torch.from_numpy(bias))
    assert y_t.dtype == torch.bfloat16
    np.testing.assert_array_equal(y_t.view(torch.int16).numpy(),
                                  np.asarray(y_j).view(np.int16))


@pytest.mark.parametrize("K,N", sorted(set(DECODE_SHAPES)))
def test_int8_matvec_launch_plan_is_valid(K, N):
    """At every decode shape and B <= 16: a portable cluster that splits K
    into non-empty parts, a strip the kernel has, the strips covering N,
    about one block per SM of the 132 or more, and shared memory a block
    may use."""
    for B in range(1, tq.MAX_BATCH + 1):
        p = tq.launch_plan(B, K, N)
        assert 1 <= p.cluster <= tq.MAX_CLUSTER and p.strip in tq.STRIPS
        strips = -(-N // p.strip)
        assert p.blocks == p.cluster * strips and (strips - 1) * p.strip < N
        assert 128 <= p.blocks <= 2 * 132
        kc = -(-K // p.cluster)
        assert (p.cluster - 1) * kc < K and kc >= tq.MIN_ROWS
        assert p.batch_tile >= B and p.batch_tile in (1, 2, 4, 8, 16)
        stage = max(kc * p.batch_tile * 2, tq.THREADS // 32 * p.batch_tile * p.strip * 4)
        mine = -(-p.batch_tile * p.strip // tq.THREADS)  # receive slots for the cluster
        assert p.smem_bytes >= stage + mine * p.cluster * tq.THREADS * 4
        assert p.smem_bytes <= tq.MAX_SMEM_BYTES and p.smem_bytes % 16 == 0


def test_scan_forward_dispatches_to_kernels_on_card(monkeypatch):
    """For card tensors the Mamba forward takes the scan kernels (stubs here
    that record the call and return the plain outputs): the plain forward
    kernel without a gradient, SelectiveScanFn (checkpointing forward, then
    the backward kernel) with one; never the plain scan."""
    monkeypatch.setattr(ts, "on_card", lambda t: True)
    calls = []

    def fwd(*a, **k):  # k: the wrappers' output= (the plain version takes it too)
        calls.append("fwd")
        return ps.scan_ckpt_ref(*a, **k)[:2]

    def fwd_ckpt(*a, **k):
        calls.append("fwd_ckpt")
        return ps.scan_ckpt_ref(*a, **k)

    def bwd(*a):
        calls.append("bwd")
        return ps.scan_bwd_ref(*a)

    def no_plain(*a, **k):
        raise AssertionError("plain scan used for a card tensor")

    monkeypatch.setattr(ps, "selective_scan_fwd", fwd)
    monkeypatch.setattr(ps, "selective_scan_fwd_ckpt", fwd_ckpt)
    monkeypatch.setattr(ps, "selective_scan_bwd", bwd)
    monkeypatch.setattr(ts, "selective_scan_ref", no_plain)
    block = MambaBlock(MambaConfig(d_model=16, d_state=4), dtype=torch.float32)
    x = torch.randn((1, 5, 16), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        block(x)
    assert calls == ["fwd"]
    y, _ = block(x)
    y.sum().backward()
    assert calls == ["fwd", "fwd_ckpt", "bwd"]
    assert block.A_log.grad is not None and block.D.grad is not None
    # the decode step has no full-sequence scan and keeps its plain step
    y, _ = block.step(torch.zeros((1, 1, 16)), block.init_state(1))
    assert y.shape == (1, 1, 16)


@pytest.mark.parametrize("case", ["u_f16", "B_dtype", "delta_bf16", "state_3", "A_shape",
                                  "noncontig", "h0_shape", "chunk_0", "chunk_32", "two_devices"])
def test_scan_kernel_rejects_unsupported_args(case):
    """What the scan kernels do not take raises before any launch (the
    kernels are built for chunks of 16 and 64 only)."""
    u, delta = torch.zeros((2, 9, 32)), torch.zeros((2, 9, 32))
    A, B, C, h0 = torch.zeros((32, 4)), torch.zeros((2, 9, 4)), torch.zeros((2, 9, 4)), None
    chunk = 16
    if case == "u_f16":
        u = u.half()
    elif case == "B_dtype":
        B = B.bfloat16()
    elif case == "delta_bf16":
        delta = delta.bfloat16()
    elif case == "state_3":
        A, B, C = torch.zeros((32, 3)), torch.zeros((2, 9, 3)), torch.zeros((2, 9, 3))
    elif case == "A_shape":
        A = torch.zeros((16, 4))
    elif case == "noncontig":
        u = torch.zeros((2, 32, 9)).transpose(1, 2)
    elif case == "h0_shape":
        h0 = torch.zeros((2, 32, 4))
    elif case == "chunk_0":
        chunk = 0
    elif case == "chunk_32":
        chunk = 32
    elif case == "two_devices":
        C = C.to("meta")
    with pytest.raises(ValueError):
        ps.selective_scan_fwd(u, delta, A, B, C, torch.zeros(32), h0, chunk)


def test_long_query_attention_dispatches_to_flash_on_card(monkeypatch):
    """For card tensors, Tq >= 128 goes to FlashAttentionFn (its kernels
    stubbed here by the plain version plus a recorded call) and never to
    the plain path; shorter queries keep the plain path, as in the JAX
    package.  What the kernels do not take raises."""
    monkeypatch.setattr(t_attention, "on_card", lambda t: True)
    calls = []

    def fwd(q, K, V, mask, scale):
        calls.append(("fwd", q.shape[2]))
        return fa.flash_attention_ref(q, K, V, mask, scale), torch.zeros(q.shape[:3])

    def bwd(q, K, V, mask, O, lse, dO, scale):
        calls.append(("bwd", q.shape[2]))
        leaves = [t.detach().requires_grad_() for t in (q, K, V)]
        with torch.enable_grad():
            fa.flash_attention_ref(*leaves, mask, scale).backward(dO)
        return tuple(t.grad for t in leaves)

    real_ref = fa.flash_attention_ref

    def plain(q, *a):
        calls.append(("plain", q.shape[2]))
        return real_ref(q, *a)

    monkeypatch.setattr(fa, "flash_attention_fwd", fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd", bwd)
    monkeypatch.setattr(t_attention, "flash_attention_ref", plain)
    attn = CrossAttention(128, 2, dtype=torch.float32)
    K = V = torch.randn((1, 2, 7, 64), generator=torch.Generator().manual_seed(1))
    x = torch.zeros((1, 128, 128), requires_grad=True)
    attn.attend(x, K, V).sum().backward()
    assert calls == [("fwd", 128), ("bwd", 128)]
    assert x.grad is not None
    assert attn.attend(torch.zeros((1, 127, 128)), K, V).shape == (1, 127, 128)
    assert calls[-1] == ("plain", 127)
    small = CrossAttention(16, 4, dtype=torch.float32)  # head_dim 4: not the kernel's 64
    with pytest.raises(ValueError, match="head_dim"):
        fa.check_flash_args(*(small._split(torch.zeros((1, 128, 16))),) * 3, None)
    with pytest.raises(ValueError, match="bf16"):
        fa.check_flash_args(torch.zeros((1, 2, 128, 64)), K.bfloat16(), V.bfloat16(), None)
