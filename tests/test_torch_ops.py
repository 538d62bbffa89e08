"""Port ops against the JAX package: selective scan, int8 quantization and
matvec, and the dispatch that keeps CUDA tensors off the plain paths.

Inputs come from a seeded numpy generator and go through both packages; all
comparisons are float32 unless a test says otherwise.  The card branch is
reached without a card by replacing ``on_card`` with a stub."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_tts_tpu.ops import int8_matvec as jq
from mamba_tts_tpu.ops.selective_scan import selective_scan_ref as j_scan_ref
from mamba_tts_tpu.ops.selective_scan import selective_scan_step as j_scan_step
from mamba_tts_torch.models import attention as t_attention
from mamba_tts_torch.config import MambaConfig
from mamba_tts_torch.models.attention import CrossAttention
from mamba_tts_torch.models.mamba import MambaBlock
from mamba_tts_torch.ops import int8_matvec as tq
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
    library that records the call) and never to the plain version."""
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


def test_scan_forward_raises_on_card(monkeypatch):
    monkeypatch.setattr(ts, "on_card", lambda t: True)
    block = MambaBlock(MambaConfig(d_model=16, d_state=4), dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="pallas_scan"):
        block(torch.zeros((1, 5, 16)))
    # the decode step has no scan kernel to wait for and stays available
    y, _ = block.step(torch.zeros((1, 1, 16)), block.init_state(1))
    assert y.shape == (1, 1, 16)


def test_long_query_attention_raises_on_card(monkeypatch):
    monkeypatch.setattr(t_attention, "on_card", lambda t: True)
    attn = CrossAttention(16, 4, dtype=torch.float32)
    K = V = torch.zeros((1, 4, 7, 4))
    with pytest.raises(NotImplementedError, match="flash"):
        attn.attend(torch.zeros((1, 128, 16)), K, V)
    assert attn.attend(torch.zeros((1, 127, 16)), K, V).shape == (1, 127, 16)
