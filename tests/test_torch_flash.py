"""The rounding points of the card's flash kernels, rehearsed on the CPU.

``ops/csrc/flash_attention.cu`` multiplies on the tensor cores: products take
bf16 inputs and sum in f32, P is rounded to bf16 before P V, and dS (times
the scale) before dK += dS^T q and dQ += dS K, as in jax's TPU flash kernel.
The kernels cannot run here, so a tiled emulation written in this file takes
their tiles (128 query rows x 128 keys forward and in the dQ pass; 128 keys x
64 query rows in the dK/dV pass), their online softmax in log2 units and
their separate dK/dV and dQ passes, and is held to the JAX package's
attention (``CrossAttention.attend`` on its CPU path, the ``_naive``
materialized softmax, with its ``jax.grad``) and to the port's plain version
``flash_attention_ref`` under autograd, at 2e-2 of each output's largest
magnitude: the limit the kernels meet on the card.  Inputs are bf16 values
made with numpy from a seed.  The wrapper's launch numbers are checked too.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_tts_tpu.models.attention import CrossAttention as JCrossAttention
from mamba_tts_torch.ops import flash_attention as fa

LOG2E, LN2 = 1.0 / math.log(2.0), math.log(2.0)
TOL = 2e-2  # tests/test_torch_cuda.py test_flash_kernels_match_plain_on_card
H = 2
SCALE = 64 ** -0.5


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _bias(mask: torch.Tensor) -> torch.Tensor:
    """(B, Tk) bool -> (B, 1, 1, Tk) additive bias, as the kernels read it."""
    return torch.where(mask, 0.0, fa.NEG_INF)[:, None, None, :]


def emulate_forward(q, K, V, mask, scale):
    """The forward kernel's tiles: online softmax over 128-key tiles for each
    128-row query tile, x = (s * scale + bias) * log2 e, P rounded to bf16
    before P V, O rounded to bf16, lse = m ln 2 + ln l."""
    Bz, Hh, Tq, _ = q.shape
    Tk = K.shape[2]
    bias = _bias(mask)
    O = torch.empty_like(q)
    lse = torch.empty(q.shape[:3])
    for q0 in range(0, Tq, fa.TILE):
        qt = q[:, :, q0:q0 + fa.TILE]
        rows = qt.shape[2]
        m = torch.full((Bz, Hh, rows), -math.inf)
        l = torch.zeros((Bz, Hh, rows))
        acc = torch.zeros((Bz, Hh, rows, 64))
        for k0 in range(0, Tk, fa.TILE):
            kt, vt = K[:, :, k0:k0 + fa.TILE], V[:, :, k0:k0 + fa.TILE]
            x = (qt @ kt.transpose(-1, -2) * scale + bias[..., k0:k0 + fa.TILE]) * LOG2E
            m_new = torch.maximum(m, x.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + _bf16(p) @ vt
            m = m_new
        O[:, :, q0:q0 + fa.TILE] = acc / l[..., None]
        lse[:, :, q0:q0 + fa.TILE] = m * LN2 + torch.log(l)
    return _bf16(O), lse


def emulate_backward(q, K, V, mask, O, lse, dO, scale):
    """The backward kernels: Delta = rowsum(dO O); a dK/dV pass (128-key
    tiles, 64-row query steps, transposed products) and a dQ pass (128-row
    query tiles, 128-key steps), each forming P = exp2(x - lse log2 e) and
    dS * scale = P (dP - Delta) * scale itself, bf16 at the products' inputs,
    f32 sums, outputs rounded to bf16."""
    Tq, Tk = q.shape[2], K.shape[2]
    bias = _bias(mask)
    delta = (dO * O).sum(-1)
    lse2 = lse * LOG2E

    def p_and_ds(qt, dot, kt, vt, bt, l2, dl):
        x = (qt @ kt.transpose(-1, -2) * scale + bt) * LOG2E
        p = torch.exp2(x - l2[..., None])
        return p, p * (dot @ vt.transpose(-1, -2) - dl[..., None]) * scale

    dK, dV = torch.zeros_like(K), torch.zeros_like(V)
    for k0 in range(0, Tk, fa.TILE):
        ks = slice(k0, k0 + fa.TILE)
        for q0 in range(0, Tq, fa.BWD_Q_TILE):
            qs = slice(q0, q0 + fa.BWD_Q_TILE)
            p, ds = p_and_ds(q[:, :, qs], dO[:, :, qs], K[:, :, ks], V[:, :, ks], bias[..., ks],
                             lse2[:, :, qs], delta[:, :, qs])
            dV[:, :, ks] += _bf16(p).transpose(-1, -2) @ dO[:, :, qs]
            dK[:, :, ks] += _bf16(ds).transpose(-1, -2) @ q[:, :, qs]
    dq = torch.zeros_like(q)
    for q0 in range(0, Tq, fa.TILE):
        qs = slice(q0, q0 + fa.TILE)
        for k0 in range(0, Tk, fa.TILE):
            ks = slice(k0, k0 + fa.TILE)
            _, ds = p_and_ds(q[:, :, qs], dO[:, :, qs], K[:, :, ks], V[:, :, ks], bias[..., ks],
                             lse2[:, :, qs], delta[:, :, qs])
            dq[:, :, qs] += _bf16(ds) @ K[:, :, ks]
    return _bf16(dq), _bf16(dK), _bf16(dV)


CASES = {  # (Tq, Tk) -> keys masked out per batch row
    (130, 77): {0: slice(10, 25), 1: slice(70, 77)},
    (257, 300): {0: slice(128, 256), 1: slice(290, 300)},  # row 0: the whole second key tile
    (200, 3): {0: slice(1, 2)},
}


def _inputs(Tq, Tk, seed=0, Bz=2):
    rng = np.random.default_rng(seed + Tq + Tk)

    def bf16_values(*shape):
        return _bf16(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))).numpy()

    q, K, V, dO = (bf16_values(Bz, H, T, 64) for T in (Tq, Tk, Tk, Tq))
    mask = np.ones((Bz, Tk), bool)
    for row, keys in CASES[(Tq, Tk)].items():
        mask[row, keys] = False
    return q, K, V, dO, mask


def _emulated(q, K, V, dO, mask):
    t = [torch.from_numpy(a) for a in (q, K, V, dO)]
    m = torch.from_numpy(mask)
    O, lse = emulate_forward(t[0], t[1], t[2], m, SCALE)
    return (O,) + emulate_backward(t[0], t[1], t[2], m, O, lse, t[3], SCALE)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_attention(q, K, V, dO, mask):
    """O and the gradients of q, K, V through the JAX package's
    ``CrossAttention.attend`` on the CPU (the materialized softmax), f32,
    with identity projections so that it attends over q, K, V themselves."""
    Bz, Hh, Tq, hd = q.shape
    d = Hh * hd
    jm = JCrossAttention(d, Hh, dtype=jnp.float32)
    shapes = jm.init(jax.random.PRNGKey(0), jnp.zeros((Bz, Tq, d)), jnp.zeros((Bz, K.shape[2], d)),
                     jnp.asarray(mask))["params"]
    eye = {"kernel": np.eye(d, dtype=np.float32), "bias": np.zeros((d,), np.float32)}
    params = {name: eye for name in shapes}  # q_proj, k_proj, v_proj, o_proj

    def merge(t):  # (B, H, T, hd) -> (B, T, H·hd)
        return t.transpose(0, 2, 1, 3).reshape(t.shape[0], t.shape[2], d)

    def out(x, Kj, Vj):
        return jm.apply({"params": params}, x, Kj, Vj, jnp.asarray(mask), method=JCrossAttention.attend)

    x = jnp.asarray(merge(q))
    y = out(x, jnp.asarray(K), jnp.asarray(V))
    w = jnp.asarray(merge(dO))
    gx, gK, gV = jax.grad(lambda *a: (out(*a) * w).sum(), argnums=(0, 1, 2))(
        x, jnp.asarray(K), jnp.asarray(V))

    def split(t):  # (B, T, H·hd) -> (B, H, T, hd)
        t = np.asarray(t)
        return t.reshape(Bz, t.shape[1], Hh, hd).transpose(0, 2, 1, 3)

    return split(y), split(gx), np.asarray(gK), np.asarray(gV)


@pytest.mark.parametrize("Tq,Tk", list(CASES))
def test_tiled_bf16_emulation_matches_jax_attention(Tq, Tk):
    """O, dq, dK, dV of the kernels' tiling and rounding against JAX's
    attention and its jax.grad on the CPU."""
    q, K, V, dO, mask = _inputs(Tq, Tk)
    got = _emulated(q, K, V, dO, mask)
    want = _jax_attention(q, K, V, dO, mask)
    for name, g, w in zip(("O", "dq", "dK", "dV"), got, want):
        assert _rel(g, w) <= TOL, name


@pytest.mark.parametrize("Tq,Tk", list(CASES))
def test_tiled_bf16_emulation_matches_plain_version(Tq, Tk):
    """The same against ``flash_attention_ref`` and autograd through it (f32),
    the plain version the card's kernels are held to."""
    q, K, V, dO, mask = _inputs(Tq, Tk, seed=1)
    got = _emulated(q, K, V, dO, mask)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, K, V)]
    out = fa.flash_attention_ref(*leaves, torch.from_numpy(mask), SCALE)
    out.backward(torch.from_numpy(dO))
    want = [out.detach()] + [t.grad for t in leaves]
    for name, g, w in zip(("O", "dq", "dK", "dV"), got, want):
        assert _rel(g, w.numpy()) <= TOL, name


@pytest.mark.parametrize("Bz,Hh,Tq,Tk", [(2, 8, 5120, 5376), (8, 8, 5120, 5376), (10, 8, 640, 896),
                                         (2, 3, 1, 300), (2, 3, 257, 129), (1, 1, 128, 3)])
def test_launch_plan_fits_the_card_and_covers_every_row_once(Bz, Hh, Tq, Tk):
    plan = fa.flash_launch_plan(Bz, Hh, Tq, Tk)
    for name, rows in (("fwd", Tq), ("dkdv", Tk), ("dq", Tq)):
        k = plan[name]
        assert 0 < k["smem"] <= fa.SMEM_PER_BLOCK, name
        assert k["smem"] % 1024 == 0, name
        tiles, planes = k["grid"]
        assert planes == Bz * Hh, name
        covered = np.zeros(rows, int)
        for t in range(tiles):
            covered[t * k["rows"]:min((t + 1) * k["rows"], rows)] += 1
        assert (covered == 1).all() and (tiles - 1) * k["rows"] < rows, name
    # the dK/dV kernel steps through the padded workspace rows 64 at a time,
    # the dQ kernel reads whole 128-row tiles of it
    steps = -(-Tq // plan["dkdv"]["q_rows"])
    assert plan["tq_pad"] % plan["dkdv"]["q_rows"] == 0 and steps * plan["dkdv"]["q_rows"] <= plan["tq_pad"]
    assert plan["tq_pad"] == plan["dq"]["grid"][0] * plan["dq"]["rows"] >= Tq


def test_launch_plan_shared_memory_matches_the_kernel_layout():
    """The C structs' sizes, written out: the forward holds q and a 3-stage
    ring of K and V tiles (16 KB each) with a 512-byte bias per stage; dQ adds
    dO; dK/dV holds K, V and 3 stages of 8 KB q and dO tiles with their lse
    and Delta; 7 barriers each; padded to 1 KB, plus 1 KB of alignment."""
    plan = fa.flash_launch_plan(2, 8, 5120, 5376)
    assert plan["fwd"]["smem"] == 117_760
    assert plan["dq"]["smem"] == 134_144
    assert plan["dkdv"]["smem"] == 84_992
