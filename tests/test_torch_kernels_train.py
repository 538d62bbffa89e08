"""The training kernels' plain versions against the JAX package on the CPU.

The scan's plain forward, checkpointing forward and backward are held to
``mamba_tts_tpu.ops.pallas_scan`` run in interpret mode (as
``tests/test_pallas_scan.py`` runs it), and the flash kernel's plain version
to the JAX ``CrossAttention`` on its CPU path.  ``SelectiveScanFn`` (the
card's autograd binding: D-skip terms, casts, the ckpt hand-over) runs here
with the plain versions standing in for its kernels.  Inputs come from a
seeded numpy generator and go to both packages; float32 throughout."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_tts_tpu.models.attention import CrossAttention as JCrossAttention
from mamba_tts_tpu.ops import pallas_scan as jps
from mamba_tts_torch.bridge import load_params
from mamba_tts_torch.models.attention import CrossAttention
from mamba_tts_torch.ops import pallas_scan as ps
from mamba_tts_torch.ops import selective_scan as ts

SCAN_TOL = 2e-4  # tests/test_pallas_scan.py:28
GRAD_TOL = 2e-3  # tests/test_pallas_scan.py:57


def _scan_inputs(seed, Bz=2, T=37, D=24, N=8):
    rng = np.random.default_rng(seed)
    f = np.float32
    u = rng.standard_normal((Bz, T, D)).astype(f)
    delta = np.log1p(np.exp(rng.standard_normal((Bz, T, D)) - 1.0)).astype(f)
    A = -np.exp(rng.standard_normal((D, N))).astype(f)
    B = rng.standard_normal((Bz, T, N)).astype(f)
    C = rng.standard_normal((Bz, T, N)).astype(f)
    Dsk = rng.standard_normal((D,)).astype(f)
    h0 = rng.standard_normal((Bz, N, D)).astype(f)
    return (u, delta, A, B, C, Dsk), h0


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("T,chunk", [(37, 8), (64, 16), (130, 32)])
def test_scan_forward_matches_pallas_interpret(T, chunk, with_h0):
    args, h0 = _scan_inputs(T, T=T)
    h0 = h0 if with_h0 else None
    y_j, h_j = jps.selective_scan_pallas(*map(jnp.asarray, args),
                                         h0=None if h0 is None else jnp.asarray(h0), chunk=chunk)
    targs = [torch.from_numpy(a) for a in args]
    th0 = None if h0 is None else torch.from_numpy(h0)
    y_t, h_t = ts.selective_scan(*targs, th0)
    y_c, h_c, _ = ps.scan_ckpt_ref(*targs, th0, chunk=chunk)
    for got in ((y_t, h_t), (y_c, h_c)):
        _close(got[0], y_j, SCAN_TOL, "y")
        _close(got[1], h_j, SCAN_TOL, "h_T")


@pytest.mark.parametrize("T,chunk", [(37, 8), (64, 16), (130, 32)])
def test_scan_ckpt_matches_pallas_ckpt_kernel(T, chunk):
    """The chunk-start states against ``_scan_kernel_ckpt``'s (interpret)."""
    args, h0 = _scan_inputs(T + 1, T=T)
    ja = list(map(jnp.asarray, args))
    y_j, h_j, ck_j = jps._pallas_forward(*ja, jnp.asarray(h0), chunk, args[0].shape[2], True,
                                         with_ckpt=True)
    y_t, h_t, ck_t = ps.scan_ckpt_ref(*map(torch.from_numpy, args), torch.from_numpy(h0), chunk)
    assert ck_t.shape == ck_j.shape == (2, -(-T // chunk), 8, 24)
    _close(ck_t, ck_j, SCAN_TOL, "ckpt")
    _close(y_t, y_j, SCAN_TOL, "y")
    _close(h_t, h_j, SCAN_TOL, "h_T")


def test_scan_bwd_ref_matches_pallas_bwd_kernel():
    """Every output of the plain backward against ``_scan_bwd_kernel``
    (interpret) on the same checkpoints and cotangents, in the kernel's
    layout: du without the D-skip term, dA per batch row."""
    T, chunk = 32, 8
    (u, delta, A, B, C, Dsk), h0 = _scan_inputs(3, T=T)
    rng = np.random.default_rng(4)
    dy = rng.standard_normal(u.shape).astype(np.float32)
    dhT = rng.standard_normal(h0.shape).astype(np.float32)
    _, _, ck = jps._pallas_forward(*map(jnp.asarray, (u, delta, A, B, C, Dsk)), jnp.asarray(h0),
                                   chunk, 24, True, with_ckpt=True)
    want = jps._scan_pallas_bwd(*map(jnp.asarray, (u, delta)), jnp.asarray(A).T,
                                *map(jnp.asarray, (B, C)), ck, jnp.asarray(dy), jnp.asarray(dhT),
                                chunk, 24, True)
    got = ps.scan_bwd_ref(*map(torch.from_numpy, (u, delta, A, B, C)),
                          torch.from_numpy(np.array(ck)), torch.from_numpy(dy),
                          torch.from_numpy(dhT), chunk)
    for name, g, w in zip("du ddt dB dC dA_b dh0".split(), got, want):
        _close(g, w, GRAD_TOL, name)


def _plain_kernels(monkeypatch):
    """SelectiveScanFn on CPU tensors, its kernels replaced by their plain
    versions (same arguments, same layouts)."""
    monkeypatch.setattr(ps, "selective_scan_fwd_ckpt", ps.scan_ckpt_ref)
    monkeypatch.setattr(ps, "selective_scan_bwd", ps.scan_bwd_ref)


@pytest.mark.parametrize("with_h0", [False, True])
def test_scan_gradients_match_pallas_vjp(with_h0, monkeypatch):
    """Gradients of u, delta, A, B, C, D (and h0) of sum(y^2) + sum(h_T^2):
    autograd through the plain scan, and SelectiveScanFn's backward over the
    plain versions, against jax.grad through the Pallas custom VJP."""
    T, chunk = 21, 8
    args, h0 = _scan_inputs(7, T=T, D=16, N=4)
    if not with_h0:
        h0 = None

    def j_loss(*a):
        *a, h = a
        y, hT = jps.selective_scan_pallas(*a, h0=h, chunk=chunk)
        return (y.astype(jnp.float32) ** 2).sum() + (hT ** 2).sum()

    jargs = list(map(jnp.asarray, args)) + [None if h0 is None else jnp.asarray(h0)]
    argnums = tuple(range(6)) + ((6,) if with_h0 else ())
    want = jax.grad(j_loss, argnums=argnums)(*jargs)
    _plain_kernels(monkeypatch)
    for fn in (lambda *a: ts.selective_scan(*a),
               lambda *a: ps.SelectiveScanFn.apply(*a, chunk)):
        leaves = [torch.from_numpy(a).requires_grad_() for a in args]
        leaves.append(None if h0 is None else torch.from_numpy(h0).requires_grad_())
        y, hT = fn(*leaves)
        ((y * y).sum() + (hT * hT).sum()).backward()
        got = [l.grad for l in leaves if l is not None]
        for name, g, w in zip("u delta A B C D h0".split(), got, want):
            _close(g, w, GRAD_TOL, name)


def test_scan_fn_grad_from_final_state_only(monkeypatch):
    """A cotangent through h_T alone (y unused) reaches u and delta."""
    args, _ = _scan_inputs(9, T=16, D=16, N=4)

    def j_loss(*a):
        return (jps.selective_scan_pallas(*a, chunk=8)[1] ** 2).sum()

    want = jax.grad(j_loss, argnums=(0, 1))(*map(jnp.asarray, args))
    _plain_kernels(monkeypatch)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    _, hT = ps.SelectiveScanFn.apply(*leaves, None, 8)
    (hT * hT).sum().backward()
    for g, w in zip([l.grad for l in leaves[:2]], want):
        _close(g, w, GRAD_TOL)


def test_flash_plain_matches_jax_attention():
    """``CrossAttention.attend`` at Tq = 160 >= 128 (the flash case) on the
    CPU, where both packages take the materialized softmax: output and the
    gradients that flow into q, K and V (through the queries and the
    memory), f32.  Tolerance 1e-5: the same f32 arithmetic, summed in
    another order."""
    B, Tq, Tm, d, H = 2, 160, 37, 64, 4
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, Tq, d)).astype(np.float32)
    mem = rng.standard_normal((B, Tm, d)).astype(np.float32)
    mask = np.ones((B, Tm), bool)
    mask[0, 10:25] = False
    mask[1, -5:] = False
    jm = JCrossAttention(d, H, dtype=jnp.float32)
    variables = jm.init(jax.random.PRNGKey(0), x, mem, mask)
    port = load_params(CrossAttention(d, H, dtype=torch.float32),
                       jax.tree.map(np.asarray, variables["params"]))

    def j_out(x, mem):
        return jm.apply(variables, x, mem, mask)

    y_j = j_out(x, mem)
    w = rng.standard_normal(y_j.shape).astype(np.float32)
    gx_j, gm_j = jax.grad(lambda x, m: (j_out(x, m) * w).sum(), argnums=(0, 1))(x, mem)
    xt, mt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(mem).requires_grad_()
    y_t = port(xt, mt, torch.from_numpy(mask))
    (y_t * torch.from_numpy(w)).sum().backward()
    _close(y_t.detach(), y_j, 1e-5, "out")
    _close(xt.grad, gx_j, 1e-5, "grad through q")
    _close(mt.grad, gm_j, 1e-5, "grad through K, V")
