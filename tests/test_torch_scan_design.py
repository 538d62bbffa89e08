"""The Hopper scan kernels' decomposition, emulated in plain torch on the CPU.

``mamba_tts_torch/ops/csrc/selective_scan.cu`` runs each direction as three
launches, chunk-parallel over the checkpoints:

- forward: (1) every chunk's end state from a zero start, S_c, and sum dt;
  (2) the carry h_{c+1} = exp(A sum dt) h_c + S_c over the chunks, which IS
  ckpt and h_T; (3) every chunk's y from its true start;
- backward: (1) every chunk's adjoint out of its start from a zero adjoint at
  its end, Q_c, and sum dt; (2) the carry g = exp(A sum dt) g + Q_c over the
  chunks in reverse from dh_T, giving each chunk's adjoint at its end and
  dh0; (3) every chunk's states recomputed from ckpt, 8-step segment by
  segment from the start states a first sweep keeps, then the adjoint with
  its true carry: du, ddt, dB/dC partials per 16-channel slice summed over a
  cluster of slices in rank order (one partial per cluster), dA partials per
  chunk.

This file codes those passes in plain torch, f32, with the grouping
:func:`scan_launch_plan` gives the kernels, and holds them to the port's
plain versions (``scan_ckpt_ref`` / ``scan_bwd_ref``) at 1e-4 of each
output's largest magnitude, as the card test does, and to the JAX package's
Pallas kernels in interpret mode at the JAX suite's 2e-4 (forward) and 2e-3
(gradients).  It also checks the launch plan's invariants."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_tts_tpu.ops import pallas_scan as jps
from mamba_tts_torch.ops import pallas_scan as ps

LOG2E = 1.4426950408889634
REL_TOL = 1e-4  # the card test's limit for f32 states and gradients
SCAN_TOL = 2e-4  # tests/test_pallas_scan.py:28
GRAD_TOL = 2e-3  # tests/test_pallas_scan.py:57

# (T, D, N, chunk): T < chunk, k * chunk +- 1, exactly one chunk; D not a
# multiple of 16 x the cluster size (clusters of 3, 4, 6 and 7 slices)
CASES = [(11, 40, 4, 16), (47, 24, 8, 16), (65, 40, 16, 64), (64, 64, 16, 64),
         (129, 170, 2, 64), (33, 300, 8, 16), (63, 48, 16, 64)]


def _inputs(seed, T, D, N, Bz=2):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(u=rng.standard_normal((Bz, T, D)).astype(f),
                delta=np.log1p(np.exp(rng.standard_normal((Bz, T, D)) - 1.0)).astype(f),
                A=-np.exp(rng.standard_normal((D, N)) * 0.5).astype(f),
                B=rng.standard_normal((Bz, T, N)).astype(f),
                C=rng.standard_normal((Bz, T, N)).astype(f),
                D=rng.standard_normal((D,)).astype(f),
                h0=(0.1 * rng.standard_normal((Bz, N, D))).astype(f),
                dy=rng.standard_normal((Bz, T, D)).astype(f),
                dhT=rng.standard_normal((Bz, N, D)).astype(f))


def _chunked(x, nc, chunk):
    """(Bz, T, K) -> (Bz, nc, chunk, K), zero past T (the kernels stage zeros)."""
    Bz, T, K = x.shape
    return torch.nn.functional.pad(x, (0, 0, 0, nc * chunk - T)).reshape(Bz, nc, chunk, K)


def _a(dt_t, A2):
    """exp(dt A) per (b, chunk, n, d), as the kernels form it: exp2(dt * A log2 e)."""
    return torch.exp2(dt_t[:, :, None, :] * A2[None, None])


def emulate_forward(u, delta, A, B, C, D, h0, chunk):
    """The forward's three passes: (y, h_T, ckpt)."""
    Bz, T, Dm = u.shape
    N, nc = A.shape[1], -(-T // chunk)
    A2 = A.T * LOG2E  # (N, D)
    uc, dc, Bc, Cc = (_chunked(x, nc, chunk) for x in (u, delta, B, C))
    # (1) every chunk from a zero start: its end state and sum dt
    S = torch.zeros((Bz, nc, N, Dm))
    sdt = torch.zeros((Bz, nc, Dm))
    for t in range(chunk):
        S = _a(dc[:, :, t], A2) * S + (dc[:, :, t] * uc[:, :, t])[:, :, None, :] * Bc[:, :, t, :, None]
        sdt = sdt + dc[:, :, t]
    # (2) the carry over the chunks: the true start of each
    ckpt = torch.empty_like(S)
    h = torch.zeros((Bz, N, Dm)) if h0 is None else h0
    for c in range(nc):
        ckpt[:, c] = h
        h = torch.exp2(A2[None] * sdt[:, c, None, :]) * h + S[:, c]
    # (3) every chunk from its true start
    hs, ys = ckpt.clone(), []
    for t in range(chunk):
        hs = _a(dc[:, :, t], A2) * hs + (dc[:, :, t] * uc[:, :, t])[:, :, None, :] * Bc[:, :, t, :, None]
        ys.append((hs * Cc[:, :, t, :, None]).sum(2))
    y = torch.stack(ys, dim=2).reshape(Bz, nc * chunk, Dm)[:, :T] + u * D
    return y, h, ckpt


def _cluster_sum(x, D, plan):
    """x (Bz, nc, chunk, N, D): per 16-channel slice, then each cluster's
    slices in rank order, then the clusters (the wrapper's sum)."""
    S, G = plan.bwd_grad.cluster, plan.partial_slices
    pad = G * S * ps.SLICE - D
    slices = torch.nn.functional.pad(x, (0, pad)).reshape(*x.shape[:-1], G * S, ps.SLICE).sum(-1)
    per_cluster = []
    for g in range(G):
        acc = slices[..., g * S]
        for r in range(1, S):
            acc = acc + slices[..., g * S + r]
        per_cluster.append(acc)
    return torch.stack(per_cluster).sum(0)


def emulate_backward(u, delta, A, B, C, ckpt, dy, dhT, chunk):
    """The backward's three passes: (du, ddt, dB, dC, dA_b, dh0)."""
    Bz, T, Dm = u.shape
    N, nc = A.shape[1], -(-T // chunk)
    plan = ps.scan_launch_plan(Bz, T, Dm, N, chunk)
    A_nd, A2 = A.T, A.T * LOG2E
    uc, dc, Bc, Cc, gc = (_chunked(x, nc, chunk) for x in (u, delta, B, C, dy))
    # (1) every chunk's adjoint out of its start from a zero adjoint at its end
    Q = torch.zeros((Bz, nc, N, Dm))
    for t in reversed(range(chunk)):
        Q = _a(dc[:, :, t], A2) * (gc[:, :, t, None, :] * Cc[:, :, t, :, None] + Q)
    sdt = dc.sum(2)
    # (2) the carry in reverse: each chunk's adjoint at its end, and dh0
    gin = torch.empty_like(Q)
    g = dhT
    for c in reversed(range(nc)):
        gin[:, c] = g
        g = torch.exp2(A2[None] * sdt[:, c, None, :]) * g + Q[:, c]
    dh0 = g
    # (3) states from ckpt by 8-step segments, then the adjoint with its carry
    seg_starts, h = [], ckpt
    for t in range(chunk):
        if t % ps.SEGMENT == 0:
            seg_starts.append(h)
        h = _a(dc[:, :, t], A2) * h + (dc[:, :, t] * uc[:, :, t])[:, :, None, :] * Bc[:, :, t, :, None]
    du, ddt = torch.zeros((Bz, nc, chunk, Dm)), torch.zeros((Bz, nc, chunk, Dm))
    xB, xC = torch.zeros((Bz, nc, chunk, N, Dm)), torch.zeros((Bz, nc, chunk, N, Dm))
    dA_c = torch.zeros((Bz, nc, N, Dm))
    g = gin
    for s in reversed(range(chunk // ps.SEGMENT)):
        t0 = s * ps.SEGMENT
        states = [seg_starts[s]]
        for t in range(t0, t0 + ps.SEGMENT):
            states.append(_a(dc[:, :, t], A2) * states[-1]
                          + (dc[:, :, t] * uc[:, :, t])[:, :, None, :] * Bc[:, :, t, :, None])
        for t in reversed(range(t0, t0 + ps.SEGMENT)):
            d_t, u_t, g_t = dc[:, :, t], uc[:, :, t], gc[:, :, t]
            Bt, Ct = Bc[:, :, t, :, None], Cc[:, :, t, :, None]
            a = _a(d_t, A2)
            hhat = g_t[:, :, None, :] * Ct + g
            hp, ht = states[t - t0], states[t - t0 + 1]
            ddt[:, :, t] = (hhat * (a * hp * A_nd + u_t[:, :, None, :] * Bt)).sum(2)
            du[:, :, t] = d_t * (hhat * Bt).sum(2)
            xB[:, :, t] = hhat * (d_t * u_t)[:, :, None, :]
            xC[:, :, t] = ht * g_t[:, :, None, :]
            dA_c = dA_c + hhat * hp * a * d_t[:, :, None, :]
            g = a * hhat
    assert plan.bwd_grad.grid[1] == nc  # one dA partial per chunk

    def flat(x):
        return x.reshape(Bz, nc * chunk, *x.shape[3:])[:, :T]

    return (flat(du), flat(ddt), flat(_cluster_sum(xB, Dm, plan)), flat(_cluster_sum(xC, Dm, plan)),
            dA_c.sum(1), dh0)


def _rel_close(got, want, tol, what):
    err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
    assert err <= tol, f"{what}: {err:.3g} of its largest magnitude (limit {tol})"


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("T,D,N,chunk", CASES)
def test_design_matches_plain_versions(T, D, N, chunk, with_h0):
    """Both directions' passes against ``scan_ckpt_ref`` and ``scan_bwd_ref``
    on the same inputs, f32, at 1e-4 of each output's largest magnitude."""
    x = {k: torch.from_numpy(v) for k, v in _inputs(T + N, T, D, N).items()}
    h0 = x["h0"] if with_h0 else None
    args = (x["u"], x["delta"], x["A"], x["B"], x["C"])
    y, hT, ck = emulate_forward(*args, x["D"], h0, chunk)
    y_w, hT_w, ck_w = ps.scan_ckpt_ref(*args, x["D"], h0, chunk)
    for name, g, w in (("y", y, y_w), ("h_T", hT, hT_w), ("ckpt", ck, ck_w)):
        _rel_close(g, w, REL_TOL, name)
    got = emulate_backward(*args, ck, x["dy"], x["dhT"], chunk)
    want = ps.scan_bwd_ref(*args, ck_w, x["dy"], x["dhT"], chunk)
    for name, g, w in zip("du ddt dB dC dA_b dh0".split(), got, want):
        assert g.shape == w.shape, name
        _rel_close(g, w, REL_TOL, name)


@pytest.mark.parametrize("T,D,N,chunk", CASES[:4] + CASES[5:6])
def test_design_matches_jax_pallas_interpret(T, D, N, chunk):
    """The same passes against ``_scan_kernel_ckpt`` and ``_scan_bwd_kernel``
    (interpret mode, inputs padded to whole chunks as the JAX package pads
    them): forward within 2e-4, gradients within 2e-3."""
    x = _inputs(2 * T + N, T, D, N)
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    args = (tx["u"], tx["delta"], tx["A"], tx["B"], tx["C"])
    y, hT, ck = emulate_forward(*args, tx["D"], tx["h0"], chunk)
    ja = [jnp.asarray(x[k]) for k in ("u", "delta", "A", "B", "C", "D")]
    y_j, hT_j, ck_j = jps._pallas_forward(*ja, jnp.asarray(x["h0"]), chunk, D, True, with_ckpt=True)
    _close(y, y_j, SCAN_TOL, "y")
    _close(hT, hT_j, SCAN_TOL, "h_T")
    _close(ck, ck_j, SCAN_TOL, "ckpt")
    got = emulate_backward(*args, ck, tx["dy"], tx["dhT"], chunk)
    Tp = -(-T // chunk) * chunk
    pad = lambda k: jnp.pad(jnp.asarray(x[k]), ((0, 0), (0, Tp - T), (0, 0)))  # noqa: E731
    want = jps._scan_pallas_bwd(pad("u"), pad("delta"), jnp.asarray(x["A"]).T, pad("B"), pad("C"),
                                ck_j, pad("dy"), jnp.asarray(x["dhT"]), chunk, D, True)
    for name, g, w in zip("du ddt dB dC dA_b dh0".split(), got, want):
        w = np.asarray(w)
        _close(g, w[:, :T] if w.ndim == 3 and w.shape[1] == Tp else w, GRAD_TOL, name)


@pytest.mark.parametrize("B,T,D,N,chunk", [(2, 5120, 1024, 16, 64), (8, 5120, 1024, 16, 64),
                                           (1, 70, 64, 4, 64), (2, 37, 40, 4, 16),
                                           (2, 130, 160, 16, 16), (3, 1000, 300, 8, 16),
                                           (16, 640, 1024, 16, 64), (1, 1, 16, 2, 16)])
def test_launch_plan_invariants(B, T, D, N, chunk):
    """At least 4 resident blocks of 256 threads a SM at N = 16 (shared memory
    well under 56 KB a block), clusters of at most 8 blocks that divide the
    gradient grid, every channel slice and every chunk covered once."""
    plan = ps.scan_launch_plan(B, T, D, N, chunk)
    nc, slices = -(-T // chunk), -(-D // ps.SLICE)
    chunk_passes = (plan.fwd_summary, plan.fwd_output, plan.bwd_summary, plan.bwd_grad)
    for p in chunk_passes:
        assert p.grid[2] == B and p.smem_bytes <= 56 * 1024 and p.resident >= 4
        if N == 16:
            assert p.threads == 256 and (p.smem_bytes + 1024) * 4 <= ps.SMEM_PER_SM
        assert p.grid[1] == nc  # one block per (slice or column, chunk, row)
    for p in (plan.fwd_summary, plan.fwd_output, plan.bwd_summary):  # one thread a channel
        assert p.threads == ps.ROW_THREADS and p.cluster == 1
        assert p.grid[0] * p.threads >= D and (p.grid[0] - 1) * p.threads < D
    assert plan.bwd_grad.threads == ps.SLICE * N
    g = plan.bwd_grad
    assert 1 <= g.cluster <= ps.MAX_CLUSTER and g.cluster <= slices and g.grid[0] % g.cluster == 0
    groups = g.grid[0] // g.cluster
    assert groups == plan.partial_slices
    # block x owns slice x; the padding blocks (x >= slices) are fewer than a cluster's worth
    owned = [x for x in range(g.grid[0]) if x < slices]
    assert owned == list(range(slices)) and g.grid[0] - slices < groups
    for carry in (plan.fwd_carry, plan.bwd_carry):
        assert carry.grid[0] * carry.threads >= N * D and carry.grid[1] == B
    if (D, N, chunk) == (1024, 16, 64):
        assert g.cluster == 8 and plan.partial_slices == 8  # 64 slices -> 8 partials
