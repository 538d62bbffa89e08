"""The Mamba decode step's two kernels (``ops/csrc/mamba_step.cu``),
rehearsed on the CPU, and held to their plain versions on the card.

The kernels cannot run here, so a plain emulation of their arithmetic
order, written in this file, takes the conv kernel's f32 sum of exact bf16
products over k = 0..K-1 and its bf16 rounding points, and the SSM kernel's
state update one n at a time (separate f32 products and sums, the sum over
n as fused multiply-adds, the norms' sums of squares in order), and is held
to the plain versions ``conv_step_ref`` and ``ssm_step_ref`` at the widths
of the two blocks the captured decodes run.  The in-place form, the
dispatch (with a stub library), the refusals and the benchmark's reader of
the launch counter are checked too.  This file imports no jax, so its
``cuda`` tests run on the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mamba_step.py -q
"""
import contextlib
import importlib.util
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mamba_tts_torch.config import DecoderConfig, MambaConfig
from mamba_tts_torch.models.decoder import MambaTTSDecoder, greedy_decode
from mamba_tts_torch.models.layers import Dense, RMSNorm, seed_init
from mamba_tts_torch.models.mamba import MambaBlock, MambaState
from mamba_tts_torch.ops import mamba_step as ms
from mamba_tts_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
EPS = 1e-6  # the jamba block's norms

# the two blocks the captured decodes run, at their widths: tts512x8's (f32
# taps, no inner norms) and AI21-Jamba2-3B's mixer (bf16 taps, RMSNorms over
# dt, B and C); d_conv 4 and d_state 16 in both
KINDS = {"tts512x8": (512, 0, False), "jamba": (2560, 160, True)}

# emulation against the plain version on the CPU: the state's largest
# error over its largest magnitude (the exp implementations and, with
# norms, the sum order of the squares), and y's and x_conv's over theirs:
# a bf16 unit (2^-8 relative) where a sum's order moves a rounding
STATE_TOL = 1e-5
BF16_TOL = 2 ** -7


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def emulate_conv(xin, window, w, b):
    """The conv kernel's order: products of bf16 values (exact in f32) summed
    over k = 0..K-1 in f32, rounded to bf16; the bias (rounded to bf16) added
    in f32 and rounded; SiLU in f32, rounded.  Returns (x_conv, window') as
    bf16."""
    full = torch.cat([window.float(), xin.float()[:, None]], dim=1)
    acc = torch.zeros(xin.shape)
    for k in range(w.shape[0]):
        acc = acc + full[:, k] * _bf16(w[k].float())
    c = _bf16(acc)
    if b is not None:
        c = _bf16(c + _bf16(b.float()))
    return _bf16(c / (1 + torch.exp(-c))).bfloat16(), full[:, 1:].bfloat16()


def _emulate_norm(v, weight, eps):
    ss = torch.zeros(v.shape[0], dtype=torch.float64)
    for n in range(v.shape[1]):  # fused multiply-adds in order
        ss = (v[:, n].double() ** 2 + ss).float().double()
    r = torch.rsqrt(ss.float() / v.shape[1] + eps)
    return _bf16(v * r[:, None] * weight)


def emulate_ssm(dt, A_log, x_conv, z, Bm, Cm, D, h, norm_weights=None):
    """The SSM kernel's order: softplus in f32 (threshold 20), the norms of B
    and C where given, then for n = 0..N-1 the state update as separate f32
    products and a sum, and y's sum as fused multiply-adds (exact in f64,
    rounded once); y + u D rounded to bf16, times SiLU(z) rounded to bf16,
    rounded.  Returns (y bf16, the new state f32)."""
    Bv, Cv = Bm.float(), Cm.float()
    if norm_weights is not None:
        Bv, Cv = (_emulate_norm(v, wt, EPS) for v, wt in zip((Bv, Cv), norm_weights))
    x = dt.float()
    delta = torch.where(x > 20.0, x, torch.log1p(torch.exp(x)))
    u = x_conv.float()
    du = delta * u
    A = -torch.exp(A_log)
    acc = torch.zeros(u.shape)
    new = torch.empty_like(h)
    for n in range(A.shape[1]):
        a = torch.exp(delta * A[:, n])
        hn = a * h[:, n] + du * Bv[:, n:n + 1]
        new[:, n] = hn
        acc = (hn.double() * Cv[:, n:n + 1].double() + acc.double()).float()
    y = _bf16(acc + u * D)
    zf = z.float()
    return _bf16(y * _bf16(zf / (1 + torch.exp(-zf)))).bfloat16(), new


def _rel(got, want) -> float:
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / want.abs().max())


def _operands(kind: str, B: int, seed: int = 0):
    """One step's operands at the block's widths, as the decode makes them:
    the x and z halves and B and C as views of one projection's output each,
    bf16 activations, taps in the block's dtype, a nonzero conv bias,
    dt_proj's output around softplus^-1 of [1e-3, 0.1], S4D-real A_log, a
    state of unit scale."""
    d_model, r, norms = KINDS[kind]
    Dm, N, K = 2 * d_model, 16, 4
    r = r or -(-d_model // 16)
    rng = np.random.default_rng(seed + 100 * B + d_model)

    def randn(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale)

    xz = randn(B, 2 * Dm).bfloat16()
    proj = randn(B, r + 2 * N).bfloat16()
    w = randn(K, Dm, scale=0.5)
    return dict(
        xin=xz[:, :Dm], z=xz[:, Dm:], window=randn(B, K - 1, Dm).bfloat16(),
        w=w.bfloat16() if norms else w, b=randn(Dm, scale=0.1),
        dt=(randn(B, Dm) - 4.0).bfloat16(),
        A_log=torch.log(torch.arange(1, N + 1, dtype=torch.float32)).expand(Dm, N).contiguous(),
        Bm=proj[:, r:r + N], Cm=proj[:, r + N:], D=1.0 + randn(Dm, scale=0.1), h=randn(B, N, Dm),
        norm_weights=(1.0 + randn(N, scale=0.1), 1.0 + randn(N, scale=0.1)) if norms else None)


def _norm(weight) -> RMSNorm:
    """A block's B or C norm with the given weight."""
    norm = RMSNorm(weight.shape[0], EPS, torch.bfloat16)
    norm.weight.data = weight
    return norm


@pytest.mark.parametrize("B", [1, 8, 16])
@pytest.mark.parametrize("kind", list(KINDS))
def test_emulated_kernels_match_plain_step(kind, B):
    """Both kernels' arithmetic order against the plain step on the same
    operands: x_conv and the new window, the state and y."""
    o = _operands(kind, B)
    x_conv, window = emulate_conv(o["xin"], o["window"], o["w"], o["b"])
    want_x, want_window = ms.conv_step_ref(o["xin"], o["window"], o["w"], o["b"])
    assert torch.equal(window, want_window)
    assert _rel(x_conv, want_x) <= BF16_TOL
    nw = o["norm_weights"]
    norms = None if nw is None else tuple(_norm(t) for t in nw)
    args = (o["dt"], o["A_log"], want_x, o["z"], o["Bm"], o["Cm"], o["D"], o["h"])
    y, h = emulate_ssm(*args, nw)
    want_y, want_h = ms.ssm_step_ref(*args, norms)
    assert want_h.dtype == torch.float32 and want_y.dtype == torch.bfloat16
    assert _rel(h, want_h) <= STATE_TOL
    assert _rel(y, want_y) <= BF16_TOL


def _block(kind: str, dtype=torch.bfloat16, d_model=None, d_state=16, seed=0) -> MambaBlock:
    """A seeded block of the kind at a small width: the jamba kind holds its
    Dense weights and taps in bf16, as ``HybridDecoder`` does; the conv bias
    and the norms' weights are drawn away from their init."""
    full, r, norms = KINDS[kind]
    d_model = d_model or (256 if norms else full)
    cfg = MambaConfig(d_model=d_model, d_state=d_state, dt_rank=16 if norms else 0)
    block = seed_init(MambaBlock(cfg, dtype=dtype, inner_norm_eps=EPS if norms else None), seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        block.conv_b.copy_(0.1 * torch.randn(block.conv_b.shape, generator=g))
        if norms:
            for n in (block.b_norm, block.c_norm):
                n.weight.copy_(1.0 + 0.1 * torch.randn(n.weight.shape, generator=g))
            for m in block.modules():
                if isinstance(m, Dense):
                    m.weight.data = m.weight.data.to(dtype)
            block.conv_w.data = block.conv_w.data.to(dtype)
    return block.eval()


@pytest.mark.parametrize("kind", list(KINDS))
def test_in_place_steps_equal_the_functional_chain(kind):
    """64 steps written over one state equal 64 steps that each return a new
    state (the plain path), and each in-place step returns the carry's own
    tensors."""
    block = _block(kind)
    B = 3
    g = torch.Generator().manual_seed(7)
    xs = [torch.randn((B, 1, block.cfg.d_model), generator=g).bfloat16() for _ in range(64)]
    carry = block.init_state(B)
    g2 = torch.Generator().manual_seed(8)
    with torch.no_grad():
        carry.conv.copy_(torch.randn(carry.conv.shape, generator=g2))
        carry.ssm.copy_(torch.randn(carry.ssm.shape, generator=g2))
        state = MambaState(carry.conv.clone(), carry.ssm.clone())
        for x in xs:
            y_f, state = block.step(x, state)
            y_i, st = block.step(x, carry, inplace=True)
            assert st.conv is carry.conv and st.ssm is carry.ssm
            assert torch.equal(y_i, y_f)
    assert torch.equal(carry.conv, state.conv) and torch.equal(carry.ssm, state.ssm)


@pytest.fixture
def card_stub(monkeypatch):
    """``on_card`` says yes; the kernels' library records each launch."""
    monkeypatch.setattr(ms, "on_card", lambda t: True)
    launches = []

    class Lib:
        def mamba_conv_step_launch(self, *args):
            launches.append(("conv", args))
            return 0

        def mamba_ssm_step_launch(self, *args):
            launches.append(("ssm", args))
            return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(ms, "_library", Lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: Stream())
    return launches


class _Ops(TorchDispatchMode):
    """Records every torch op with the tensors it reads or writes."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        flat = list(args) + list((kwargs or {}).values())
        flat += [b for a in flat if isinstance(a, (list, tuple)) for b in a]
        self.seen.append((str(func), [a for a in flat if isinstance(a, torch.Tensor)]))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("inplace", [True, False])
@pytest.mark.parametrize("kind,dtype", [("tts512x8", torch.bfloat16), ("jamba", torch.bfloat16),
                                        ("tts512x8", torch.float32)])
def test_card_step_launches_each_kernel_once_and_no_op_reads_the_state(card_stub, kind, dtype,
                                                                        inplace):
    """On the card without a gradient: one conv and one SSM launch a call
    (``launches`` counts both) with the carry's window and state as their
    inputs, written over in place or into new tensors; the taps in their
    held dtype, the norms' weights where the block has them, the compute
    dtype's flag; and no torch op reads or writes the window or the state
    (``empty_like`` reads only their sizes)."""
    block = _block(kind, dtype=dtype)
    f32 = int(dtype == torch.float32)
    B = 5
    state = block.init_state(B)
    x = torch.zeros((B, 1, block.cfg.d_model), dtype=dtype)
    ops = _Ops()
    before = ms.launches
    with torch.no_grad(), ops:
        y, new = block.step(x, state, inplace=inplace)
    assert y.shape == (B, 1, block.cfg.d_model) and y.dtype == dtype
    assert [k for k, _ in card_stub] == ["conv", "ssm"] and ms.launches == before + 2
    (_, conv), (_, ssm) = card_stub
    Dm, N = block.cfg.d_inner, block.cfg.d_state
    assert conv[2] == state.conv.data_ptr() and conv[3] == new.conv.data_ptr()
    assert conv[4] == block.conv_w.data_ptr() and conv[5] == int(kind == "jamba")
    assert conv[6] == block.conv_b.data_ptr() and conv[7] == 1
    assert conv[1] == 2 * Dm and conv[9:] == (B, Dm, block.cfg.d_conv, f32, 0)
    assert ssm[13] == state.ssm.data_ptr() and ssm[14] == new.ssm.data_ptr()
    assert ssm[4] == 2 * Dm and ssm[16:] == (B, Dm, N, f32, 0)
    if kind == "jamba":
        assert ssm[9:12] == (block.b_norm.weight.data_ptr(), block.c_norm.weight.data_ptr(), EPS)
    else:
        assert ssm[9:11] == (None, None)
    assert (new.conv is state.conv and new.ssm is state.ssm) == inplace
    storages = {t.untyped_storage().data_ptr() for t in (state.conv, state.ssm, new.conv, new.ssm)}
    for name, tensors in ops.seen:
        if name != "aten.empty_like.default":
            assert not any(t.untyped_storage().data_ptr() in storages for t in tensors), name


def test_cpu_step_stays_plain_and_a_card_step_with_a_gradient_raises(card_stub, monkeypatch):
    """On the card a step with a gradient recorded raises (the kernels have
    no backward), launches nothing and leaves the carry as it was; CPU
    tensors take the plain versions, with a gradient reaching the block's
    parameters or without one, and launch nothing."""
    block = _block("tts512x8", d_model=64)
    x = torch.randn((2, 1, 64)).bfloat16()
    state = block.init_state(2)
    state.ssm.normal_()
    kept = MambaState(state.conv.clone(), state.ssm.clone())
    before = ms.launches
    with pytest.raises(ValueError, match="a gradient is recorded"):
        block.step(x, state, inplace=True)
    assert not card_stub and ms.launches == before
    assert torch.equal(state.conv, kept.conv) and torch.equal(state.ssm, kept.ssm)
    monkeypatch.setattr(ms, "on_card", lambda t: False)
    y, _ = block.step(x.clone().requires_grad_(), block.init_state(2))
    y.float().sum().backward()
    assert block.A_log.grad is not None
    state = block.init_state(2)
    with torch.no_grad():
        got, new = block.step(x, state)
        xin, z = (t[:, 0] for t in block._in_proj(x))
        x_conv, window = ms.conv_step_ref(xin, state.conv, block.conv_w, block.conv_b)
        dt_raw, Bm, Cm = block._x_proj(x_conv)
        want, h = ms.ssm_step_ref(block.dt_proj(dt_raw), block.A_log, x_conv, z, Bm, Cm, block.D,
                                  state.ssm)
    assert not card_stub and ms.launches == before
    assert torch.equal(got, y.detach()) and torch.equal(got, block.out_proj(want)[:, None])
    assert torch.equal(new.conv, window) and torch.equal(new.ssm, h)


@pytest.mark.parametrize("case", ["f16_activations", "width_not_a_multiple_of_8", "d_state_12",
                                  "strided_state", "f32_window", "misaligned_taps"])
def test_card_calls_the_kernels_do_not_take_raise(card_stub, case):
    """A step on the card that the kernels do not take raises, launches
    nothing and leaves the state as it was; it never falls back to the
    plain version."""
    kw = {"f16_activations": dict(dtype=torch.float16),
          "width_not_a_multiple_of_8": dict(d_model=6),
          "d_state_12": dict(d_state=12)}.get(case, {})
    block = _block("tts512x8", d_model=kw.pop("d_model", 64), **kw)
    B = 2
    state = block.init_state(B)
    if case == "strided_state":
        s = state.ssm
        state = MambaState(state.conv, s.transpose(0, 1).contiguous().transpose(0, 1))
    elif case == "f32_window":
        state = MambaState(state.conv.float(), state.ssm)
    elif case == "misaligned_taps":
        flat = torch.zeros(block.conv_w.numel() + 1)[1:].reshape(block.conv_w.shape)
        block.conv_w.data = flat.copy_(block.conv_w.data)
    state.ssm.normal_()
    kept = MambaState(state.conv.clone(), state.ssm.clone())
    x = torch.zeros((B, 1, block.cfg.d_model), dtype=block.dtype)
    with torch.no_grad(), pytest.raises(ValueError, match="does not take"):
        block.step(x, state, inplace=True)
    assert not card_stub
    assert torch.equal(state.conv, kept.conv) and torch.equal(state.ssm, kept.ssm)


def _reader():
    path = REPO / "portbench" / "metrics" / "mamba_step_launches.serve.py"
    spec = importlib.util.spec_from_file_location("mamba_step_launches_serve", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_benchmark_reader_takes_launches_over_replayed_steps(monkeypatch):
    """``mamba_step_launches.serve`` divides the counter by the steps of the
    traced requests' ``decode.capture`` (the warm-up) and ``decode.run``
    spans; a program without the counter, or without the tracer, reads None
    and raises nothing."""
    reader = _reader()
    traced = {"profile": {"window": (0.0, 1e12), "kernels": []}, "records": []}
    profiling.reset()
    profiling.enable()
    try:
        for warm, run, layers in ((4, 2556, 26), (1, 1276, 26)):
            with profiling.annotate("synth.request"):
                with profiling.annotate("decode.capture", steps=warm):
                    pass
                with profiling.annotate("decode.run", steps=run, path="hybrid"):
                    pass
                profiling.count("decode.mamba_step_launches", 2 * layers * (warm + run))
        assert reader.read(traced) == 52.0
        assert reader.read({"records": []}) is None
        profiling.reset()
        with profiling.annotate("synth.request"):
            with profiling.annotate("decode.run", steps=4, path="megakernel"):
                pass
        assert reader.read(traced) is None  # a program that counts no such launches
    finally:
        profiling.disable()
        profiling.reset()
    bare = types.ModuleType("mamba_tts_torch.utils.profiling")
    monkeypatch.setitem(sys.modules, "mamba_tts_torch.utils.profiling", bare)
    import mamba_tts_torch.utils as utils

    monkeypatch.setattr(utils, "profiling", bare, raising=False)
    assert reader.read(traced) is None


# ---------------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the Mamba step's kernels have no CPU mode")
    return torch.device("cuda")


# on the card, each step from the plain chain's state: the kernels' state
# against the plain step's over its largest magnitude, y against its largest.
# Without inner norms the two differ only in the order of the conv's and of
# y's f32 sums: 1e-4 and a bf16 unit.  With the jamba block's norms the
# order of their sums of squares now and then moves a rounding of B or C by
# one bf16 unit, and du·B reaches the state's own scale in that block (its
# dt passes dt_norm): a unit of B is 2^-8 of the state's largest, measured
# 2.0e-3; so 2^-8, and y two bf16 units.  Given the plain step's B and C
# (the norms applied outside), its state update equals the plain step's.
# The two chains run apart for 256 steps (the kernels' in place, the plain
# step's), where such differences stay: within CHAIN_TOL.
STEP_TOL = {False: (1e-4, 2 ** -7), True: (2 ** -8, 2 ** -6)}  # (state, y) by inner norms
CHAIN_TOL = 1e-2


def chains_on_card(card, kind, B, dtype, steps=256):
    """The worst errors over ``steps`` steps of one block at the kind's
    width: each step's state and y, the chains' state and y, and, with inner
    norms, the state and y of the SSM kernel given the plain step's B and C;
    and the kernels' launches."""
    d_model = KINDS[kind][0]
    block = _block(kind, dtype=dtype, d_model=d_model).to(card)
    g = torch.Generator(device=card).manual_seed(B)
    carry = block.init_state(B)
    carry.ssm.copy_(torch.randn(carry.ssm.shape, generator=g, device=card))
    plain = MambaState(carry.conv.clone(), carry.ssm.clone())
    norms = (block.b_norm, block.c_norm) if block.inner_norms else None
    worst = [0.0] * 6
    before = ms.launches
    with torch.no_grad():
        for t in range(steps):
            x = torch.randn((B, 1, d_model), generator=g, device=card).to(dtype)
            xin, z = (v[:, 0] for v in block._in_proj(x))
            x_conv, conv_p = ms.conv_step_ref(xin, plain.conv, block.conv_w, block.conv_b)
            dt_raw, Bm, Cm = block._x_proj(x_conv)
            dt = block.dt_proj(dt_raw)
            y_g, h_p = ms.ssm_step_ref(dt, block.A_log, x_conv, z, Bm, Cm, block.D, plain.ssm, norms)
            y_p = block.out_proj(y_g)[:, None]
            y_1, st_1 = block.step(x, plain)
            if t == 0:  # a rerun is bit-identical
                again = block.step(x, plain)
                assert torch.equal(again[0], y_1) and torch.equal(again[1].ssm, st_1.ssm)
                assert torch.equal(again[1].conv, st_1.conv)
            if norms is not None:  # (the plain conv lays x_conv out (D, B))
                y_n, h_n = ms.ssm_step(dt, block.A_log, x_conv.contiguous(), z, norms[0](Bm),
                                       norms[1](Cm), block.D, plain.ssm)
                worst[4] = max(worst[4], _rel(h_n, h_p))
                worst[5] = max(worst[5], _rel(y_n, y_g))
            y_k, st = block.step(x, carry, inplace=True)
            assert st.conv is carry.conv and st.ssm is carry.ssm
            assert torch.equal(st_1.conv, conv_p)
            # the kernels take contiguous states; the plain step leaves the
            # window a view and lays h out (B, D, N)
            plain = MambaState(conv_p.contiguous(), h_p.contiguous())
            for i, err in enumerate((_rel(st_1.ssm, h_p), _rel(y_1, y_p),
                                     _rel(st.ssm, h_p), _rel(y_k, y_p))):
                worst[i] = max(worst[i], err)
    torch.cuda.synchronize()
    return worst, ms.launches - before


@pytest.mark.cuda
@pytest.mark.parametrize("kind,B,dtype", [("tts512x8", 8, torch.bfloat16),
                                          ("jamba", 16, torch.bfloat16),
                                          ("tts512x8", 2, torch.float32)])
def test_kernels_hold_to_the_plain_step_over_256_steps_on_card(card, kind, B, dtype):
    """At the configurations' widths and batches (tts512x8's narration B = 8,
    the jamba block's B = 16; and an f32 block, as the smoke configuration
    serves): the kernels' step from the plain chain's state against the
    plain step at each of 256 steps, and the kernels' in-place chain against
    the plain chain over them; two launches a step; a rerun bit-identical."""
    worst, launched = chains_on_card(card, kind, B, dtype)
    norms = KINDS[kind][2]
    assert launched == 2 * (2 * 256 + 1) + (256 if norms else 0)
    state_tol, y_tol = STEP_TOL[norms]
    assert worst[0] <= state_tol and worst[1] <= y_tol, worst
    assert worst[2] <= CHAIN_TOL and worst[3] <= CHAIN_TOL, worst
    assert worst[4] <= 1e-6 and worst[5] <= STEP_TOL[False][1], worst


@pytest.mark.cuda
def test_captured_decode_counts_two_launches_a_layer_a_step_on_card(card):
    """The captured default decode runs the two kernels on every layer of
    every step (warm-up and replays), the carry's states updated in place,
    and counts them as ``decode.mamba_step_launches``."""
    cfg = DecoderConfig(codebook_size=64, d_model=128, n_layers=2, n_heads=2, d_ff=256,
                        d_style=32, max_len=256, num_quantizers=3, dtype="bfloat16",
                        mamba=MambaConfig(d_model=128, d_state=16))
    dec = seed_init(MambaTTSDecoder(cfg), 0).to(card).eval()
    g = torch.Generator(device=card).manual_seed(0)
    th = torch.randn((2, 7, 128), generator=g, device=card).bfloat16()
    z = torch.randn((2, 32), generator=g, device=card).bfloat16()
    profiling.reset()
    profiling.enable()
    try:
        before = ms.launches
        greedy_decode(dec, th, z, 6)
        torch.cuda.synchronize()
        counted = profiling.counters().get("decode.mamba_step_launches")
    finally:
        profiling.disable()
        profiling.reset()
    assert ms.launches - before == counted == 2 * cfg.n_layers * 3 * 6
