"""The port's decode megakernel (host side and plain version) against the JAX
package, and the JAX file's own tests (tests/test_decode_megakernel.py)
carried over onto the port.

Tiny bf16 decoder, inputs made with numpy from a seed, weights carried over
with ``mamba_tts_torch.bridge``.  The JAX side runs its Pallas kernel in
interpret mode, as its own tests do; the port runs ``decode_megakernel_ref``
(the CUDA kernel has no CPU mode; tests/test_torch_cuda.py holds it to the
same plain version on a card).  Both sides round to bf16 at the same points
and differ in f32 summation order only; measured on this suite's inputs:
teacher-forced relative max logit error 7.1e-3 to 1.08e-2 over the three
dtype rungs at B=1 and B=2, argmax agreement 100% (limits 2e-2 and 90%)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_tts_tpu.config import DecoderConfig as JDecoderConfig
from mamba_tts_tpu.config import MambaConfig as JMambaConfig
from mamba_tts_tpu.infer import quant_decode as jqd
from mamba_tts_tpu.models.decoder import MambaTTSDecoder as JDecoder
from mamba_tts_tpu.ops import decode_megakernel as jmk
from mamba_tts_torch.bridge import load_params
from mamba_tts_torch.config import DecoderConfig, MambaConfig
from mamba_tts_torch.infer import quant_decode as tqd
from mamba_tts_torch.models.decoder import MambaTTSDecoder
from mamba_tts_torch.ops import decode_megakernel as tmk

RUNGS = [("bfloat16", "bfloat16"), ("int8", "bfloat16"), ("int8", "int8")]
T_TEXT, T_REF, F = 7, 11, 4


def _kw(num_quantizers=2):
    return dict(codebook_size=16, d_model=64, n_layers=2, n_heads=4, d_ff=128, d_style=32,
                max_len=256, num_quantizers=num_quantizers, dtype="bfloat16", scan_chunk=8,
                use_pallas=False)


def _cfgs(num_quantizers=2):
    kw = _kw(num_quantizers)
    return (JDecoderConfig(mamba=JMambaConfig(d_model=64, d_state=4), **kw),
            DecoderConfig(mamba=MambaConfig(d_model=64, d_state=4), **kw))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
                        else np.asarray(a), tree)


def _t(x, dtype=None):
    """numpy / jax array -> torch tensor (bf16 arrays pass through f32, exactly)."""
    if hasattr(x, "dtype") and x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def _f32(t):
    return t.to(torch.float32).numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


class Pair:
    """One set of weights and inputs in both packages."""

    def __init__(self, num_quantizers=2, seed=0, batch=1):
        self.jcfg, self.tcfg = _cfgs(num_quantizers)
        c = self.jcfg
        rng = np.random.default_rng(seed)
        B = self.B = batch
        bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
        self.th = bf(rng.standard_normal((B, T_TEXT, c.d_model)))
        self.z = bf(rng.standard_normal((B, c.d_style)))
        self.rh = bf(rng.standard_normal((B, T_REF, c.d_model)))
        tm = np.ones((B, T_TEXT), bool)
        tm[:, T_TEXT - 2:] = False  # ragged mask
        self.tm, self.rm = tm, np.ones((B, T_REF), bool)
        audio = rng.integers(2, c.vocab_size_audio, (B, c.num_quantizers, 4)).astype(np.int32)
        self.jdec = JDecoder(c)
        self.variables = self.jdec.init(jax.random.PRNGKey(seed), audio, self.th, self.z,
                                        self.tm, self.rh, self.rm)
        self.jq = jqd.quantize_decoder_params(self.variables["params"], c)
        self.tdec = load_params(MambaTTSDecoder(self.tcfg), _np(self.variables["params"])).eval()
        self.tq = tqd.quantize_decoder_params(self.tdec)
        self.total = c.num_quantizers * F
        self.forced = np.concatenate(
            [np.full((B, 1), c.bos_id), rng.integers(2, c.vocab_size_audio, (B, self.total - 1))],
            axis=1).astype(np.int32)  # (B, total)

    # conditioning, once through the JAX package and carried over, so that the
    # plans are compared on equal K/V (project_memories has its own tests)
    def jax_memories(self):
        return self.jdec.apply(self.variables, self.th, self.tm, self.rh, self.rm, self.z,
                               method=JDecoder.project_memories)

    def torch_memories(self):
        KV, mm, films = self.jax_memories()
        return ([(_t(k), _t(v)) for k, v in KV], _t(mm), [(_t(g), _t(b)) for g, b in films])

    def jax_kw(self):
        return dict(text_mask=self.tm, ref_hidden=self.rh, ref_mask=self.rm)

    def torch_args(self, shift=0.0):
        th = _t(self.th)
        if shift:
            th = (th.float() + shift).to(torch.bfloat16)
        return (self.tdec, self.tq, th, _t(self.z), F), dict(
            text_mask=_t(self.tm), ref_hidden=_t(self.rh), ref_mask=_t(self.rm))


@pytest.fixture(scope="module")
def pair1():
    return Pair(batch=1)


@pytest.fixture(scope="module")
def pair2():
    return Pair(batch=2, seed=1)


def _rel(got, want, sp):
    g, w = got[..., sp:], want[..., sp:]
    return float(np.abs(g - w).max() / np.abs(w).max()), float(
        (g.argmax(-1) == w.argmax(-1)).mean())


# ------------------------------------------------------- against the JAX package


@pytest.mark.parametrize("wd,kvd", RUNGS)
def test_plan_fields_match_jax(pair1, wd, kvd):
    """Every field of build_weight_plan and _build_plan: int8 and bf16 fields
    bit for bit, f32 fields to 1e-6.  No 1-LSB exception was needed: both
    sides quantize with the same f32 divisions and round half to even."""
    p = pair1
    jwp = jmk.build_weight_plan(p.jcfg, p.jq, wd)
    twp = tmk.build_weight_plan(p.tcfg, p.tq, wd)
    assert twp._fields == jwp._fields
    KV, mm, films = p.jax_memories()
    jplan = jmk._build_plan(p.jcfg, p.jq, KV, mm, films, F, weight_dtype=wd, kv_dtype=kvd)
    tKV, tmm, tfilms = p.torch_memories()
    tplan = tmk._build_plan(p.tcfg, p.tq, tKV, tmm, tfilms, F, weight_dtype=wd, kv_dtype=kvd,
                            weight_plan=twp)
    assert tplan._fields == jplan._fields
    for plans in ((twp, jwp), (tplan, jplan)):
        for name, got, want in zip(plans[0]._fields, *plans):
            assert tuple(got.shape) == tuple(want.shape), name
            assert str(got.dtype).split(".")[-1] == str(want.dtype), name
            if got.dtype == torch.float32:
                np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6, atol=1e-6,
                                           err_msg=name)
            else:
                np.testing.assert_array_equal(_f32(got), _f32(want), err_msg=name)


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("wd,kvd", RUNGS)
def test_ref_teacher_forced_logits_match_jax_kernel(pair1, pair2, wd, kvd, batch):
    p = pair1 if batch == 1 else pair2
    res = jmk.megakernel_greedy_decode(
        p.jdec, p.variables, p.jq, p.th, p.z, F, collect_logits=True, interpret=True,
        forced_tokens=jnp.asarray(p.forced), weight_dtype=wd, kv_dtype=kvd, **p.jax_kw())
    tKV, tmm, tfilms = p.torch_memories()
    plan = tmk._build_plan(p.tcfg, p.tq, tKV, tmm, tfilms, F, weight_dtype=wd, kv_dtype=kvd)
    out = tmk.decode_megakernel_ref(p.tcfg, plan, F, forced_tokens=_t(p.forced.T))
    assert out.logits.shape == (p.total, batch, 128) and out.logits.dtype == torch.float32
    got = out.logits.transpose(0, 1)[:, :, : p.jcfg.vocab_size_audio].numpy()
    rel, agree = _rel(got, np.asarray(res.logits, np.float32), p.jcfg.num_special_tokens)
    print(f"{wd}/{kvd} B={batch}: rel {rel:.3g}, argmax agreement {agree:.3f}")
    assert rel <= 2e-2, rel
    assert agree >= 0.9, agree


def test_sampled_run_same_gumbel_noise_as_jax_kernel(pair1):
    """The same numpy Gumbel noise through ``_megakernel_call`` of both
    packages: logits agree at every step whose inputs agree (up to the first
    token flip, if the noise leaves one)."""
    p = pair1
    noise = np.random.default_rng(5).gumbel(size=(p.total, 1, 128)).astype(np.float32) * 0.7
    KV, mm, films = p.jax_memories()
    jplan = jmk._build_plan(p.jcfg, p.jq, KV, mm, films, F)
    jl = np.asarray(jmk._megakernel_call(p.jcfg, jplan, F, True, None,
                                         gumbel=jnp.asarray(noise)))
    tKV, tmm, tfilms = p.torch_memories()
    tplan = tmk._build_plan(p.tcfg, p.tq, tKV, tmm, tfilms, F)
    before = tmk._megakernel_call.launches
    tl = tmk._megakernel_call(p.tcfg, tplan, F, gumbel=_t(noise)).logits.numpy()
    assert tmk._megakernel_call.launches == before  # CPU tensors: the plain version
    jt, tt = (jl + noise).argmax(-1)[:, 0], (tl + noise).argmax(-1)[:, 0]
    diff = np.nonzero(jt != tt)[0]
    end = diff[0] + 1 if len(diff) else p.total
    assert end >= p.total // 2, f"streams part at step {end}"
    sp = p.jcfg.num_special_tokens
    rel, _ = _rel(tl[:end, 0, :p.jcfg.vocab_size_audio], jl[:end, 0, :p.jcfg.vocab_size_audio], sp)
    assert rel <= 2e-2, rel


# ------------------------ tests/test_decode_megakernel.py, one for one on the port


def _step_decode_logits(p, forced):
    """Per-step ``quant_step_with_kv`` of the port with forced input tokens."""
    dec, c = p.tdec, p.tcfg
    (_, _, th, z, _), kw = p.torch_args()
    KV, mm, films = dec.project_memories(th, kw["text_mask"], kw["ref_hidden"], kw["ref_mask"], z)
    states = dec.init_states(th.shape[0])
    out = []
    with torch.no_grad():
        for t in range(forced.shape[1]):
            lg, states = tqd.quant_step_with_kv(
                p.tq, c, _t(forced[:, t:t + 1]).long(), KV, mm, films, states,
                torch.tensor([t]), F)
            out.append(lg[:, 0].float())
    return torch.stack(out, dim=1).numpy()  # (B, total, V)


def test_teacher_forced_logits_match_step_scan(pair1):
    p = pair1
    args, kw = p.torch_args()
    sp = p.tcfg.num_special_tokens
    ref = _step_decode_logits(p, p.forced)
    res = tmk.megakernel_greedy_decode(*args, collect_logits=True, forced_tokens=_t(p.forced[0]),
                                       weight_dtype="int8", **kw)
    rel, agree = _rel(res.logits.numpy(), ref, sp)
    assert rel < 3e-2, rel  # identical int8 weights; bf16 op order only
    assert agree >= 0.9, agree
    res_bf = tmk.megakernel_greedy_decode(*args, collect_logits=True,
                                          forced_tokens=_t(p.forced[0]),
                                          weight_dtype="bfloat16", **kw)
    rel_bf, _ = _rel(res_bf.logits.numpy(), ref, sp)
    assert rel_bf < 5e-2, rel_bf  # adds bf16 rounding of the folded weights


def test_greedy_stream_contract():
    p = Pair(num_quantizers=3, seed=3)
    args, kw = p.torch_args()
    res = tmk.megakernel_greedy_decode(*args, collect_logits=True, **kw)
    c = p.tcfg
    total = c.num_quantizers * F
    assert res.tokens.shape == (1, total) and res.logits.shape == (1, total, c.vocab_size_audio)
    toks = res.tokens[0].numpy()
    assert (toks >= c.num_special_tokens).all() and (toks < c.vocab_size_audio).all()
    assert np.isfinite(res.logits[0, :, c.num_special_tokens:].numpy()).all()
    # the first step has no feedback: it must match the step decode's argmax
    ref0 = _step_decode_logits(p, np.full((1, 1), c.bos_id, np.int32))
    assert int(ref0[0, 0, c.num_special_tokens:].argmax()) + c.num_special_tokens == int(toks[0])


def test_sampled_decode(pair1):
    """Gumbel-max sampling: near-zero temperature reproduces greedy; the same
    seed reproduces; different seeds diverge; tokens stay in range."""
    args, kw = pair1.torch_args()
    c = pair1.tcfg

    def run(temperature, seed=None):
        g = None if seed is None else torch.Generator().manual_seed(seed)
        return tmk.megakernel_greedy_decode(*args, temperature=temperature, generator=g,
                                            **kw).tokens.numpy()

    greedy = run(0.0)
    assert (run(1e-4, seed=0) == greedy).all()
    s1, s1b, s2 = run(2.0, seed=1), run(2.0, seed=1), run(2.0, seed=7)
    assert (s1 == s1b).all()
    assert (s1 != s2).any()
    assert (s1 >= c.num_special_tokens).all() and (s1 < c.vocab_size_audio).all()
    with pytest.raises(ValueError):
        run(1.0)  # temperature > 0 with neither generator nor noise


def test_int8_kv_mode_close_to_bf16(pair1):
    args, kw = pair1.torch_args()
    outs = {kvd: tmk.megakernel_greedy_decode(
        *args, collect_logits=True, forced_tokens=_t(pair1.forced[0]), kv_dtype=kvd,
        **kw).logits.numpy() for kvd in ("bfloat16", "int8")}
    rel, agree = _rel(outs["int8"], outs["bfloat16"], pair1.tcfg.num_special_tokens)
    assert rel < 5e-2, rel
    assert agree >= 0.9


def test_batched_matches_per_sequence_runs(pair1):
    """B=2 decode == two independent B=1 decodes of the same inputs (rows
    share weights only; K/V, mask, FiLM and state are per row)."""
    p = pair1
    outs = []
    for shift in (0.0, 0.3):
        args, kw = p.torch_args(shift)
        outs.append(tmk.megakernel_greedy_decode(*args, collect_logits=True, **kw))
    (dec, q, th, z, _), kw = p.torch_args()
    th2 = torch.cat([th, (th.float() + 0.3).to(torch.bfloat16)])
    kw2 = {k: torch.cat([v, v]) for k, v in kw.items()}
    res2 = tmk.megakernel_greedy_decode(dec, q, th2, torch.cat([z, z]), F, collect_logits=True,
                                        **kw2)
    assert res2.tokens.shape == (2, p.total)
    sp = p.tcfg.num_special_tokens
    for row in (0, 1):
        assert torch.equal(res2.tokens[row], outs[row].tokens[0])
        rel, _ = _rel(res2.logits[row].numpy(), outs[row].logits[0].numpy(), sp)
        assert rel < 1e-2, rel


@pytest.mark.parametrize("sampled,teacher_force", [(False, False), (True, False), (False, True)])
def test_plan_resident_bytes_matches_real_plan(pair2, sampled, teacher_force):
    """The planner's shape arithmetic against the tensors one call really
    holds: the kernel's operands, its outputs, state and scratch, and the
    optional noise and forced-token operands, byte for byte on every rung."""
    p = pair2
    c = p.tcfg.with_mamba_dims()
    KV, mm, films = p.torch_memories()
    memory_len = T_REF + T_TEXT
    Vpad = 128
    for wd, kvd in RUNGS:
        plan = tmk._build_plan(c, p.tq, KV, mm, films, F, weight_dtype=wd, kv_dtype=kvd)
        held = list(tmk._kernel_operands(plan).values())
        held += list(tmk._call_buffers(c, p.B, p.total, "cpu").values())
        if sampled:
            held.append(torch.empty((p.total, p.B, Vpad), dtype=torch.float32))
        if teacher_force:
            held.append(torch.empty((p.total, p.B), dtype=torch.int32))
        want = sum(t.numel() * t.element_size() for t in held)
        got = tmk.plan_resident_bytes(c, p.B, memory_len, wd, kvd, sampled=sampled,
                                      teacher_force=teacher_force, total_steps=p.total)
        assert got == want, (wd, kvd, got, want)
    # the default step count is the longest decode the position table allows
    assert tmk.plan_resident_bytes(c, 1, memory_len) == tmk.plan_resident_bytes(
        c, 1, memory_len, total_steps=c.num_quantizers * c.max_len)


def test_megakernel_fit_monotone():
    """Growing batch or memory never yields an earlier rung, past the last
    rung (or the kernel's largest batch) the planner returns None, and a
    budget override moves the boundaries."""
    from mamba_tts_torch.config import TTSConfig

    cfg = TTSConfig().decoder.with_mamba_dims()
    rank = {pair: i for i, pair in enumerate(tmk._DTYPE_LADDER)}
    budget = 120 * 10 ** 6  # small enough that every rung and None appear
    for M in (114, 370, 1250, 2610):
        prev = -1
        for B in range(1, 33):
            fit = tmk.megakernel_fit(cfg, B, M, budget_bytes=budget, total_steps=320)
            r = rank[fit] if fit is not None else len(tmk._DTYPE_LADDER)
            assert r >= prev, (M, B, fit)
            prev = r
        mb = tmk.megakernel_max_batch(cfg, M)
        assert mb == tmk.MEGAKERNEL_MAX_BATCH  # device memory is no limit at these sizes
        assert tmk.megakernel_fit(cfg, mb + 1, M) is None
        assert tmk.megakernel_fit(cfg, mb, M) == tmk._DTYPE_LADDER[0]
    seen = {tmk.megakernel_fit(cfg, B, 1250, budget_bytes=budget, total_steps=320)
            for B in range(1, 9)}
    assert seen == set(tmk._DTYPE_LADDER) | {None}, seen
    assert tmk.megakernel_max_batch(cfg, 1250, cap=3) == 3


def test_precomputed_weight_plan_matches_inline(pair1):
    args, kw = pair1.torch_args()
    for wd, kvd in (("bfloat16", "bfloat16"), ("int8", "int8")):
        wp = tmk.build_weight_plan(pair1.tcfg, pair1.tq, wd)
        a = tmk.megakernel_greedy_decode(*args, collect_logits=True, weight_dtype=wd,
                                         kv_dtype=kvd, **kw)
        b = tmk.megakernel_greedy_decode(*args, collect_logits=True, weight_dtype=wd,
                                         kv_dtype=kvd, weight_plan=wp, **kw)
        assert torch.equal(a.tokens, b.tokens) and torch.equal(a.logits, b.logits)


def test_weight_plan_dtype_mismatch_rejected(pair1):
    args, kw = pair1.torch_args()
    wp_bf16 = tmk.build_weight_plan(pair1.tcfg, pair1.tq, "bfloat16")
    with pytest.raises(ValueError, match="does not match"):
        tmk.megakernel_greedy_decode(*args, weight_dtype="int8", kv_dtype="int8",
                                     weight_plan=wp_bf16, **kw)


def test_wrapper_launches_or_raises_for_card_tensors(pair1, monkeypatch):
    """A tensor on the card never reaches the plain version: with the card
    test stubbed to true on this CUDA-less machine the wrapper goes for the
    kernel's library and fails there instead of falling back."""
    plan = tmk._build_plan(pair1.tcfg, pair1.tq, *pair1.torch_memories(), F)
    monkeypatch.setattr(tmk, "on_card", lambda t: True)
    monkeypatch.setattr(tmk, "decode_megakernel_ref",
                        lambda *a, **k: pytest.fail("fell back to the plain version"))
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py launches the kernel")
    with pytest.raises((RuntimeError, OSError)):
        tmk._megakernel_call(pair1.tcfg, plan, F)
    with pytest.raises(ValueError, match="B <= 8"):
        big = plan._replace(K=plan.K.repeat(1, 9, 1, 1), V=plan.V.repeat(1, 9, 1, 1))
        tmk.check_kernel_args(pair1.tcfg, tmk._kernel_operands(big))


# ------------------------------------------ the redesigned kernel's launch plan


@pytest.mark.parametrize("wd,kvd", RUNGS)
def test_launch_plan_owners_and_shared_memory(wd, kvd):
    """Every d_inner channel and every output column of every product has
    exactly one owning block; each (row, head) unit's ranks split the head's
    q columns; resident slices plus the working set fit a block's shared
    memory; the cluster divides the grid and equals ``memory_slices``.  At
    the small config and at full width, at a 1,536-position memory and at
    the largest one (the position table plus the padded text), on the
    default grid and on the 120 blocks an H100 keeps resident in clusters
    of 8."""
    from mamba_tts_torch.config import TTSConfig

    full = TTSConfig()
    cases = [(_cfgs()[1], (T_REF + T_TEXT,)),
             (full.decoder, (1536, full.decoder.max_len + full.data.max_text_len))]
    for cfg, memories in cases:
        c = cfg.with_mamba_dims()
        m = c.mamba
        d, di, dff, H = c.d_model, m.d_inner, c.d_ff, c.n_heads
        hd, Vpad = d // H, -(-c.vocab_size_audio // 128) * 128
        for M in memories:
            Tmp = -(-M // 128) * 128
            for B in range(1, 9):
                for grid in (None, 120):
                    lp = tmk.launch_plan(c, B, Tmp, wd, kvd, grid=grid)
                    G = lp.grid
                    assert G % lp.cluster == 0 and lp.clusters == G // lp.cluster
                    assert lp.cluster == tmk.memory_slices(B, H, G)
                    for bounds, n in ((lp.chan, di), (lp.cols["in_w"], 2 * di),
                                      (lp.cols["out_w"], d), (lp.cols["o_w"], d),
                                      (lp.cols["ff2_w"], d), (lp.cols["ff1_w"], dff),
                                      (lp.cols["head_w"], Vpad)):
                        assert len(bounds) == G + 1 and bounds[0] == 0 and bounds[-1] == n
                        assert all(a <= b for a, b in zip(bounds[:-1], bounds[1:]))
                    # q: unit u = (b, h) on cluster u % clusters, rank r owns r*qc .. (r+1)*qc
                    assert lp.q_cols * lp.cluster == hd and lp.units == B * H
                    owned = {}
                    for u in range(lp.units):
                        for r in range(lp.cluster):
                            for j in range(r * lp.q_cols, (r + 1) * lp.q_cols):
                                key = (u // H, (u % H) * hd + j)
                                assert key not in owned
                                owned[key] = (u % lp.clusters, r)
                    assert len(owned) == B * d
                    assert lp.smem_bytes + tmk._STATIC_SMEM <= 232_448
                    if "q_w" in lp.resident:
                        assert lp.units <= lp.clusters
    assert len(tmk.stage_names(full.decoder)) <= 66
    assert len(tmk.stage_names(full.decoder)) == 7 * full.decoder.n_layers + 1


def test_kernel_operands_in_proj_block_major(pair1):
    """in_proj's rows (x and z columns of the plan) are a permutation that
    puts each block's x columns and then its z columns together, for any
    grid, and the plan's bytes are unchanged."""
    p = pair1
    plan = tmk._build_plan(p.tcfg, p.tq, *p.torch_memories(), F, weight_dtype="int8")
    di = plan.in_w.shape[2] // 2
    for grid in (128, 120, 7):
        ops = tmk._kernel_operands(plan, grid)
        chan = tmk._bounds(di, grid)
        seen = []
        for g in range(grid):
            lo, hi = chan[g], chan[g + 1]
            cols = list(range(lo, hi)) + list(range(di + lo, di + hi))
            rows = ops["in_w"][:, 2 * lo:2 * hi]
            assert torch.equal(rows, plan.in_w[:, :, cols].transpose(1, 2))
            assert torch.equal(ops["in_s"][:, 2 * lo:2 * hi], plan.in_s[:, 0, cols])
            seen += cols
        assert sorted(seen) == list(range(2 * di))
        assert sum(t.numel() * t.element_size() for t in ops.values()) == sum(
            t.numel() * t.element_size() for t in tmk._kernel_operands(plan).values())


# --------------------- a plain emulation of the redesigned kernel's dataflow


def _emulate(cfg, plan, frames, lp, forced=None):
    """The kernel's dataflow in plain PyTorch, at decode_megakernel_ref's
    rounding points: the x-projection as per-block partial sums over each
    block's channels, added in rank order within each cluster and then in
    cluster order; attention split into the cluster's memory slices, each
    slice's max and sum exchanged, probabilities rounded with the global max
    and sum, and the slices' P @ V parts added in rank order."""
    c = cfg
    m = c.with_mamba_dims().mamba
    L, di, N, H, dc = c.n_layers, m.d_inner, m.d_state, c.n_heads, m.d_conv
    r = m.dt_rank_actual
    p = plan
    BF, F32 = torch.bfloat16, torch.float32
    B, d, Tmp = p.K.shape[1], p.K.shape[2], p.K.shape[3]
    hd, TS = d // H, lp.cluster
    Tc = Tmp // TS
    total = c.num_quantizers * frames
    xp = torch.cat([p.xp_dt, p.xp_B, p.xp_C], dim=2).to(F32)  # (L, di, r + 2N)
    conv_s = torch.zeros((L, dc - 1, B, di), dtype=BF)
    ssm_s = torch.zeros((L, B, N, di), dtype=F32)
    token = torch.full((B,), c.bos_id, dtype=torch.long)
    out = []
    for t in range(total):
        if forced is not None:
            token = forced[t].to(torch.long)
        x = p.token_embed[token] + p.emb_pq[t]
        for l in range(L):
            nb = p.norms[l]
            xz = tmk._dq_dot(tmk._ln(x, nb[0], nb[1]), p.in_w[l], p.in_s[l])
            xin, z = xz[:, :di], xz[:, di:]
            conv_out = xin * p.conv_w[l, dc - 1]
            for k in range(dc - 1):
                conv_out = conv_out + conv_s[l, k] * p.conv_w[l, k]
            conv_out = conv_out + p.conv_b[l].to(BF)
            for k in range(dc - 2):
                conv_s[l, k] = conv_s[l, k + 1]
            conv_s[l, dc - 2] = xin
            xc = tmk._silu(conv_out)
            parts = [xc[:, a:b].to(F32) @ xp[l, a:b] for a, b in zip(lp.chan[:-1], lp.chan[1:])]
            total_sum = torch.zeros_like(parts[0])
            for k in range(lp.clusters):  # clusters in order, each its ranks in order
                cl = torch.zeros_like(parts[0])
                for q in range(TS):
                    cl = cl + parts[k * TS + q]
                total_sum = total_sum + cl
            dbc = total_sum.to(BF)
            dt = tmk._softplus(tmk._dot_bf16(dbc[:, :r], p.dt_w[l]).to(F32) + p.dt_b[l])
            Bm, Cm = dbc[:, r:r + N].to(F32), dbc[:, r + N:].to(F32)
            dtx = dt * xc.to(F32)
            h_new = torch.exp(dt[:, None, :] * p.A[l][None]) * ssm_s[l] + Bm[:, :, None] * dtx[:, None, :]
            ssm_s[l] = h_new
            y = ((Cm[:, :, None] * h_new).sum(dim=1) + xc.to(F32) * p.D[l]).to(BF)
            x = x + tmk._dq_dot(y * tmk._silu(z), p.out_w[l], p.out_s[l])
            q_all = tmk._dq_dot(tmk._ln(x, nb[2], nb[3]), p.q_w[l], p.q_s[l], p.q_b[l])
            qk = (q_all.to(F32) * p.k_scale[l, :, 0]).to(BF).to(F32).view(B, H, hd)
            S = torch.einsum("bhj,bhjt->bht", qk, p.K[l].to(F32).view(B, H, hd, Tmp))
            S = S * hd ** -0.5 + p.mask_row[:, None, :]
            Sl = [S[..., q * Tc:(q + 1) * Tc] for q in range(TS)]
            gmax = torch.stack([s_.max(-1).values for s_ in Sl]).max(0).values[..., None]
            El = [torch.exp(s_ - gmax) for s_ in Sl]
            gsum = torch.zeros_like(gmax)
            for e in El:
                gsum = gsum + e.sum(-1, keepdim=True)
            Vl = p.V[l].to(F32).view(B, Tmp, H, hd)
            O = torch.zeros((B, H, hd), dtype=F32)
            for q, e in enumerate(El):
                O = O + torch.einsum("bht,bthj->bhj", (e / gsum).to(BF).to(F32),
                                     Vl[:, q * Tc:(q + 1) * Tc])
            attn = (O.reshape(B, d) * p.v_scale[l, :, 0]).to(BF)
            x = x + tmk._dq_dot(attn, p.o_w[l], p.o_s[l], p.o_b[l])
            hh = tmk._ln(x, nb[4], nb[5])
            hh = p.gamma[l].to(BF) * hh + p.beta[l].to(BF)
            x = x + tmk._dq_dot(tmk._gelu_exact(tmk._dq_dot(hh, p.ff1_w[l], p.ff1_s[l], p.ff1_b[l])),
                                p.ff2_w[l], p.ff2_s[l], p.ff2_b[l])
        logits = tmk._ln(x, p.norm_out[0], p.norm_out[1]).to(F32) @ p.head_w.to(F32) + p.head_b
        out.append(logits)
        if forced is None:
            token = tmk._first_argmax(logits)
    return torch.stack(out)


@pytest.mark.parametrize("batch,grid", [(1, 128), (2, 40), (2, 7)])
@pytest.mark.parametrize("wd,kvd", RUNGS)
def test_emulated_dataflow_matches_ref_and_jax_kernel(pair1, pair2, wd, kvd, batch, grid):
    """The emulation of the kernel's dataflow against the plain version and
    the JAX kernel (interpret mode), teacher-forced on the same tokens:
    relative max logit error <= 3e-2 and argmax agreement >= 90% (the
    megakernel's limits); clusters of 8 (B = 1), 4 (B = 2 on 40 blocks) and
    1 (B = 2 on 7 blocks: channels spread unevenly)."""
    p = pair1 if batch == 1 else pair2
    tKV, tmm, tfilms = p.torch_memories()
    plan = tmk._build_plan(p.tcfg, p.tq, tKV, tmm, tfilms, F, weight_dtype=wd, kv_dtype=kvd)
    lp = tmk.launch_plan(p.tcfg, batch, plan.K.shape[3], wd, kvd, grid=grid)
    assert lp.cluster == {128: 8, 40: 4, 7: 1}[grid]
    forced = _t(p.forced.T)
    got = _emulate(p.tcfg, plan, F, lp, forced)
    want = tmk.decode_megakernel_ref(p.tcfg, plan, F, forced_tokens=forced).logits
    res = jmk.megakernel_greedy_decode(
        p.jdec, p.variables, p.jq, p.th, p.z, F, collect_logits=True, interpret=True,
        forced_tokens=jnp.asarray(p.forced), weight_dtype=wd, kv_dtype=kvd, **p.jax_kw())
    sp, V = p.jcfg.num_special_tokens, p.jcfg.vocab_size_audio
    g = got.transpose(0, 1)[:, :, :V].numpy()
    for want_ in (want.transpose(0, 1)[:, :, :V].numpy(), np.asarray(res.logits, np.float32)):
        rel, agree = _rel(g, want_, sp)
        assert rel <= 3e-2, rel
        assert agree >= 0.9, agree


def test_emulated_feedback_is_exact(pair1):
    """A free run of the emulation and its teacher-forced rerun on the tokens
    it chose give equal logits: the fed-back token is the argmax."""
    p = pair1
    plan = tmk._build_plan(p.tcfg, p.tq, *p.torch_memories(), F)
    lp = tmk.launch_plan(p.tcfg, 1, plan.K.shape[3])
    free = _emulate(p.tcfg, plan, F, lp)
    tokens = free.argmax(-1)
    forced = torch.cat([torch.full((1, 1), p.tcfg.bos_id), tokens[:-1]])
    assert torch.equal(_emulate(p.tcfg, plan, F, lp, forced), free)
