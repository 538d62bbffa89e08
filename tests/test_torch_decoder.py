"""Port decoder against the JAX package: Mamba block, decoder forward and
step, and the plain and int8 greedy decodes, on weights carried across by
``mamba_tts_torch.bridge``.  float32 configs throughout; tolerances are
stated per test."""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_tts_tpu.config import DecoderConfig as JDecoderConfig
from mamba_tts_tpu.config import MambaConfig as JMambaConfig
from mamba_tts_tpu.infer import quant_decode as jqd
from mamba_tts_tpu.models.decoder import MambaTTSDecoder as JDecoder
from mamba_tts_tpu.models.decoder import greedy_decode as j_greedy_decode
from mamba_tts_tpu.models.mamba import MambaBlock as JMambaBlock
from mamba_tts_torch import config as config_lib
from mamba_tts_torch.bridge import load_params
from mamba_tts_torch.config import DecoderConfig, MambaConfig
from mamba_tts_torch.infer import quant_decode as tqd
from mamba_tts_torch.infer.synthesize import Synthesizer
from mamba_tts_torch.models import hybrid
from mamba_tts_torch.models.decoder import (
    DecodeResult,
    MambaTTSDecoder,
    decode_step_,
    graph_split,
    greedy_decode,
    init_carry,
    next_token,
)
from mamba_tts_torch.models.layers import Dense, seed_init
from mamba_tts_torch.models.mamba import MambaBlock
from mamba_tts_torch.models.tts import MambaTTS

KW = dict(codebook_size=24, d_model=32, n_layers=2, n_heads=4, d_ff=64, d_style=16,
          max_len=128, num_quantizers=5, dtype="float32", scan_chunk=8, use_pallas=False)
J_CFG = JDecoderConfig(mamba=JMambaConfig(d_model=32, d_state=4), **KW)
T_CFG = DecoderConfig(mamba=MambaConfig(d_model=32, d_state=4), **KW)
TOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def run_decode_loop(step_fn, batch, total, temperature=0.0, top_k=0, generator=None):
    """The functional autoregressive loop over Python-int steps, the
    reference the in-place decodes are held to: ``step_fn(token (B, 1),
    step (1,)) -> logits (B, 1, V)`` carries its own state."""
    token = torch.full((batch, 1), T_CFG.bos_id, dtype=torch.long)
    tokens, logits = [], []
    for step in range(total):
        step_logits, token = next_token(step_fn(token, torch.tensor([step]))[:, 0],
                                        T_CFG.num_special_tokens, temperature, top_k, generator)
        tokens.append(token)
        logits.append(step_logits)
    return DecodeResult(tokens=torch.cat(tokens, dim=1), logits=torch.stack(logits, dim=1))


def assert_streams_agree(port_tokens, jax_tokens, jax_logits, margin=1e-3, min_agree=0.99):
    """Greedy streams must be equal, except where random weights leave the
    JAX top-2 logits within ``margin``; such flips are printed, and at least
    ``min_agree`` of the tokens must still agree."""
    port_tokens, jax_tokens = np.asarray(port_tokens), np.asarray(jax_tokens)
    flips = np.argwhere(port_tokens != jax_tokens)
    if len(flips) == 0:
        return
    top2 = np.sort(np.asarray(jax_logits), axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    for b, t in flips:
        print(f"near-tie flip at row {b} step {t}: JAX top-2 margin {gap[b, t]:.3g}")
    assert all(gap[b, t] < margin for b, t in flips), "a flip at a clear margin"
    assert (port_tokens == jax_tokens).mean() >= min_agree


def assert_logits_until_flip(port_logits, jax_logits, port_tokens, jax_tokens, tol=TOL):
    """Logits agree at every step whose inputs agree: up to and including
    each row's first token flip."""
    port_tokens, jax_tokens = np.asarray(port_tokens), np.asarray(jax_tokens)
    for b in range(port_tokens.shape[0]):
        diff = np.nonzero(port_tokens[b] != jax_tokens[b])[0]
        end = diff[0] + 1 if len(diff) else port_tokens.shape[1]
        np.testing.assert_allclose(np.asarray(port_logits)[b, :end],
                                   np.asarray(jax_logits)[b, :end], atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def setup():
    dec = JDecoder(J_CFG)
    rng = np.random.default_rng(0)
    B, Q, F, Tt, Tr = 2, J_CFG.num_quantizers, 6, 7, 9
    at = rng.integers(2, J_CFG.vocab_size_audio, (B, Q, F)).astype(np.int32)
    th = rng.standard_normal((B, Tt, J_CFG.d_model)).astype(np.float32)
    z = rng.standard_normal((B, J_CFG.d_style)).astype(np.float32)
    rh = rng.standard_normal((B, Tr, J_CFG.d_model)).astype(np.float32)
    tm = np.array([[True] * Tt, [True] * (Tt - 2) + [False] * 2])
    rm = np.ones((B, Tr), bool)
    variables = dec.init(jax.random.PRNGKey(0), at, th, z, tm, rh, rm)
    port = load_params(MambaTTSDecoder(T_CFG), _np(variables["params"]))
    return dict(dec=dec, variables=variables, port=port, at=at, th=th, z=z, tm=tm, rh=rh,
                rm=rm, F=F)


def test_mamba_block_step_and_forward_match_jax():
    mcfg_j, mcfg_t = JMambaConfig(d_model=16, d_state=4), MambaConfig(d_model=16, d_state=4)
    block_j = JMambaBlock(mcfg_j, dtype=jnp.float32)
    x = np.random.default_rng(1).standard_normal((2, 6, 16)).astype(np.float32)
    params = block_j.init(jax.random.PRNGKey(1), x)
    block_t = load_params(MambaBlock(mcfg_t, dtype=torch.float32), _np(params["params"]))

    with torch.no_grad():
        y_j, _ = block_j.apply(params, x)
        y_t, _ = block_t(_t(x))
        np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), atol=2e-4, rtol=2e-4)

        st_j = block_j.apply(params, 2, method=JMambaBlock.init_state)
        st_t = block_t.init_state(2)
        for t in range(x.shape[1]):
            o_j, st_j = block_j.apply(params, x[:, t:t + 1], st_j, method=JMambaBlock.step)
            o_t, st_t = block_t.step(_t(x[:, t:t + 1]), st_t)
            # tests/test_mamba_block.py:53 tolerance
            np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j), atol=2e-4, rtol=2e-4)
        np.testing.assert_allclose(st_t.ssm.numpy(), np.asarray(st_j.ssm), atol=2e-4, rtol=2e-4)


def test_decoder_forward_logits_match_jax(setup):
    s = setup
    want = s["dec"].apply(s["variables"], s["at"], s["th"], s["z"], s["tm"], s["rh"], s["rm"])
    with torch.no_grad():
        got = s["port"](_t(s["at"]).long(), _t(s["th"]), _t(s["z"]), _t(s["tm"]), _t(s["rh"]),
                        _t(s["rm"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_step_with_kv_logits_match_jax(setup):
    s = setup
    dec, v, port, F = s["dec"], s["variables"], s["port"], s["F"]
    KV, mm, films = dec.apply(v, s["th"], s["tm"], s["rh"], s["rm"], s["z"],
                              method=JDecoder.project_memories)
    states = dec.init_states(2)
    with torch.no_grad():
        KV_t, mm_t, films_t = port.project_memories(_t(s["th"]), _t(s["tm"]), _t(s["rh"]),
                                                    _t(s["rm"]), _t(s["z"]))
        states_t = port.init_states(2)
        flat = s["at"].reshape(2, -1)
        for t in range(12):
            tok = flat[:, t:t + 1]
            lg, states = dec.apply(v, tok, KV, mm, films, states, jnp.asarray(t), F,
                                   method=JDecoder.step_with_kv)
            lg_t, states_t = port.step_with_kv(_t(tok).long(), KV_t, mm_t, films_t, states_t,
                                               torch.tensor([t]), F)
            np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg), atol=TOL, rtol=TOL)


def test_port_decode_matches_forward_prefix(setup):
    """Feeding a sequence step by step reproduces the port's own
    teacher-forced logits (tests/test_decoder.py:83 tolerance)."""
    s = setup
    port, F = s["port"], s["F"]
    tokens = _t(s["at"]).long()
    with torch.no_grad():
        full = port(tokens, _t(s["th"]), _t(s["z"]), _t(s["tm"]), _t(s["rh"]), _t(s["rm"]))
        KV, mm, films = port.project_memories(_t(s["th"]), _t(s["tm"]), _t(s["rh"]),
                                              _t(s["rm"]), _t(s["z"]))
        states = port.init_states(2)
        flat = tokens.reshape(2, -1)
        steps = []
        for t in range(flat.shape[1]):
            lg, states = port.step_with_kv(flat[:, t:t + 1], KV, mm, films, states,
                                           torch.tensor([t]), F)
            steps.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("mode", ["none", "int8", "int8_kv"])
def test_greedy_decode_matches_jax(setup, mode):
    s = setup
    dec, v, port, F = s["dec"], s["variables"], s["port"], s["F"]
    kw = dict(text_mask=s["tm"], ref_hidden=s["rh"], ref_mask=s["rm"], collect_logits=True)
    if mode == "none":
        res_j = jax.jit(lambda: j_greedy_decode(dec, v, s["th"], s["z"], F, **kw))()
    else:
        qp_j = jqd.quantize_decoder_params(v["params"], J_CFG)
        res_j = jax.jit(lambda: jqd.greedy_decode_int8(
            dec, v, qp_j, s["th"], s["z"], F, int8_kv=mode == "int8_kv", **kw))()
    tkw = dict(text_mask=_t(s["tm"]), ref_hidden=_t(s["rh"]), ref_mask=_t(s["rm"]),
               collect_logits=True)
    if mode == "none":
        res_t = greedy_decode(port, _t(s["th"]), _t(s["z"]), F, **tkw)
    else:
        qp_t = tqd.quantize_decoder_params(port)
        for name in ("in_proj", "ff2"):  # the int8 trees agree bit for bit
            np.testing.assert_array_equal(qp_t["layers"][1][name]["w_q"].numpy(),
                                          np.asarray(qp_j["layers"][1][name]["w_q"]))
        res_t = tqd.greedy_decode_int8(port, qp_t, _t(s["th"]), _t(s["z"]), F,
                                       int8_kv=mode == "int8_kv", **tkw)
    assert res_t.tokens.shape == (2, J_CFG.num_quantizers * F)
    assert_streams_agree(res_t.tokens.numpy(), res_j.tokens, res_j.logits)
    assert_logits_until_flip(res_t.logits.numpy(), res_j.logits, res_t.tokens.numpy(),
                             res_j.tokens)


@pytest.mark.parametrize("mode", ["int8", "int8_kv"])
def test_in_place_step_decode_matches_jax_and_python_int_loop(setup, mode):
    """The captured decode's step (device step index, token/logits written by
    index, states copied in place), run eagerly on the CPU for all 30 steps
    (five quantizer streams of 6 frames: four quantizer boundaries), against
    JAX's ``greedy_decode_int8`` and, exactly, against the loop of
    ``quant_step_with_kv`` over Python-int steps with returned states."""
    s = setup
    dec, v, port, F = s["dec"], s["variables"], s["port"], s["F"]
    int8_kv = mode == "int8_kv"
    qp_j = jqd.quantize_decoder_params(v["params"], J_CFG)
    res_j = jax.jit(lambda: jqd.greedy_decode_int8(
        dec, v, qp_j, s["th"], s["z"], F, text_mask=s["tm"], ref_hidden=s["rh"],
        ref_mask=s["rm"], collect_logits=True, int8_kv=int8_kv))()
    qp = tqd.quantize_decoder_params(port)
    total = T_CFG.num_quantizers * F
    with torch.no_grad():
        KV, mm, films = port.project_memories(_t(s["th"]), _t(s["tm"]), _t(s["rh"]),
                                              _t(s["rm"]), _t(s["z"]))
        if int8_kv:
            KV = tqd.quantize_kv(KV)
        carry = tqd.init_carry(T_CFG, 2, total, port.dtype, torch.device("cpu"), True)
        for _ in range(total):
            decode_step_(lambda tok, st, i: tqd.quant_step_with_kv(qp, T_CFG, tok, KV, mm, films,
                                                                   st, i, F),
                         carry, T_CFG.num_special_tokens)
        states = port.init_states(2)

        def step_fn(token, step):
            nonlocal states
            logits, states = tqd.quant_step_with_kv(qp, T_CFG, token, KV, mm, films, states,
                                                    step, F)
            return logits

        loop = run_decode_loop(step_fn, 2, total)
    assert int(carry.step) == total
    assert_streams_agree(carry.tokens.numpy(), res_j.tokens, res_j.logits)
    assert_logits_until_flip(carry.logits.numpy(), res_j.logits, carry.tokens.numpy(),
                             res_j.tokens)
    assert torch.equal(carry.tokens, loop.tokens)
    assert torch.equal(carry.logits, loop.logits)
    for got, want in zip(carry.states, states):
        assert torch.equal(got.conv, want.conv) and torch.equal(got.ssm, want.ssm)


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_in_place_none_step_decode_equals_the_functional_loop(setup, temperature):
    """``greedy_decode`` (quant "none"): its in-place step (device step
    index, token and logits written by index, states copied in place), run
    eagerly on the CPU for all 30 steps, gives the tokens and, bit for bit,
    the logits and states of the functional ``step_with_kv`` loop over
    Python-int steps; greedy, and sampled with top-k from one seed on both
    sides (the same draws)."""
    s = setup
    port, F = s["port"], s["F"]
    cond = (_t(s["th"]), _t(s["tm"]), _t(s["rh"]), _t(s["rm"]), _t(s["z"]))
    total = T_CFG.num_quantizers * F
    with torch.no_grad():
        got = greedy_decode(port, cond[0], cond[4], F, text_mask=cond[1], ref_hidden=cond[2],
                            ref_mask=cond[3], temperature=temperature, top_k=8,
                            generator=torch.Generator().manual_seed(11), collect_logits=True)
        KV, mm, films = port.project_memories(*cond)
        carry = init_carry(T_CFG, 2, total, port.dtype, torch.device("cpu"), True)
        g = torch.Generator().manual_seed(11)
        for _ in range(total):  # the in-place step alone, for its states
            decode_step_(lambda tok, st, i: port.step_with_kv(tok, KV, mm, films, st, i, F),
                         carry, T_CFG.num_special_tokens, temperature, 8, g)
        states = port.init_states(2)

        def step_fn(token, step):
            nonlocal states
            logits, states = port.step_with_kv(token, KV, mm, films, states, step, F)
            return logits

        loop = run_decode_loop(step_fn, 2, total, temperature, 8,
                               torch.Generator().manual_seed(11))
    for res in (got, carry):
        assert torch.equal(res.tokens, loop.tokens)
        assert torch.equal(res.logits, loop.logits)
    assert int(carry.step) == total
    for st, want in zip(carry.states, states):
        assert torch.equal(st.conv, want.conv) and torch.equal(st.ssm, want.ssm)


@pytest.mark.parametrize("steps_per_graph", [1, 4, 5])
def test_graph_split_covers_every_step(steps_per_graph):
    """The captured decode runs 1 to ``steps_per_graph`` eager warm-up steps,
    then whole graphs, and covers every step of any length."""
    for total in range(1, 60):
        warm, replays = graph_split(total, steps_per_graph)
        assert 1 <= warm <= steps_per_graph
        assert warm + replays * steps_per_graph == total


# ------------------------------------------------- the decoder as served

SMOKE = config_lib.from_json(open("tests/smoke_config.json").read())


def _served_cfg(kind):
    """The smoke configuration with a bf16 decoder: the default decoder
    (the layers of ``tts512x8`` at a small width) or a small jamba decoder
    (4 layers, attention at layer 2)."""
    if kind == "default":
        dec = dataclasses.replace(SMOKE.decoder, dtype="bfloat16")
    else:
        dec = DecoderConfig(
            block="jamba", codebook_size=SMOKE.decoder.codebook_size, d_model=64, n_layers=4,
            n_heads=4, n_kv_heads=1, d_ff=128, d_style=SMOKE.decoder.d_style, max_len=64,
            num_quantizers=SMOKE.decoder.num_quantizers, attn_layer_offset=2,
            attn_layer_period=4, dtype="bfloat16",
            mamba=MambaConfig(d_model=64, d_state=16, dt_rank=4))
    return dataclasses.replace(SMOKE, decoder=dec)


def _served_model(kind, mesh=None):
    """(a seeded model, an untouched copy of it); every bias nonzero, so
    that each one's storage is tested."""
    model = seed_init(MambaTTS(_served_cfg(kind), mesh=mesh), 0).eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for n, p in model.decoder.named_parameters():
            if n.endswith(".bias"):
                p.add_((0.1 * torch.randn(p.shape, generator=g)).to(p.dtype))
    return model, copy.deepcopy(model)


def _served_decode(kind, dec):
    """Tokens and logits of a 2-row decode of 6 frames a stream."""
    g = torch.Generator().manual_seed(2)
    B, F_ = 2, 6
    th = torch.randn((B, 7, SMOKE.text_encoder.d_model), generator=g)
    z = torch.randn((B, dec.cfg.d_style), generator=g)
    mask = torch.arange(7)[None] < torch.tensor([[7], [4]])
    rh = torch.randn((B, 9, dec.cfg.d_model), generator=g)
    if kind == "jamba":
        return hybrid.hybrid_greedy_decode(dec, th, z, F_, text_mask=mask, ref_hidden=rh,
                                           collect_logits=True)
    return greedy_decode(dec, th.bfloat16(), z, F_, text_mask=mask, ref_hidden=rh.bfloat16(),
                         collect_logits=True)


def _dense_tensors(dec):
    return {f"{n}.{k}": t for n, m in dec.named_modules() if isinstance(m, Dense)
            for k, t in (("weight", m.weight), ("bias", m.bias)) if t is not None}


@pytest.mark.parametrize("kind", ["default", "jamba"])
def test_a_served_decoder_holds_its_products_weights_in_the_compute_dtype(kind):
    """``Synthesizer(quant="none")`` stores every bf16 product's weight and
    bias in bf16, the values its float32 masters round to; the f32 head,
    the norms, A_log, D, the conv taps and bias and the embeddings are
    left as they were."""
    model, masters = _served_model(kind)
    dec = Synthesizer(_served_cfg(kind), model, device="cpu").decoder
    assert dec is model.decoder
    held, want = _dense_tensors(dec), _dense_tensors(masters.decoder)
    bf16 = {n for n in held if not n.startswith("head.")}
    assert bf16 and all(held[n].dtype == torch.bfloat16 for n in bf16)
    assert all(torch.equal(held[n], want[n].to(torch.bfloat16)) for n in bf16)
    before = dict(masters.decoder.named_parameters())
    rest = {n: p for n, p in dec.named_parameters() if n not in held}
    assert any(n.endswith("A_log") for n in rest) and any("conv_w" in n for n in rest)
    for n, p in [*rest.items(), *((n, held[n]) for n in held if n.startswith("head."))]:
        assert p.dtype == before[n].dtype and torch.equal(p, before[n]), n
    # the default decoder's conv taps stay f32 (``conv_step`` reads them so)
    assert kind == "jamba" or all(p.dtype == torch.float32 for n, p in rest.items())


@pytest.mark.parametrize("kind", ["default", "jamba"])
def test_a_served_decoder_decodes_bit_equal_to_its_float32_masters(kind):
    """The held decoder's greedy tokens and every step's logits equal, bit
    for bit, those of the same weights left as built."""
    model, masters = _served_model(kind)
    Synthesizer(_served_cfg(kind), model, device="cpu")
    got, want = _served_decode(kind, model.decoder), _served_decode(kind, masters.decoder)
    assert torch.equal(got.tokens, want.tokens) and torch.equal(got.logits, want.logits)
    assert got.logits.shape[1] == SMOKE.decoder.num_quantizers * 6


class _GroupMesh:
    """Enough of a mesh to build a model on: one data rank, ``tp`` model
    ranks, this rank 0, groups as tokens."""
    mesh_dim_names = ("data", "model")

    def __init__(self, tp):
        self.shape = (1, tp)

    def size(self, i):
        return self.shape[i]

    def get_group(self, axis):
        return f"group:{axis}"

    def get_local_rank(self, axis):
        return 0


@pytest.mark.parametrize("case", ["int8", "megakernel", "tensor_parallel"])
def test_quantized_and_tensor_parallel_decoders_keep_their_float32_masters(case):
    """The int8 and megakernel paths quantize the float32 masters, and a
    tensor-parallel decoder adds its f32 bias after the reduce: the
    Synthesizer leaves their storage as built, and quantizing it gives the
    tensors an untouched decoder gives."""
    mesh = _GroupMesh(2) if case == "tensor_parallel" else None
    model, masters = _served_model("default", mesh)
    synth = Synthesizer(_served_cfg("default"), model, device="cpu",
                        quant="none" if case == "tensor_parallel" else case)
    if mesh is not None:
        assert synth.decoder.layers[0].tp_group == "group:model"
    before = dict(masters.decoder.named_parameters())
    for n, p in synth.decoder.named_parameters():
        assert p.dtype == torch.float32 and torch.equal(p, before[n]), n
    got = synth._qparams or tqd.quantize_decoder_params(synth.decoder)
    want = tqd.quantize_decoder_params(masters.decoder)
    flat_got, flat_want = (jax.tree_util.tree_leaves(t) for t in (got, want))
    assert len(flat_got) == len(flat_want)
    assert all(torch.equal(a, b) for a, b in zip(flat_got, flat_want))
