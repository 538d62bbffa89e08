"""Port decoder against the JAX package: Mamba block, decoder forward and
step, and the plain and int8 greedy decodes, on weights carried across by
``mamba_tts_torch.bridge``.  float32 configs throughout; tolerances are
stated per test."""
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
from mamba_tts_torch.bridge import load_params
from mamba_tts_torch.config import DecoderConfig, MambaConfig
from mamba_tts_torch.infer import quant_decode as tqd
from mamba_tts_torch.models.decoder import MambaTTSDecoder, greedy_decode
from mamba_tts_torch.models.mamba import MambaBlock

KW = dict(codebook_size=24, d_model=32, n_layers=2, n_heads=4, d_ff=64, d_style=16,
          max_len=128, num_quantizers=5, dtype="float32", scan_chunk=8, use_pallas=False)
J_CFG = JDecoderConfig(mamba=JMambaConfig(d_model=32, d_state=4), **KW)
T_CFG = DecoderConfig(mamba=MambaConfig(d_model=32, d_state=4), **KW)
TOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


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
            lg_t, states_t = port.step_with_kv(_t(tok).long(), KV_t, mm_t, films_t, states_t, t, F)
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
            lg, states = port.step_with_kv(flat[:, t:t + 1], KV, mm, films, states, t, F)
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
