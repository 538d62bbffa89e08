"""Port front-ends against the JAX package: G2P phoneme ids, text encoder,
duration predictor, SMSD head and mixture sampling, BERT style encoder and
FACodec, at the smoke config (float32), on weights carried across by
``mamba_tts_torch.bridge``.  Tolerances are stated per test."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_tts_tpu import config as jcl
from mamba_tts_tpu.models.facodec import FACodec as JFACodec
from mamba_tts_tpu.models.smsd import MDNHead as JMDNHead
from mamba_tts_tpu.models.smsd import sample_mixture as j_sample_mixture
from mamba_tts_tpu.models.style_text_encoder import BertEncoder as JBert
from mamba_tts_tpu.models.text_encoder import DurationPredictor as JDur
from mamba_tts_tpu.models.text_encoder import TextEncoder as JTextEncoder
from mamba_tts_tpu.text.processor import PhonemeFrontend as JFrontend
from mamba_tts_torch import config as tcl
from mamba_tts_torch.bridge import bert_from_params, facodec_from_params, load_params
from mamba_tts_torch.models.smsd import MDNHead, sample_mixture
from mamba_tts_torch.models.text_encoder import DurationPredictor, TextEncoder
from mamba_tts_torch.text.processor import PhonemeFrontend

SMOKE = open("tests/smoke_config.json").read()
J_CFG, T_CFG = jcl.from_json(SMOKE), tcl.from_json(SMOKE)
TEXTS = ["Hello world, this is a test.", "The 3 quick foxes read 12 books in 1999!",
         "Dr. Smith's colour-coded schedule", "supercalifragilistic"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def tame_codec_params(params):
    """Halve every FACodec kernel of a JAX random init.  At full LeCun scale
    the random codec drives almost every output sample into tanh saturation,
    where f32 rounding differences between two correct graphs (even one JAX
    graph compiled with and without optimizations) grow to ~1e-2; halved, the
    waveform is well conditioned and the 5e-4 bound is meaningful."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x * 0.5 if "kernel" in jax.tree_util.keystr(path) else x, params)


def test_phoneme_ids_identical():
    want = JFrontend(vocab_path="phoneme_vocab.json").encode_batch(TEXTS, pad_to=64)
    got = PhonemeFrontend(vocab_path="phoneme_vocab.json").encode_batch(TEXTS, pad_to=64)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])


@torch.no_grad()
def test_text_encoder_and_duration_predictor_match_jax():
    rng = np.random.default_rng(0)
    ids = rng.integers(1, J_CFG.text_encoder.vocab_size, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), bool)
    mask[1, 9:] = False
    ids[~mask] = 0
    enc_j, dur_j = JTextEncoder(J_CFG.text_encoder), JDur(J_CFG.duration)
    ep = enc_j.init(jax.random.PRNGKey(0), ids, mask)
    h_j = enc_j.apply(ep, ids, mask)
    dp = dur_j.init(jax.random.PRNGKey(1), h_j, mask)
    d_j = dur_j.apply(dp, h_j, mask)

    enc_t = load_params(TextEncoder(T_CFG.text_encoder), _np(ep["params"]))
    dur_t = load_params(DurationPredictor(T_CFG.duration), _np(dp["params"]))
    h_t = enc_t(_t(ids).long(), _t(mask))
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=1e-4, rtol=1e-4)
    d_t = dur_t(_t(np.asarray(h_j)), _t(mask))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mode", ["isotropic_across_clusters", "isotropic", "diagonal", "fixed"])
@torch.no_grad()
def test_mdn_head_and_injected_sampling_match_jax(mode):
    jc = dataclasses.replace(J_CFG.smsd, variance_mode=mode)
    tc = dataclasses.replace(T_CFG.smsd, variance_mode=mode)
    x = np.random.default_rng(1).standard_normal((3, jc.bert_dim)).astype(np.float32)
    head_j = JMDNHead(jc)
    params = head_j.init(jax.random.PRNGKey(2), x)
    pi_j, mu_j, sig_j = head_j.apply(params, x)
    head_t = load_params(MDNHead(tc), _np(params["params"]))
    pi_t, mu_t, sig_t = head_t(_t(x))
    for got, want in ((pi_t, pi_j), (mu_t, mu_j), (sig_t, sig_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)

    # the JAX draw, with its (k, eps) recovered from the same key split
    key = jax.random.PRNGKey(3)
    y_j = j_sample_mixture(key, pi_j, mu_j, sig_j, mode, jc.fixed_std)
    k_rng, n_rng = jax.random.split(key)
    k = jax.random.categorical(k_rng, jnp.log(pi_j + 1e-8), axis=-1)
    eps = jax.random.normal(n_rng, (x.shape[0], jc.style_dim), jnp.float32)
    y_t = sample_mixture(_t(pi_j), _t(mu_j), _t(sig_j), mode, tc.fixed_std,
                         k=_t(k), eps=_t(eps))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-6, rtol=1e-6)


def test_sample_mixture_draws_from_generator():
    pi = torch.tensor([[0.0, 1.0, 0.0]])
    mu = torch.arange(6.0).reshape(1, 3, 2)
    g = torch.Generator().manual_seed(0)
    y = sample_mixture(pi, mu, torch.zeros(1), generator=g)
    np.testing.assert_array_equal(y.numpy(), [[2.0, 3.0]])  # sigma 0: the mean of mixture 1


@torch.no_grad()
def test_bert_cls_matches_jax():
    rng = np.random.default_rng(4)
    c = J_CFG.style_encoder
    ids = rng.integers(4, c.vocab_size, (2, 10)).astype(np.int32)
    mask = np.ones((2, 10), bool)
    mask[0, 7:] = False
    bert_j = JBert(c)
    params = bert_j.init(jax.random.PRNGKey(5), ids, mask)
    cls_j = bert_j.apply(params, ids, mask)
    bert_t = bert_from_params(T_CFG.style_encoder, _np(params["params"]))
    cls_t = bert_t(_t(ids).long(), _t(mask))
    np.testing.assert_allclose(cls_t.numpy(), np.asarray(cls_j), atol=1e-4, rtol=1e-4)


@torch.no_grad()
def test_facodec_encode_and_decode_match_jax():
    c = J_CFG.codec
    t = np.arange(3 * 1280) / c.sample_rate
    wav = np.stack([0.3 * np.sin(2 * np.pi * 220 * t), 0.2 * np.sin(2 * np.pi * 331 * t + 1.0)])
    wav = wav.astype(np.float32)
    codec_j = JFACodec(c)
    params = tame_codec_params(codec_j.init(jax.random.PRNGKey(6), wav))
    ids_j, spk_j = codec_j.apply(params, wav, method=JFACodec.encode)
    codec_t = facodec_from_params(T_CFG.codec, _np(params["params"]))
    ids_t, spk_t = codec_t.encode(_t(wav))
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))  # exact
    np.testing.assert_allclose(spk_t.numpy(), np.asarray(spk_j), atol=1e-4, rtol=1e-4)

    wav_j = codec_j.apply(params, ids_j, spk_j, method=JFACodec.decode)
    wav_t = codec_t.decode(_t(ids_j).long(), _t(spk_j))
    # tests/test_facodec_convert.py bound
    np.testing.assert_allclose(wav_t.numpy(), np.asarray(wav_j), atol=5e-4)
