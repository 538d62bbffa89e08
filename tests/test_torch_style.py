"""The NAR style branch of the port (``mamba_tts_torch/models/style.py``)
against the JAX package's ``models/style.py``, on weights carried across by
``mamba_tts_torch.bridge``: each module in a float32 config (1e-5) and in
bfloat16 (2e-2 of the largest magnitude), ``length_regulate`` bit for bit,
``MambaTTS.nar_frames`` and ``compute_losses(use_nar_branch=True)`` at the
smoke config.  Inputs come from seeded numpy generators."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_tts_tpu import config as jcl
from mamba_tts_tpu.models import style as jstyle
from mamba_tts_tpu.models import tts as jtts
from mamba_tts_torch import config as tcl
from mamba_tts_torch.bridge import load_params, mamba_tts_from_params
from mamba_tts_torch.models import style as tstyle
from mamba_tts_torch.models.tts import MambaTTS
from mamba_tts_torch.train import train as train_lib

SMOKE = open("tests/smoke_config.json").read()
J_CFG, T_CFG = jcl.from_json(SMOKE), tcl.from_json(SMOKE)
F32_TOL = 1e-5
BF16_TOL = 2e-2  # of the largest magnitude
LOSS_TOL = 1e-4  # tests/test_torch_train.py
GRAD_TOL = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _cfgs(dtype):
    return (dataclasses.replace(J_CFG.style, dtype=dtype),
            dataclasses.replace(T_CFG.style, dtype=dtype))


def _close(got, want, dtype):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    else:
        assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()


def _inputs(c, B=2, T=7, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, c.d_model)).astype(np.float32)
    z = rng.standard_normal((B, c.d_style)).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[1, 5:] = False
    dur = rng.uniform(0.0, 4.0, (B, T)).astype(np.float32)
    return x, z, mask, dur


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("module", ["projection", "cross_attn", "pipeline"])
@torch.no_grad()
def test_style_modules_match_jax(module, dtype):
    jc, tc = _cfgs(dtype)
    x, z, mask, dur = _inputs(jc)
    if module == "projection":
        jm, tm = jstyle.StyleProjection(jc), tstyle.StyleProjection(tc)
        params = jm.init(jax.random.PRNGKey(0), z)
        want, got = jm.apply(params, z), load_params(tm, _np(params["params"]))(_t(z))
    elif module == "cross_attn":
        kv = np.random.default_rng(1).standard_normal((2, 2, 1, jc.d_model)).astype(np.float32)
        jm, tm = jstyle.StyleCrossAttnBlock(jc), tstyle.StyleCrossAttnBlock(tc)
        params = jm.init(jax.random.PRNGKey(1), x, kv[0], kv[1])
        want = (jm.apply(params, x, kv[0], kv[1]),)
        got = (load_params(tm, _np(params["params"]))(_t(x), _t(kv[0]), _t(kv[1])),)
    else:
        jm, tm = jstyle.StyleConditioningPipeline(jc), tstyle.StyleConditioningPipeline(tc)
        params = jm.init(jax.random.PRNGKey(2), x, z, dur, mask, 16)
        want = jm.apply(params, x, z, dur, mask, 16)
        tm = load_params(tm, _np(params["params"]))
        got = tm(_t(x), _t(z), _t(dur), _t(mask), 16)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        want, got = (want[0], want[2], want[3]), (got[0], got[2], got[3])
        # training mode with target durations is the same call
        again = tm.forward_with_target(_t(x), _t(z), _t(dur), _t(mask), 16)
        assert torch.equal(again[0], got[0])
    for g, w in zip(got, want):
        _close(g, w, dtype)


@pytest.mark.parametrize("max_len", [12, 24])
def test_length_regulate_is_bit_equal(max_len):
    """Half-integer durations (round half to even), zeros, negatives,
    masked phonemes, and a total beyond ``max_len`` (12): the same frames,
    zeros past each row's total, and the total reported unclipped."""
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((3, 6, 5)).astype(np.float32)
    dur = np.array([[0.5, 1.5, 2.5, 0.0, 3.49, 1.0],
                    [2.0, 0.0, -1.0, 4.5, 0.5, 2.5],
                    [5.0, 4.0, 3.5, 2.0, 1.0, 0.0]], np.float32)
    mask = np.ones((3, 6), bool)
    mask[1, 4:] = False
    dur = dur * mask
    want, want_len = jstyle.length_regulate(jnp.asarray(hidden), jnp.asarray(dur), max_len)
    got, got_len = tstyle.length_regulate(_t(hidden), _t(dur), max_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert got_len.dtype == torch.int32
    np.testing.assert_array_equal(got_len.numpy(), [8, 6, 16])
    for bf16 in (False, True):  # a bf16 hidden keeps its dtype
        h = _t(hidden).bfloat16() if bf16 else _t(hidden)
        assert tstyle.length_regulate(h, _t(dur), max_len)[0].dtype == h.dtype


def _batch(cfg, B=2, L=12, S=20, seed=0):
    rng = np.random.default_rng(seed)
    Q, V = cfg.decoder.num_quantizers, cfg.decoder.vocab_size_audio
    text_mask = np.arange(L)[None] < np.array([[L], [9]])
    target = rng.integers(2, V, (B, S, Q)).astype(np.int32)
    target[1, 15:] = 0
    return {
        "phoneme_ids": (rng.integers(1, cfg.text_encoder.vocab_size, (B, L)) * text_mask).astype(np.int32),
        "text_mask": text_mask,
        "style_bert": rng.standard_normal((B, cfg.smsd.bert_dim)).astype(np.float32),
        "spk_embs": rng.standard_normal((B, cfg.smsd.style_dim)).astype(np.float32),
        "target_codec": target,
        "target_frames": np.array([S, 15], np.int32),
        "voice_codec": rng.integers(2, V, (B, S, Q)).astype(np.int32),
    }


@pytest.fixture(scope="module")
def model_setup():
    batch = _batch(J_CFG)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = jtts.MambaTTS(J_CFG)
    sample_rng = jax.random.PRNGKey(3)
    params = jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
         "noise": jax.random.PRNGKey(2)}, jb, sample_rng, use_nar_branch=True,
        method=jtts.MambaTTS.compute_losses))()["params"]
    return dict(model=model, params=params, batch=batch, jb=jb, sample_rng=sample_rng,
                port=mamba_tts_from_params(T_CFG, _np(params)))


@torch.no_grad()
def test_nar_frames_matches_jax(model_setup):
    s = model_setup
    rng = np.random.default_rng(4)
    th = rng.standard_normal((2, 9, J_CFG.style.d_model)).astype(np.float32)
    z = rng.standard_normal((2, J_CFG.style.d_style)).astype(np.float32)
    dur = rng.uniform(0.0, 5.0, (2, 9)).astype(np.float32)
    mask = np.ones((2, 9), bool)
    mask[0, 6:] = False
    want = s["model"].apply({"params": s["params"]}, th, z, dur, mask, 32,
                            method=jtts.MambaTTS.nar_frames)
    got = s["port"].nar_frames(_t(th), _t(z), _t(dur), _t(mask), 32)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in zip((got[0], got[2], got[3]), (want[0], want[2], want[3])):
        _close(g, w, "float32")


def test_compute_losses_with_the_branch_match_jax_and_consume_nothing(model_setup):
    """With the branch, the four losses equal JAX's (same key split for the
    style draw), equal the port's own without the branch (deterministic, and
    with dropout from one seed, since the branch draws last), and every
    ``style_pipe`` gradient is exactly zero, as in JAX."""
    s = model_setup

    def loss_fn(p):
        out = s["model"].apply({"params": p}, s["jb"], s["sample_rng"], deterministic=True,
                               use_nar_branch=True, method=jtts.MambaTTS.compute_losses)
        return out["loss_total"], out

    (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(s["params"])
    pi, _, _ = s["model"].apply({"params": s["params"]}, s["jb"]["style_bert"], True,
                                method=lambda m, x, d: m.smsd(x, deterministic=d))
    k_rng, n_rng = jax.random.split(s["sample_rng"])
    k = _t(jax.random.categorical(k_rng, jnp.log(pi + 1e-8), axis=-1))
    eps = _t(jax.random.normal(n_rng, (pi.shape[0], J_CFG.smsd.style_dim), jnp.float32))

    port = mamba_tts_from_params(T_CFG, _np(s["params"]))
    batch = train_lib.batch_to_device(s["batch"], torch.device("cpu"))
    with_branch = port.compute_losses(batch, deterministic=True, style_k=k, style_eps=eps,
                                      use_nar_branch=True)
    with torch.no_grad():
        without = port.compute_losses(batch, deterministic=True, style_k=k, style_eps=eps)
    for key in ("loss_total", "loss_codec", "loss_dur", "loss_smsd"):
        w = float(want[key])
        assert abs(float(with_branch[key].detach()) - w) <= LOSS_TOL * abs(w), key
        assert torch.equal(with_branch[key].detach(), without[key]), key
    with_branch["loss_total"].backward()
    want_grads = dict(load_params(MambaTTS(T_CFG), _np(grads)).named_parameters())
    n_style = 0
    for name, p in port.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        w = want_grads[name].detach()
        if name.startswith("style_pipe."):
            n_style += 1
            assert not torch.any(w) and not torch.any(g), name
        else:
            assert float((g - w).abs().max()) <= GRAD_TOL * float(w.abs().max()) + 1e-7, name
    assert n_style == len(list(port.style_pipe.parameters())) > 0

    with torch.no_grad():  # training mode: dropout from one seed, with and without
        drawn = [port.compute_losses(batch, generator=torch.Generator().manual_seed(7),
                                     use_nar_branch=branch) for branch in (True, False)]
    for key in drawn[0]:
        assert torch.equal(drawn[0][key], drawn[1][key]), key
