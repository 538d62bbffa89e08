"""The serving slice as a whole: the port's ``Synthesizer`` against the JAX
package's, at the smoke config (float32), in the none, int8 and int8_kv
decode modes, on weights carried across by ``mamba_tts_torch.bridge``.

Both sides get the same text, style prompt, voice waveform and frame budget.
``torch.Generator`` cannot reproduce ``jax.random``, so the JAX side's style
sample ``z_style`` is recomputed outside its jit (same key split as
``mamba_tts_tpu/infer/synthesize.py:200-202``) and injected into the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_tts_tpu import config as jcl
from mamba_tts_tpu.audio.codec import FACodecTokenizer as JTokenizer
from mamba_tts_tpu.infer import quant_decode as jqd
from mamba_tts_tpu.infer.synthesize import Synthesizer as JSynthesizer
from mamba_tts_tpu.infer.synthesize import load_synthesizer as j_load_synthesizer
from mamba_tts_tpu.models.decoder import MambaTTSDecoder as JDecoder
from mamba_tts_tpu.models.tts import MambaTTS as JMambaTTS
from mamba_tts_torch import config as tcl
from mamba_tts_torch.audio.codec import FACodecTokenizer
from mamba_tts_torch.bridge import bert_from_params, facodec_from_params, mamba_tts_from_params
from mamba_tts_torch.infer import quant_decode as tqd
from mamba_tts_torch.infer.synthesize import Synthesizer, load_synthesizer
from mamba_tts_torch.models.style_text_encoder import StyleTextEncoder

SMOKE = open("tests/smoke_config.json").read()
J_CFG, T_CFG = jcl.from_json(SMOKE), tcl.from_json(SMOKE)
TEXT, STYLE, SEED = "hello world, good day", "speak fast", 0
LOGIT_TOL = 1e-4
WAV_TOL = 5e-4  # tests/test_facodec_convert.py bound


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _voice():
    t = np.arange(3200) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)


def tame_codec_params(params):
    """Halve every FACodec kernel of the JAX random init, which otherwise
    drives almost every output sample into tanh saturation, where f32
    rounding differences between two correct graphs grow to ~1e-2 (see
    tests/test_torch_frontends.py)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x * 0.5 if "kernel" in jax.tree_util.keystr(path) else x, params)


@pytest.fixture(scope="module")
def pair():
    """The JAX synthesizer's weights, front-ends and inputs, and the port's
    modules carrying the same weights."""
    js = j_load_synthesizer(J_CFG)
    jtok = JTokenizer(J_CFG.codec, params=tame_codec_params(js.tokenizer.params))
    model = mamba_tts_from_params(T_CFG, _np(js.params))
    ttok = FACodecTokenizer(T_CFG.codec, module=facodec_from_params(T_CFG.codec, _np(jtok.params)),
                            device="cpu")
    tbert = StyleTextEncoder(T_CFG.style_encoder, device="cpu", module=bert_from_params(
        T_CFG.style_encoder, _np(js.style_encoder.params)))
    ids, _, mask = js.frontend.encode_batch([TEXT], pad_to=J_CFG.data.max_text_len)
    style_bert = np.asarray(js.style_encoder.embed([STYLE]))
    voice = _voice()
    mvars = {"params": js.params}
    style_rng, _ = jax.random.split(jax.random.PRNGKey(SEED))
    z = jax.jit(lambda p, b, r: JMambaTTS(J_CFG).apply(
        {"params": p}, b, r, method=JMambaTTS.sample_style))(js.params, style_bert, style_rng)
    return dict(js=js, jtok=jtok, model=model, ttok=ttok, tbert=tbert, ids=ids, mask=mask,
                style_bert=style_bert, voice=voice, mvars=mvars, z=np.asarray(z))


def _synths(pair, quant):
    js = pair["js"]
    jsyn = JSynthesizer(J_CFG, js.params, tokenizer=pair["jtok"], frontend=js.frontend,
                        style_encoder=js.style_encoder, quant=quant)
    tsyn = Synthesizer(T_CFG, pair["model"], tokenizer=pair["ttok"],
                       style_encoder=pair["tbert"], quant=quant, device="cpu")
    return jsyn, tsyn


def _jax_teacher_forced(pair, jsyn, voice_codec, tokens, frames):
    """Per-step JAX logits (B, T, V) with the JAX token stream fed back."""
    model, dec, mvars = JMambaTTS(J_CFG), JDecoder(J_CFG.decoder.with_mamba_dims()), pair["mvars"]
    th = model.apply(mvars, pair["ids"], pair["mask"], method=JMambaTTS.encode_text)
    rh, rm = model.apply(mvars, voice_codec, method=JMambaTTS.embed_voice)
    dvars = {"params": jsyn.params["decoder"]}
    KV, mm, films = dec.apply(dvars, th, pair["mask"], rh, rm, pair["z"],
                              method=JDecoder.project_memories)
    if jsyn.quant == "int8_kv":
        KV = jqd.quantize_kv(KV)
    qp = jsyn._qparams

    @jax.jit
    def step(tok, states, t):
        if qp is None:
            return dec.apply(dvars, tok, KV, mm, films, states, t, frames,
                             method=JDecoder.step_with_kv)
        return jqd.quant_step_with_kv(qp, dec.cfg, tok, KV, mm, films, states, t, frames)

    states = dec.init_states(1)
    inputs = np.concatenate([[[J_CFG.decoder.bos_id]], tokens[:, :-1]], axis=1)
    out = []
    for t in range(tokens.shape[1]):
        lg, states = step(jnp.asarray(inputs[:, t:t + 1]), states, jnp.asarray(t))
        out.append(np.asarray(lg[:, 0]))
    return np.stack(out, axis=1), inputs


@torch.no_grad()
def _port_teacher_forced(pair, tsyn, voice_codec, inputs, frames):
    model, dec = tsyn.model, tsyn.decoder
    ids, mask, voice = tsyn._tensors(pair["ids"], pair["mask"], voice_codec)
    th = model.encode_text(ids, mask)
    rh, rm = model.embed_voice(voice)
    KV, mm, films = dec.project_memories(th, mask, rh, rm, _t(pair["z"]))
    if tsyn.quant == "int8_kv":
        KV = tqd.quantize_kv(KV)
    states = dec.init_states(1)
    out = []
    for t in range(inputs.shape[1]):
        tok = _t(inputs[:, t:t + 1]).long()
        if tsyn.quant == "none":
            lg, states = dec.step_with_kv(tok, KV, mm, films, states, t, frames)
        else:
            lg, states = tqd.quant_step_with_kv(tsyn._qparams, dec.cfg, tok, KV, mm, films,
                                                states, t, frames)
        out.append(lg[:, 0].numpy())
    return np.stack(out, axis=1)


def assert_streams_agree(port_tokens, jax_tokens, jax_logits, margin=1e-3, min_agree=0.99):
    """Equal greedy streams, except where random weights leave the JAX top-2
    logits within ``margin`` (each such step is printed); at least
    ``min_agree`` of the tokens must still agree."""
    flips = np.argwhere(port_tokens != jax_tokens)
    if len(flips) == 0:
        return
    logits = jax_logits.copy()
    logits[..., : J_CFG.decoder.num_special_tokens] = -1e9
    top2 = np.sort(logits, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    for b, t in flips:
        print(f"near-tie flip at row {b} step {t}: JAX top-2 margin {gap[b, t]:.3g}")
    assert all(gap[b, t] < margin for b, t in flips), "a flip at a clear margin"
    assert (port_tokens == jax_tokens).mean() >= min_agree


@pytest.mark.parametrize("quant", ["none", "int8", "int8_kv"])
def test_synthesize_matches_jax(pair, quant, monkeypatch):
    jsyn, tsyn = _synths(pair, quant)
    # frame budgets
    frames_j = jsyn.predict_frames(pair["ids"], pair["mask"])
    frames_t = tsyn.predict_frames(pair["ids"], pair["mask"])
    assert frames_t == frames_j
    frames = jsyn._bucket(frames_j)
    assert tsyn._bucket(frames_t) == frames

    # the JAX greedy stream, through the JAX serving jit
    voice_codec = jsyn._encode_voice([pair["voice"]])
    np.testing.assert_array_equal(tsyn._encode_voice([pair["voice"]]), voice_codec)
    run = jsyn._decode_fn(frames, 0.0)
    tokens_j = np.asarray(run(jnp.asarray(pair["ids"]), jnp.asarray(pair["mask"]),
                              jnp.asarray(pair["style_bert"]), jnp.asarray(voice_codec),
                              jax.random.PRNGKey(SEED)))

    # teacher-forced step logits, both sides fed the JAX stream
    logits_j, inputs = _jax_teacher_forced(pair, jsyn, voice_codec, tokens_j, frames)
    logits_t = _port_teacher_forced(pair, tsyn, voice_codec, inputs, frames)
    np.testing.assert_allclose(logits_t, logits_j, atol=LOGIT_TOL, rtol=LOGIT_TOL)

    # the port's own synthesize(), with the JAX style sample injected
    monkeypatch.setattr(tsyn.model, "sample_style", lambda b, generator=None: _t(pair["z"]))
    seen = {}
    decode_rows = tsyn._decode_rows

    def spy(arrays, f, temperature, generator):
        seen["tokens"] = decode_rows(arrays, f, temperature, generator)
        return seen["tokens"]

    monkeypatch.setattr(tsyn, "_decode_rows", spy)
    wav_t, info = tsyn.synthesize(TEXT, STYLE, pair["voice"], seed=SEED)
    assert info["frames"] == frames and info["tokens"] == J_CFG.decoder.num_quantizers * frames
    assert_streams_agree(seen["tokens"], tokens_j, logits_j)

    # the JAX stream through both FACodecs
    Q = J_CFG.decoder.num_quantizers
    codec = tokens_j.reshape(1, Q, frames).transpose(0, 2, 1)
    wav_j = pair["jtok"].decode(codec)[0]
    np.testing.assert_allclose(pair["ttok"].decode(codec)[0], wav_j, atol=WAV_TOL)
    assert wav_t.shape == wav_j.shape and np.isfinite(wav_t).all()
    if (seen["tokens"] == tokens_j).all():
        np.testing.assert_allclose(wav_t, wav_j, atol=WAV_TOL)


def test_synthesize_batch_variable_length(pair, monkeypatch):
    """Rows group by their own 64-frame bucket; each waveform is trimmed to
    its predicted frames (the contract of the JAX test of the same name)."""
    _, tsyn = _synths(pair, "int8")
    monkeypatch.setattr(tsyn, "predict_frames_per_utterance",
                        lambda ids, mask: np.array([8, 100], np.int64))
    budgets = []
    decode_rows = tsyn._decode_rows

    def spy(arrays, frames, temperature, generator):
        budgets.append((int(arrays[0].shape[0]), frames))
        return decode_rows(arrays, frames, temperature, generator)

    monkeypatch.setattr(tsyn, "_decode_rows", spy)
    voice = pair["voice"]
    wavs, info = tsyn.synthesize_batch(["hi", "a much longer sentence to speak"],
                                       ["calm", "fast"], [voice, voice], variable_length=True)
    assert budgets == [(1, 64), (1, 128)]
    assert info["frames"] == [8, 100] and info["buckets"] == [64, 128]
    hop = tsyn.tokenizer.hop
    assert len(wavs[0]) == 8 * hop and len(wavs[1]) == 100 * hop
    assert all(np.isfinite(w).all() for w in wavs)
    Q = T_CFG.decoder.num_quantizers
    assert info["tokens"] == Q * 64 + Q * 128


def test_synthesize_batch_fixed_budget_rows_differ(pair):
    _, tsyn = _synths(pair, "int8_kv")
    voice = pair["voice"]
    wavs, info = tsyn.synthesize_batch(["hello world", "good day"], ["fast", "slow"],
                                       [voice, voice], frames=64)
    assert wavs.shape == (2, 64 * T_CFG.codec.hop_length) and np.isfinite(wavs).all()
    assert info["tokens"] == 2 * 64 * T_CFG.decoder.num_quantizers
    assert not np.allclose(wavs[0], wavs[1])


def test_register_voice_reuses_codec(pair, monkeypatch):
    _, tsyn = _synths(pair, "int8")
    tsyn.register_voice("spk", pair["voice"])
    calls = []
    monkeypatch.setattr(tsyn.tokenizer, "encode_with_lengths",
                        lambda *a, **k: calls.append(a))
    wav, info = tsyn.synthesize(TEXT, STYLE, "spk", frames=16)
    assert calls == [] and wav.shape == (64 * T_CFG.codec.hop_length,)


@pytest.mark.parametrize("what", ["megakernel", "mesh", "checkpoint", "no_card"])
def test_unported_paths_raise(what):
    if what == "megakernel":
        with pytest.raises(NotImplementedError, match="megakernel"):
            load_synthesizer(T_CFG, quant="megakernel", device="cpu")
    elif what == "mesh":
        with pytest.raises(NotImplementedError, match="mesh"):
            load_synthesizer(T_CFG, mesh=object(), device="cpu")
    elif what == "checkpoint":
        with pytest.raises(NotImplementedError, match="checkpoint"):
            load_synthesizer(T_CFG, checkpoint_dir="checkpoints", device="cpu")
    elif torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_synthesizer(T_CFG)
