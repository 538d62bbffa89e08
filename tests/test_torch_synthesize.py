"""The serving slice as a whole: the port's ``Synthesizer`` against the JAX
package's, at the smoke config (float32), in the none, int8, int8_kv and
megakernel decode modes, on weights carried across by
``mamba_tts_torch.bridge``.

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
from mamba_tts_tpu.ops import decode_megakernel as jmk
from mamba_tts_torch import config as tcl
from mamba_tts_torch.audio.codec import FACodecTokenizer
from mamba_tts_torch.bridge import bert_from_params, facodec_from_params, mamba_tts_from_params
from mamba_tts_torch.infer import quant_decode as tqd
from mamba_tts_torch.infer import synthesize as tsyn_mod
from mamba_tts_torch.infer.synthesize import Synthesizer, load_synthesizer
from mamba_tts_torch.models.layers import seed_init
from mamba_tts_torch.models.style_text_encoder import StyleTextEncoder
from mamba_tts_torch.models.tts import MambaTTS
from mamba_tts_torch.ops import decode_megakernel as tmk

SMOKE = open("tests/smoke_config.json").read()
J_CFG, T_CFG = jcl.from_json(SMOKE), tcl.from_json(SMOKE)
TEXT, STYLE, SEED = "hello world, good day", "speak fast", 0
LOGIT_TOL = 1e-4
WAV_TOL = 5e-4  # tests/test_facodec_convert.py bound


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs six test
    processes on the machine's cores, and torch's default of a thread per
    core in each oversubscribes them (six concurrent CPU train steps at the
    smoke config took minutes each with eight threads, about a second with
    one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
        step = torch.tensor([t])
        if tsyn.quant == "none":
            lg, states = dec.step_with_kv(tok, KV, mm, films, states, step, frames)
        else:
            lg, states = tqd.quant_step_with_kv(tsyn._qparams, dec.cfg, tok, KV, mm, films,
                                                states, step, frames)
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


def _megakernel_matches_jax(pair, jsyn, tsyn, monkeypatch, frames=8):
    """quant="megakernel": the JAX side is driven at the ``_decode_fn`` level
    (its Pallas kernel in interpret mode) at a frame budget interpret mode can
    afford, as tests/test_utils_and_infer.py does; the port decodes the same
    rows at the same budget through ``_decode_rows``.  The kernel works in
    bf16 whatever the config's dtype, and the two sides sum in different
    orders, so the logits are held to the megakernel's own limits (relative
    max error 2e-2, argmax agreement 90%) with both sides fed the JAX stream,
    and the free-running streams must agree up to their first near-tie."""
    voice_codec = jsyn._encode_voice([pair["voice"]])
    run = jsyn._decode_fn(frames, 0.0)
    tokens_j = np.asarray(run(jnp.asarray(pair["ids"]), jnp.asarray(pair["mask"]),
                              jnp.asarray(pair["style_bert"]), jnp.asarray(voice_codec),
                              jax.random.PRNGKey(SEED)))
    total = J_CFG.decoder.num_quantizers * frames
    assert tokens_j.shape == (1, total)
    inputs = np.concatenate([[[J_CFG.decoder.bos_id]], tokens_j[:, :-1]], axis=1)

    # teacher-forced logits of both megakernel paths on the JAX stream
    model, dec, mvars = JMambaTTS(J_CFG), JDecoder(J_CFG.decoder.with_mamba_dims()), pair["mvars"]
    th = model.apply(mvars, pair["ids"], pair["mask"], method=JMambaTTS.encode_text)
    rh, rm = model.apply(mvars, voice_codec, method=JMambaTTS.embed_voice)
    dtypes = dict(zip(("weight_dtype", "kv_dtype"), tsyn_mod._megakernel_dtypes(
        tsyn.decoder.cfg, 1, rh.shape[1] + th.shape[1])))
    res_j = jmk.megakernel_greedy_decode(
        dec, {"params": jsyn.params["decoder"]}, jsyn._qparams, th, pair["z"], frames,
        text_mask=pair["mask"], ref_hidden=rh, ref_mask=rm, collect_logits=True, interpret=True,
        forced_tokens=jnp.asarray(inputs[0]), **dtypes)
    ids, mask, voice = tsyn._tensors(pair["ids"], pair["mask"], voice_codec)
    with torch.no_grad():
        th_t = tsyn.model.encode_text(ids, mask)
        rh_t, rm_t = tsyn.model.embed_voice(voice)
    res_t = tmk.megakernel_greedy_decode(
        tsyn.decoder, tsyn._qparams, th_t, _t(pair["z"]), frames, text_mask=mask,
        ref_hidden=rh_t, ref_mask=rm_t, collect_logits=True, forced_tokens=_t(inputs[0]),
        weight_plan=tsyn._weight_plans[dtypes["weight_dtype"]], **dtypes)
    sp = J_CFG.decoder.num_special_tokens
    lj, lt = np.asarray(res_j.logits, np.float32)[0, :, sp:], res_t.logits.numpy()[0, :, sp:]
    rel = np.abs(lt - lj).max() / np.abs(lj).max()
    assert rel <= 2e-2, rel
    assert (lt.argmax(-1) == lj.argmax(-1)).mean() >= 0.9

    # the port's serving path at the same budget, JAX style sample injected
    monkeypatch.setattr(tsyn.model, "sample_style", lambda b, generator=None: _t(pair["z"]))
    style = _t(pair["style_bert"])
    tokens_t = tsyn._decode_rows((ids, mask, style, voice), frames, 0.0, tsyn._generator(SEED))
    assert tokens_t.shape == tokens_j.shape
    assert (tokens_t >= sp).all() and (tokens_t < J_CFG.decoder.vocab_size_audio).all()
    diff = np.nonzero(tokens_t[0] != tokens_j[0])[0]
    if len(diff):  # streams part only where the JAX top-2 logits nearly tie
        top2 = np.sort(lj[diff[0]])[-2:]
        assert top2[1] - top2[0] <= 2e-2 * np.abs(lj).max(), (diff[0], top2)


@pytest.mark.parametrize("quant", ["none", "int8", "int8_kv", "megakernel"])
def test_synthesize_matches_jax(pair, quant, monkeypatch):
    jsyn, tsyn = _synths(pair, quant)
    if quant == "megakernel":
        _megakernel_matches_jax(pair, jsyn, tsyn, monkeypatch)
        return
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


def test_run_chunked():
    """Row chunks of at most ``chunk``, run in order with the one generator
    (each chunk draws from it in turn) and concatenated; the batch runs whole
    when ``chunk`` is None or covers it."""
    calls = []

    def fake_run(a, b, generator):
        calls.append((a.shape[0], float(torch.rand((), generator=generator))))
        return a * 10 + b

    a = torch.arange(10, dtype=torch.float32)[:, None]
    b = torch.ones((10, 1))
    out = tsyn_mod._run_chunked(fake_run, (a, b), torch.Generator().manual_seed(0), chunk=4)
    assert out.shape == (10, 1) and torch.equal(out, a * 10 + 1)
    assert [c[0] for c in calls] == [4, 4, 2]
    assert len({c[1] for c in calls}) == 3  # distinct draws per chunk
    calls.clear()
    out2 = tsyn_mod._run_chunked(fake_run, (a, b), torch.Generator().manual_seed(0), chunk=None)
    assert calls[0][0] == 10 and torch.equal(out2, out)


def test_megakernel_dtype_selection(pair, monkeypatch):
    """The H100 planner at the flagship memory length (3 s prompt: 1200 ref +
    50 text tokens): device memory admits the first rung at every batch the
    kernel takes, a batch beyond the kernel's largest finds no fit, a small
    budget walks down the ladder to None, and None sends the decode through
    the int8 step path."""
    from mamba_tts_torch.config import TTSConfig

    cfg = TTSConfig().decoder.with_mamba_dims()
    M = 1250
    pick = tsyn_mod._megakernel_dtypes
    for B in (1, 2, 4, 8):
        assert pick(cfg, B, M) == ("bfloat16", "bfloat16")
        assert pick(cfg, B, M, sampled=True) == ("bfloat16", "bfloat16")
    assert pick(cfg, 9, M) is None  # step-decode fallback
    assert tmk.megakernel_max_batch(cfg, M) == tmk.MEGAKERNEL_MAX_BATCH == 8
    assert tmk.megakernel_max_batch(cfg, 64 * cfg.num_quantizers + 50) == 8
    # a small budget walks B=1 down the ladder (324.5 / 290.9 / 280.4 MB at the
    # default step count, the longest decode the position table allows)
    assert pick(cfg, 1, M, budget_bytes=330 * 10 ** 6) == ("bfloat16", "bfloat16")
    assert pick(cfg, 1, M, budget_bytes=300 * 10 ** 6) == ("int8", "bfloat16")
    assert pick(cfg, 1, M, budget_bytes=285 * 10 ** 6) == ("int8", "int8")
    assert pick(cfg, 1, M, budget_bytes=200 * 10 ** 6) is None

    # no fit -> the int8 step decode, not the megakernel
    _, tsyn = _synths(pair, "megakernel")
    monkeypatch.setattr(tsyn_mod, "_megakernel_dtypes", lambda *a, **k: None)
    monkeypatch.setattr(tsyn_mod, "megakernel_greedy_decode",
                        lambda *a, **k: pytest.fail("took the megakernel without a fit"))
    taken = []
    step_decode = tsyn_mod.greedy_decode_int8

    def spy(*a, **k):
        taken.append(k.get("int8_kv"))
        return step_decode(*a, **k)

    monkeypatch.setattr(tsyn_mod, "greedy_decode_int8", spy)
    voice_codec = tsyn._encode_voice([pair["voice"]])
    ids, mask, voice = tsyn._tensors(pair["ids"], pair["mask"], voice_codec)
    tokens = tsyn._decode_rows((ids, mask, _t(pair["style_bert"]), voice), 2, 0.0,
                               tsyn._generator(SEED))
    assert taken == [False] and tokens.shape == (1, 2 * T_CFG.decoder.num_quantizers)


def test_megakernel_batch_is_chunked(pair, monkeypatch):
    """A batch beyond ``megakernel_max_batch`` is cut into consecutive
    megakernel calls by ``_run_chunked``; rows come back in order."""
    _, tsyn = _synths(pair, "megakernel")
    monkeypatch.setattr(tsyn_mod, "megakernel_max_batch", lambda *a, **k: 2)
    sizes = []
    decode = tsyn_mod.megakernel_greedy_decode

    def spy(decoder, qparams, text_hidden, *a, **k):
        sizes.append(text_hidden.shape[0])
        return decode(decoder, qparams, text_hidden, *a, **k)

    monkeypatch.setattr(tsyn_mod, "megakernel_greedy_decode", spy)
    voice_codec = tsyn._encode_voice([pair["voice"]] * 3)
    texts = ["hello world", "good day", "hello world"]
    ids, _, mask = tsyn.frontend.encode_batch(texts, pad_to=T_CFG.data.max_text_len)
    ids, mask, voice = tsyn._tensors(ids, mask, voice_codec)
    style = tsyn.style_encoder.embed(["fast", "slow", "fast"])
    monkeypatch.setattr(tsyn.model, "sample_style",
                        lambda b, generator=None: _t(pair["z"]).expand(b.shape[0], -1))
    tokens = tsyn._decode_rows((ids, mask, style, voice), 2, 0.0, tsyn._generator(SEED))
    assert sizes == [2, 1]
    assert tokens.shape == (3, 2 * T_CFG.decoder.num_quantizers)
    np.testing.assert_array_equal(tokens[0], tokens[2])  # equal rows, different chunks
    assert (tokens[0] != tokens[1]).any()


@pytest.mark.parametrize("what", ["mesh", "checkpoint", "no_card"])
def test_unported_paths_raise(what, tmp_path):
    if what == "mesh":  # served since parallelism is ported: data-parallel serving needs
        # one process a rank (torchrun), and a lone process has no process group
        from mamba_tts_torch.infer.synthesize import main

        with pytest.raises(ValueError, match="one process a rank"):
            main(["--text", "hi", "--voice_wav", str(tmp_path / "v.wav"), "--dp_serving",
                  "--device", "cpu"])
    elif what == "checkpoint":  # served since checkpoints are ported: a missing directory
        # gives the seeded init, as in the JAX package
        synth = load_synthesizer(T_CFG, checkpoint_dir=str(tmp_path / "none"), seed=3,
                                 device="cpu")
        want = seed_init(MambaTTS(T_CFG), 3).state_dict()
        got = synth.model.state_dict()
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    elif torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_synthesizer(T_CFG)
