"""Serving trained weights on the CPU: the port's own checkpoints (written
by its train CLI at the smoke config, read back by ``load_synthesizer`` and
the synthesis CLI with no config given) and the JAX package's orbax
checkpoints through the README's recipe (restore, ``np.savez`` of
``/``-joined keys, ``bridge.tree_from_npz``)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_tts_tpu import config as jcl
from mamba_tts_tpu.train import state as jstate
from mamba_tts_tpu.train.train import build_model, init_params
from mamba_tts_torch import config as tcl
from mamba_tts_torch.audio.wavio import write_wav
from mamba_tts_torch.bridge import mamba_tts_from_params, tree_from_npz
from mamba_tts_torch.infer import synthesize as tsyn
from mamba_tts_torch.infer.synthesize import Synthesizer, load_synthesizer
from mamba_tts_torch.models.layers import seed_init
from mamba_tts_torch.models.tts import MambaTTS
from mamba_tts_torch.train import state as state_lib
from mamba_tts_torch.train import train as train_lib

SMOKE = "tests/smoke_config.json"
T_CFG = tcl.from_json(open(SMOKE).read())
TEXT, STYLE = "hello world, good day", "speak fast"
LOGIT_TOL = 1e-4  # tests/test_torch_synthesize.py


def _voice():
    t = np.arange(3200) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)


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


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    ck = tmp_path_factory.mktemp("ck")
    out = train_lib.main(["--synthetic", "--device", "cpu", "--config_json", SMOKE,
                          "--max_steps", "2", "--checkpoint_dir", str(ck)])
    assert out["step"] == 2 and (ck / "2" / "state.pt").is_file()
    return ck


def _tokens(synth, frames=3, seed=0):
    ids, _, mask = synth.frontend.encode_batch([TEXT], pad_to=synth.cfg.data.max_text_len)
    ids, mask, voice = synth._tensors(ids, mask, synth._encode_voice([_voice()]))
    style = synth.style_encoder.embed([STYLE])
    return synth.decode_tokens(ids, mask, style, voice, frames,
                               generator=torch.Generator().manual_seed(seed))


def test_load_synthesizer_serves_the_train_clis_checkpoint(trained):
    synth = load_synthesizer(checkpoint_dir=str(trained), device="cpu")
    # the CLI's config (the smoke config, its step count overridden), from config.json
    assert synth.cfg == tcl.override(T_CFG, "train.max_steps", 2)
    assert json.loads(tcl.to_json(synth.cfg)) == json.loads((trained / "config.json").read_text())
    params, restored = state_lib.restore_params(str(trained))
    assert restored
    own = dict(synth.model.named_parameters())
    assert set(own) == set(params) and any(n.startswith("style_pipe.") for n in own)
    assert all(torch.equal(own[n], params[n]) for n in params)
    init = dict(seed_init(MambaTTS(synth.cfg), 0).named_parameters())
    assert not torch.equal(own["decoder.head.weight"], init["decoder.head.weight"])

    twin = MambaTTS(synth.cfg)
    state_lib.copy_params(dict(twin.named_parameters()), params)
    same = Synthesizer(synth.cfg, twin, device="cpu")
    torch.testing.assert_close(_tokens(synth), _tokens(same), rtol=0, atol=0)


def test_synthesis_cli_configures_itself_from_the_checkpoint(trained, tmp_path, capsys):
    wav_in, wav_out = tmp_path / "voice.wav", tmp_path / "out.wav"
    write_wav(str(wav_in), _voice(), 16000)
    tsyn.main(["--text", TEXT, "--voice_wav", str(wav_in), "--output", str(wav_out),
               "--checkpoint_dir", str(trained), "--frames", "2", "--device", "cpu"])
    assert wav_out.is_file() and "RTF" in capsys.readouterr().out


@pytest.mark.parametrize("where", ["missing", "empty"])
def test_no_checkpoint_gives_the_seeded_init(tmp_path, where):
    ck = tmp_path / "ck"
    if where == "empty":
        ck.mkdir()
    synth = load_synthesizer(T_CFG, checkpoint_dir=str(ck), seed=5, device="cpu")
    want = dict(seed_init(MambaTTS(T_CFG), 5).named_parameters())
    assert all(torch.equal(p, want[n]) for n, p in synth.model.named_parameters())


@pytest.mark.parametrize("drift", ["missing_key", "extra_key", "shape"])
def test_a_checkpoint_that_differs_from_the_model_raises(trained, tmp_path, drift):
    saved = torch.load(trained / "2" / "state.pt", weights_only=True)
    name = "style_pipe.cross_attn_1.ffn1.weight"
    if drift == "missing_key":
        del saved["params"][name]
    elif drift == "extra_key":
        saved["params"]["decoder.no_such.weight"] = torch.zeros(3)
        name = "decoder.no_such.weight"
    else:
        saved["params"][name] = saved["params"][name][:, :-1]
    (tmp_path / "2").mkdir()
    torch.save(saved, tmp_path / "2" / "state.pt")
    error = ValueError if drift == "shape" else KeyError
    with pytest.raises(error, match=name):
        load_synthesizer(T_CFG, checkpoint_dir=str(tmp_path), device="cpu")


def test_orbax_checkpoint_round_trip_through_npz(tmp_path):
    """The README recipe: a whole JAX ``MambaTTS`` tree (``style_pipe``
    included) saved by the JAX trainer's orbax checkpointing, restored,
    saved as one ``.npz`` of ``/``-joined keys, and loaded through the
    bridge: the decoder's forward logits equal JAX's."""
    jcfg = jcl.from_json(open(SMOKE).read())
    model = build_model(jcfg)
    params = init_params(model, jcfg, jax.random.PRNGKey(0))
    st = jstate.create_train_state(params, jstate.make_optimizer(1e-4))
    jstate.save_checkpoint(str(tmp_path / "orbax"), st)
    abstract = jax.eval_shape(lambda k: init_params(model, jcfg, k), jax.random.PRNGKey(0))
    restored, ok = jstate.restore_params(str(tmp_path / "orbax"), abstract)
    assert ok and "style_pipe" in restored
    flat = {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(restored)}
    np.savez(tmp_path / "params.npz", **flat)
    port = mamba_tts_from_params(T_CFG, tree_from_npz(tmp_path / "params.npz")).eval()

    rng = np.random.default_rng(0)
    B, Q, F, L = 2, jcfg.decoder.num_quantizers, 4, 7
    at = rng.integers(2, jcfg.decoder.vocab_size_audio, (B, Q, F)).astype(np.int32)
    ids = rng.integers(1, jcfg.text_encoder.vocab_size, (B, L)).astype(np.int32)
    mask = np.ones((B, L), bool)
    z = rng.standard_normal((B, jcfg.decoder.d_style)).astype(np.float32)

    def fwd(m, at, ids, mask, z):
        return m.decoder(at, m.encode_text(ids, mask), z, mask)

    want = model.apply({"params": params}, *map(jnp.asarray, (at, ids, mask, z)), method=fwd)
    with torch.no_grad():
        got = fwd(port, *(torch.from_numpy(a) for a in (at.astype(np.int64),
                                                        ids.astype(np.int64), mask, z)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=LOGIT_TOL)
