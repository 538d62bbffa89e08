"""The plain reference against the system on the CPU at the smoke size, and
the imports each side may make."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import generator, weights
from portbench.reference import model as ref_model
from portbench.reference import text as ref_text
from portbench.reference.config import from_json as ref_config
from portbench.tests import tiny

REPO = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mamba_tts_tpu")


@pytest.fixture(scope="module")
def pair():
    """The system's modules and the reference's at the smoke size in
    float32, on the same benchmark weights."""
    from mamba_tts_torch.config import from_json
    from mamba_tts_torch.models.facodec import FACodec
    from mamba_tts_torch.models.style_text_encoder import BertEncoder
    from mamba_tts_torch.models.tts import MambaTTS

    torch.set_num_threads(2)
    m = tiny.model_config()
    for k in ("decoder", "text_encoder", "duration"):
        m[k]["dtype"] = "float32"
    cfg, rcfg = from_json(json.dumps(m)), ref_config(json.dumps(m))
    prog = {"tts": MambaTTS(cfg), "bert": BertEncoder(cfg.style_encoder),
            "codec": FACodec(cfg.codec)}
    shapes = {f"{k}.{n}": tuple(p.shape) for k, v in prog.items() for n, p in v.named_parameters()}
    w = weights.make(shapes, 11, "cpu")
    for k, v in prog.items():
        weights.load_into(v, weights.split(w, k))
    ref = {"tts": ref_model.MambaTTS(rcfg), "bert": ref_model.BertEncoder(rcfg.style_encoder),
           "codec": ref_model.FACodec(rcfg.codec)}
    tts = {k: v for k, v in weights.split(w, "tts").items() if not k.startswith("style_pipe.")}
    weights.load_into(ref["tts"], tts)
    weights.load_into(ref["bert"], weights.split(w, "bert"))
    weights.load_into(ref["codec"], weights.split(w, "codec"))
    return cfg, rcfg, prog, ref


def test_same_parameter_names(pair):
    _, _, prog, ref = pair
    for k in prog:
        names = {n for n, _ in prog[k].named_parameters() if not n.startswith("style_pipe.")}
        assert names == {n for n, _ in ref[k].named_parameters()}


def test_phonemes_and_style_tokens_equal_the_system():
    from mamba_tts_torch.text.processor import PhonemeFrontend
    from mamba_tts_torch.text.wordpiece import BertTokenizer

    t = generator.load_json("traffic", "interactive")
    reqs = generator.serve_traffic(t, 99, count=30).requests
    texts = [r.texts[0] for r in reqs]
    fe = PhonemeFrontend(vocab_path=str(REPO / "phoneme_vocab.json"))
    want, _, wmask = fe.encode_batch(texts, pad_to=256)
    got, gmask = ref_text.phoneme_ids(texts, ref_text.load_words(),
                                      ref_text.load_phoneme_vocab(), 256)
    assert np.array_equal(want, got) and np.array_equal(wmask, gmask)
    prompts = [r.style for r in reqs]
    want, wmask = BertTokenizer(None, vocab_size=30522).encode_batch(prompts, 128)
    got, gmask = ref_text.style_token_ids(prompts, 30522, 128)
    assert np.array_equal(want, got) and np.array_equal(wmask, gmask)


def test_teacher_forced_logits_equal_the_system(pair):
    cfg, rcfg, prog, ref = pair
    g = torch.Generator().manual_seed(3)
    B, S, Sv, L = 2, 16, 8, 64
    ids = torch.randint(3, 79, (B, L), generator=g)
    ids[:, 40:] = 0
    mask = ids != 0
    voice = torch.randint(2, 12, (B, Sv, 5), generator=g)
    voice[1, 6:] = 0
    targets = torch.randint(2, 12, (B, 5, S), generator=g)
    z = torch.randn(B, 32, generator=g)
    with torch.no_grad():
        th = prog["tts"].encode_text(ids, mask)
        rh, rm = prog["tts"].embed_voice(voice)
        inputs = ref["tts"].shifted(targets)
        want = prog["tts"].decoder(inputs, th, z, mask, rh, rm)
        rth = ref["tts"].text_encoder(ids, mask)
        memory, mmask = ref["tts"].memory(rth, mask, voice)
        got = ref["tts"].decoder(inputs, memory, mmask, z)
    assert torch.allclose(rth, th, atol=1e-5)
    assert torch.allclose(got, want, atol=2e-4, rtol=1e-4)


def test_style_sample_equals_the_system(pair):
    _, _, prog, ref = pair
    x = torch.randn(3, 64, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = prog["tts"].sample_style(x, torch.Generator().manual_seed(9))
        got = ref["tts"].smsd.sample(x, torch.Generator().manual_seed(9))
        bw = prog["bert"](torch.tensor([[101, 5, 7, 102]]), torch.tensor([[True] * 4]))
        bg = ref["bert"](torch.tensor([[101, 5, 7, 102]]), torch.tensor([[True] * 4]))
    assert torch.allclose(got, want, atol=1e-5)
    assert torch.allclose(bg, bw, atol=1e-5)


def test_codec_equals_the_system(pair):
    _, _, prog, ref = pair
    wav = torch.from_numpy(generator.voice(5, 0.8))[None]
    with torch.no_grad():
        want, _ = prog["codec"].encode(wav)
        got = ref["codec"].encode_ids(wav)
        assert torch.equal(got, want)
        assert torch.allclose(ref["codec"].decode(got), prog["codec"].decode(want), atol=1e-5)


def test_training_losses_equal_the_system(pair):
    cfg, rcfg, prog, ref = pair
    t = {"batch": 2, "frames": 8, "voice_frames": 8, "text_len": [8, 16], "pool": 1}
    m = tiny.model_config()
    batch = {k: torch.as_tensor(v) for k, v in generator.train_batches(t, 5, m)[0].items()}
    batch = {k: (v.float() if v.dtype.is_floating_point else v) for k, v in batch.items()}
    want = prog["tts"].compute_losses(batch, generator=torch.Generator().manual_seed(1))
    got = ref["tts"].compute_losses(batch, torch.Generator().manual_seed(1))
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5), k


def _modules_after(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json;"
                          "print(json.dumps(sorted(m.split('.')[0] for m in sys.modules)))"],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_reference_imports_nothing_of_the_system():
    mods = _modules_after("import portbench.reference.model, portbench.reference.text, "
                          "portbench.weights, portbench.generator, portbench.yardstick")
    assert "mamba_tts_torch" not in mods
    assert not set(mods) & set(FORBIDDEN)


def test_a_run_loads_no_jax():
    mods = _modules_after(
        "import sys, tempfile, pathlib, torch; torch.set_num_threads(2)\n"
        "from portbench import run\nfrom portbench.tests import tiny\n"
        "root = pathlib.Path(tempfile.mkdtemp())\nspec = tiny.make(root)\n"
        "for c in ('tiny.one', 'tiny-mk.one', 'tiny.train'):\n"
        "    run.execute(c, 1, 0.01, True, 'cpu', spec=spec, root=root)\n"
        "assert not run.forbidden_modules()")
    assert "mamba_tts_torch" in mods and not set(mods) & set(FORBIDDEN)
