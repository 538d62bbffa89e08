"""The port's data and fixture tools against the JAX package's on the CPU.

``tools/wavmax`` (the longest WAV of an archive, and its CLI's lines),
``tools/train_lts`` (the bundled LTS artifact byte for byte; ``--eval``'s
held-out line on a small lexicon given to both packages) and
``tools/gen_manifests`` (both ``tests/data`` manifests byte for byte, from
the port's own upstream-graph replicas, which equal the test replicas of
``tests/test_facodec_convert.py`` key for key and output for output)."""
import dataclasses
import sys
import tarfile

import numpy as np
import pytest
import torch

import test_facodec_convert as tfc
from mamba_tts_tpu.tools import train_lts as jtrain_lts
from mamba_tts_tpu.tools import wavmax as jwavmax
from mamba_tts_torch import config as tconfig
from mamba_tts_torch.audio.wavio import write_wav
from mamba_tts_torch.text.lts import _ALIGNMENTS_PATH
from mamba_tts_torch.tools import facodec_replicas, gen_manifests, train_lts, wavmax

DATA = "tests/data"


def _tar(tmp_path, members, suffix=".tar.gz"):
    """An archive of ``members``: name -> (seconds, sample rate) for a WAV,
    bytes for another file, None for a directory."""
    src = tmp_path / "src"
    src.mkdir()
    path = tmp_path / f"corpus{suffix}"
    rng = np.random.default_rng(0)
    with tarfile.open(path, "w:gz" if suffix.endswith("gz") else "w") as tf:
        for i, (name, what) in enumerate(members.items()):
            f = src / f"m{i}.wav"  # write_wav keeps only a .wav suffix
            if what is None:
                f.mkdir()
            elif isinstance(what, bytes):
                f.write_bytes(what)
            else:
                seconds, sr = what
                write_wav(str(f), 0.1 * rng.standard_normal(int(seconds * sr)).astype(np.float32), sr)
            tf.add(str(f), arcname=name, recursive=False)
    return str(path)


@pytest.mark.parametrize("suffix", [".tar.gz", ".tar"])
def test_wavmax_matches_jax(tmp_path, capsys, suffix):
    path = _tar(tmp_path, {
        "a.wav": (0.4, 16000), "notes.txt": b"not audio", "sub": None, "clips.wav": None,
        "sub/Long.WAV": (1.25, 22050), "b.wav": (0.9, 16000), "c.wav.bak": b"RIFF????"})
    got = wavmax.longest_wav_in_tar(path)
    assert got == jwavmax.longest_wav_in_tar(path)
    assert got[0] == "sub/Long.WAV" and abs(got[1] - 1.25) < 1e-4
    wavmax.main([path])
    ours = capsys.readouterr().out
    jwavmax.main([path])
    assert ours == capsys.readouterr().out
    assert ours.splitlines() == ["Longest file: sub/Long.WAV", "Duration: 1.250 seconds"]


def test_wavmax_without_wavs_matches_jax(tmp_path, capsys):
    path = _tar(tmp_path, {"notes.txt": b"not audio", "sub": None})
    assert wavmax.longest_wav_in_tar(path) == jwavmax.longest_wav_in_tar(path) == (None, 0.0)
    wavmax.main([path])
    ours = capsys.readouterr().out
    jwavmax.main([path])
    assert ours == capsys.readouterr().out == "No WAV files found.\n"


def test_train_lts_reproduces_the_bundled_artifact(tmp_path, capsys):
    out = tmp_path / "lts_alignments.txt"
    train_lts.main(["--out", str(out)])
    assert out.read_bytes() == open(_ALIGNMENTS_PATH, "rb").read()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("lexicon entries: ") and lines[-1].startswith("wrote ")


def test_train_lts_eval_matches_jax(tmp_path, capsys, monkeypatch):
    """``--eval`` on the first 400 sorted entries of the lexicon, handed to
    both tools, with one EM iteration: the same lines and the same file."""
    from mamba_tts_torch.text.g2p import _builtin_lexicon

    full = _builtin_lexicon()
    small = {w: full[w] for w in sorted(full)[:400]}
    monkeypatch.setattr(train_lts, "_builtin_lexicon", lambda: small)
    monkeypatch.setattr(jtrain_lts, "_builtin_lexicon", lambda: small)
    outs = {k: tmp_path / f"{k}.txt" for k in ("torch", "jax")}
    train_lts.main(["--eval", "--iters", "1", "--out", str(outs["torch"])])
    ours = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["train_lts", "--eval", "--iters", "1", "--out", str(outs["jax"])])
    jtrain_lts.main()
    theirs = capsys.readouterr().out.splitlines()
    assert ours[:-1] == theirs[:-1]
    assert ours[0] == "lexicon entries: 400" and ours[1].startswith("held-out exact: ")
    assert ours[1].split(": ")[1].split(" = ")[0].endswith("/80")
    assert outs["torch"].read_bytes() == outs["jax"].read_bytes()


def test_gen_manifests_reproduce_the_fixtures(tmp_path):
    assert gen_manifests.main(str(tmp_path)) == str(tmp_path)
    for name in ("bert_base_uncased_manifest.json", "facodec_consumed_manifest.json"):
        assert (tmp_path / name).read_bytes() == open(f"{DATA}/{name}", "rb").read(), name
    fac = gen_manifests.facodec_manifest()
    assert (len(fac["encoder"]), len(fac["decoder"])) == (119, 206)


def test_facodec_replicas_equal_the_test_replicas():
    """The port's replicas hold the same keys and shapes as the test module's
    and, on one state dict, give the same encoder latents and the same
    decoder waveform, ids and speaker embedding."""
    cfg = tconfig.CodecConfig(**{f.name: getattr(tfc.CFG, f.name)
                                 for f in dataclasses.fields(tconfig.CodecConfig)})
    torch.manual_seed(0)
    theirs = (tfc.TEncoder(tfc.CFG).eval(), tfc.TDecoder(tfc.CFG).eval())
    ours = (facodec_replicas.TEncoder(cfg).eval(), facodec_replicas.TDecoder(cfg).eval())
    for a, b in zip(ours, theirs):
        sa, sb = a.state_dict(), b.state_dict()
        assert {k: v.shape for k, v in sa.items()} == {k: v.shape for k, v in sb.items()}
        a.load_state_dict(sb)
    wav = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 1, 64)).astype(np.float32))
    with torch.no_grad():
        lat = ours[0](wav)
        torch.testing.assert_close(lat, theirs[0](wav), rtol=0, atol=0)
        for x, y in zip(ours[1](lat), theirs[1](lat)):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
