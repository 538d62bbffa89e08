"""Offline-preprocessed data and the worker-backed loader of the port
against the JAX package on the CPU, at the smoke config.

Both preprocessors of each package over one synthetic corpus, on the same
weights (the JAX BERT's seeded init and a tamed JAX FACodec, carried into the
port by the bridge): every file name, the metadata and the phoneme and codec
ids equal, style and speaker embeddings within 1e-4 of their largest
magnitude.  ``OfflineDataset.batches`` of either package over a directory
the other wrote: equal batches for two seeds.  The port's directory equals
the JAX one file for file, so the JAX trainer, which its own tests run on a
JAX-written directory, trains on it too; the port's trainer runs here on the
JAX-written one.  The loader: batches equal ``_collate`` of the sampler's
items, the same seed gives the same batches, two workers give the same
targets as none.  The trainer CLI with ``--preprocessed_dir`` and ``--loader
grain``, and the preprocessing CLIs, on the CPU."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_tts_tpu import config as jconfig
from mamba_tts_tpu.audio.codec import FACodecTokenizer as JTokenizer
from mamba_tts_tpu.data import preprocess as jpp
from mamba_tts_tpu.data import preprocess_parallel as jppp
from mamba_tts_tpu.models.facodec import FACodec as JFACodec
from mamba_tts_tpu.models.style_text_encoder import BertEncoder as JBert
from mamba_tts_tpu.models.style_text_encoder import StyleTextEncoder as JStyle
from mamba_tts_torch import config as tconfig
from mamba_tts_torch.audio.codec import FACodecTokenizer
from mamba_tts_torch.bridge import bert_from_params, facodec_from_params
from mamba_tts_torch.data import grain_pipeline as gp
from mamba_tts_torch.data import preprocess as tpp
from mamba_tts_torch.data import preprocess_parallel as tppp
from mamba_tts_torch.data.dataset import VccmTTSDataset, make_synthetic_dataset
from mamba_tts_torch.models.style_text_encoder import StyleTextEncoder
from mamba_tts_torch.train import state as state_lib
from mamba_tts_torch.train import train as train_lib

SMOKE = "tests/smoke_config.json"
J_CFG, T_CFG = jconfig.from_json(open(SMOKE).read()), tconfig.from_json(open(SMOKE).read())
EMB_TOL = 1e-4  # of the largest magnitude: the same f32 graph, another summation order
SUFFIXES = ("phonemes", "style", "codec", "spk_emb")


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


def tame_codec_params(params):
    """Halve every FACodec kernel of the JAX random init, which otherwise
    drives almost every output sample into tanh saturation, where f32
    rounding differences between two correct graphs grow to ~1e-2 (see
    tests/test_torch_frontends.py)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x * 0.5 if "kernel" in jax.tree_util.keystr(path) else x, params)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    csv_path, tar_path = make_synthetic_dataset(str(root / "synth"), n_items=6)
    # the JAX weights, initialised under jit (op by op it takes many seconds)
    codec = tame_codec_params(jax.jit(lambda: JFACodec(J_CFG.codec).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 12800), jnp.float32)))()["params"])
    bert = jax.jit(lambda: JBert(J_CFG.style_encoder).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), bool)))()["params"]

    def port_bert(cfg, device="cuda"):
        return StyleTextEncoder(cfg, module=bert_from_params(cfg, _np(bert)), device=device)

    def port_codec(cfg, device="cuda", **_):
        return FACodecTokenizer(cfg, module=facodec_from_params(cfg, _np(codec)), device=device)

    tseq = tpp.DatasetPreprocessor(str(root / "port_seq"), [tar_path], cfg=T_CFG, device="cpu")
    tseq.style_encoder = port_bert(T_CFG.style_encoder, "cpu")
    tseq.tokenizer = port_codec(T_CFG.codec, "cpu")
    assert tseq.preprocess(csv_path) == 6
    jtok = JTokenizer(J_CFG.codec, params=codec)  # one of each: their jitted calls compile once
    jstyle = JStyle(J_CFG.style_encoder, checkpoint=bert)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jpp, jppp):
            mp.setattr(mod, "FACodecTokenizer", lambda cfg, **_: jtok)
            mp.setattr(mod, "StyleTextEncoder", lambda cfg: jstyle)
        assert jpp.DatasetPreprocessor(str(root / "jax_seq"), [tar_path],
                                       cfg=J_CFG).preprocess(csv_path) == 6
        assert jppp.ParallelDatasetPreprocessor(
            str(root / "jax_par"), [tar_path], cfg=J_CFG, cpu_workers=1,
            gpu_batch_size=4).preprocess(csv_path) == 6
        mp.setattr(tppp, "StyleTextEncoder", port_bert)
        mp.setattr(tppp, "FACodecTokenizer", port_codec)
        assert tppp.ParallelDatasetPreprocessor(
            str(root / "port_par"), [tar_path], cfg=T_CFG, cpu_workers=2, gpu_batch_size=4,
            device="cpu").preprocess(csv_path) == 6
    return {"root": root, "csv": csv_path, "tar": tar_path}


@pytest.mark.parametrize("kind", ["seq", "par"])
def test_port_preprocessor_writes_what_jax_writes(corpus, kind):
    jdir, tdir = corpus["root"] / f"jax_{kind}", corpus["root"] / f"port_{kind}"
    names = sorted(p.name for p in (jdir / "tensors").iterdir())
    assert names == sorted(p.name for p in (tdir / "tensors").iterdir())
    assert len(names) == 6 * 4
    assert json.loads((tdir / "metadata.json").read_text()) == \
        json.loads((jdir / "metadata.json").read_text())
    for name in names:
        want, got = np.load(jdir / "tensors" / name), np.load(tdir / "tensors" / name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if name.endswith(("_style.npy", "_spk_emb.npy")):
            err = float(np.abs(got - want).max())
            assert err <= EMB_TOL * float(np.abs(want).max()), (name, err)
        else:  # phoneme and codec ids
            np.testing.assert_array_equal(got, want, err_msg=name)
    for suffix in SUFFIXES:
        assert sum(n.endswith(f"_{suffix}.npy") for n in names) == 6, suffix


@pytest.mark.parametrize("writer", ["jax_seq", "port_seq"])
@pytest.mark.parametrize("seed", [0, 3])
def test_offline_batches_equal_across_packages(corpus, writer, seed):
    """Each package's ``OfflineDataset`` over a directory either wrote:
    the same batches, exactly."""
    d = str(corpus["root"] / writer)
    want = list(jpp.OfflineDataset(d).batches(2, max_text_len=64, seed=seed))
    got = list(tpp.OfflineDataset(d).batches(2, max_text_len=64, seed=seed))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _cli(tmp_path, *extra):
    return train_lib.main(["--device", "cpu", "--config_json", SMOKE, "--batch_size", "2",
                           "--checkpoint_dir", str(tmp_path / "ck"), *extra])


def test_train_cli_on_a_jax_preprocessed_directory(corpus, tmp_path):
    d = str(corpus["root"] / "jax_seq")
    out = _cli(tmp_path, "--preprocessed_dir", d, "--max_steps", "2")
    assert (out["start_step"], out["step"]) == (0, 2)
    assert all(np.isfinite(list(h.values())).all() for h in out["history"])
    out = _cli(tmp_path, "--preprocessed_dir", d, "--max_steps", "4", "--resume")
    assert (out["start_step"], out["step"]) == (2, 4)  # epochs of 3 batches, resumed across
    assert state_lib.restore_params(str(tmp_path / "ck"), step=4)[1]
    with pytest.raises(ValueError, match="fewer items than the batch size"):
        _cli(tmp_path, "--preprocessed_dir", d, "--batch_size", "7", "--max_steps", "1")


def test_train_cli_with_the_worker_loader(tmp_path):
    out = _cli(tmp_path, "--synthetic", "--loader", "grain", "--grain_workers", "2",
               "--max_steps", "2")
    assert (out["start_step"], out["step"]) == (0, 2)
    assert all(np.isfinite(list(h.values())).all() for h in out["history"])


@pytest.fixture(scope="module")
def loader_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("loader")
    return make_synthetic_dataset(str(d), n_items=7)


def test_loader_batches_are_collated_sampler_items(loader_data):
    csv_path, tar_path = loader_data
    got = list(gp.make_grain_loader(VccmTTSDataset(csv_path, tar_path, seed=1), 3, seed=5,
                                    num_epochs=2))
    # 14 items in the stream: four batches of 3, the third across the epoch
    # boundary, the last 2 items dropped
    assert len(got) == 4
    source = gp._Source(VccmTTSDataset(csv_path, tar_path, seed=1))
    orders = gp.epoch_orders(7, seed=5)
    first, second = next(orders), next(orders)
    assert sorted(first) == list(range(7)) and first != second
    stream = first + second
    for b, (inputs, target) in enumerate(got):
        idx = stream[b * 3:b * 3 + 3]
        want_inputs, want_target = gp._collate([source[i] for i in idx])
        np.testing.assert_array_equal(target, want_target)
        np.testing.assert_array_equal(inputs["voice_waveform"], want_inputs["voice_waveform"])
        assert inputs["text_prompt"] == want_inputs["text_prompt"]
        assert inputs["style_prompt"] == want_inputs["style_prompt"]
        assert target.shape[0] == 3 and target.dtype == np.float32
    plain = list(gp.make_grain_loader(VccmTTSDataset(csv_path, tar_path), 3, shuffle=False))
    np.testing.assert_array_equal(plain[0][1], gp._collate([source[i] for i in range(3)])[1])


def test_loader_cuts_batches_across_epochs_as_grain_does(tmp_path):
    """10 items, B = 4, two epochs, no shuffle: one stream of 20 items, 5
    batches, the third across the epoch boundary, as grain's loader gives
    (only the stream's last partial batch is dropped; without an end none)."""
    from mamba_tts_tpu.data.dataset import VccmTTSDataset as JDataset
    from mamba_tts_tpu.data.grain_pipeline import make_grain_loader as jloader

    csv_path, tar_path = make_synthetic_dataset(str(tmp_path), n_items=10)
    got = list(gp.make_grain_loader(VccmTTSDataset(csv_path, tar_path), 4, shuffle=False,
                                    num_epochs=2))
    want = list(jloader(JDataset(csv_path, tar_path), 4, shuffle=False, num_epochs=2))
    texts = VccmTTSDataset(csv_path, tar_path)
    text_of = [texts[i][0]["text_prompt"] for i in range(10)]
    assert len(got) == len(want) == 5
    assert got[2][0]["text_prompt"] == [text_of[i] for i in (8, 9, 0, 1)]
    for (gi, gt), (wi, wt) in zip(got, want):
        assert list(gi["text_prompt"]) == list(wi["text_prompt"])
        np.testing.assert_array_equal(gt, np.asarray(wt))
    endless = gp.make_grain_loader(VccmTTSDataset(csv_path, tar_path), 4, shuffle=False,
                                   num_epochs=None)
    stream = [next(endless)[0]["text_prompt"] for _ in range(5)]
    assert sum(stream, []) == (text_of * 2)[:20]


def test_loader_repeats_with_a_seed_and_workers_give_the_same_targets(loader_data):
    csv_path, tar_path = loader_data

    def run(seed, workers):
        return list(gp.make_grain_loader(VccmTTSDataset(csv_path, tar_path, seed=0), 2,
                                         seed=seed, worker_count=workers))

    a, b, c, w = run(7, 0), run(7, 0), run(8, 0), run(7, 2)
    assert len(a) == len(w) == 3
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x[1], y[1])
        np.testing.assert_array_equal(x[0]["voice_waveform"], y[0]["voice_waveform"])
    assert any(not np.array_equal(x[1], y[1]) for x, y in zip(a, c))
    for x, y in zip(a, w):  # the voices come from each worker's own copy of the rng
        np.testing.assert_array_equal(x[1], y[1])
        assert x[0]["text_prompt"] == y[0]["text_prompt"]


def test_dataset_reopens_its_archive_in_another_process(loader_data):
    """A pickled copy (what a spawned worker gets) holds no handle and opens
    its own; one whose recorded process differs (a forked worker) too."""
    import pickle

    csv_path, tar_path = loader_data
    for native in (True, False):
        ds = VccmTTSDataset(csv_path, tar_path, use_native=native)
        copy = pickle.loads(pickle.dumps(ds))
        assert copy.tar is None and copy._native is None
        np.testing.assert_array_equal(copy._wav(ds.rows[2]["item_name"]),
                                      ds._wav(ds.rows[2]["item_name"]))
        handle = ds.tar if ds._native is None else ds._native
        ds._pid = -1
        ds._wav(ds.rows[0]["item_name"])
        assert (ds.tar if ds._native is None else ds._native) is not handle


def test_preprocess_clis_on_cpu(corpus, tmp_path):
    base = ["--csv_path", corpus["csv"], "--tarball", corpus["tar"], "--config_json", SMOKE,
            "--device", "cpu"]
    assert tpp.main(base + ["--output_dir", str(tmp_path / "seq"), "--debug"]) == 6
    assert tppp.main(base + ["--output_dir", str(tmp_path / "par"), "--cpu_workers", "1",
                             "--gpu_batch_size", "4"]) == 6
    for d in ("seq", "par"):
        assert len(list((tmp_path / d / "tensors").glob("*.npy"))) == 6 * 4
    # the seeded init of both preprocessors is one codec: equal ids
    for p in (tmp_path / "seq" / "tensors").glob("*_codec.npy"):
        np.testing.assert_array_equal(np.load(p), np.load(tmp_path / "par" / "tensors" / p.name))


def test_entry_points_run_on_the_card_by_default(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    from mamba_tts_torch.train import train_codec

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_codec.main(["--synthetic", "--max_steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpp.main(["--csv_path", corpus["csv"], "--tarball", corpus["tar"], "--output_dir",
                  str(tmp_path / "x")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tppp.main(["--csv_path", corpus["csv"], "--tarball", corpus["tar"], "--output_dir",
                   str(tmp_path / "y"), "--cpu_workers", "1"])
    assert not Path(tmp_path / "y" / "metadata.json").exists()
