"""The program's tracer (``mamba_tts_torch.utils.profiling``): off, a span
does one check and records nothing; under a profiler, or after
``enable()``, spans carry their tree and the profiler's clock; serving and
training record the span trees their layers define, and give the same
numbers traced or not.  The ``cuda`` tests skip without a card.  This file
imports neither jax nor the JAX package, so it also runs on the card's
machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py -q
"""
import collections
import time

import numpy as np
import pytest
import torch

from mamba_tts_torch import config as config_lib
from mamba_tts_torch.config import DecoderConfig, MambaConfig
from mamba_tts_torch.infer.quant_decode import quantize_decoder_params
from mamba_tts_torch.infer.synthesize import load_synthesizer
from mamba_tts_torch.models.decoder import MambaTTSDecoder, greedy_decode
from mamba_tts_torch.models.layers import seed_init
from mamba_tts_torch.models.tts import MambaTTS
from mamba_tts_torch.ops import decode_megakernel as mk
from mamba_tts_torch.train import state as state_lib
from mamba_tts_torch.train.train import batch_to_device, make_train_step
from mamba_tts_torch.utils import profiling
from mamba_tts_torch.utils.profiling import annotate, count

SMOKE = config_lib.from_json(open("tests/smoke_config.json").read())


@pytest.fixture(autouse=True)
def _tracer_and_one_thread():
    """A fresh tracer, left off; one intra-op thread (the suite runs several
    test processes on the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def tree(spans):
    """The spans as nested (name, children) tuples, roots in order."""
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)

    def node(s):
        return (s.name, tuple(node(c) for c in kids.get(s.id, [])))
    return [node(s) for s in kids.get(None, [])]


def test_off_a_span_records_nothing_and_enters_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("tracing is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(profiling._TRACER, "open", refuse)
    monkeypatch.setattr(profiling._TRACER, "now_ns", refuse)

    @annotate("t.decorated", device_time=True)
    def f(x):
        return x + 1

    with annotate("t.root", device_time=True, rows=1) as span:
        assert span is None
        with annotate("t.child"):
            count("t.count", 3)
            assert f(1) == 2
    assert profiling.spans() == [] and profiling.counters() == {}


def test_under_a_profiler_spans_carry_their_tree_and_the_profilers_clock():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        # the first named range of a session pays the profiler's own set-up
        # inside its enter (1-2 ms seen), between the tracer's stamp and the
        # profiler's
        with torch.profiler.record_function("t.first"):
            pass
        for r in range(2):
            with annotate(f"t.root{r}", rows=2) as root:
                root.attrs["frames"] = 64
                with annotate(f"t.child{r}"):
                    time.sleep(0.002)
                    with annotate(f"t.leaf{r}", steps=3):
                        torch.ones(8).sum()
                count("t.count", 2)
    got = profiling.spans()
    assert tree(got) == [(f"t.root{r}", ((f"t.child{r}", ((f"t.leaf{r}", ()),)),))
                         for r in range(2)]
    by = {s.name: s for s in got}
    for r in range(2):
        root, child, leaf = by[f"t.root{r}"], by[f"t.child{r}"], by[f"t.leaf{r}"]
        assert root.parent is None and child.parent == root.id and leaf.parent == child.id
        assert root.request == child.request == leaf.request == root.id
        assert root.attrs == {"rows": 2, "frames": 64} and leaf.attrs == {"steps": 3}
        assert root.device_ms is None  # no device time asked for
    assert by["t.root0"].request != by["t.root1"].request
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    # a named range in the profiler, on its clock within 1 ms
    off = {s.name: (events[s.name].start_ns() - s.start_ns, events[s.name].end_ns() - s.end_ns)
           for s in got}
    assert all(abs(a) < 1e6 and abs(b) < 1e6 for a, b in off.values()), off
    assert profiling.counters() == {"t.count": 4}
    root0 = by["t.root0"]
    assert profiling.counters((root0.start_ns, root0.end_ns)) == {"t.count": 2}
    assert [s.name for s in profiling.spans((root0.start_ns, root0.end_ns))] == [
        "t.root0", "t.child0", "t.leaf0"]


def test_enable_records_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    profiling.enable()
    with annotate("t.on") as span:
        assert span is not None
        count("t.count")
    profiling.disable()
    with annotate("t.off") as span:
        assert span is None
        count("t.count")
    assert [s.name for s in profiling.spans()] == ["t.on"]
    assert profiling.counters() == {"t.count": 1}
    profiling.reset()
    assert profiling.spans() == [] and profiling.counters() == {}


def _voice():
    t = np.arange(3200) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)


def _serve(synth):
    """A request through each entry; their waveforms and decoded tokens."""
    tokens, decode_rows = [], synth._decode_rows

    def keep(*a, **k):
        tokens.append(decode_rows(*a, **k))
        return tokens[-1]

    synth._decode_rows = keep
    v = _voice()
    one, _ = synth.synthesize("hello world, good day", "speak fast", v, seed=3)
    two, _ = synth.synthesize_batch(["hello world", "good day"], ["speak fast"] * 2, [v, v],
                                    frames=16, seed=4)
    synth._decode_rows = decode_rows
    return [one, two], tokens


@pytest.mark.parametrize("quant", ["none", "megakernel"])
def test_synthesizer_span_tree_and_outputs_unchanged(quant):
    synth = load_synthesizer(SMOKE, device="cpu", quant=quant)
    plain_wavs, plain_tokens = _serve(synth)
    assert profiling.spans() == []
    profiling.enable()
    wavs, tokens = _serve(synth)
    profiling.disable()
    for a, b in zip(wavs + tokens, plain_wavs + plain_tokens):
        assert np.array_equal(a, b)
    fit = (("decode.plan", ()),) if quant == "megakernel" else ()
    decode = ("synth.decode", (("synth.condition", ()), *fit, ("decode.memory", ()),
                               ("decode.plan", ()), ("decode.run", ())))
    front = (("synth.g2p", ()), ("synth.bert", ()), ("synth.voice_encode", ()))
    got = profiling.spans()
    assert tree(got) == [
        ("synth.request", (*front, ("synth.durations", ()), decode, ("synth.codec_decode", ()))),
        ("synth.request", (*front, decode, ("synth.codec_decode", ())))]
    runs = [s for s in got if s.name == "decode.run"]
    Q = SMOKE.decoder.num_quantizers
    assert [s.attrs["steps"] for s in runs] == [Q * 64, Q * 64]
    path = "megakernel" if quant == "megakernel" else "eager"
    assert all(s.attrs["path"] == path and s.device_ms is None for s in runs)
    assert profiling.counters() == {}  # nothing is captured off the card


def _batch(cfg, B=2, L=12, S=16, seed=0):
    rng = np.random.default_rng(seed)
    Q, V = cfg.decoder.num_quantizers, cfg.decoder.vocab_size_audio
    text_mask = np.ones((B, L), bool)
    text_mask[1, 9:] = False
    return batch_to_device({
        "phoneme_ids": (rng.integers(1, cfg.text_encoder.vocab_size, (B, L)) * text_mask),
        "text_mask": text_mask,
        "style_bert": rng.standard_normal((B, cfg.smsd.bert_dim)).astype(np.float32),
        "spk_embs": rng.standard_normal((B, cfg.smsd.style_dim)).astype(np.float32),
        "target_codec": rng.integers(2, V, (B, S, Q)),
        "target_frames": np.array([S, 13]),
        "voice_codec": rng.integers(2, V, (B, S, Q)),
    }, torch.device("cpu"))


def _train(steps=2):
    model = seed_init(MambaTTS(SMOKE), 0)
    tx = state_lib.make_optimizer(SMOKE.train.lr, SMOKE.train.grad_clip_norm)
    st = state_lib.create_train_state(dict(model.named_parameters()), tx)
    step = make_train_step(model, tx, seed=5)
    losses = []
    for i in range(steps):
        st, out = step(st, _batch(SMOKE, seed=i))
        losses.append({k: v.clone() for k, v in out.items()})
    return losses, {n: p.detach().clone() for n, p in st.params.items()}


def test_train_step_span_tree_and_results_unchanged():
    plain_losses, plain_params = _train()
    profiling.enable()
    losses, params = _train()
    profiling.disable()
    for a, b in zip(losses, plain_losses):
        assert all(torch.equal(a[k], b[k]) for k in b)
    assert all(torch.equal(params[n], plain_params[n]) for n in plain_params)
    forward = ("train.forward", (("train.text_encoder", ()), ("train.smsd", ()),
                                 ("train.duration", ()), ("train.decoder", ())))
    step = ("train.step", (forward, ("train.backward", ()), ("train.optimizer", ())))
    assert tree(profiling.spans()) == [step, step]


# ----------------------------------------------------------------- on the card

def _card_decoder(card):
    cfg = DecoderConfig(codebook_size=16, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                        d_style=32, max_len=256, num_quantizers=2, dtype="bfloat16",
                        scan_chunk=8, use_pallas=False, mamba=MambaConfig(d_model=64, d_state=4))
    dec = seed_init(MambaTTSDecoder(cfg), 0).to(card).eval()
    g = torch.Generator(device=card).manual_seed(1)
    th = torch.randn((1, 7, 64), generator=g, device=card).bfloat16()
    z = torch.randn((1, 32), generator=g, device=card).bfloat16()
    kw = {"text_mask": torch.ones((1, 7), dtype=torch.bool, device=card),
          "ref_hidden": torch.randn((1, 11, 64), generator=g, device=card).bfloat16()}
    return dec, th, z, kw


def _decodes(dec, th, z, kw):
    """A captured default decode (18 steps: 4-step graphs) and a megakernel
    decode, on the same inputs."""
    greedy_decode(dec, th, z, 9, **kw)
    mk.megakernel_greedy_decode(dec, quantize_decoder_params(dec), th, z, 9, **kw)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_graph_captures_count_one_a_captured_call_on_card(card):
    dec, th, z, kw = _card_decoder(card)
    profiling.enable()
    for n in (1, 2):
        greedy_decode(dec, th, z, 9, **kw)
        # and the Mamba step's two kernels, on each of 2 layers of 18 steps
        assert profiling.counters() == {"decode.graph_captures": n,
                                        "decode.mamba_step_launches": 72 * n}
    runs = [s for s in profiling.spans() if s.name == "decode.run"]
    assert [s.attrs["steps"] for s in runs] == [16, 16]  # 2 eager steps, 4 replays of 4
    assert all(s.attrs["path"] == "graph" and s.device_ms > 0 for s in runs)


@pytest.mark.cuda
def test_traced_megakernel_stamps_rise_and_split_the_step_on_card(card):
    dec, th, z, kw = _card_decoder(card)
    profiling.enable()
    mk.megakernel_greedy_decode(dec, quantize_decoder_params(dec), th, z, 9, **kw)
    (run,) = [s for s in profiling.spans() if s.name == "decode.run"]
    c = run.attrs["stage_clocks"]
    assert run.attrs["path"] == "megakernel" and run.device_ms > 0
    assert len(c) == mk.stage_clock_count(dec.cfg) and all(b > a for a, b in zip(c, c[1:]))
    wait = sum(c[i + 1] - c[i] for i in range(1, len(c) - 1, 2))
    assert 0 < wait / (c[-1] - c[0]) < 1


@pytest.mark.cuda
def test_a_traced_window_adds_no_device_kernel_on_card(card, monkeypatch):
    """Under a profiler the program's spans record (device events, the
    megakernel's stamp buffer) and launch no kernel: no kernel name occurs
    more often in every one of three traced sessions than in some session
    with the tracer kept off.  (A session's record of one kernel was seen
    to come and go once in the first run of a cold process, so a single
    session is not compared with a single other.)"""
    dec, th, z, kw = _card_decoder(card)
    _decodes(dec, th, z, kw)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):  # a process's first session can drop
        torch.zeros(1, device=card).add_(1)        # kernels at its edges
        torch.cuda.synchronize()

    def kernels():
        with torch.profiler.profile(activities=acts) as prof:
            _decodes(dec, th, z, kw)
        return collections.Counter(
            e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation() and e.name() != "Context Sync")

    opened = profiling._TRACER.open
    got = {True: [], False: []}
    for traced in (True, False) * 3:
        monkeypatch.setattr(profiling._TRACER, "open",
                            opened if traced else (lambda *a, **k: None))
        got[traced].append(kernels())
    assert {s.name for s in profiling.spans()} >= {"decode.run", "decode.capture"}
    assert all(sum(c.values()) > 0 for c in got[True] + got[False])
    for name in set().union(*got[True], *got[False]):
        on, off = [c[name] for c in got[True]], [c[name] for c in got[False]]
        assert min(on) <= max(off), (name, on, off)
