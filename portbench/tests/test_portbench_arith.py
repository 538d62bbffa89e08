"""The benchmark's arithmetic against hand counts: the traffic's
determinism, rates over the whole window, the tail percentile with its
count beyond, the idle share from overlapping intervals, and each
operation and byte count."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from portbench import generator, run, yardstick as y

REPO = Path(__file__).resolve().parents[2]
MODEL = json.loads((REPO / "portbench/configs/tts512x8.json").read_text())["model"]
DIMS = y.decoder_dims(MODEL["decoder"])


@pytest.mark.parametrize("name", ["interactive", "short-fresh-voice", "narration-b8"])
def test_serve_traffic_is_seeded_and_every_seed_does_the_same_work(name):
    t = generator.load_json("traffic", name)
    a = generator.serve_traffic(t, 2 ** 31 + 11, count=40)
    b = generator.serve_traffic(t, 2 ** 31 + 11, count=40)
    c = generator.serve_traffic(t, 5, count=40)
    assert [(r.frames, r.texts, r.style, r.seed) for r in a.requests] == \
        [(r.frames, r.texts, r.style, r.seed) for r in b.requests]
    assert all(np.array_equal(a.voices[k], b.voices[k]) for k in a.voices)
    assert [r.texts for r in a.requests] != [r.texts for r in c.requests]
    n = len(t["frame_buckets"])
    for lo in range(0, 40 - n + 1, n):  # each block holds every bucket once
        assert sorted(r.frames for r in a.requests[lo:lo + n]) == sorted(t["frame_buckets"])
        assert sorted(r.frames for r in c.requests[lo:lo + n]) == sorted(t["frame_buckets"])
    if t.get("order") == "fixed":  # then every seed sends the buckets in one order
        assert [r.frames for r in a.requests] == [r.frames for r in c.requests]
    words = set(generator.words())
    assert all(w in words for r in a.requests for s in r.texts for w in s.split(" "))
    v = next(iter(a.voices.values()))
    assert v.dtype == np.float32 and len(v) == int(t["voice_seconds"] * 16000)


def test_train_traffic_is_seeded_and_rows_differ():
    t = generator.load_json("traffic", "train-flagship")
    a = generator.train_batches(t, 3, MODEL)
    b = generator.train_batches(t, 3, MODEL)
    assert len(a) == t["pool"]
    for x, z in zip(a, b):
        assert all(np.array_equal(x[k], z[k]) for k in x)
    rows = [bytes(x["target_codec"][i]) for x in a for i in range(t["batch"])]
    assert len(set(rows)) == len(rows)
    x = a[0]
    assert x["target_codec"].shape == (8, 1024, 5) and x["voice_codec"].shape == (8, 1024, 5)
    assert x["target_codec"].min() >= 2 and x["target_codec"].max() < 1026


def _run(records, window_s):
    return {"records": records, "window_s": window_s, "config": {"model": MODEL},
            "traffic": generator.load_json("traffic", "interactive")}


def test_rates_are_over_the_whole_window():
    recs = [{"ok": True, "audio_s": 2.0, "wall_s": 0.5, "frames": 160, "rows": 1}] * 3
    assert run.load_metric("audio_s_per_s").read(_run(recs, 4.0)) == pytest.approx(1.5)
    train = {"tokens": 3 * 8 * 1024 * 5, "window_s": 0.6}
    assert run.load_metric("train_tokens_per_s").read(train) == pytest.approx(204800.0)


def test_p90_and_its_count_beyond():
    vals = list(range(1, 101))
    assert y.percentile(vals, 90) == (90, 10)
    recs = [{"ok": True, "wall_s": v / 1e3} for v in vals]
    assert run.load_metric("latency_p90_ms").read(_run(recs, 1.0)) == pytest.approx(90.0)
    recs[0] = {"ok": False, "wall_s": 0.0}  # a failed request misses every limit
    assert run.load_metric("latency_p90_ms").read(_run(recs, 1.0)) == pytest.approx(91.0)


def test_idle_share_from_overlapping_intervals():
    assert y.union_seconds([(0, 2), (1, 3), (5, 6), (5.5, 5.7)], 0, 10) == pytest.approx(4.0)
    assert y.union_seconds([(-1, 1), (9, 12)], 0, 10) == pytest.approx(2.0)
    p = {"profile": {"window": (0.0, 10.0), "kernels": [("a", 0, 2), ("b", 1, 3), ("c", 5, 6)]},
         "records": []}
    assert run.load_metric("device_idle.serve").read(p) == pytest.approx(60.0)


def test_training_idle_share_takes_the_step_time_from_the_unprofiled_steps():
    """3 traced steps hold 0.3 s of kernels (0.1 a step) in a 0.6 s stretch
    that the profiler slowed; the 10 steps after them took 1.25 s (0.125 a
    step): 20% idle, not the traced stretch's 50%."""
    kernels = [("k", 0.0, 0.1), ("k", 0.2, 0.3), ("k", 0.4, 0.5)]
    p = {"tokens": 1, "profile": {"window": (0.0, 0.6), "kernels": kernels, "steps": 3,
                                  "unprofiled_steps": 10, "unprofiled_s": 1.25}}
    assert run.load_metric("device_idle.train").read(p) == pytest.approx(20.0)
    p["profile"]["unprofiled_steps"] = 0  # nothing ran after the traced steps
    assert run.load_metric("device_idle.train").read(p) is None


def test_decode_step_operations_by_hand():
    # per layer: in 512x2048, x 1024x64, dt 32x1024, out 1024x512, q and o
    # 512x512 each, attention 2 x 512 x 1536, FFN 2 x 512x2048; the head 512x1026
    per_layer = (1048576 + 65536 + 32768 + 524288 + 524288 + 1572864 + 2097152)
    assert y.decode_step_flops(DIMS, 1, 1536, 1026) == 2 * (8 * per_layer + 512 * 1026)


def test_megakernel_bound_matches_the_kernel_table():
    # the system's kernel table (B = 1, 320 steps, 3 s voice): 99.8 MB read
    # once take 0.0298 ms; 30.4 GFLOP at the bf16 peak take 0.0307 ms
    assert y.megakernel_bytes_once(DIMS, 1, 1536, 320) == pytest.approx(99.8e6, rel=1e-3)
    assert y.megakernel_bound_ms(DIMS, 1, 1536, 320) == pytest.approx(0.0307, rel=2e-3)


def test_scan_and_flash_bounds_by_hand():
    # B = 8, T = 5,120, D = 1,024, N = 16: forward bound by exps, backward by bytes
    elems = 8 * 5120 * 1024 * 16
    assert y.scan_bound_ms("fwd", 8, 5120, 1024, 16) == pytest.approx(
        1e3 * elems / (132 * 16 * 1.98e9))
    nbytes = (8 * 5120 * 1024 * 6 + 2 * 8 * 5120 * 16 * 2 + 1024 * 16 * 4 + 80 * 8 * 16 * 1024 * 4
              + 8 * 5120 * 1024 * 4 + 8 * 16 * 1024 * 4 + 2 * 8 * 5120 * 1024 * 4
              + 2 * 8 * 5120 * 16 * 4 + 2 * 8 * 16 * 1024 * 4)
    assert y.scan_bound_ms("bwd", 8, 5120, 1024, 16) == pytest.approx(1e3 * nbytes / 3.35e12)
    mac = 2 * 8 * 5120 * 5376 * 64
    assert y.flash_flops("fwd", 2, 8, 5120, 5376) == 4 * mac
    assert y.flash_bound_ms("bwd", 2, 8, 5120, 5376) == pytest.approx(1e3 * 10 * mac / 989e12)


def test_train_step_operations_by_hand():
    d, di, dff = 512, 1024, 2048
    per_tok = 8 * (d * 2 * di + di * 64 + 32 * di + di * d + 2 * d * d + 2 * d * dff) + d * 1026
    kv = 2 * d * d * 8 * 8 * 5376
    text_tok = 4 * (3 * 512 * 128 + 128 * 512 + 512 * 1024 * 9 + 1024 * 512)
    text_attn = 4 * 2 * 8 * 2 * 256 * 256 * 64
    attn = 8 * 7 * 8 * 8 * 5120 * 5376 * 64
    want = 6 * (8 * 5120 * per_tok + kv + 8 * 256 * text_tok + text_attn) + 2 * attn
    assert y.train_step_flops(DIMS, MODEL["text_encoder"], 8, 5120, 5376, 256) == want
    assert 20e12 < want < 25e12


def test_leaf_gap_measures_against_the_larger_of_the_leaf_and_the_median():
    ref = {"a": 1.0, "b": 2.0, "c": 3.0, "tiny": 1e-9}
    prog = {"a": 1.1, "b": 2.0, "c": 3.0, "tiny": 2e-9}
    gap, leaf = y.leaf_gap(prog, ref, sorted(ref))
    assert leaf == "a" and gap == pytest.approx(0.1 / 1.5)
