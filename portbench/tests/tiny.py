"""Tiny cells for the benchmark's CPU tests: the system's smoke-sized model
(``tests/smoke_config.json`` of the repository) under short mixes, written
into a folder laid out as the benchmark's own (configs, traffic, limits,
metrics)."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
SMOKE = REPO / "tests" / "smoke_config.json"

LIMITS = {"serve": {"logit_gap": 5e-2, "wave_err": 1e-3},
          "train": {"loss_gap": 1e-3, "grad_gap": 5e-2, "change_median_gap": 2e-2,
                    "change_p90_gap": 5e-2}}


def model_config() -> dict:
    m = json.loads(SMOKE.read_text())
    for k in ("decoder", "text_encoder", "duration"):
        m[k]["dtype"] = "bfloat16"
    return m


def make(root: Path) -> dict:
    """Write the tiny files under ``root`` and return a BENCHMARK-like spec
    with one cell per path: megakernel and default serving, training."""
    for d in ("configs", "traffic", "limits"):
        (root / d).mkdir(parents=True, exist_ok=True)
    if not (root / "metrics").exists():
        shutil.copytree(BENCH / "metrics", root / "metrics")
    model = model_config()
    decode = {"none": {"path": "greedy_decode", "dtype": "bfloat16"},
              "megakernel": {"path": "megakernel", "weight_dtype": "bfloat16",
                             "kv_dtype": "bfloat16"}}
    for name, quant in (("tiny", "none"), ("tiny-mk", "megakernel")):
        (root / "configs" / f"{name}.json").write_text(json.dumps(
            {"name": name, "source": "tests/smoke_config.json", "reduced": [], "quant": quant,
             "decode": decode[quant], "model": model}))
    serve = {"kind": "serve", "entry": "synthesize", "batch": 1, "frame_buckets": [64],
             "words_per_second": 2.5, "voice_seconds": 0.5, "voice_pool": 2,
             "style_prompts": "style_prompts.txt", "max_requests": 50, "trace_requests": 1,
             "check": {"requests": 2, "rows": 1}}
    batch = dict(serve, entry="synthesize_batch", batch=2, voice_pool=1,
                 check={"requests": 1, "rows": 2})
    train = {"kind": "train", "batch": 2, "frames": 8, "voice_frames": 8, "text_len": [8, 16],
             "pool": 4, "checked_steps": 3, "trace_steps": 1}
    for name, t in (("one", serve), ("batch", batch), ("train", train)):
        (root / "traffic" / f"{name}.json").write_text(json.dumps(t))
    cells = [("tiny.one", "tiny", "one"), ("tiny-mk.one", "tiny-mk", "one"),
             ("tiny.batch", "tiny", "batch"), ("tiny.train", "tiny", "train")]
    for cell, _, traffic in cells:
        kind = "train" if traffic == "train" else "serve"
        (root / "limits" / f"{cell}.json").write_text(json.dumps(LIMITS[kind]))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["workloads"] = [{"name": c, "config": k, "traffic": t, "chips": 1, "why": "test"}
                         for c, k, t in cells]
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.pop("workloads", None)
    return spec
