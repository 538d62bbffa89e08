"""The readers of the system's own spans and counters: traced tiny cells on
the CPU report the host-time metrics, and the device-time and stamp
metrics read nothing there; a program without the tracer reads nothing."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

from portbench import run
from portbench.tests import tiny

REPO = Path(__file__).resolve().parents[2]
SERVE = ("frontend_ms.serve", "decode_setup_ms.serve", "decode_device_ms_per_step.serve",
         "graph_captures.serve", "megakernel_barrier_share.serve")
TRAIN = ("forward_device_ms.train", "backward_device_ms.train", "optimizer_device_ms.train")


def test_traced_tiny_cells_read_the_program_spans(tmp_path):
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = tiny.make(tmp_path / "portbench")["workloads"]
    spec["configs"] += [{"name": n, "source": "tests/smoke_config.json",
                         "file": f"portbench/configs/{n}.json", "reduced": [], "why": "test"}
                        for n in ("tiny", "tiny-mk")]
    spec["workloads"] += cells
    for m in spec["per_layer"]:
        if m["name"] in SERVE:
            m["workloads"] += [c["name"] for c in cells if c["traffic"] != "train"]
        elif m["name"] in TRAIN:
            m["workloads"].append("tiny.train")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); sys.path.append(sys.argv[2]);"
            "import torch; torch.set_num_threads(2);"
            "from portbench import run;"
            "print(json.dumps({c: run.execute(c, 2 ** 31 + 11, 0.05, True, 'cpu')"
            " for c in ('tiny.one', 'tiny-mk.one', 'tiny.batch', 'tiny.train')}))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path), str(REPO)], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    for cell in ("tiny.one", "tiny-mk.one", "tiny.batch"):
        r = got[cell]
        assert r["correct"], r["checks"]
        m = {k: v["value"] for k, v in r["metrics"].items()}
        assert m["frontend_ms.serve"] > 0 and m["decode_setup_ms.serve"] > 0, m
        assert m["graph_captures.serve"] == 0  # nothing is captured on the CPU
        assert "decode_device_ms_per_step.serve" not in m
        assert "megakernel_barrier_share.serve" not in m
    assert got["tiny.train"]["correct"]
    assert not set(TRAIN) & set(got["tiny.train"]["metrics"])


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_a_program_without_the_tracer_reads_nothing(name, monkeypatch):
    """The benchmark laid over a program that has no span API (its
    ``utils/profiling`` without ``spans``), or a run with no traced window,
    reads None and raises nothing."""
    reader = run.load_metric(name)
    traced = {"profile": {"window": (0.0, 1.0), "kernels": []}, "records": []}
    assert reader.read({"records": []}) is None
    bare = types.ModuleType("mamba_tts_torch.utils.profiling")
    monkeypatch.setitem(sys.modules, "mamba_tts_torch.utils.profiling", bare)
    import mamba_tts_torch.utils as utils

    monkeypatch.setattr(utils, "profiling", bare, raising=False)
    assert reader.read(traced) is None
