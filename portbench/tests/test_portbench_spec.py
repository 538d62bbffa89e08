"""The benchmark is driven by data: every cell, configuration, traffic mix,
limit and per-layer metric of BENCHMARK.json loads from its own file, and
a new cell can be added by new files and entries alone."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import generator, run
from portbench.tests import tiny

REPO = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_keys_and_names(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["portbench"] and spec["command"][1] == "portbench/run.py"
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert all(m["moves"] in e2e for m in spec["per_layer"])


@pytest.mark.parametrize("kind", ["configs", "traffic", "limits", "metrics"])
def test_every_entry_loads_from_its_file(spec, kind):
    for w in spec["workloads"]:
        if kind == "configs":
            conf = generator.load_json("configs", w["config"])
            assert conf["quant"] in ("none", "megakernel")
        elif kind == "traffic":
            assert generator.load_json("traffic", w["traffic"])["kind"] in ("serve", "train")
        elif kind == "limits":
            assert generator.load_json("limits", w["name"])
    if kind == "metrics":
        for m in spec["end_to_end"] + spec["per_layer"]:
            assert callable(run.load_metric(m["name"]).read)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(spec):
    for w in spec["workloads"]:
        e2e = [m["name"] for m in run.metrics_for(spec, w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert run.metrics_for(spec, w["name"], "per_layer")


def test_a_cell_added_by_files_alone_runs(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    per-layer metric and a cell by new files and entries alone, and runs."""
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = tmp_path / "portbench"
    tiny_spec = tiny.make(bench)  # new config, traffic and limits files
    (bench / "metrics" / "requests_done.py").write_text(
        "def read(run):\n    return float(sum(r['ok'] for r in run.get('records', [])))\n")
    spec["configs"].append({"name": "tiny", "source": "tests/smoke_config.json",
                            "file": "portbench/configs/tiny.json", "reduced": [], "why": "test"})
    spec["workloads"].append(next(w for w in tiny_spec["workloads"] if w["name"] == "tiny.one"))
    spec["per_layer"].append({"name": "requests_done", "unit": "requests", "better": "higher",
                              "source": "program_counter", "layer": "test",
                              "moves": "audio_s_per_s", "workloads": ["tiny.one"]})
    for m in spec["end_to_end"]:
        if "workloads" in m and m["name"] == "audio_s_per_s":
            m["workloads"].append("tiny.one")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); sys.path.append(sys.argv[2]);"
            "import torch; torch.set_num_threads(2);"
            "from portbench import run;"
            "assert run.BENCH.parent == __import__('pathlib').Path(sys.argv[1]);"
            "print(json.dumps([run.execute('tiny.one', 7, 0.05, t, 'cpu') for t in (0, 1)]))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path), str(REPO)], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = json.loads(out.stdout.strip().splitlines()[-1])
    assert plain["correct"] and traced["correct"]
    assert {"audio_s_per_s", "setup_s"} <= set(plain["metrics"])
    assert traced["metrics"]["requests_done"]["value"] >= 1


def test_a_traffic_kind_added_by_files_alone_runs(tmp_path):
    """A copy of the benchmark gains a traffic kind (its driver), a generator
    of its own, a mix, limits and a cell by new files and entries alone."""
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    bench = tmp_path / "portbench"
    (bench / "generators").mkdir()
    (bench / "generators" / "counting.py").write_text(
        "def items(t, seed):\n    return [seed % 97 + i for i in range(t['items'])]\n")
    (bench / "drivers" / "echo.py").write_text(
        "import time\n"
        "from portbench import generator\n"
        "def run(conf, traffic, limits, seed, seconds, traced, device, fault=None):\n"
        "    t0 = time.perf_counter()\n"
        "    got = generator.for_traffic(traffic).items(traffic, seed)\n"
        "    err = float(sum(got) != sum(seed % 97 + i for i in range(traffic['items'])))\n"
        "    return {'window_start': t0, 'window_s': 1.0, 'attempted': len(got), 'failed': 0,\n"
        "            'peak_bytes': 0, 'profile': None, 'records': [],\n"
        "            'checks': {'err': {'value': err, 'limit': limits['err']},\n"
        "                       'pass': err <= limits['err']}}\n")
    (bench / "traffic" / "echo.json").write_text(json.dumps(
        {"kind": "echo", "generator": "counting", "items": 5}))
    (bench / "limits" / "tts512x8.echo.json").write_text(json.dumps({"err": 0}))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tts512x8.echo", "config": "tts512x8",
                              "traffic": "echo", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); sys.path.append(sys.argv[2]);"
            "from portbench import run;"
            "print(json.dumps(run.execute('tts512x8.echo', 7, 0.05, False, 'cpu')))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path), str(REPO)], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["attempted"] == 5 and r["checks"]["err"]["value"] == 0.0
    assert "setup_s" in r["metrics"]
