"""The data-parallel training driver (``drivers/train_dp.py``) on the CPU:
a tiny cell of two ranks over gloo, plain and traced, held to the plain
reference stepped in blocks of a rank's rows; the same cell with the
gradients' sum over the ranks left out is not correct."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

from portbench.tests import tiny

REPO = Path(__file__).resolve().parents[2]


def test_a_tiny_data_parallel_cell_runs_and_matches_the_reference(tmp_path):
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    bench = tmp_path / "portbench"
    spec = tiny.make(bench)
    train = json.loads((bench / "traffic" / "train.json").read_text())
    train.update(kind="train_dp", ranks=2, batch=1)
    (bench / "traffic" / "train-dp2.json").write_text(json.dumps(train))
    (bench / "limits" / "tiny.train-dp2.json").write_text(json.dumps(tiny.LIMITS["train"]))
    spec["workloads"] = [{"name": "tiny.train-dp2", "config": "tiny", "traffic": "train-dp2",
                          "chips": 1, "why": "test"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); sys.path.append(sys.argv[2]);"
            "from portbench import run;"
            "from portbench.drivers import train_dp;"
            "print(json.dumps([run.execute('tiny.train-dp2', 2**31 + 9, 0.5, t, 'cpu')"
            " for t in (0, 1)]"
            " + [run.execute('tiny.train-dp2', 2**31 + 9, 0.5, False, 'cpu',"
            " fault=train_dp.no_exchange)]))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path), str(REPO)], cwd=REPO,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced, no_exchange = json.loads(out.stdout.strip().splitlines()[-1])
    for r in (plain, traced):
        assert r["correct"], r["checks"]
        assert r["attempted"] >= 2 and r["failed"] == 0
        assert len(r["checks"]["losses"]) == 3
    assert {"train_tokens_per_s", "setup_s"} <= set(plain["metrics"])
    assert traced["metrics"]["mfu.train"]["value"] > 0
    # each rank stepping on its own rows: the first gradient is one rank's
    assert not no_exchange["correct"]
    assert no_exchange["checks"]["grad_gap"]["value"] > no_exchange["checks"]["grad_gap"]["limit"]
