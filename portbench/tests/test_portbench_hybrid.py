"""The jamba cell's pieces on the CPU: its operation and byte counts
(``yardstick_hybrid``) against hand counts at the published sizes, and a
tiny jamba cell (the smoke model's front-ends around a 4-layer jamba
decoder) run through ``run.execute`` with ``drivers/serve_hybrid.py``,
plain and traced."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

from portbench import yardstick_hybrid as yh
from portbench.tests import tiny

REPO = Path(__file__).resolve().parents[2]
JAMBA = json.loads((REPO / "portbench/configs/jamba2-3b-tts.json").read_text())
X = yh.dims(JAMBA["model"]["decoder"])


def test_sizes_of_the_published_configuration():
    assert (X["d"], X["di"], X["N"], X["r"], X["H"], X["Hkv"], X["hd"], X["ff"], X["V"]) == \
        (2560, 5120, 16, 160, 20, 1, 128, 8192, 1026)
    assert (X["n_mamba"], X["n_attn"]) == (26, 2)


def test_operations_against_hand_counts():
    """A Mamba layer's products: in_proj 2560 x 10240, conv 4 x 5120, x_proj
    5120 x 192, dt_proj 160 x 5120, out_proj 5120 x 2560; an attention
    layer's: q and o 2560 x 2560, k and v 2560 x 128; each MLP 3 x 2560 x
    8192; the head 1026 x 2560."""
    mamba = 26_214_400 + 20_480 + 983_040 + 819_200 + 13_107_200
    attn = 2 * 6_553_600 + 2 * 327_680
    mlp = 62_914_560
    assert yh.layer_macs(X) == 26 * (mamba + mlp) + 2 * (attn + mlp)
    head = 2_626_560
    # one row, prefix 1,000: every layer over 1,000 positions, causal
    # attention 2 x 2 x 20 x 128 x (1 + ... + 1,000) a layer
    assert yh.prefill_flops(X, [1000]) == 2 * yh.layer_macs(X) * 1000 + 2 * 4 * 2560 * 500_500
    # 3 steps of two rows of prefix 10 and 20: valid keys 11 + 21, 12 + 22, 13 + 23
    keys = 32 + 34 + 36
    assert yh.decode_flops(X, [10, 20], 3) == \
        2 * (yh.layer_macs(X) + head) * 2 * 3 + 2 * 4 * 2560 * keys
    assert yh.valid_keys([10, 20], 2) == 36


def test_bytes_against_hand_counts():
    """The layers' 2.862B parameters: matrices at 2 bytes, the rest at 4,
    and the f32 head; a step at B = 16 adds the states, read and written,
    and the valid K/V."""
    mats = 26 * (26_214_400 + 20_480 + 983_040 + 819_200 + 13_107_200 + 62_914_560) \
        + 2 * (2 * 6_553_600 + 2 * 327_680 + 62_914_560)
    small = 26 * (5120 + 5120 + 81_920 + 5120 + 160 + 32 + 5120) + 2 * 5120
    assert yh.weight_bytes(X) == 2 * mats + 4 * small + 4 * 2_626_560
    assert round((mats + small) / 1e9, 3) == 2.862
    states = 26 * 16 * 2 * (4 * 16 * 5120 + 2 * 3 * 5120)
    kv = 2 * 2 * 2 * 40_000 * 128  # two layers, K and V, bf16
    assert yh.step_bytes(X, 16, 40_000) == yh.weight_bytes(X) + states + kv
    assert yh.attention_call_bytes(X, 16, 40_000) == 2 * 2 * 40_000 * 128 + 2 * 2 * 16 * 2560


def tiny_jamba(root: Path) -> dict:
    """A tiny jamba configuration, mix, limits and cell written under
    ``root`` (a copy of the benchmark); returns the spec."""
    spec = tiny.make(root)
    model = tiny.model_config()
    model["decoder"] = {
        "block": "jamba", "codebook_size": 10, "num_special_tokens": 2, "d_model": 64,
        "n_layers": 4, "n_heads": 4, "n_kv_heads": 1, "d_ff": 128, "d_style": 32,
        "max_len": 128, "num_quantizers": 5, "attn_layer_offset": 2, "attn_layer_period": 4,
        "mamba": {"d_model": 64, "d_state": 16, "d_conv": 4, "expand": 2, "dt_rank": 4},
        "dtype": "bfloat16"}
    (root / "configs" / "tiny-jamba.json").write_text(json.dumps(
        {"name": "tiny-jamba", "source": "test", "reduced": [], "quant": "none",
         "decode": {"path": "hybrid_greedy_decode", "dtype": "bfloat16"}, "model": model}))
    traffic = json.loads((root / "traffic" / "batch.json").read_text())
    traffic.update(kind="serve_hybrid", batch=3, check={"requests": 1, "rows": 2})
    (root / "traffic" / "batch-hybrid.json").write_text(json.dumps(traffic))
    (root / "limits" / "tiny-jamba.batch.json").write_text(json.dumps(
        {"logit_gap": 1.0, "wave_err": 1e-3}))
    spec["workloads"] = [{"name": "tiny-jamba.batch", "config": "tiny-jamba",
                          "traffic": "batch-hybrid", "chips": 1, "why": "test"}]
    return spec


def test_a_tiny_jamba_cell_runs_and_reads_its_metrics(tmp_path):
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    spec = tiny_jamba(tmp_path / "portbench")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); sys.path.append(sys.argv[2]);"
            "import torch; torch.set_num_threads(2);"
            "from portbench import run;"
            "print(json.dumps([run.execute('tiny-jamba.batch', 2**31 + 5, 0.05, t, 'cpu')"
            " for t in (0, 1)]))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path), str(REPO)], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = json.loads(out.stdout.strip().splitlines()[-1])
    for r in (plain, traced):
        assert r["correct"], r["checks"]
        assert r["checks"]["decode_path"]["value"] == [["hybrid_greedy_decode", "bfloat16"]]
        assert r["checks"]["tokens_compared"] == 2 * 5 * 64
    assert {"audio_s_per_s", "setup_s"} <= set(plain["metrics"])
    assert traced["metrics"]["mfu.hybrid.serve"]["value"] > 0
    # the serving cells' readers of spans and records read the jamba decode
    # too (their device readers only on the card)
    assert {"frontend_ms.serve", "frontend_share.serve", "decode_setup_ms.serve",
            "decode_ms_per_step.serve", "graph_captures.serve"} <= set(traced["metrics"])
    # off the card the decode's spans carry no device time, and no kernel runs
    assert "hybrid_step_roofline.serve" not in traced["metrics"]
    assert "self_attention_decode_roofline" not in traced["metrics"]
