"""The granite cell's pieces on the CPU: its operation and byte counts
(``yardstick_granite``) against hand counts at the published sizes, the
weights it draws, and a tiny granite cell (the smoke model's front-ends
around a 3-layer granite decoder) run through ``run.execute`` with
``drivers/serve_granite.py``, plain and traced."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from portbench import weights_granite as wg
from portbench import yardstick_granite as yg
from portbench.tests import tiny

REPO = Path(__file__).resolve().parents[2]
GRANITE = json.loads((REPO / "portbench/configs/granite-4.0-h-small-tts.json").read_text())
X = yg.dims(GRANITE["model"]["decoder"])


def test_sizes_of_the_published_configuration():
    assert (X["d"], X["H2"], X["P"], X["N"], X["di"], X["conv"]) == \
        (4096, 128, 64, 128, 8192, 8448)
    assert (X["H"], X["Hkv"], X["hd"], X["E"], X["top_k"], X["held"], X["de"], X["ds"]) == \
        (32, 8, 128, 72, 10, 9, 768, 1536)
    assert (X["n_mamba"], X["n_attn"], X["n_layers"], X["V"]) == (36, 4, 40, 1026)


def test_operations_against_hand_counts():
    """A Mamba-2 mixer's products: in_proj 4,096 x 16,768, the conv 4 x 8,448,
    out_proj 8,192 x 4,096; an attention mixer's: q and o 4,096 x 4,096, k
    and v 4,096 x 1,024; each MoE the router 4,096 x 72, 1.25 experts of 3 x
    4,096 x 768 a token, the shared MLP 3 x 4,096 x 1,536; the head 1,026 x
    4,096."""
    mamba = 68_681_728 + 33_792 + 33_554_432
    attn = 2 * 16_777_216 + 2 * 4_194_304
    moe = 294_912 + 1.25 * 9_437_184 + 18_874_368
    assert yg.layer_macs(X) == 36 * mamba + 4 * attn + 40 * moe
    # one row, prefix 1,000: causal attention 2 x 2 x 32 x 128 x (1 + ... + 1,000) a layer
    assert yg.prefill_flops(X, [1000]) == \
        2 * yg.layer_macs(X) * 1000 + 4 * 2 * 2 * 32 * 128 * 500_500
    keys = 32 + 34 + 36  # 3 steps of rows of prefix 10 and 20
    assert yg.decode_flops(X, [10, 20], 3) == \
        2 * (yg.layer_macs(X) + 1026 * 4096) * 2 * 3 + 4 * 2 * 2 * 32 * 128 * keys


def test_bytes_against_hand_counts():
    """A step at B = 16: 9.28 GB of weights outside the experts, 6.80 GB of
    held experts, 4.89 GB of states and windows read and written, and the
    valid K/V; the state kernel's call 134 MB of state."""
    mamba = 2 * (68_681_728 + 33_792 + 33_554_432) + 4 * (8448 + 3 * 128 + 8192)
    attn = 2 * (2 * 16_777_216 + 2 * 4_194_304)
    moe = 4 * 294_912 + 2 * 18_874_368
    assert yg.weight_bytes(X) == 36 * mamba + 4 * attn + 40 * (moe + 4 * 8192) + 4 * 1026 * 4096
    assert round(yg.weight_bytes(X) / 1e9, 2) == 9.28
    assert yg.expert_bytes(X) == 40 * 9 * 2 * 9_437_184
    states = 36 * 16 * 2 * (4 * 1_048_576 + 2 * 3 * 8448)
    kv = 4 * 2 * 2 * 40_000 * 8 * 128
    assert yg.step_bytes(X, 16, 40_000) == \
        yg.weight_bytes(X) + yg.expert_bytes(X) + states + kv
    assert round(states / 1e9, 2) == 4.89
    assert yg.mamba2_call_bytes(X, 16) == (2 * 4 * 16 * 1_048_576
                                           + 2 * 16 * (2 * 8192 + 256 + 128) + 12 * 128
                                           + 4 * 16 * 8192)


def test_attention_call_bytes_against_a_hand_count():
    """A grouped-attention call at B = 2 over 30 valid keys: K and V of 8
    heads of 128 a key (bf16), q read and the output written (32 heads of
    128 a row, bf16)."""
    assert yg.attention_call_bytes(X, 2, 30) == 2 * 2 * 30 * 8 * 128 + 2 * 2 * 2 * 32 * 128
    assert yg.attention_call_bytes(X, 2, 30) == yg.kv_bytes(X, 30) + 2 * 2 * 2 * 4096


class _Span:
    def __init__(self, lengths):
        self.attrs = {"lengths": lengths}


def test_the_attention_roofline_reads_the_kernel_records(monkeypatch):
    """Two rows of prefix 10 and 20 decoding one frame (5 steps): 36 valid
    keys a call on average, so 180,224 bytes a call; 20 records of 1 µs
    give 180,224 B / 3.35 TB/s over 1 µs.  Other kernels, records outside
    the window and a cell of another block read nothing."""
    from portbench import run as bench

    m = bench.load_metric("granite_attention_decode_roofline")
    monkeypatch.setattr(m._granite, "decodes", lambda run: [(_Span([10, 20]), [], 1)])
    kernels = [("void decode_attention_grouped_kernel<4>(Params)", 1 + i * 1e-5,
                1 + i * 1e-5 + 1e-6) for i in range(20)]
    kernels += [("nvjet_gemm", 1.5, 1.6), ("void decode_attention_grouped_kernel<4>(Params)",
                                           9.0, 9.1)]
    run = {"config": GRANITE, "profile": {"kernels": kernels, "window": (0.5, 2.0)}}
    want = 100 * (2 * 2 * 36 * 8 * 128 + 2 * 2 * 2 * 32 * 128) / 3.35e12 / 1e-6
    assert abs(m.read(run) - want) < 1e-6 * want
    other = json.loads((REPO / "portbench/configs/jamba2-3b-tts.json").read_text())
    assert m.read({**run, "config": other}) is None
    assert m.read({**run, "profile": {"kernels": kernels[20:21], "window": (0.5, 2.0)}}) is None


def test_the_warm_up_decodes_its_later_buckets_short():
    """``serve.run``'s first call serves its request whole, calls 2 to n
    (the warm-up's later buckets) decode ``WARM_FRAMES`` frames repeated to
    the bucket's length, and every later call is whole again."""
    from portbench.drivers import serve_granite as sg

    asked = []

    class Synth:
        def _decode_rows(self, arrays, frames, temperature, generator):
            asked.append(frames)
            # (B, Q * frames): row b, stream q, frame f holds 100 b + 10 q + f
            grid = (100 * np.arange(2)[:, None, None] + 10 * np.arange(5)[None, :, None]
                    + np.arange(frames)[None, None])
            return grid.reshape(2, 5 * frames)

    def call(synth, traffic, req, voices):
        return synth._decode_rows(None, req, 0.0, None)

    synth, wrapped = Synth(), sg._warm_call(call, 3)
    full = wrapped(synth, None, 20, None)
    short = wrapped(synth, None, 20, None)
    wrapped(synth, None, 12, None)
    after = wrapped(synth, None, 20, None)
    assert asked == [20, sg.WARM_FRAMES, sg.WARM_FRAMES, 20]
    assert short.shape == full.shape == after.shape == (2, 100)
    grid = short.reshape(2, 5, 20)
    assert (grid[..., :8] == full.reshape(2, 5, 20)[..., :8]).all()
    assert (grid[..., 8:16] == grid[..., :8]).all() and (grid[..., 16:] == grid[..., :4]).all()
    assert synth._decode_rows.__func__ is Synth._decode_rows  # the system's decode again


def test_weights_follow_their_rules_and_the_seed():
    """Per-head A in [1, 16] and dt in [1e-3, 0.1] (through softplus), an
    expert stack by its own fan-in, a matrix by weights.py's rule; a name and
    a seed give the same draw, another seed another."""
    a = torch.exp(wg.draw("tts.decoder.layer_0.mamba.A_log", (4096,), 3, "cpu"))
    assert 1 <= float(a.min()) and float(a.max()) <= 16
    dt = torch.nn.functional.softplus(wg.draw("tts.decoder.layer_0.mamba.dt_bias", (4096,), 3,
                                              "cpu"))
    assert 1e-3 * 0.999 <= float(dt.min()) and float(dt.max()) <= 0.1 * 1.001
    e = wg.draw("tts.decoder.layer_0.moe.input_linear", (2, 256, 1024), 3, "cpu")
    assert abs(float(e.std()) * 32 - 1) < 0.02
    w = wg.draw("tts.decoder.layer_0.mamba.in_proj.weight", (512, 1024), 3, "cpu")
    assert abs(float(w.std()) * 32 - 1) < 0.02
    assert torch.equal(w, wg.draw("tts.decoder.layer_0.mamba.in_proj.weight", (512, 1024), 3,
                                  "cpu"))
    assert not torch.equal(w, wg.draw("tts.decoder.layer_0.mamba.in_proj.weight", (512, 1024),
                                      4, "cpu"))
    assert float(wg.draw("tts.decoder.layer_0.mamba.D", (8,), 3, "cpu").min()) == 1.0
    # the layers' inputs at weights.py's scale over the embedding multiplier
    t = wg.draw("tts.decoder.token_embed.weight", (1026, 4096), 3, "cpu", 12.0)
    assert abs(float(t.std()) * 64 * 12 - 1) < 0.02
    assert torch.allclose(t * 12, wg.draw("tts.decoder.token_embed.weight", (1026, 4096), 3,
                                          "cpu"), rtol=1e-6, atol=0)
    assert torch.equal(w, wg.draw("tts.decoder.layer_0.mamba.in_proj.weight", (512, 1024), 3,
                                  "cpu", 12.0))


def tiny_granite(root: Path) -> dict:
    """A tiny granite configuration, mix, limits and cell written under
    ``root`` (a copy of the benchmark); returns the spec."""
    spec = tiny.make(root)
    model = tiny.model_config()
    model["decoder"] = {
        "block": "granite", "codebook_size": 10, "num_special_tokens": 2, "d_model": 64,
        "n_layers": 3, "n_heads": 4, "n_kv_heads": 2, "d_style": 32, "max_len": 128,
        "num_quantizers": 5, "layer_types": ["mamba", "attention", "mamba"], "norm_eps": 1e-5,
        "mamba2": {"n_heads": 8, "head_dim": 16, "d_state": 16, "n_groups": 1, "d_conv": 4,
                   "chunk": 32},
        "moe": {"n_experts": 8, "top_k": 2, "d_expert": 24, "d_shared": 32, "experts_held": 3},
        "embedding_multiplier": 12.0, "residual_multiplier": 0.22,
        "attention_multiplier": 0.0625, "logits_scaling": 16.0, "dtype": "bfloat16"}
    (root / "configs" / "tiny-granite.json").write_text(json.dumps(
        {"name": "tiny-granite", "source": "test", "reduced": [], "quant": "none",
         "decode": {"path": "hybrid_greedy_decode", "dtype": "bfloat16"}, "model": model}))
    traffic = json.loads((root / "traffic" / "batch.json").read_text())
    traffic.update(kind="serve_granite", batch=3, check={"requests": 1, "rows": 2})
    (root / "traffic" / "batch-granite.json").write_text(json.dumps(traffic))
    (root / "limits" / "tiny-granite.batch.json").write_text(json.dumps(
        {"logit_gap": 0.1, "wave_err": 1e-3}))
    spec["workloads"] = [{"name": "tiny-granite.batch", "config": "tiny-granite",
                          "traffic": "batch-granite", "chips": 1, "why": "test"}]
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    mine = {m["name"] for m in real["end_to_end"] + real["per_layer"]
            if "granite.narration-b16" in m.get("workloads", ["granite.narration-b16"])}
    for m in spec["end_to_end"] + spec["per_layer"]:  # the metrics of the granite cell
        m["workloads"] = ["tiny-granite.batch"] if m["name"] in mine else []
    return spec


def test_a_tiny_granite_cell_runs_and_reads_its_metrics(tmp_path):
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    spec = tiny_granite(tmp_path / "portbench")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); sys.path.append(sys.argv[2]);"
            "import torch; torch.set_num_threads(2);"
            "from portbench import run;"
            "print(json.dumps([run.execute('tiny-granite.batch', 2**31 + 5, 0.05, t, 'cpu')"
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
    assert traced["metrics"]["mfu.granite.serve"]["value"] > 0
    assert {"frontend_ms.serve", "frontend_share.serve", "decode_setup_ms.serve",
            "decode_ms_per_step.serve", "graph_captures.serve",
            "uncast_weight_share.serve"} <= set(traced["metrics"])
    # off the card the spans carry no device time, and no kernel runs
    assert not {"granite_step_roofline.serve", "mamba2_step_roofline",
                "moe_prefill_share.serve", "moe_prefill_ms.serve",
                "granite_attention_decode_roofline"} & set(traced["metrics"])


def test_a_program_without_the_granite_decoder_fails_at_once(tmp_path, monkeypatch):
    """On a program without the granite decoder ``serve_granite.build``
    raises before it builds anything."""
    import builtins

    from portbench.drivers import serve_granite

    real = builtins.__import__

    def no_granite(name, *a, **k):
        if name == "mamba_tts_torch.models.granite":
            raise ModuleNotFoundError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_granite)
    monkeypatch.setattr(serve_granite.importlib, "import_module",
                        lambda n: no_granite(n))
    try:
        serve_granite.build(GRANITE, 1, "cpu")
    except ModuleNotFoundError:
        return
    raise AssertionError("the build did not fail")
