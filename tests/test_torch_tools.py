"""The last small surfaces of the port against the JAX package on the CPU.

``SMSDPipeline`` (style-prompt strings in; the loss, or samples with
``(pi, mu, sigma)``) on weights carried across by the bridge, the sample
with JAX's noise handed in; ``utils/profiling.annotate`` as a context
manager and as a decorator; ``parallel/distributed.initialize_multihost``
in a lone process; ``tools/parity_check`` (``measure_parity`` and its CLI).
float32 throughout."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_tts_tpu.config import SMSDConfig as JSMSDConfig
from mamba_tts_tpu.models.smsd import SMSDPipeline as JPipeline
from mamba_tts_torch import config as tconfig
from mamba_tts_torch.bridge import bert_from_params, load_params
from mamba_tts_torch.models.layers import seed_init
from mamba_tts_torch.models.smsd import SMSD, SMSDPipeline
from mamba_tts_torch.models.style_text_encoder import StyleTextEncoder
from mamba_tts_torch.models.tts import MambaTTS
from mamba_tts_torch.tools import parity_check

PROMPTS = ["speak fast", "a calm low voice"]
STATS = {"argmax_flip_rate", "logit_rel_diff_max", "logit_rel_diff_mean", "top2_margin_mean",
         "positions"}  # the keys of the JAX tool's stats


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pipelines():
    cfg = JSMSDConfig(bert_dim=32, style_dim=8, num_mixtures=3, hidden_dim=16)
    jpipe = JPipeline(cfg)
    tcfg = tconfig.SMSDConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    enc_cfg = tconfig.StyleEncoderConfig(d_model=32, n_layers=2, n_heads=8, d_ff=128)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    encoder = StyleTextEncoder(enc_cfg, module=bert_from_params(enc_cfg, to_np(jpipe.encoder.params)),
                               device="cpu")
    tpipe = SMSDPipeline(tcfg, style_encoder=encoder,
                         module=load_params(SMSD(tcfg), to_np(jpipe.params)), device="cpu")
    return jpipe, tpipe


def test_smsd_pipeline_loss_and_params_match_jax(pipelines):
    jpipe, tpipe = pipelines
    y_true = np.random.default_rng(0).standard_normal((2, 8)).astype(np.float32)
    want = float(jpipe(PROMPTS, y_true=y_true))
    assert abs(float(tpipe(PROMPTS, y_true=y_true)) - want) <= 1e-4 * abs(want)
    y_j, params_j = jpipe(PROMPTS, return_params=True, seed=0)
    # the draws of JAX's sample_mixture under its key, handed to the port
    pi = params_j[0]
    k_rng, n_rng = jax.random.split(jax.random.PRNGKey(0))
    k = torch.from_numpy(np.asarray(jax.random.categorical(k_rng, jnp.log(pi + 1e-8), axis=-1)))
    eps = torch.from_numpy(np.asarray(jax.random.normal(n_rng, (2, 8), jnp.float32)))
    y_t, params_t = tpipe(PROMPTS, return_params=True, k=k, eps=eps)
    for got, want in zip((y_t, *params_t), (y_j, *params_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    assert tuple(tpipe(PROMPTS[0]).shape) == (1, 8)  # a string is a batch of one
    g = torch.Generator().manual_seed(5)
    y_a = tpipe(PROMPTS, generator=g)
    assert torch.equal(y_a, tpipe(PROMPTS, generator=torch.Generator().manual_seed(5)))


def test_annotate_names_a_profiler_scope():
    from mamba_tts_torch.utils.profiling import annotate

    @annotate("decorated_scope")
    def f(x):
        return x * 2

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with annotate("context_scope"):
            y = torch.ones(4).sum()
        z = f(torch.ones(2))
    names = {e.name for e in prof.events()}
    assert {"context_scope", "decorated_scope"} <= names
    assert float(y) == 4.0 and z.tolist() == [2.0, 2.0]


def test_initialize_multihost_in_a_lone_process_is_a_no_op():
    from mamba_tts_torch.parallel.distributed import initialize_multihost

    info = initialize_multihost()
    assert info == {"process_index": 0, "process_count": 1, "local_devices": 1,
                    "global_devices": 1}
    assert initialize_multihost() == info
    with pytest.raises(ValueError, match="num_processes"):
        initialize_multihost("localhost:1")


def test_measure_parity_rows_and_the_scan_switch():
    cfg = tconfig.from_json(open("tests/smoke_config.json").read())
    model = seed_init(MambaTTS(cfg), 0).eval()
    out = parity_check.measure_parity(model, cfg, frames=2, batch=2)
    assert set(out) == {"hopper", "plain", "megakernel_bflow_bflokv", "megakernel_int8w_bflokv",
                        "megakernel_int8w_int8kv"}
    for row in out.values():
        assert set(row) == STATS and row["positions"] == 2 * 2 * cfg.decoder.num_quantizers
        assert 0.0 <= row["argmax_flip_rate"] <= 1.0
    assert out["hopper"] == out["plain"]  # on the CPU both are the plain scan
    assert out["plain"]["logit_rel_diff_max"] < 1e-5  # the f32 step decode and forward agree
    from mamba_tts_torch.models import mamba
    from mamba_tts_torch.ops.selective_scan import selective_scan

    assert mamba.selective_scan is selective_scan  # the switch put the kernel scan back


def test_parity_check_cli_trains_then_measures(tmp_path, capsys):
    out = parity_check.main(["--config_json", "tests/smoke_config.json", "--train_steps", "1",
                             "--frames", "2", "--batch", "1", "--device", "cpu"])
    assert out["batch"] == 1 and set(out["greedy_parity"]["plain"]) == STATS
    assert '"greedy_parity"' in capsys.readouterr().out
