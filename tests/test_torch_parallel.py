"""The parallel slice of the port against the JAX package on the CPU.

Multi-rank runs are worlds of spawned ranks over gloo
(``mamba_tts_torch.parallel.dryrun.spawn``, a ``file://`` init in a fresh
temporary directory): one world of 2 and one of 4 ranks for the training
checks, one of 2 for serving, each running several checks
(``tests/test_torch_parallel_ranks.py``).  The JAX side runs in this process
on its virtual CPU devices.  Inputs come from seeded numpy generators.

- the rule table: every leaf of the JAX tree splits on the same logical
  axis in both packages, indivisible dims replicated;
- the time-sharded scan over 2 and 4 ranks against JAX's ``sp_selective_scan``
  (2e-4) and its gradients against the single-rank scan (2e-3);
- ``use_sp_scan`` wired into the decoder: loss (5e-4) and gradients
  (rtol 5e-2, atol 1.5e-3) against JAX's sp decoder; without a mesh it raises;
- deterministic dp x tp steps at (2, 1), (1, 2) and (2, 2), and at (2, 2)
  with the scans time-sharded over "data" as well, against the single-rank
  step (losses 5e-4, gradients rtol 5e-2 / atol 1.5e-3) and JAX's losses;
  a step with dropout leaves every rank's replicated parameters equal; a
  global-norm clip that triggers;
- the checkpoint round trip at (2, 2) and into (1, 4);
- data-parallel serving on 2 ranks: 3 rows (padded to 4) against per-row
  decodes (wav atol 2e-4), the megakernel's row tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parallel_ranks as ranks
from mamba_tts_tpu import config as jconfig
from mamba_tts_tpu.models import tts as jtts
from mamba_tts_tpu.models.decoder import MambaTTSDecoder as JDecoder
from mamba_tts_tpu.parallel.mesh import _path_str, make_mesh as jmake_mesh, param_shardings
from mamba_tts_tpu.parallel.sp_scan import sp_selective_scan as jsp_scan
from mamba_tts_torch import config as tconfig
from mamba_tts_torch.bridge import _target, load_params
from mamba_tts_torch.models.decoder import MambaTTSDecoder
from mamba_tts_torch.models.layers import Conv, Dense
from mamba_tts_torch.models.tts import MambaTTS
from mamba_tts_torch.ops.selective_scan import selective_scan_ref
from mamba_tts_torch.parallel import mesh as tmesh
from mamba_tts_torch.parallel.dryrun import dryrun_multichip, spawn, train_check

LOSS_TOL = 5e-4  # relative
GRAD_RTOL, GRAD_ATOL = 5e-2, 1.5e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _step_cfg(clip=1.0):
    """The JAX dry run's widths, one layer a stack, in float32."""
    cl = jconfig
    return cl.TTSConfig(
        decoder=cl.DecoderConfig(
            d_model=64, n_layers=1, n_heads=4, d_ff=128, d_style=32, max_len=256,
            num_quantizers=5, mamba=cl.MambaConfig(d_model=64, d_state=4), dtype="float32",
            scan_chunk=8),
        text_encoder=cl.TextEncoderConfig(vocab_size=79, d_model=64, n_layers=1, n_heads=2,
                                          d_k=16, d_v=16, d_inner=128, dtype="float32"),
        duration=cl.DurationPredictorConfig(d_model=64, filter_size=32, dtype="float32"),
        smsd=cl.SMSDConfig(bert_dim=64, style_dim=32, num_mixtures=3, hidden_dim=48),
        style=cl.StylePipelineConfig(d_style=32, d_model=64, num_heads=4, dtype="float32"),
        train=cl.TrainConfig(grad_clip_norm=clip),
    )


def _batch(cfg, B=4, L=6, S=8, seed=1):
    rng = np.random.default_rng(seed)
    Q, V = cfg.decoder.num_quantizers, cfg.decoder.vocab_size_audio
    text_mask = np.ones((B, L), bool)
    text_mask[1, 4:] = False
    target = rng.integers(2, V, (B, S, Q)).astype(np.int32)
    target[3, 6:] = 0
    return {
        "phoneme_ids": (rng.integers(1, cfg.text_encoder.vocab_size, (B, L)) * text_mask
                        ).astype(np.int32),
        "text_mask": text_mask,
        "style_bert": rng.standard_normal((B, cfg.smsd.bert_dim)).astype(np.float32),
        "spk_embs": rng.standard_normal((B, cfg.smsd.style_dim)).astype(np.float32),
        "target_codec": target,
        "target_frames": np.array([S, S, S, 6], np.int32),
        "voice_codec": rng.integers(2, V, (B, S, Q)).astype(np.int32),
    }


@pytest.fixture(scope="module")
def step_setup():
    """JAX's losses on the step config, its params and the z_style draw."""
    jcfg = _step_cfg()
    batch = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = jtts.MambaTTS(jcfg)
    sample_rng = jax.random.PRNGKey(3)
    params = jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
         "noise": jax.random.PRNGKey(2)}, jb, sample_rng, use_nar_branch=True,
        method=jtts.MambaTTS.compute_losses))()["params"]
    losses = jax.jit(lambda p: model.apply({"params": p}, jb, sample_rng, deterministic=True,
                                           method=jtts.MambaTTS.compute_losses))(params)
    pi, _, _ = model.apply({"params": params}, jb["style_bert"], True,
                           method=lambda m, x, d: m.smsd(x, deterministic=d))
    k_rng, n_rng = jax.random.split(sample_rng)
    style = {"k": np.asarray(jax.random.categorical(k_rng, jnp.log(pi + 1e-8), axis=-1)),
             "eps": np.asarray(jax.random.normal(n_rng, (pi.shape[0], jcfg.smsd.style_dim)))}
    cfg_json = jconfig.to_json(jcfg)
    step = (cfg_json, batch, _np(params), 0, "cpu", style)
    single = train_check(*step)
    return dict(jcfg=jcfg, batch=batch, params=_np(params), style=style, step=step,
                single=single, jax_losses={k: float(v) for k, v in losses.items()})


def _scan_inputs(Bz=2, T=40, D=16, N=4, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    u = rng.standard_normal((Bz, T, D)).astype(f)
    delta = np.log1p(np.exp(rng.standard_normal((Bz, T, D)) - 1)).astype(f)
    A = -np.exp(rng.standard_normal((D, N))).astype(f)
    B, C = (rng.standard_normal((Bz, T, N)).astype(f) for _ in range(2))
    Dk = rng.standard_normal(D).astype(f)
    weights = (rng.standard_normal((Bz, T, D)).astype(f), rng.standard_normal((Bz, N, D)).astype(f))
    return (u, delta, A, B, C, Dk), weights


def _sp_decoder_case():
    cl = jconfig
    cfg = cl.TTSConfig(decoder=cl.DecoderConfig(
        d_model=32, n_layers=1, n_heads=2, d_ff=32, d_style=16, max_len=256, num_quantizers=5,
        mamba=cl.MambaConfig(d_model=32, d_state=4), dtype="bfloat16", scan_chunk=8,
        use_sp_scan=True))
    c = cfg.decoder
    rng = np.random.default_rng(1)
    B, Q, F, Tt = 2, c.num_quantizers, 8, 6  # flat T = 40
    lo, hi = c.num_special_tokens, c.vocab_size_audio
    inputs = {
        "audio_tokens": rng.integers(lo, hi, (B, Q, F)).astype(np.int64),
        "text_hidden": rng.standard_normal((B, Tt, c.d_model)).astype(np.float32),
        "z_style": rng.standard_normal((B, c.d_style)).astype(np.float32),
        "text_mask": np.ones((B, Tt), bool),
        "targets": rng.integers(lo, hi, (B, Q * F)).astype(np.int64),
    }
    return cfg, inputs


@pytest.fixture(scope="module")
def sp_case():
    """JAX's sp decoder over 2 devices: loss and gradients."""
    cfg, inputs = _sp_decoder_case()
    mesh = jmake_mesh((2,), ("data",), devices=jax.devices()[:2])
    dec = JDecoder(cfg.decoder, sp_mesh=mesh)
    ji = {k: jnp.asarray(v) for k, v in inputs.items()}
    ji["text_hidden"] = ji["text_hidden"].astype(jnp.bfloat16)
    ji["z_style"] = ji["z_style"].astype(jnp.bfloat16)
    params = jax.jit(lambda: dec.init(jax.random.PRNGKey(4), ji["audio_tokens"],
                                      ji["text_hidden"], ji["z_style"], ji["text_mask"]))()["params"]

    def loss_fn(p):
        logits = dec.apply({"params": p}, ji["audio_tokens"], ji["text_hidden"], ji["z_style"],
                           ji["text_mask"])
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, ji["targets"][..., None], -1))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    inputs = {**inputs, "text_hidden": np.asarray(ji["text_hidden"].astype(jnp.float32)),
              "z_style": np.asarray(ji["z_style"].astype(jnp.float32))}
    # the port feeds the bf16-rounded activations as bf16
    inputs["text_hidden"] = torch.from_numpy(inputs["text_hidden"]).bfloat16().float().numpy()
    return dict(cfg=cfg, inputs=inputs, params=_np(params), loss=float(loss),
                grads=_np(grads))


@pytest.fixture(scope="module")
def world2(step_setup, sp_case):
    scan = _scan_inputs()
    dec_inputs = {**sp_case["inputs"]}
    out = spawn(2, ranks.sp_world, scan,
                (jconfig.to_json(sp_case["cfg"]), sp_case["params"], dec_inputs),
                step_setup["step"])
    return dict(scan=scan, out=out)


@pytest.fixture(scope="module")
def world4(step_setup, tmp_path_factory):
    s = step_setup
    noisy = (s["step"][0], s["batch"], s["params"], 0, "cpu", None)
    clip_json = jconfig.to_json(_step_cfg(clip=1e-7))
    clip = (clip_json, s["batch"], s["params"], 0, "cpu", s["style"])
    ckpt = (s["step"][0], s["batch"], s["style"], str(tmp_path_factory.mktemp("ck")))
    jcfg = s["jcfg"]
    odd_json = jconfig.to_json(dataclasses.replace(
        jcfg, decoder=dataclasses.replace(jcfg.decoder, d_ff=99)))
    odd = (odd_json, s["batch"], None, 0, "cpu", s["style"])
    scan4 = _scan_inputs()
    out = spawn(4, ranks.dp_tp_world, s["step"], noisy, clip, ckpt, odd)
    scan_out = spawn(4, ranks.scan_check, *scan4)
    return dict(out=out, scan=scan4, scan_out=scan_out, single_clip=train_check(*clip),
                single_odd=train_check(*odd))


# --------------------------------------------------------------- rule table


class _Mesh:
    """The rule table reads only the axis sizes of a mesh."""
    mesh_dim_names = ("data", "model")

    def __init__(self, data, model):
        self.shape = (data, model)

    def size(self, i):
        return self.shape[i]


def _torch_dim(mod, leaf, jdim):
    """The torch dim of a Flax leaf's dim ``jdim`` (the bridge's layouts)."""
    if isinstance(mod, Dense) and leaf == "kernel":
        return 1 - jdim
    if isinstance(mod, Conv) and leaf == "kernel":
        return (2, 1, 0)[jdim]
    return jdim


@pytest.mark.parametrize("tp", [2, 4])
def test_rule_table_splits_every_jax_leaf_on_the_same_axis(tp, step_setup):
    params = step_setup["params"]
    jspecs = param_shardings(jax.tree.map(jnp.asarray, params),
                             jmake_mesh((8 // tp, tp), ("data", "model")))
    port = MambaTTS(tconfig.from_json(jconfig.to_json(step_setup["jcfg"])))
    tsplit = tmesh.param_shardings(dict(port.named_parameters()), _Mesh(8 // tp, tp))
    seen = []

    def check(kp, sharding, leaf_value):
        path = _path_str(kp).split("/")
        mod = port.get_submodule(".".join(path[:-1]))
        name = ".".join(path[:-1] + [_target(mod, path[-1], leaf_value)[0]])
        jdims = [d for d, a in enumerate(sharding.spec) if a == "model"]
        split = tsplit[name]
        seen.append(name)
        if not jdims:
            assert split is None, name
        else:
            assert split is not None and split.dim == _torch_dim(mod, path[-1], jdims[0]), name

    jax.tree_util.tree_map_with_path(check, jspecs, params)
    assert sorted(seen) == sorted(tsplit)  # every port parameter is a JAX leaf
    assert sum(v is not None for v in tsplit.values()) == 19 + 2 * 10  # a layer, 2 blocks


def test_indivisible_dims_are_replicated_and_in_proj_splits_both_halves():
    mesh = _Mesh(4, 2)
    odd = tmesh.param_shardings({"mamba.in_proj.weight": torch.zeros(9, 7)}, mesh)
    assert odd == {"mamba.in_proj.weight": None}  # JAX: the (7, 9) kernel, 9 % 2 != 0
    w = torch.arange(8.0)[:, None].expand(8, 3)  # rows 0-3: the x half, 4-7: the z half
    full = {"mamba.in_proj.weight": w, "norm.weight": torch.ones(3)}
    for rank in range(2):
        class _Rank(_Mesh):
            def get_local_rank(self, axis, rank=rank):
                return rank
        local = tmesh.shard_params(full, _Rank(1, 2))
        assert local["mamba.in_proj.weight"][:, 0].tolist() == [2 * rank, 2 * rank + 1,
                                                                 4 + 2 * rank, 5 + 2 * rank]
        assert local["norm.weight"] is full["norm.weight"]


class _GroupMesh(_Mesh):
    """Enough of a mesh to build a model on: rank 0, groups as tokens."""

    def get_group(self, axis):
        return f"group:{axis}"

    def get_local_rank(self, axis):
        return 0


def _odd_cfg(tp):
    """Widths where some of the model's split dims divide into ``tp`` and
    others do not."""
    cl = tconfig
    dec = cl.DecoderConfig(d_model=64, n_layers=1, n_heads=4, d_ff=99 if tp == 3 else 98,
                           d_style=32, max_len=64, num_quantizers=2,
                           mamba=cl.MambaConfig(d_model=64, d_state=4), dtype="float32")
    return cl.TTSConfig(decoder=dec, style=cl.StylePipelineConfig(
        d_style=32, d_model=42, num_heads=3 if tp == 3 else 2, dtype="float32"))


@pytest.mark.parametrize("tp", [3, 4])
def test_a_model_on_a_mesh_builds_the_widths_of_param_shardings(tp):
    # one rule source: each module's local width is its full width cut by
    # param_shardings, replicated where the dim does not divide
    cfg = _odd_cfg(tp)
    full = dict(MambaTTS(cfg).named_parameters())
    mesh = _GroupMesh(1, tp)
    want = tmesh.param_shardings(full, mesh)
    model = MambaTTS(cfg, mesh=mesh)
    assert model.shardings == want
    local = tmesh.shard_params(full, mesh)
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == {
        n: tuple(t.shape) for n, t in local.items()}
    split = {n.split(".")[-2] for n, s in want.items() if s is not None}
    replicated = {n.split(".")[-2] for n, s in want.items()
                  if s is None and tmesh.partition_spec_for_path(n) is not None}
    if tp == 4:  # d_ff 98 and the style attention's 42 do not divide
        assert {"ff1", "ff2", "q_proj", "o_proj"} <= replicated and "ffn1" in split
        assert "in_proj" in split and "ff1" not in split
    else:  # d_model 64 and d_inner 128 do not divide, d_ff 99 and 42 do
        assert {"ff1", "ff2", "ffn1", "ffn2"} <= split
        assert {"in_proj", "x_proj", "out_proj"} <= replicated and "in_proj" not in split
    bad = tconfig.TTSConfig(decoder=dataclasses.replace(cfg.decoder, n_heads=2),
                            style=cfg.style)
    with pytest.raises(ValueError, match="heads"):
        MambaTTS(bad, mesh=_GroupMesh(1, 4))  # d_model splits, its 2 heads do not


# ---------------------------------------------------------- sequence parallel


def _scan_ref(inputs, weights):
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    y, h = selective_scan_ref(*ts)
    ((y * torch.from_numpy(weights[0])).sum() + (h * torch.from_numpy(weights[1])).sum()).backward()
    return y.detach().numpy(), h.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("S", [2, 4])
def test_sp_scan_matches_jax_and_its_gradients_the_single_rank_scan(S, world2, world4):
    inputs, weights = world2["scan"] if S == 2 else world4["scan"]
    outs = world2["out"] if S == 2 else world4["scan_out"]
    got = outs[0]["scan"] if S == 2 else outs[0]
    mesh = jmake_mesh((S,), ("data",), devices=jax.devices()[:S])
    y_j, h_j = jsp_scan(*(jnp.asarray(x) for x in inputs), mesh=mesh, chunk=8)
    np.testing.assert_allclose(got["y"], np.asarray(y_j), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got["h"], np.asarray(h_j), rtol=2e-4, atol=2e-4)
    _, _, grads = _scan_ref(inputs, weights)
    for g, want in zip(got["grads"], grads):
        np.testing.assert_allclose(g, want, rtol=2e-3, atol=2e-3)
    for rank_out in outs[1:]:  # every rank holds the whole y and h_final
        r = rank_out["scan"] if S == 2 else rank_out
        np.testing.assert_array_equal(r["y"], got["y"])
        np.testing.assert_array_equal(r["h"], got["h"])


def test_replicate_takes_rank_0s_tensors(world2):
    for r in world2["out"]:
        assert r["replicated"].tolist() == [1.0, 1.0, 1.0]


def test_sp_decoder_loss_and_gradients_match_jax(sp_case, world2):
    got = world2["out"][0]["decoder"]
    assert abs(got["loss"] - sp_case["loss"]) < 5e-4, (got["loss"], sp_case["loss"])
    want = dict(load_params(MambaTTSDecoder(tconfig.from_json(
        jconfig.to_json(sp_case["cfg"])).decoder, sp_mesh=object()), sp_case["grads"]
    ).named_parameters())
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g, want[name].detach().numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def test_use_sp_scan_without_a_mesh_raises():
    cfg = tconfig.DecoderConfig(d_model=16, n_layers=1, n_heads=2, d_ff=32, d_style=8,
                                max_len=64, num_quantizers=1,
                                mamba=tconfig.MambaConfig(d_model=16, d_state=2),
                                use_sp_scan=True)
    with pytest.raises(ValueError, match="use_sp_scan"):
        MambaTTSDecoder(cfg)
    with pytest.raises(ValueError, match="use_sp_scan"):
        MambaTTS(tconfig.TTSConfig(decoder=cfg))


# ------------------------------------------------------------------ dp x tp


def _assert_step_matches(got, single, jax_losses, what):
    # the norm before clipping: the data-summed gradients over every shard once
    assert abs(got["norm"] - single["norm"]) <= LOSS_TOL * single["norm"], what
    for k, want in single["losses"].items():
        assert abs(got["losses"][k] - want) <= LOSS_TOL * abs(want), (what, k)
        assert abs(got["losses"][k] - jax_losses[k]) <= LOSS_TOL * abs(jax_losses[k]), (what, k)
    for name, want in single["grads"].items():
        np.testing.assert_allclose(got["grads"][name], want, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("shape", ["2,1", "1,2", "2,2", "2,2 sp"])
def test_dp_tp_step_matches_the_single_rank_step_and_jax(shape, step_setup, world2, world4):
    s = step_setup
    got = {"2,1": lambda: world2["out"][0]["steps"][(2, 1)],
           "1,2": lambda: world2["out"][0]["steps"][(1, 2)],
           "2,2": lambda: world4["out"][0]["step"],
           "2,2 sp": lambda: world4["out"][0]["sp_step"]}[shape]()
    _assert_step_matches(got, s["single"], s["jax_losses"], shape)
    ranks_out = world2["out"] if shape in ("2,1", "1,2") else world4["out"]
    key = {"2,1": "steps", "1,2": "steps", "2,2": "step", "2,2 sp": "sp_step"}[shape]
    for r in ranks_out[1:]:  # each rank's losses are the global batch's
        other = r[key][(2, 1) if shape == "2,1" else (1, 2)] if key == "steps" else r[key]
        assert other["losses"] == got["losses"]


def test_single_rank_step_matches_jax(step_setup):
    s = step_setup
    for k, want in s["jax_losses"].items():
        assert abs(s["single"]["losses"][k] - want) <= LOSS_TOL * abs(want), k


def test_step_with_dropout_keeps_replicated_parameters_equal_on_every_rank(world4):
    noisy = [r["noisy"] for r in world4["out"]]
    assert noisy[0]
    for other in noisy[1:]:
        assert other.keys() == noisy[0].keys()
        for name, p in other.items():
            np.testing.assert_array_equal(p, noisy[0][name], err_msg=name)


def test_global_norm_clip_that_triggers(world4):
    got, single = world4["out"][0]["clip"], world4["single_clip"]
    assert single["norm"] > 1e-7  # the clip to 1e-7 triggers
    assert abs(got["norm"] - single["norm"]) <= 1e-4 * single["norm"]
    for name, want in single["params"].items():
        np.testing.assert_allclose(got["params"][name], want, rtol=1e-5, atol=2e-8,
                                   err_msg=name)


def test_step_with_replicated_dims_matches_the_single_rank_step(world4):
    # d_ff 99 on 2 model ranks: ff1/ff2 replicated (JAX's rule), the norm
    # counts them once and the gathered gradients are the full ones
    got, single = world4["out"][0]["odd_step"], world4["single_odd"]
    assert got["grads"]["decoder.layer_0.ff1.weight"].shape == (99, 64)
    assert "decoder.layer_0.ff1.weight" in got["replicated"]
    assert abs(got["norm"] - single["norm"]) <= LOSS_TOL * single["norm"]
    for k, want in single["losses"].items():
        assert abs(got["losses"][k] - want) <= LOSS_TOL * abs(want), k
    for name, want in single["grads"].items():
        np.testing.assert_allclose(got["grads"][name], want, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_checkpoint_round_trip_across_mesh_shapes(world4):
    for r in world4["out"]:
        c = r["ckpt"]
        assert c["same_mesh"] and c["other_mesh"]
        assert abs(c["loss_restored"] - c["loss_mem"]) < 1e-5
        assert abs(c["loss_restored_1x4"] - c["loss_mem"]) < 1e-5


# ------------------------------------------------------------------ serving


@pytest.fixture(scope="module")
def serving():
    cfg_json = open("tests/smoke_config.json").read()
    sr = tconfig.from_json(cfg_json).codec.sample_rate
    t = np.arange(3200) / sr
    voices = [(0.3 * np.sin(2 * np.pi * (180.0 + 20 * i) * t)).astype(np.float32)
              for i in range(3)]
    texts = [f"hello world number {i}" for i in range(3)]
    return spawn(2, ranks.serving_world, cfg_json, texts, ["calm"] * 3, voices, 32)


@pytest.mark.parametrize("quant", ["none", "megakernel"])
def test_data_parallel_serving_matches_per_row_decodes(quant, serving):
    got = serving[0][quant]
    assert got["wav_dp"].shape[0] == 3  # 3 rows on 2 ranks: padded to 4, trimmed
    np.testing.assert_array_equal(serving[1][quant]["wav_dp"], got["wav_dp"])
    for i, wav in enumerate(got["singles"]):
        np.testing.assert_allclose(got["wav_dp"][i][:len(wav)], wav, atol=2e-4,
                                   err_msg=f"row {i}")


def test_data_parallel_megakernel_tokens_equal_one_rank(serving):
    got = serving[0]["megakernel"]
    assert got["tokens_dp"].shape[0] == 3
    np.testing.assert_array_equal(got["tokens_dp"][0], got["tokens_row0"][0])


def test_dryrun_multichip_runs_one_full_step_on_a_2x2_mesh():
    losses = dryrun_multichip(4)
    assert len(losses) == 4 and set(losses[0]) == {"loss_total", "loss_codec", "loss_dur",
                                                   "loss_smsd"}
    assert all(np.isfinite(v) for v in losses[0].values())
