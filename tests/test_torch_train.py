"""The training slice of the port against the JAX package on the CPU.

``MambaTTS.compute_losses`` (all four losses) and the gradient of every
parameter on weights carried across by the bridge, at the smoke config with
``deterministic=True`` on both sides and the ``sample_mixture`` draw handed
over from JAX's key split; the SMSD and duration losses and the style draw
per variance mode; one optimizer update against optax; the trainer CLI on
the CPU (checkpoint, resume, flags that are not ported); dropout's masks.
Inputs come from seeded numpy generators; float32 throughout."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mamba_tts_tpu import config as jconfig
from mamba_tts_tpu.models import smsd as jsmsd
from mamba_tts_tpu.models import text_encoder as jte
from mamba_tts_tpu.models import tts as jtts
from mamba_tts_torch import config as tconfig
from mamba_tts_torch.bridge import load_params
from mamba_tts_torch.models import smsd as tsmsd
from mamba_tts_torch.models import text_encoder as tte
from mamba_tts_torch.models import tts as ttts
from mamba_tts_torch.models.decoder import MambaTTSDecoder
from mamba_tts_torch.models.layers import dropout, seed_init
from mamba_tts_torch.models.tts import MambaTTS
from mamba_tts_torch.train import state as state_lib
from mamba_tts_torch.train import train as train_lib

SMOKE = "tests/smoke_config.json"
LOSS_TOL = 1e-4  # relative, per loss: the same f32 graph, another summation order
GRAD_TOL = 1e-3  # relative to each parameter's largest gradient magnitude


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs six test
    processes on the machine's cores, and torch's default of a thread per
    core in each oversubscribes them (six concurrent CPU train steps at the
    smoke config took minutes each with eight threads, about a second with
    one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, B=2, L=12, S=16, seed=0):
    rng = np.random.default_rng(seed)
    Q, V = cfg.decoder.num_quantizers, cfg.decoder.vocab_size_audio
    text_mask = np.ones((B, L), bool)
    text_mask[1, 9:] = False
    target = rng.integers(2, V, (B, S, Q)).astype(np.int32)
    target[1, 13:] = 0  # a shorter second item: PAD frames
    voice = rng.integers(2, V, (B, S, Q)).astype(np.int32)
    voice[0, 11:] = 0
    return {
        "phoneme_ids": (rng.integers(1, cfg.text_encoder.vocab_size, (B, L)) * text_mask).astype(np.int32),
        "text_mask": text_mask,
        "style_bert": rng.standard_normal((B, cfg.smsd.bert_dim)).astype(np.float32),
        "spk_embs": rng.standard_normal((B, cfg.smsd.style_dim)).astype(np.float32),
        "target_codec": target,
        "target_frames": np.array([S, 13], np.int32),
        "voice_codec": voice,
    }


@pytest.fixture(scope="module")
def slice_setup():
    text = open(SMOKE).read()
    jcfg, tcfg = jconfig.from_json(text), tconfig.from_json(text)
    batch = _batch(jcfg)
    model = jtts.MambaTTS(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    sample_rng = jax.random.PRNGKey(3)
    params = jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
         "noise": jax.random.PRNGKey(2)}, jb, sample_rng, use_nar_branch=True,
        method=jtts.MambaTTS.compute_losses))()["params"]

    def loss_fn(p):
        out = model.apply({"params": p}, jb, sample_rng, deterministic=True,
                          method=jtts.MambaTTS.compute_losses)
        return out["loss_total"], out

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    # the z_style draw of compute_losses, from the same key split
    pi, _, _ = model.apply({"params": params}, jb["style_bert"], True,
                           method=lambda m, x, d: m.smsd(x, deterministic=d))
    k_rng, n_rng = jax.random.split(sample_rng)
    k = jax.random.categorical(k_rng, jnp.log(pi + 1e-8), axis=-1)
    eps = jax.random.normal(n_rng, (pi.shape[0], jcfg.smsd.style_dim), jnp.float32)
    return dict(tcfg=tcfg, batch=batch, params=_np(params), losses=_np(losses), grads=_np(grads),
                k=np.asarray(k), eps=np.asarray(eps))


def test_compute_losses_and_every_gradient_match_jax(slice_setup):
    s = slice_setup
    port = MambaTTS(s["tcfg"])
    train_lib.init_params(port, params=s["params"])  # through the weight bridge
    batch = train_lib.batch_to_device(s["batch"], torch.device("cpu"))
    losses = port.compute_losses(batch, deterministic=True, style_k=torch.from_numpy(s["k"]),
                                 style_eps=torch.from_numpy(s["eps"]))
    for key in ("loss_total", "loss_codec", "loss_dur", "loss_smsd"):
        want = float(s["losses"][key])
        assert abs(float(losses[key]) - want) <= LOSS_TOL * abs(want), key
    losses["loss_total"].backward()
    # the JAX gradient tree in the port's layout: the bridge's own mapping
    want = dict(load_params(MambaTTS(s["tcfg"]), s["grads"]).named_parameters())
    for name, p in port.named_parameters():
        w = want[name].detach()
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= GRAD_TOL * scale + 1e-7, (name, err, scale)


@pytest.mark.parametrize("mode", ["isotropic_across_clusters", "isotropic", "diagonal", "fixed"])
def test_mixture_nll_and_sample_match_jax(mode):
    rng = np.random.default_rng(5)
    B, K, d = 3, 4, 6
    pi = rng.dirichlet(np.ones(K), B).astype(np.float32)
    mu = rng.standard_normal((B, K, d)).astype(np.float32)
    shape = {"isotropic_across_clusters": (B,), "isotropic": (B, K), "diagonal": (B, K, d),
             "fixed": (B,)}[mode]
    sigma = (0.5 + rng.random(shape)).astype(np.float32)
    y = rng.standard_normal((B, d)).astype(np.float32)
    want = jsmsd.mixture_nll_loss(*map(jnp.asarray, (y, pi, mu, sigma)), mode)
    got = tsmsd.mixture_nll_loss(*map(torch.from_numpy, (y, pi, mu, sigma)), mode)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    key = jax.random.PRNGKey(9)
    want = jsmsd.sample_mixture(key, *map(jnp.asarray, (pi, mu, sigma)), mode)
    k_rng, n_rng = jax.random.split(key)
    k = jax.random.categorical(k_rng, jnp.log(jnp.asarray(pi) + 1e-8), axis=-1)
    eps = jax.random.normal(n_rng, (B, d), jnp.float32)
    got = tsmsd.sample_mixture(*map(torch.from_numpy, (pi, mu, sigma)), mode,
                               k=torch.from_numpy(np.asarray(k)), eps=torch.from_numpy(np.asarray(eps)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_duration_and_codec_losses_match_jax():
    rng = np.random.default_rng(6)
    mask = np.array([[True] * 5, [True] * 3 + [False] * 2])
    frames = np.array([23, 7], np.int32)
    np.testing.assert_array_equal(
        ttts.heuristic_durations(torch.from_numpy(mask), torch.from_numpy(frames)).numpy(),
        np.asarray(jtts.heuristic_durations(jnp.asarray(mask), jnp.asarray(frames))))
    pred = rng.standard_normal((2, 5)).astype(np.float32)
    target = rng.integers(0, 6, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        float(tte.duration_loss(*map(torch.from_numpy, (pred, target, mask)))),
        float(jte.duration_loss(*map(jnp.asarray, (pred, target, mask)))), rtol=1e-6)
    logits = rng.standard_normal((2, 7, 9)).astype(np.float32)
    targets = rng.integers(0, 9, (2, 7)).astype(np.int32)
    targets[0, :3] = 0
    np.testing.assert_allclose(
        float(ttts.codec_ce_loss(torch.from_numpy(logits), torch.from_numpy(targets))),
        float(jtts.codec_ce_loss(jnp.asarray(logits), jnp.asarray(targets))), rtol=1e-6)


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])  # below and above the clip norm
def test_optimizer_updates_match_optax(grad_scale):
    """Three updates of clip_by_global_norm(1.0) + adam(1e-3) from the same
    params and gradients; 1e-6 (the same f32 formulas)."""
    rng = np.random.default_rng(7)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (grad_scale * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    opt = state_lib.make_optimizer(1e-3, 1.0)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts_ = opt.init(tp)
    for g in grads:
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        ts_ = opt.apply(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts_)
    assert ts_["count"] == 3
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)


def _cli(tmp_path, *extra):
    return train_lib.main([
        "--device", "cpu", "--synthetic", "--config_json", SMOKE, "--batch_size", "2",
        "--checkpoint_dir", str(tmp_path / "ck"), "--log_file", str(tmp_path / "log.jsonl"),
        *extra])


def test_cli_on_cpu_writes_checkpoints_and_resumes(tmp_path):
    out = _cli(tmp_path, "--max_steps", "2", "--checkpoint_every", "1")
    assert out["start_step"] == 0 and out["step"] == 2
    assert all(np.isfinite(list(h.values())).all() for h in out["history"])
    ck = tmp_path / "ck"
    assert (ck / "1" / "state.pt").is_file() and (ck / "2" / "state.pt").is_file()
    written = tconfig.from_json((ck / "config.json").read_text())
    assert written.decoder == tconfig.from_json(open(SMOKE).read()).decoder
    assert (written.train.batch_size, written.train.max_steps) == (2, 2)  # the CLI's overrides
    assert len((tmp_path / "log.jsonl").read_text().splitlines()) == 2
    saved, restored = state_lib.restore_params(str(ck))
    assert restored
    out = _cli(tmp_path, "--max_steps", "3", "--resume")
    assert out["start_step"] == 2 and out["step"] == 3 and len(out["history"]) == 1
    again, _ = state_lib.restore_params(str(ck), step=2)
    assert all(torch.equal(saved[n], again[n]) for n in saved)
    latest, _ = state_lib.restore_params(str(ck))
    assert any(not torch.equal(saved[n], latest[n]) for n in saved)  # step 3 moved the params


@pytest.mark.parametrize("flag", [["--mesh", "4,2"]])
def test_cli_flags_not_ported_raise(flag, tmp_path):
    # ported since parallelism is: --mesh needs one process a rank (torchrun),
    # and a lone process has no process group
    with pytest.raises(ValueError, match="one process a rank"):
        _cli(tmp_path, *flag)


def test_restore_missing_dir_is_noop(tmp_path):
    model = seed_init(MambaTTS(tconfig.from_json(open(SMOKE).read())), 0)
    params = dict(model.named_parameters())
    st = state_lib.create_train_state(params, state_lib.make_optimizer(1e-4))
    st2, restored = state_lib.restore_checkpoint(str(tmp_path / "nope"), st)
    assert not restored and st2.step == 0


def test_train_step_lowers_the_loss_of_a_fixed_batch():
    cfg = tconfig.from_json(open(SMOKE).read())
    model = train_lib.build_model(cfg)
    params = train_lib.init_params(model, seed=0)
    tx = state_lib.make_optimizer(1e-3)
    st = state_lib.create_train_state(params, tx)
    step = train_lib.make_train_step(model, tx)
    batch = train_lib.batch_to_device(_batch(cfg, S=8), torch.device("cpu"))
    first = None
    for _ in range(8):
        st, losses = step(st, batch)
        first = first if first is not None else float(losses["loss_codec"])
    assert st.step == 8 and float(losses["loss_codec"]) < first


def test_dropout_mask_comes_from_the_generator():
    x = torch.ones((64, 512))
    a = dropout(x, 0.1, False, torch.Generator().manual_seed(3))
    b = dropout(x, 0.1, False, torch.Generator().manual_seed(3))
    c = dropout(x, 0.1, False, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = float((a != 0).float().mean())
    n = x.numel()
    assert abs(kept - 0.9) <= 3 * (0.9 * 0.1 / n) ** 0.5  # within 3 sigma of the keep rate
    assert torch.equal(a[a != 0], torch.full_like(a[a != 0], 1 / 0.9))
    assert dropout(x, 0.1, True, None) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.1, False, None)


def test_noise_net_adds_scaled_noise_in_training():
    net = tsmsd.NoiseNet(0.25)
    x = torch.zeros((4, 3))
    got = net(x, deterministic=False, generator=torch.Generator().manual_seed(1))
    eps = torch.randn((4, 3), generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(got, 0.25 * eps)
    assert net(x) is x


def test_decoder_remat_gives_the_same_gradients():
    """``DecoderConfig.remat`` recomputes each layer in the backward
    (torch.utils.checkpoint): outputs and gradients equal the plain run."""
    import dataclasses

    cfg = tconfig.from_json(open(SMOKE).read()).decoder.with_mamba_dims()
    rng = np.random.default_rng(8)
    tokens = torch.from_numpy(rng.integers(2, cfg.vocab_size_audio, (2, 5, 6)))
    th = torch.from_numpy(rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((2, cfg.d_style)).astype(np.float32))
    grads = []
    for remat in (False, True):
        dec = seed_init(MambaTTSDecoder(dataclasses.replace(cfg, remat=remat)), 0)
        out = dec(tokens, th, z)
        out.square().mean().backward()
        grads.append((out.detach(), [p.grad.clone() for p in dec.parameters()]))
    torch.testing.assert_close(grads[0][0], grads[1][0])
    for a, b in zip(grads[0][1], grads[1][1]):
        torch.testing.assert_close(a, b)


def test_decoder_remat_through_the_card_branch(monkeypatch):
    """``remat`` on the card branch (``on_card`` stubbed; each kernel wrapper
    replaced by its plain version with a call count, the scan's after the
    kernels' own argument check): the backward recomputes each layer's
    checkpointing scan forward and flash forward, which the non-reentrant
    checkpoint holds to the first forward's saved tensors, so each forward
    runs 2 x n_layers times and each backward n_layers times; outputs and
    gradients equal the run without remat."""
    import dataclasses

    from mamba_tts_torch.models import attention as t_attention
    from mamba_tts_torch.ops import flash_attention as fa
    from mamba_tts_torch.ops import pallas_scan as ps
    from mamba_tts_torch.ops import selective_scan as ts

    calls = {}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return wrapper

    def scan_fwd_ckpt(u, delta, A, B, C, D, h0=None, chunk=ps.CHUNK, output=True):
        ps.check_scan_args(u, delta, A, B, C, chunk, D=D, h0=h0)
        return ps.scan_ckpt_ref(u, delta, A, B, C, D, h0, chunk, output=output)

    def flash_bwd(q, K, V, mask, O, lse, dO, scale):
        leaves = [t.detach().requires_grad_() for t in (q, K, V)]
        with torch.enable_grad():
            fa.flash_attention_ref(*leaves, mask, scale).backward(dO)
        return tuple(t.grad for t in leaves)

    for mod in (ts, t_attention):
        monkeypatch.setattr(mod, "on_card", lambda t: True)
    def no_plain_forward(*a, **k):
        raise AssertionError("the forward without checkpoints ran under a gradient")

    monkeypatch.setattr(ps, "selective_scan_fwd", no_plain_forward)
    monkeypatch.setattr(ps, "selective_scan_fwd_ckpt", counted("selective_scan_fwd_ckpt", scan_fwd_ckpt))
    monkeypatch.setattr(ps, "selective_scan_bwd", counted("selective_scan_bwd", ps.scan_bwd_ref))
    monkeypatch.setattr(fa, "flash_attention_fwd", counted("flash_attention_fwd", lambda q, K, V, m, s: (
        fa.flash_attention_ref(q, K, V, m, s), torch.zeros(q.shape[:3]))))
    monkeypatch.setattr(fa, "flash_attention_bwd", counted("flash_attention_bwd", flash_bwd))

    cfg = tconfig.from_json(open(SMOKE).read()).decoder.with_mamba_dims()
    rng = np.random.default_rng(9)
    tokens = torch.from_numpy(rng.integers(2, cfg.vocab_size_audio, (2, 5, 26)))  # Tq = 130 >= 128
    th = torch.from_numpy(rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((2, cfg.d_style)).astype(np.float32))
    runs, L = [], cfg.n_layers
    for remat in (False, True):
        calls.clear()
        dec = seed_init(MambaTTSDecoder(dataclasses.replace(cfg, remat=remat)), 0)
        out = dec(tokens, th, z)
        out.square().mean().backward()
        k = 2 if remat else 1
        assert calls == {"selective_scan_fwd_ckpt": k * L, "flash_attention_fwd": k * L,
                         "selective_scan_bwd": L, "flash_attention_bwd": L}, (remat, calls)
        runs.append((out.detach(), [p.grad.clone() for p in dec.parameters()]))
    torch.testing.assert_close(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        torch.testing.assert_close(a, b)
