"""Codec training in the port against the JAX package on the CPU.

STFT magnitudes and the two spectral losses (1e-5 relative); the 2-D conv's
"SAME" padding and the multi-resolution discriminator's logits and feature
maps on bridged weights (1e-4); the three GAN losses on given inputs
(1e-6); the codec train step's losses (1e-4 relative each) and every
parameter's gradient (1e-3 of its largest magnitude, as
tests/test_torch_train.py), without and with the adversarial terms, the
discriminator's gradients too; the quantizers' straight-through gradient;
``grad_reverse``; the codec CLI on the CPU.  Each JAX step's gradients are
read from the step itself, through an optimizer that returns them as its
state and leaves the parameters unchanged.  Inputs come from seeded numpy
generators; float32 throughout."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mamba_tts_tpu import config as jconfig
from mamba_tts_tpu.audio import mel as jmel
from mamba_tts_tpu.models import discriminator as jdisc
from mamba_tts_tpu.models import facodec as jfc
from mamba_tts_tpu.train import train_codec as jtc
from mamba_tts_torch import config as tconfig
from mamba_tts_torch.audio import mel as tmel
from mamba_tts_torch.bridge import discriminator_from_params, facodec_from_params, load_params
from mamba_tts_torch.data.dataset import VccmTTSDataset, make_synthetic_dataset
from mamba_tts_torch.models import discriminator as tdisc
from mamba_tts_torch.models import facodec as tfc
from mamba_tts_torch.models.layers import Conv2d
from mamba_tts_torch.train import state as state_lib
from mamba_tts_torch.train import train_codec as ttc

TINY = dict(ngf=4, up_ratios=(2, 4), latent_dim=16, codebook_size=10, codebook_dim=4,
            spk_dim=8, max_seq_len=64, decoder_initial_channels=32)
J_TINY, T_TINY = jconfig.CodecConfig(**TINY), tconfig.CodecConfig(**TINY)
DISC_RES = ((128, 32), (64, 16))
LOSS_TOL = 1e-4  # relative, per loss
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


def _t(x):
    return torch.from_numpy(np.array(x))


def tame_codec_params(params):
    """Halve every FACodec kernel of the JAX random init, which otherwise
    drives almost every output sample into tanh saturation, where f32
    rounding differences between two correct graphs grow to ~1e-2 (see
    tests/test_torch_frontends.py)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x * 0.5 if "kernel" in jax.tree_util.keystr(path) else x, params)


def _wav(B=2, T=1200, seed=0, scale=0.3):
    return (scale * np.random.default_rng(seed).standard_normal((B, T))).astype(np.float32)


def _close(got, want, rel, what, atol=1e-12):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= rel * scale + atol, (what, err, scale)


# ------------------------------------------------------------------ spectra


@pytest.mark.parametrize("n_fft,hop", [(64, 16), (512, 128), (1024, 256)])
def test_stft_magnitude_matches_jax(n_fft, hop):
    wav = _wav(T=2500, seed=1)
    want = np.asarray(jmel.stft_magnitude(jnp.asarray(wav), n_fft, hop))
    got = tmel.stft_magnitude(_t(wav), n_fft, hop).numpy()
    assert got.shape == (2, 1 + 2500 // hop, n_fft // 2 + 1)
    _close(got, want, 1e-5, "stft_magnitude")


def test_spectral_losses_match_jax():
    pred, target = _wav(T=2500, seed=2), _wav(T=2500, seed=3)
    for res in (((512, 128), (1024, 256), (2048, 512)), ((512, 128), (1024, 256))):
        want = float(jmel.multi_resolution_stft_loss(jnp.asarray(pred), jnp.asarray(target), res))
        got = float(tmel.multi_resolution_stft_loss(_t(pred), _t(target), res))
        assert abs(got - want) <= 1e-5 * abs(want), (res, got, want)
    want = float(jmel.mel_l1_loss(jnp.asarray(pred), jnp.asarray(target)))
    got = float(tmel.mel_l1_loss(_t(pred), _t(target)))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    np.testing.assert_array_equal(tmel.mel_filterbank(16000, 1024, 80),
                                  jmel.mel_filterbank(16000, 1024, 80))
    # one Frobenius norm over the batch: scaling one row's error moves it
    assert float(tmel.multi_resolution_stft_loss(_t(target), _t(target))) < 1e-6


# ------------------------------------------------------------ discriminator


@pytest.mark.parametrize("shape,kernel,strides", [
    ((2, 5, 10, 3), (3, 9), (1, 2)),  # an even width: 3 low, 4 high
    ((2, 5, 11, 3), (3, 9), (1, 2)),
    ((1, 7, 8, 2), (3, 3), (2, 3)),
    ((1, 4, 4, 2), (3, 3), (1, 1)),
])
def test_conv2d_same_padding_matches_flax(shape, kernel, strides):
    import flax.linen as fnn

    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    conv = fnn.Conv(6, kernel, strides=strides)
    params = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = np.asarray(conv.apply({"params": params}, jnp.asarray(x)))
    port = load_params(Conv2d(shape[-1], 6, kernel, strides), _np(params))
    got = port(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    _close(got, want, 1e-5, "conv2d")


@pytest.fixture(scope="module")
def disc_setup():
    wav = _wav(T=1200, seed=5)
    disc = jdisc.MultiSTFTDiscriminator(resolutions=DISC_RES)
    params = disc.init(jax.random.PRNGKey(2), jnp.asarray(wav))["params"]
    return wav, disc, params


def test_discriminator_logits_and_features_match_jax(disc_setup):
    wav, disc, params = disc_setup
    want = disc.apply({"params": params}, jnp.asarray(wav))
    port = discriminator_from_params(DISC_RES, _np(params))
    got = port(_t(wav))
    assert len(got) == len(want) == 2
    for (gl, gf), (wl, wf) in zip(got, want):
        _close(gl.detach().numpy(), wl, 1e-4, "logits")
        assert len(gf) == len(wf) == 5
        for a, b in zip(gf, wf):  # the port's maps are channels-first
            _close(a.detach().permute(0, 2, 3, 1).numpy(), b, 1e-4, "features")
    np.testing.assert_allclose(
        tdisc.stft_complex(_t(wav), 128, 32).numpy(),
        np.asarray(jdisc.stft_complex(jnp.asarray(wav), 128, 32)), rtol=1e-5, atol=1e-4)


def test_gan_losses_match_jax():
    rng = np.random.default_rng(6)

    def outs(shift):
        return [(rng.standard_normal((2, 5, 7)).astype(np.float32) + shift,
                 [rng.standard_normal((2, 3, 5, 4)).astype(np.float32) for _ in range(3)])
                for _ in range(2)]

    real, fake = outs(0.5), outs(-0.5)

    def to(o, f):
        return [(f(lg), [f(x) for x in fs]) for lg, fs in o]

    jr, jf, tr_, tf = to(real, jnp.asarray), to(fake, jnp.asarray), to(real, _t), to(fake, _t)
    for name in ("discriminator_loss", "feature_matching_loss"):
        want = float(getattr(jdisc, name)(jr, jf))
        got = float(getattr(tdisc, name)(tr_, tf))
        assert abs(got - want) <= 1e-6 * abs(want), (name, got, want)
    want = float(jdisc.generator_adversarial_loss(jf))
    assert abs(float(tdisc.generator_adversarial_loss(tf)) - want) <= 1e-6 * abs(want)
    # feature matching: the real features and their normaliser are constants
    r = [(lg, [x.clone().requires_grad_() for x in fs]) for lg, fs in tr_]
    f = [(lg, [x.clone().requires_grad_() for x in fs]) for lg, fs in tf]
    tdisc.feature_matching_loss(r, f).backward()
    jg = jax.grad(lambda ff: jdisc.feature_matching_loss(
        jr, [(lg, fs) for (lg, _), fs in zip(jf, ff)]))([fs for _, fs in jf])
    for (_, fs), want_fs in zip(f, jg):
        for x, w in zip(fs, want_fs):
            _close(x.grad.numpy(), w, 1e-6, "fm gradient")
    assert all(x.grad is None for _, fs in r for x in fs)


# ------------------------------------------------------------ codec training


class _Recorder(state_lib.Optimizer):
    """An optimizer that keeps each gradient it is given and moves nothing."""

    def __init__(self):
        super().__init__(0.0)
        self.grads = None

    def apply(self, params, grads, opt_state):
        self.grads = {n: g.detach().clone() for n, g in grads.items()}
        return opt_state


def _grads_as_state():
    """optax: the gradients become the new optimizer state; no update."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


@pytest.fixture(scope="module")
def codec_setup():
    wav = _wav(T=1200, seed=7)
    model = jfc.FACodec(J_TINY)
    params = jax.jit(lambda w: model.init(jax.random.PRNGKey(1), w))(jnp.asarray(wav))["params"]
    return wav, model, tame_codec_params(params)


def _port_codec(params):
    return facodec_from_params(T_TINY, _np(params))


def _check_grads(module_cls, got, want_tree):
    want = dict(load_params(module_cls, _np(want_tree)).named_parameters())
    assert set(got) == set(want)
    for name, g in got.items():
        # the floor of tests/test_torch_train.py: gradients that are zero in
        # exact arithmetic (the timbre keys' biases) are rounding noise
        _close(g.numpy(), want[name].detach().numpy(), GRAD_TOL, name, atol=1e-7)


def _check_losses(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        w = float(w)
        assert abs(float(got[k]) - w) <= LOSS_TOL * abs(w), (k, float(got[k]), w)


def test_codec_train_step_losses_and_every_gradient_match_jax(codec_setup):
    wav, model, params = codec_setup
    step = jax.jit(jtc.make_codec_train_step(model, _grads_as_state()).__wrapped__)
    _, jgrads, jmetrics = step(params, _grads_as_state().init(params), jnp.asarray(wav))
    port = _port_codec(params)
    rec = _Recorder()
    st = state_lib.create_train_state(dict(port.named_parameters()), rec)
    st, metrics = ttc.make_codec_train_step(port, rec)(st, _t(wav))
    assert st.step == 1
    _check_losses(metrics, jmetrics)
    assert float(metrics["loss_vq"]) > 0
    _check_grads(tfc.FACodec(T_TINY), rec.grads, jgrads)
    # the encoder learns through the quantizers' straight-through path
    assert float(rec.grads["encoder.stem.weight"].abs().max()) > 0


def test_gan_step_generator_and_discriminator_gradients_match_jax(codec_setup, disc_setup):
    wav, model, params = codec_setup
    _, disc, d_params = disc_setup
    tx = _grads_as_state()
    step = jax.jit(jtc.make_gan_codec_train_step(model, disc, tx, tx).__wrapped__)
    _, _, jg, jd, jmetrics = step(params, d_params, tx.init(params), tx.init(d_params),
                                  jnp.asarray(wav))
    port, pdisc = _port_codec(params), discriminator_from_params(DISC_RES, _np(d_params))
    rec_g, rec_d = _Recorder(), _Recorder()
    g_st = state_lib.create_train_state(dict(port.named_parameters()), rec_g)
    d_st = state_lib.create_train_state(dict(pdisc.named_parameters()), rec_d)
    _, _, metrics = ttc.make_gan_codec_train_step(port, pdisc, rec_g, rec_d)(g_st, d_st, _t(wav))
    _check_losses(metrics, jmetrics)
    _check_grads(tfc.FACodec(T_TINY), rec_g.grads, jg)
    _check_grads(tdisc.MultiSTFTDiscriminator(DISC_RES), rec_d.grads, jd)
    # the generator's backward left nothing in the discriminator's parameters
    assert all(p.grad is None for p in pdisc.parameters())


def test_straight_through_gives_the_encoder_jax_gradient():
    """The quantized latent's gradient reaches the quantizer's input and
    in_proj (the straight-through estimator), as in JAX."""
    rng = np.random.default_rng(8)
    z = rng.standard_normal((2, 6, 16)).astype(np.float32)
    r = rng.standard_normal((2, 6, 16)).astype(np.float32)
    vq = jfc.VectorQuantizer(10, 4, 16)
    params = vq.init(jax.random.PRNGKey(3), jnp.asarray(z))["params"]

    def loss(p, zz):
        q, _ = vq.apply({"params": p}, zz, mutable=["losses"])[0]
        return (q * jnp.asarray(r)).sum()

    jp, jz = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(z))
    port = load_params(tfc.VectorQuantizer(10, 4, 16), _np(params))
    zt = _t(z).requires_grad_()
    q, ids = port(zt)
    (q * _t(r)).sum().backward()
    _close(zt.grad.numpy(), jz, 1e-5, "input")
    _close(port.in_proj.weight.grad.numpy(), np.asarray(jp["in_proj"]["kernel"]).T, 1e-5, "in_proj")
    assert float(port.in_proj.weight.grad.abs().max()) > 0
    _close(port.out_proj.weight.grad.numpy(), np.asarray(jp["out_proj"]["kernel"]).T, 1e-5,
           "out_proj")
    # the forward value is the code's, whatever the gradient path
    with torch.no_grad():
        np.testing.assert_array_equal(q.detach().numpy(), port(_t(z))[0].numpy())
        np.testing.assert_array_equal(
            ids.numpy(), np.asarray(vq.apply({"params": params}, jnp.asarray(z),
                                             mutable=["losses"])[0][1]))


def test_grad_reverse_negates_the_gradient_as_jax():
    rng = np.random.default_rng(9)
    x, w = rng.standard_normal((3, 4)).astype(np.float32), rng.standard_normal((3, 4)).astype(np.float32)
    want = jax.grad(lambda a: (jfc.grad_reverse(a) * jnp.asarray(w)).sum())(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    y = tfc.grad_reverse(xt)
    np.testing.assert_array_equal(y.detach().numpy(), x)
    (y * _t(w)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), -w)


def test_segment_batches_equal_the_jax_clis(tmp_path, monkeypatch):
    """The JAX CLI's training batches (``sample_batch`` after the inits'
    draws) equal the port sampler's, bit for bit.  The JAX CLI runs with a
    one-parameter stand-in for its codec and a step that records each batch:
    only the batches are compared."""
    import flax.linen as fnn

    csv_path, tar_path = make_synthetic_dataset(str(tmp_path), n_items=6, seconds=0.4)
    seen = []

    class Stand_in(fnn.Module):
        @fnn.compact
        def __call__(self, wav):
            return self.param("w", fnn.initializers.zeros, (1,))

    def fake_step(model, tx, **kw):
        def step(params, opt_state, wav):
            seen.append(np.asarray(wav))
            return params, opt_state, {"loss_total": jnp.zeros(())}
        return step

    monkeypatch.setattr(jtc, "CodecConfig", lambda: J_TINY)
    monkeypatch.setattr(jtc, "FACodec", lambda cfg: Stand_in())
    monkeypatch.setattr(jtc, "make_codec_train_step", fake_step)
    from mamba_tts_tpu.train import state as jstate

    monkeypatch.setattr(jstate, "save_checkpoint", lambda *a, **k: None)
    jtc.main(["--csv_path", csv_path, "--audio_root", tar_path, "--batch_size", "3",
              "--segment_seconds", "0.3", "--max_steps", "3", "--seed", "4"])
    seg = int(0.3 * 16000) - int(0.3 * 16000) % J_TINY.hop_length
    sample = ttc.make_segment_sampler(VccmTTSDataset(csv_path, tar_path, seed=4), 3, seg, 4)
    sample()  # the JAX CLI initialises its codec on one batch
    for want in seen:
        np.testing.assert_array_equal(sample(), want)
    assert len(seen) == 3


def test_codec_cli_on_cpu(tmp_path):
    """Both modes of the CLI at the default width, one short step each:
    finite losses under the JAX metric names and a checkpoint."""
    base = ["--device", "cpu", "--synthetic", "--batch_size", "1", "--segment_seconds", "0.1",
            "--max_steps", "1"]
    out = ttc.main(base + ["--checkpoint_dir", str(tmp_path / "plain")])
    assert list(out["history"][0]) == ["step", "loss_total", "loss_wave", "loss_stft",
                                       "loss_mel", "loss_vq"]
    adv = ttc.main(base + ["--adversarial", "--checkpoint_dir", str(tmp_path / "adv")])
    assert list(adv["history"][0])[-3:] == ["loss_adv", "loss_fm", "loss_disc"]
    for run, d in ((out, "plain"), (adv, "adv")):
        assert all(np.isfinite(v) for v in run["history"][0].values())
        assert (tmp_path / d / "1" / "state.pt").is_file()
    saved, ok = state_lib.restore_params(str(tmp_path / "adv"))
    assert ok and set(saved) == set(dict(tfc.FACodec(tconfig.CodecConfig()).named_parameters()))
    assert ttc.discriminator_resolutions(1600) == ((512, 128), (1024, 256))
    assert dataclasses.asdict(tconfig.CodecConfig()) == dataclasses.asdict(jconfig.CodecConfig())
