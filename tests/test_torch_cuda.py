"""Tests of the port that need an NVIDIA card: the CUDA kernels have no CPU
mode, so these skip without one.  This file imports neither jax nor the JAX
package, so it runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest`` skips ``tests/conftest.py``, which configures jax.)"""
import numpy as np
import pytest
import torch

from mamba_tts_torch import config as config_lib
from mamba_tts_torch.config import DecoderConfig, MambaConfig, StylePipelineConfig, TTSConfig
from mamba_tts_torch.data.dataset import make_synthetic_dataset
from mamba_tts_torch.data.preprocess_parallel import ParallelDatasetPreprocessor
from mamba_tts_torch.infer import quant_decode as qd
from mamba_tts_torch.infer.quant_decode import quantize_decoder_params
from mamba_tts_torch.infer.synthesize import load_synthesizer
from mamba_tts_torch.models.attention import CrossAttention
from mamba_tts_torch.models.decoder import MambaTTSDecoder, decode_step_, greedy_decode, init_carry
from mamba_tts_torch.models.discriminator import MultiSTFTDiscriminator
from mamba_tts_torch.models.facodec import ConvTranspose1dTorch, FACodec
from mamba_tts_torch.models.layers import Conv, Dense, seed_init
from mamba_tts_torch.models.mamba import MambaBlock
from mamba_tts_torch.models.style import StyleConditioningPipeline
from mamba_tts_torch.models.tts import MambaTTS
from mamba_tts_torch.ops import decode_attention as da
from mamba_tts_torch.ops import decode_megakernel as mk
from mamba_tts_torch.ops import flash_attention as fa
from mamba_tts_torch.ops import int8_matvec as tq
from mamba_tts_torch.ops import pallas_scan as ps
from mamba_tts_torch.ops import selective_scan as ts
from mamba_tts_torch.train import state as state_lib
from mamba_tts_torch.train import train as train_lib
from mamba_tts_torch.train import train_codec
from mamba_tts_torch.utils import profiling

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


DECODE_SHAPES = [(512, 2048), (1024, 512), (512, 512), (512, 512), (512, 2048), (2048, 512)]


@pytest.mark.parametrize("B", [1, 2, 4, 8, 16])
def test_int8_matvec_kernel_matches_plain_on_card(card, B):
    """At the six decode shapes, without a bias and with an f32 and a bf16
    one: one launch per call, within one bf16 ulp relative plus 1e-2
    absolute of the plain version (another summation order; the scale is
    applied after the sum), and a rerun bit-identical."""
    g = torch.Generator(device=card).manual_seed(B)
    for K, N in DECODE_SHAPES:
        x = torch.randn((B, K), generator=g, device=card).bfloat16()
        w_q, s = tq.quantize_weight(torch.randn((K, N), generator=g, device=card) * 0.05)
        bias = torch.randn((N,), generator=g, device=card) * 0.1
        for b in (None, bias, bias.bfloat16()):
            before = tq.int8_matvec.launches
            got = tq.int8_matvec(x, w_q, s, b)
            again = tq.int8_matvec(x, w_q, s, b)
            torch.cuda.synchronize()
            assert tq.int8_matvec.launches == before + 2
            want = tq.int8_matvec_ref(x, w_q, s, b)
            torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7, atol=1e-2)
            assert torch.equal(got, again)


def _small_decoder(card, seed=0, n_heads=4):
    cfg = DecoderConfig(codebook_size=64, d_model=128, n_layers=2, n_heads=n_heads, d_ff=256,
                        d_style=32, max_len=256, num_quantizers=3, dtype="bfloat16",
                        scan_chunk=8, use_pallas=False, mamba=MambaConfig(d_model=128, d_state=8))
    return seed_init(MambaTTSDecoder(cfg), seed).to(card).eval()


def _decode_inputs(card, dec, B, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    d = dec.cfg.d_model
    th = torch.randn((B, 7, d), generator=g, device=card).bfloat16()
    z = torch.randn((B, dec.cfg.d_style), generator=g, device=card).bfloat16()
    rh = torch.randn((B, 11, d), generator=g, device=card).bfloat16()
    tm = torch.ones((B, 7), dtype=torch.bool, device=card)
    tm[:, 5:] = False
    return th, z, dict(text_mask=tm, ref_hidden=rh)


def _eager_int8_decode(dec, qp, th, z, frames, kw, int8_kv, temperature=0.0, generator=None):
    """The step loop of ``greedy_decode_int8`` without capture: every
    in-place step launched eagerly on the card."""
    cfg = dec.cfg
    with torch.no_grad():
        KV, mm, films = dec.project_memories(th, kw["text_mask"], kw["ref_hidden"], None, z)
        if int8_kv:
            KV = qd.quantize_kv(KV)
        total = cfg.num_quantizers * frames
        carry = qd.init_carry(cfg, th.shape[0], total, dec.dtype, th.device, True)
        for _ in range(total):
            decode_step_(lambda tok, st, i: qd.quant_step_with_kv(qp, cfg, tok, KV, mm, films,
                                                                  st, i, frames),
                         carry, cfg.num_special_tokens, temperature, 0, generator)
    return carry


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("int8_kv", [False, True])
def test_captured_int8_decode_matches_eager_on_card(card, B, int8_kv):
    """``greedy_decode_int8`` on the card replays a captured CUDA graph (one
    eager warm-up step, then 4-step graphs over 3 x 9 = 27 steps, crossing
    two quantizer boundaries); its tokens and logits equal the eager step
    loop's, and the kernel count is one per product per step executed."""
    dec = _small_decoder(card)
    qp = quantize_decoder_params(dec)
    th, z, kw = _decode_inputs(card, dec, B, seed=B)
    frames = 9
    total = dec.cfg.num_quantizers * frames
    before = tq.int8_matvec.launches
    got = qd.greedy_decode_int8(dec, qp, th, z, frames, collect_logits=True, int8_kv=int8_kv,
                                **kw)
    torch.cuda.synchronize()
    assert tq.int8_matvec.launches - before == 6 * dec.cfg.n_layers * total
    want = _eager_int8_decode(dec, qp, th, z, frames, kw, int8_kv)
    assert torch.equal(got.tokens, want.tokens)
    assert torch.equal(got.logits, want.logits)


def test_captured_sampled_int8_decode_on_card(card):
    """Sampled decode (temperature 0.8) is captured too, with the request's
    generator registered to the graph: the same seed repeats, another seed
    differs, and the replays draw what the eager loop draws."""
    dec = _small_decoder(card)
    qp = quantize_decoder_params(dec)
    th, z, kw = _decode_inputs(card, dec, 2, seed=5)
    frames = 9

    def run(seed):
        g = torch.Generator(device=card).manual_seed(seed)
        return qd.greedy_decode_int8(dec, qp, th, z, frames, temperature=0.8, generator=g,
                                     **kw).tokens

    first, again, other = run(0), run(0), run(1)
    assert torch.equal(first, again)
    assert not torch.equal(first, other)
    eager = _eager_int8_decode(dec, qp, th, z, frames, kw, False, 0.8,
                               torch.Generator(device=card).manual_seed(0))
    assert torch.equal(first, eager.tokens)


def _eager_none_decode(dec, th, z, frames, kw, temperature=0.0, generator=None):
    """The step loop of ``greedy_decode`` (quant "none") without capture:
    every in-place step launched eagerly on the card."""
    cfg = dec.cfg
    with torch.no_grad():
        KV, mm, films = dec.project_memories(th, kw["text_mask"], kw["ref_hidden"], None, z)
        carry = init_carry(cfg, th.shape[0], cfg.num_quantizers * frames, dec.dtype, th.device,
                           True)
        for _ in range(cfg.num_quantizers * frames):
            decode_step_(lambda tok, st, i: dec.step_with_kv(tok, KV, mm, films, st, i, frames),
                         carry, cfg.num_special_tokens, temperature, 0, generator)
    return carry


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_captured_none_decode_matches_eager_on_card(card, B, temperature):
    """``greedy_decode`` (quant "none") on the card replays a captured CUDA
    graph (one eager warm-up step, then 4-step graphs over 27 steps); its
    tokens and logits equal the eager in-place step loop's, greedy and
    sampled (the generator registered with the graph)."""
    dec = _small_decoder(card)
    th, z, kw = _decode_inputs(card, dec, B, seed=B)
    frames = 9

    def gen():
        return torch.Generator(device=card).manual_seed(3) if temperature > 0 else None

    got = greedy_decode(dec, th, z, frames, temperature=temperature, generator=gen(),
                        collect_logits=True, **kw)
    want = _eager_none_decode(dec, th, z, frames, kw, temperature, gen())
    torch.cuda.synchronize()
    assert torch.equal(got.tokens, want.tokens)
    assert torch.equal(got.logits, want.logits)


def test_nar_frames_on_card_matches_cpu(card):
    """The NAR style branch at d_model 128 in bf16: the card against the CPU
    within 2e-2 of the largest magnitude (the bf16 tolerance of
    tests/test_torch_style.py), the frame counts equal."""
    cfg = TTSConfig(style=StylePipelineConfig(d_style=32, d_model=128, num_heads=4))
    pipe = seed_init(StyleConditioningPipeline(cfg.style), 0).eval()
    g = torch.Generator().manual_seed(0)
    th = torch.randn((3, 20, 128), generator=g)
    z = torch.randn((3, 32), generator=g)
    dur = torch.rand((3, 20), generator=g) * 4
    mask = torch.arange(20)[None] < torch.tensor([[20], [13], [7]])
    with torch.no_grad():
        want = pipe(th, z, dur, mask, 64)
        got = pipe.to(card)(th.to(card), z.to(card), dur.to(card), mask.to(card), 64)
    assert torch.equal(got[1].cpu(), want[1])
    for a, b in zip((got[0], got[2], got[3]), (want[0], want[2], want[3])):
        assert float((a.cpu().float() - b.float()).abs().max()) <= 2e-2 * float(b.float().abs().max())


def test_checkpoint_round_trip_on_card(card, tmp_path):
    """Two train steps on the card at the smoke config, saved as the train
    CLI saves them, then served by ``load_synthesizer(checkpoint_dir=...)``
    with no config: the config and every parameter come back, and a
    request decodes (captured) to finite audio."""
    cfg = config_lib.from_json(open("tests/smoke_config.json").read())
    (tmp_path / "config.json").write_text(config_lib.to_json(cfg))
    model = seed_init(MambaTTS(cfg), 0).to(card)
    tx = state_lib.make_optimizer(1e-3)
    st = state_lib.create_train_state(dict(model.named_parameters()), tx)
    step = train_lib.make_train_step(model, tx)
    B, S, Q = 2, 16, cfg.decoder.num_quantizers
    g = torch.Generator(device=card).manual_seed(0)
    batch = {"phoneme_ids": torch.randint(1, 50, (B, 12), generator=g, device=card),
             "text_mask": torch.ones((B, 12), dtype=torch.bool, device=card),
             "style_bert": torch.randn((B, cfg.smsd.bert_dim), generator=g, device=card),
             "spk_embs": torch.randn((B, cfg.smsd.style_dim), generator=g, device=card),
             "target_codec": torch.randint(2, 12, (B, S, Q), generator=g, device=card),
             "target_frames": torch.full((B,), S, device=card),
             "voice_codec": torch.randint(2, 12, (B, S, Q), generator=g, device=card)}
    for _ in range(2):
        st, _ = step(st, batch)
    state_lib.save_checkpoint(str(tmp_path), st)
    synth = load_synthesizer(checkpoint_dir=str(tmp_path), device=card)
    assert synth.cfg == cfg
    for n, p in synth.model.named_parameters():
        assert torch.equal(p, st.params[n]), n
    t = torch.arange(3200) / 16000.0
    wav, info = synth.synthesize("hello there", "calm", (0.3 * torch.sin(2 * torch.pi * 220 * t)).numpy(),
                                 frames=64)
    assert wav.shape == (64 * cfg.codec.hop_length,) and bool(np.isfinite(wav).all())


class _Recorder(state_lib.Optimizer):
    """An optimizer that keeps each gradient it is given and moves nothing."""

    def __init__(self):
        super().__init__(0.0)
        self.grads = None

    def apply(self, params, grads, opt_state):
        self.grads = {n: g.detach().float().cpu() for n, g in grads.items()}
        return opt_state


def _tamed_codec(cfg, seed=0):
    """A seeded FACodec with every kernel halved (the CPU tests'
    ``tame_codec_params``): at full scale the random codec saturates its
    tanh head, where rounding differences between two correct graphs grow."""
    model = seed_init(FACodec(cfg), seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (Conv, Dense, ConvTranspose1dTorch)):
                m.weight.mul_(0.5)
    return model


@pytest.fixture
def no_tf32():
    """cuDNN convolutions in full f32 (PyTorch's default rounds them to
    TF32), so that the card is held to the CPU's f32 path."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = prev


def test_codec_gan_step_on_card_matches_cpu(card, no_tf32):
    """One GAN codec step (``make_gan_codec_train_step``) at the smoke
    config's codec, B = 2, 3,200 samples, on the card against the CPU:
    every loss within 1e-2 relative and each component's gradient (the
    codec's five parts, the discriminator) within 5e-2 of its largest
    magnitude, ``PERF.md``'s training gates."""
    cfg = config_lib.from_json(open("tests/smoke_config.json").read()).codec
    wav = 0.3 * torch.randn((2, 3200), generator=torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cpu", "cuda"):
        model = _tamed_codec(cfg).to(dev)
        disc = seed_init(MultiSTFTDiscriminator(((512, 128), (1024, 256))), 1).to(dev)
        rg, rd = _Recorder(), _Recorder()
        step = train_codec.make_gan_codec_train_step(model, disc, rg, rd)
        _, _, metrics = step(state_lib.create_train_state(dict(model.named_parameters()), rg),
                             state_lib.create_train_state(dict(disc.named_parameters()), rd),
                             wav.to(dev))
        grads = {**rg.grads, **{f"disc.{n}": g for n, g in rd.grads.items()}}
        parts = {}
        for n, g in grads.items():
            parts.setdefault(n.split(".")[0], []).append(g.flatten())
        out[dev] = ({k: float(v) for k, v in metrics.items()},
                    {k: torch.cat(v) for k, v in parts.items()})
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out["cuda"]
    assert all(np.isfinite(v) for v in l_gpu.values())
    for k, v in l_cpu.items():
        assert abs(l_gpu[k] - v) <= 1e-2 * abs(v), (k, l_gpu[k], v)
    assert set(g_cpu) == {"encoder", "timbre", "vq_prosody", "vq_content", "vq_residual",
                          "decoder", "disc"}
    for k, v in g_cpu.items():
        assert float((g_gpu[k] - v).abs().max()) <= 5e-2 * float(v.abs().max()), k


def test_parallel_preprocessor_on_card_matches_cpu(card, no_tf32, tmp_path):
    """``ParallelDatasetPreprocessor`` at the smoke config (spawned G2P
    workers, then BERT and FACodec on the card in chunks of 4) against the
    same run on the CPU: the same files and metadata, equal phoneme and codec
    ids, style and speaker embeddings within 1e-4 of their largest
    magnitude."""
    import json

    csv_path, tar_path = make_synthetic_dataset(str(tmp_path / "synth"), n_items=6)
    cfg = config_lib.from_json(open("tests/smoke_config.json").read())
    for dev in ("cpu", "cuda"):
        assert ParallelDatasetPreprocessor(str(tmp_path / dev), [tar_path], cfg=cfg, cpu_workers=2,
                                           gpu_batch_size=4, device=dev).preprocess(csv_path) == 6
    names = sorted(p.name for p in (tmp_path / "cpu" / "tensors").iterdir())
    assert len(names) == 6 * 4 and names == sorted(p.name for p in (tmp_path / "cuda" / "tensors").iterdir())
    assert json.loads((tmp_path / "cpu" / "metadata.json").read_text()) == \
        json.loads((tmp_path / "cuda" / "metadata.json").read_text())
    for name in names:
        want, got = (np.load(tmp_path / d / "tensors" / name) for d in ("cpu", "cuda"))
        if name.endswith(("_style.npy", "_spk_emb.npy")):
            assert float(np.abs(got - want).max()) <= 1e-4 * float(np.abs(want).max()), name
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


def _small_cfg(d=64, H=4):
    return DecoderConfig(codebook_size=16, d_model=d, n_layers=2, n_heads=H, d_ff=2 * d,
                         d_style=32, max_len=256, num_quantizers=2, dtype="bfloat16",
                         scan_chunk=8, use_pallas=False, mamba=MambaConfig(d_model=d, d_state=4))


def _small_plan(card, B, wd, kvd, frames=4, d=64, H=4):
    cfg = _small_cfg(d, H)
    dec = seed_init(MambaTTSDecoder(cfg), 0).to(card).eval()
    g = torch.Generator(device=card).manual_seed(B)
    th = torch.randn((B, 7, d), generator=g, device=card).bfloat16()
    z = torch.randn((B, 32), generator=g, device=card).bfloat16()
    rh = torch.randn((B, 11, d), generator=g, device=card).bfloat16()
    tm = torch.ones((B, 7), dtype=torch.bool, device=card)
    tm[:, 5:] = False
    with torch.no_grad():
        KV, mm, films = dec.project_memories(th, tm, rh, None, z)
    plan = mk._build_plan(cfg, quantize_decoder_params(dec), KV, mm, films, frames,
                          weight_dtype=wd, kv_dtype=kvd)
    return cfg, plan, frames


def _versus_plain(card, cfg, plan, frames, B):
    """One teacher-forced launch (and a rerun) against the plain version:
    the megakernel's limits, one launch per call, reruns bit-identical."""
    total = cfg.num_quantizers * frames
    g = torch.Generator(device=card).manual_seed(1)
    forced = torch.randint(2, cfg.vocab_size_audio, (total, B), generator=g, device=card,
                           dtype=torch.int32)
    before = mk._megakernel_call.launches
    got = mk._megakernel_call(cfg, plan, frames, forced)
    again = mk._megakernel_call(cfg, plan, frames, forced)
    torch.cuda.synchronize()
    assert mk._megakernel_call.launches == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    want = mk.decode_megakernel_ref(cfg, plan, frames, forced)
    sp, V = cfg.num_special_tokens, cfg.vocab_size_audio
    g_, w_ = got.logits[:, :, sp:V], want.logits[:, :, sp:V]
    # same rounding points, another summation order: the megakernel's limits
    assert float((g_ - w_).abs().max() / w_.abs().max()) <= 3e-2
    assert float((g_.argmax(-1) == w_.argmax(-1)).float().mean()) >= 0.9
    assert float((got.ssm_state - want.ssm_state).abs().max()) <= 1e-1 * float(
        want.ssm_state.abs().max())
    assert float((got.conv_state.float() - want.conv_state.float()).abs().max()) <= 3e-2 * float(
        want.conv_state.float().abs().max())


@pytest.mark.parametrize("B", [1, 2, 3, 8])  # batch tiles 1, 2, 4, 8
@pytest.mark.parametrize("wd,kvd", mk._DTYPE_LADDER)
def test_decode_megakernel_matches_plain_on_card(card, B, wd, kvd):
    cfg, plan, frames = _small_plan(card, B, wd, kvd)
    # the plan the launch uses: the card's grid (120 blocks for clusters of 8
    # on an H100) still holds 4 heads x 8 slices for up to 3 rows
    lp = mk._card_plan(cfg, B, plan.K.shape[3], wd, kvd, card)
    assert lp.cluster == mk.memory_slices(B, cfg.n_heads, lp.grid)
    assert B > 3 or lp.cluster == 8
    _versus_plain(card, cfg, plan, frames, B)


@pytest.mark.parametrize("wd,kvd", [mk._DTYPE_LADDER[0], mk._DTYPE_LADDER[2]])
@pytest.mark.parametrize("ts", [8, 4, 2])
def test_decode_megakernel_each_cluster_size_on_card(card, ts, wd, kvd):
    """Every cluster size the plan picks, as the card launches it
    (``_card_plan``, on the grid the occupancy query allows): the first small
    case (4 heads of 16 or 8 heads of 16, B = 1..8) whose launch uses
    clusters of ``ts``."""
    cases = [(d, H, B) for d, H in ((64, 4), (128, 8)) for B in range(1, 9)]
    found = [c for c in cases
             if mk._card_plan(_small_cfg(c[0], c[1]), c[2], 128, wd, kvd, card).cluster == ts]
    assert found, f"no small case launches clusters of {ts} on this card"
    d, H, B = found[0]
    cfg, plan, frames = _small_plan(card, B, wd, kvd, d=d, H=H)
    assert mk._card_plan(cfg, B, plan.K.shape[3], wd, kvd, card).cluster == ts
    _versus_plain(card, cfg, plan, frames, B)


@pytest.mark.parametrize("wd,kvd", [mk._DTYPE_LADDER[0], mk._DTYPE_LADDER[2]])
@pytest.mark.parametrize("d,H,B", [(128, 8, 8), (96, 6, 3)])
def test_decode_megakernel_cluster_and_ownership_cases_on_card(card, d, H, B, wd, kvd):
    """8 heads of 16 at B = 8: clusters of 2, as the full-width B = 8 tile
    launches.  d_inner 192 over the grid: blocks own one or two channels."""
    cfg, plan, frames = _small_plan(card, B, wd, kvd, d=d, H=H)
    lp = mk._card_plan(cfg, B, plan.K.shape[3], wd, kvd, card)
    di = cfg.with_mamba_dims().mamba.d_inner
    if d == 128:
        assert lp.cluster == 2
    else:
        assert di % lp.grid and len({b - a for a, b in zip(lp.chan[:-1], lp.chan[1:])}) == 2
    _versus_plain(card, cfg, plan, frames, B)


def test_decode_megakernel_feedback_is_exact_on_card(card):
    """A free run and a teacher-forced run on the tokens it produced give
    bit-identical logits; so do two free runs, greedy and with given noise."""
    cfg, plan, frames = _small_plan(card, 2, "int8", "int8")
    total = cfg.num_quantizers * frames
    bos = torch.full((1, 2), cfg.bos_id, dtype=torch.int32, device=card)
    noise = mk.gumbel_noise((total, 2, 128), torch.Generator(device=card).manual_seed(3), card)
    for gumbel in (None, noise):
        free = mk._megakernel_call(cfg, plan, frames, gumbel=gumbel).logits
        tokens = (free if gumbel is None else free + gumbel).argmax(-1).to(torch.int32)
        forced = torch.cat([bos, tokens[:-1]])
        assert torch.equal(mk._megakernel_call(cfg, plan, frames, forced).logits, free)
        assert torch.equal(mk._megakernel_call(cfg, plan, frames, gumbel=gumbel).logits, free)


def test_decode_megakernel_stage_clocks_on_card(card):
    """The diagnostic stamps: the step's start and two per grid barrier of the
    middle step, all written and rising, none beyond them, and the logits do
    not depend on whether they are taken."""
    cfg, plan, frames = _small_plan(card, 1, "bfloat16", "bfloat16")
    n = mk.stage_clock_count(cfg)
    assert n == 1 + 2 * (7 * cfg.n_layers + 1)
    clocks = torch.zeros(n + 16, dtype=torch.int64, device=card)
    with_clocks = mk._megakernel_call(cfg, plan, frames, stage_clocks=clocks).logits
    stamps, spare = clocks[:n].cpu(), clocks[n:].cpu()
    assert bool((stamps > 0).all()) and bool((spare == 0).all())
    assert bool((stamps[1:] > stamps[:-1]).all())
    assert torch.equal(with_clocks, mk._megakernel_call(cfg, plan, frames).logits)
    with pytest.raises(ValueError, match="stage_clocks"):
        mk._megakernel_call(cfg, plan, frames, stage_clocks=clocks[:4])


def test_decode_megakernel_rejects_what_the_kernel_does_not_take(card):
    cfg, plan, frames = _small_plan(card, 1, "int8", "int8")
    big = plan._replace(K=plan.K.repeat(1, 9, 1, 1), V=plan.V.repeat(1, 9, 1, 1))
    with pytest.raises(ValueError, match="B <= 8"):
        mk._megakernel_call(cfg, big, frames)
    with pytest.raises(ValueError, match="forced tokens"):
        mk._megakernel_call(cfg, plan, frames, torch.zeros((3, 1), dtype=torch.int32, device=card))


def test_decode_megakernel_barriers_on_card(card):
    """The probes of ``mamba_tts_torch/diag/card_probes.py``: each barrier
    kind runs to its end on a grid of clusters of 8, and the L2 read rate is
    finite and positive."""
    from mamba_tts_torch.diag import card_probes

    lib = card_probes._library()
    for mode in card_probes.BARRIERS:
        cycles, grid = card_probes.barrier(lib, mode, 100)
        assert cycles > 0 and grid % 8 == 0
    assert 0 < card_probes.l2_read_rate(lib, 8, reps=4) < float("inf")


def test_full_sequence_paths_launch_kernels_on_card(card):
    """The teacher-forced Mamba forward goes through the scan kernels (the
    plain forward kernel without a gradient, the checkpointing forward and
    the backward kernel with one) and long-query attention through the flash
    kernels; the plain versions are never taken for card tensors."""
    block = seed_init(MambaBlock(MambaConfig(d_model=32, d_state=4), dtype=torch.float32), 0).to(card)
    x = torch.randn((2, 70, 32), device=card)
    counts = (ps.selective_scan_fwd.launches, ps.selective_scan_fwd_ckpt.launches,
              ps.selective_scan_bwd.launches)
    with torch.no_grad():
        y0, _ = block(x)
    y, _ = block(x.requires_grad_())
    y.float().sum().backward()
    torch.cuda.synchronize()
    assert (ps.selective_scan_fwd.launches, ps.selective_scan_fwd_ckpt.launches,
            ps.selective_scan_bwd.launches) == tuple(c + 1 for c in counts)
    torch.testing.assert_close(y0, y.detach())
    attn = seed_init(CrossAttention(128, 2, dtype=torch.bfloat16), 0).to(card)
    K = torch.randn((1, 2, 7, 64), device=card).bfloat16()
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches)
    q = torch.randn((1, 128, 128), device=card, requires_grad=True)
    attn.attend(q, K, K).float().sum().backward()
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert attn.attend(q[:, :127], K, K).shape == (1, 127, 128)  # decode lengths: plain path
    assert fa.flash_attention_fwd.launches == before[0] + 1


def _scan_case(card, dtype, Bz, T, Dm, N, seed, with_h0=True):
    g = torch.Generator(device=card).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=card)

    u = rnd(Bz, T, Dm).to(dtype)
    delta = torch.nn.functional.softplus(rnd(Bz, T, Dm) - 1.0)
    A = -torch.exp(rnd(Dm, N) * 0.5)
    B, C = rnd(Bz, T, N).to(dtype), rnd(Bz, T, N).to(dtype)
    D = rnd(Dm)
    h0 = rnd(Bz, N, Dm) * 0.1 if with_h0 else None
    return u, delta, A, B, C, D, h0


def _rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max().clamp(min=1e-12))


# (T, D, N, h0, chunk): ragged T (T < chunk, k * chunk +- 1), one chunk, every
# d_state, D not a multiple of 16 x the cluster (clusters of 3, 4, 6 and 7
# slices); D = 1,024 spans 8 clusters of 8 per (row, chunk)
SCAN_CASES = [(37, 40, 4, True, 16), (130, 64, 16, False, 16), (64, 24, 8, True, 16),
              (11, 40, 2, True, 16), (33, 300, 8, False, 16), (65, 40, 16, True, 64),
              (64, 64, 16, False, 64), (129, 170, 2, False, 64), (63, 48, 4, True, 64),
              (200, 1024, 16, True, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,Dm,N,with_h0,chunk", SCAN_CASES)
def test_scan_kernels_match_plain_on_card(card, dtype, T, Dm, N, with_h0, chunk):
    """Forward (with and without checkpoints) and backward kernels against
    the plain versions on the same inputs, ragged T and channel slices.
    Tolerances: y rounds to its dtype (1e-2 of its largest magnitude covers
    one bf16 ulp); the f32 states and gradients differ only in summation
    order and exp rounding (1e-4 of each output's largest magnitude).  The
    two forwards give bit-identical y and h_T, and a rerun of the backward
    bit-identical outputs (no atomics)."""
    u, delta, A, B, C, D, h0 = _scan_case(card, dtype, 2, T, Dm, N, seed=T, with_h0=with_h0)
    y_w, hT_w, ck_w = ps.scan_ckpt_ref(u, delta, A, B, C, D, h0, chunk)
    y_tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    y, hT = ps.selective_scan_fwd(u, delta, A, B, C, D, h0, chunk)
    y2, hT2, ck = ps.selective_scan_fwd_ckpt(u, delta, A, B, C, D, h0, chunk)
    torch.cuda.synchronize()
    assert y.dtype == dtype and hT.dtype == torch.float32
    assert torch.equal(y, y2) and torch.equal(hT, hT2)
    assert _rel(y, y_w) <= y_tol
    assert _rel(hT, hT_w) <= 1e-4 and _rel(ck, ck_w) <= 1e-4
    dy = torch.randn((2, T, Dm), device=card)
    dhT = torch.randn((2, N, Dm), device=card)
    got = ps.selective_scan_bwd(u, delta, A, B, C, ck, dy, dhT, chunk)
    torch.cuda.synchronize()
    want = ps.scan_bwd_ref(u, delta, A, B, C, ck_w, dy, dhT, chunk)
    for name, g_, w_ in zip("du ddt dB dC dA_b dh0".split(), got, want):
        assert _rel(g_, w_) <= 1e-4, name
    again = ps.selective_scan_bwd(u, delta, A, B, C, ck, dy, dhT, chunk)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics: bit-identical


def test_scan_launch_plan_spans_clusters_on_card(card):
    """At d_inner 1,024 the gradient pass runs 8 clusters of 8 slices per
    (row, chunk) and writes 8 dB/dC partials; the kernels take that
    plan and refuse one whose shared memory differs."""
    plan = ps.scan_launch_plan(2, 200, 1024, 16, 64)
    assert plan.bwd_grad.cluster == 8 and plan.bwd_grad.grid[0] == 64 and plan.partial_slices == 8
    u, delta, A, B, C, D, _ = _scan_case(card, torch.bfloat16, 2, 200, 1024, 16, seed=3)
    ck = ps.selective_scan_fwd_ckpt(u, delta, A, B, C, D)[2]
    dy, dhT = torch.randn((2, 200, 1024), device=card), torch.randn((2, 16, 1024), device=card)
    lib = ps._library()
    bad = torch.empty(1, device=card)
    err = lib.selective_scan_bwd_launch(
        *[t.data_ptr() for t in (u, delta, A, B, C, ck, dy, dhT)], *[bad.data_ptr()] * 8,
        2, 200, 1024, 16, 64, 1, plan.bwd_grad.cluster, plan.bwd_summary.smem_bytes,
        plan.bwd_grad.smem_bytes + 16, torch.cuda.current_stream().cuda_stream)
    assert err != 0  # a plan laid out otherwise is refused before any launch


@pytest.mark.parametrize("with_h0", [False, True])
def test_selective_scan_fn_matches_autograd_on_card(card, with_h0):
    """Gradients of every input through the kernels (SelectiveScanFn) against
    autograd through the plain scan, f32 (1e-4 of each gradient's largest
    magnitude)."""
    args = _scan_case(card, torch.float32, 2, 75, 48, 16, seed=5, with_h0=with_h0)

    def grads(fn):
        leaves = [a.detach().clone().requires_grad_() if a is not None else None for a in args]
        y, hT = fn(*leaves)
        ((y * y).sum() + (hT * hT).sum()).backward()
        return [l.grad for l in leaves if l is not None]

    got = grads(lambda *a: ps.selective_scan_pallas(*a))
    want = grads(lambda *a: ts.selective_scan_ref(*a))
    for g_, w_ in zip(got, want):
        assert _rel(g_, w_) <= 1e-4


def test_captured_none_decode_takes_decode_attention_on_card(card):
    """With head_dim 64 the captured decode's cross-attention is the
    one-query kernel, one launch a layer a step (the warm-up's launches and
    the replays' executions), and the tracer counts them as
    ``decode.attention_launches``; tokens and logits equal the eager in-place
    loop's, which launches the same kernel."""
    dec = _small_decoder(card, n_heads=2)
    th, z, kw = _decode_inputs(card, dec, 4, seed=4)
    frames = 9
    total = dec.cfg.num_quantizers * frames
    before = da.decode_attention.launches
    profiling.reset()
    profiling.enable()
    try:
        got = greedy_decode(dec, th, z, frames, collect_logits=True, **kw)
        torch.cuda.synchronize()
        counted = profiling.counters().get("decode.attention_launches")
    finally:
        profiling.disable()
        profiling.reset()
    assert da.decode_attention.launches - before == dec.cfg.n_layers * total
    assert counted == dec.cfg.n_layers * total
    want = _eager_none_decode(dec, th, z, frames, kw)
    assert torch.equal(got.tokens, want.tokens)
    assert torch.equal(got.logits, want.logits)


def test_captured_decode_leaves_no_device_memory_behind_on_card(card):
    """Requests after the first leave the allocated device memory where it
    was: the warm-up and capture run on the device's one side stream (a new
    stream a call left a cuBLAS workspace behind each time)."""
    dec = _small_decoder(card)
    th, z, kw = _decode_inputs(card, dec, 2, seed=2)
    left = []
    for _ in range(4):
        greedy_decode(dec, th, z, 9, **kw)
        torch.cuda.synchronize()
        left.append(torch.cuda.memory_allocated())
    assert left[1] == left[2] == left[3], left


CU_GRAPH_NODE_KERNEL = 0  # CUgraphNodeType: a kernel launch


def _captured_node_types(card, fn):
    """The node types of the CUDA graph that stream capture records around
    ``fn()`` on a side stream (through libcuda, so every kernel launch, copy
    and memset the calls make is a node; the graph is never launched)."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    stream, graph = ctypes.c_void_p(side.cuda_stream), ctypes.c_void_p()
    with torch.cuda.stream(side):
        fn()  # the side stream's cached blocks exist before the capture
        torch.cuda.synchronize(card)
        assert cu.cuStreamBeginCapture_v2(stream, ctypes.c_int(2)) == 0  # relaxed mode
        try:
            fn()
        finally:
            assert cu.cuStreamEndCapture(stream, ctypes.byref(graph)) == 0
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0
    types = []
    for node in nodes:
        t = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)) == 0
        types.append(t.value)
    assert cu.cuGraphDestroy(graph) == 0
    return types


def _decode_attention_case(card, B, H, Tm, seed, mask_kind):
    """q (B, 1, H·64) and K, V as ``CrossAttention._split`` leaves them;
    masks: each row losing its last b·Tm/2B keys, that plus a whole slice of
    the launch plan masked in row 0 (and in the last row), or none."""
    g = torch.Generator(device=card).manual_seed(seed)
    K, V = (torch.randn((B, Tm, H * 64), generator=g, device=card).bfloat16()
            .reshape(B, Tm, H, 64).transpose(1, 2) for _ in range(2))
    q = torch.randn((B, 1, H * 64), generator=g, device=card).bfloat16()
    if mask_kind == "none":
        return q, K, V, None
    mask = torch.ones((B, Tm), dtype=torch.bool, device=card)
    for b in range(B):
        mask[b, Tm - (b * Tm) // (2 * B):] = False
    if mask_kind == "slice":
        keys = da.launch_plan(B, H, Tm).keys
        mask[0, keys:2 * keys] = False
        mask[B - 1, :keys] = False
    return q, K, V, mask


@pytest.mark.parametrize("B,H,Tm,mask_kind", [(8, 8, 1536, "ragged"), (1, 8, 1536, "ragged"),
                                              (4, 8, 1536, "none"), (3, 2, 77, "ragged"),
                                              (2, 8, 1000, "slice"), (8, 8, 1, "none"),
                                              (16, 8, 6000, "slice"), (1, 1, 6913, "slice"),
                                              (2, 8, 20_000, "slice")])
def test_decode_attention_kernel_matches_plain_on_card(card, B, H, Tm, mask_kind):
    """The narration shape (B = 8, H = 8, Tm = 1,536), B = 1, ragged and
    masked memories, and memories whose slices are read in tiles (scores
    in the workspace) against the plain version, at the flash kernels'
    2e-2 of the largest output (the kernel sums in another order); a rerun
    is bit-identical, and a call is one device kernel: five calls captured
    into a CUDA graph are five kernel nodes and nothing else (the profiler
    was dropping some of this kernel's records on the card)."""
    q, K, V, mask = _decode_attention_case(card, B, H, Tm, seed=B * 10_000 + Tm, mask_kind=mask_kind)
    before = da.decode_attention.launches
    got = da.decode_attention(q, K, V, mask, 64 ** -0.5)
    again = da.decode_attention(q, K, V, mask, 64 ** -0.5)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 2
    want = da.decode_attention_ref(q, K, V, mask, 64 ** -0.5)
    assert got.dtype == torch.bfloat16 and got.shape == (B, 1, H * 64)
    assert _rel(got, want) <= 2e-2
    assert torch.equal(got, again)
    assert _captured_node_types(card, lambda: [da.decode_attention(q, K, V, mask, 64 ** -0.5)
                                                for _ in range(5)]) == [CU_GRAPH_NODE_KERNEL] * 5


def test_decode_attention_rejects_what_it_does_not_take(card):
    q, K, V, mask = _decode_attention_case(card, 2, 2, 33, seed=0, mask_kind="ragged")
    with pytest.raises(ValueError, match="does not take"):
        da.decode_attention(q, K.contiguous(), V, mask, 1.0)
    with pytest.raises(ValueError, match="does not take"):
        da.decode_attention(q.float(), K, V, mask, 1.0)
    with pytest.raises(ValueError, match="does not take"):
        da.decode_attention(q, K, V, mask[:, :4], 1.0)
    plan = da.launch_plan(2, 2, 33)
    with pytest.raises(RuntimeError, match="launch failed"):
        da._launch(q, K, V, mask, 1.0, plan._replace(smem_bytes=plan.smem_bytes + 16))
    with pytest.raises(RuntimeError, match="launch failed"):  # a workspace where none is read
        da._launch(q, K, V, mask, 1.0, plan._replace(workspace=2 * 2 * plan.cluster * plan.keys))


CROSS_ATTENTION_OUTPUTS = {  # sha256 (first 16 hex) of the kernel's bf16 outputs, as first built
    (8, 8, 1536): "ef23f3fd93c58cf1", (1, 8, 1536): "688594965997b756",
    (2, 8, 20000): "94f7a53814dab8f0", (3, 2, 77): "33152f155c2d9b59"}


@pytest.mark.parametrize("B,H,Tm", list(CROSS_ATTENTION_OUTPUTS))
def test_cross_attention_kernel_gives_the_outputs_it_gave(card, B, H, Tm):
    """The head_dim-64 kernel with one K/V head a query head (the MAVE
    decoder's cross-attention) gives bit for bit the outputs it gave before
    the grouped kernel joined its source: the hashes were read on an H100
    from the source as it stood then, on these seeded inputs."""
    import hashlib

    g = torch.Generator().manual_seed(B * 1000 + Tm)
    q = torch.randn((B, 1, H * 64), generator=g).bfloat16().to(card)
    mem = torch.randn((2, B, Tm, H * 64), generator=g).bfloat16().to(card)
    K = mem[0].reshape(B, Tm, H, 64).transpose(1, 2)
    V = mem[1].reshape(B, Tm, H, 64).transpose(1, 2)
    mask = (torch.rand((B, Tm), generator=g) > 0.1).to(card)
    y = da.decode_attention(q, K, V, mask, 0.125)
    got = hashlib.sha256(y.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]
    assert got == CROSS_ATTENTION_OUTPUTS[(B, H, Tm)]


@pytest.mark.parametrize("hd,G,Hkv,B,Tm", [(128, 20, 1, 16, 4100), (128, 20, 1, 1, 1538),
                                            (128, 2, 3, 2, 9000)])
def test_grouped_decode_attention_on_card(card, hd, G, Hkv, B, Tm):
    """The grouped kernel (the jamba decoder's self-attention step) against
    its plain version at 2e-2 of the largest output, a rerun bit-identical,
    one device kernel a call (graph nodes, as above); K/V are views of a
    (B, Tm, H_kv, hd) cache, as ``SelfAttention.step`` hands them."""
    g = torch.Generator(device=card).manual_seed(hd + G + B + Tm)
    cache = torch.randn((2, B, Tm, Hkv, hd), generator=g, device=card).bfloat16()
    K, V = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
    q = torch.randn((B, 1, Hkv * G * hd), generator=g, device=card).bfloat16()
    mask = torch.arange(Tm, device=card)[None] < (Tm - 5 * torch.arange(B, device=card))[:, None]
    got = da.decode_attention(q, K, V, mask, hd ** -0.5)
    again = da.decode_attention(q, K, V, mask, hd ** -0.5)
    want = da.decode_attention_ref(q, K, V, mask, hd ** -0.5)
    torch.cuda.synchronize()
    assert got.shape == q.shape and _rel(got, want) <= 2e-2
    assert torch.equal(got, again)
    assert _captured_node_types(card, lambda: [da.decode_attention(q, K, V, mask, hd ** -0.5)
                                                for _ in range(3)]) == [CU_GRAPH_NODE_KERNEL] * 3


def _flash_case(card, Bz, H, Tq, Tk, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    q, K, V = (torch.randn((Bz, H, T, 64), generator=g, device=card).bfloat16()
               for T in (Tq, Tk, Tk))
    mask = torch.ones((Bz, Tk), dtype=torch.bool, device=card)
    mask[0, Tk // 3: 2 * Tk // 3] = False
    return q, K, V, mask


@pytest.mark.parametrize("Tq,Tk", [(130, 77), (128, 256), (200, 3), (257, 129), (1, 300),
                                   (384, 5376)])
def test_flash_kernels_match_plain_on_card(card, Tq, Tk):
    """O and the gradients of q, K, V through the kernels against autograd
    through the plain materialized softmax, at shapes on both sides of the
    kernels' 128-row query and key tiles (and the 64-row query steps of the
    dK/dV kernel); B = 2, H = 3 reach every (batch, head) offset.  The kernels
    round P and dS to bf16 at the products' inputs, the plain version rounds
    the probabilities, and both round outputs to bf16: 2e-2 of each output's
    largest magnitude.  Reruns are bit-identical (no atomics)."""
    q, K, V, mask = _flash_case(card, 2, 3, Tq, Tk, seed=Tq + Tk)
    scale = 64 ** -0.5
    dO = torch.randn((2, 3, Tq, 64), device=card).bfloat16()

    def run(fn):
        leaves = [t.detach().clone().requires_grad_() for t in (q, K, V)]
        out = fn(*leaves, mask, scale)
        out.backward(dO)
        return [out.detach()] + [l.grad for l in leaves]

    got = run(fa.flash_attention)
    want = run(fa.flash_attention_ref)
    for name, g_, w_ in zip(("O", "dq", "dK", "dV"), got, want):
        assert g_.dtype == torch.bfloat16, name
        assert _rel(g_, w_) <= 2e-2, name
    O, lse = fa.flash_attention_fwd(q, K, V, mask, scale)
    assert torch.equal(O, got[0])
    first = fa.flash_attention_bwd(q, K, V, mask, O, lse, dO, scale)
    again = fa.flash_attention_bwd(q, K, V, mask, O, lse, dO, scale)
    for name, a, b in zip(("dq", "dK", "dV"), first, again):
        assert torch.equal(a, b), name


def test_flash_kernel_rejects_what_it_does_not_take(card):
    q, K, V, mask = _flash_case(card, 1, 2, 128, 9, seed=0)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q[..., :32].contiguous(), K[..., :32].contiguous(),
                               V[..., :32].contiguous(), mask, 1.0)
    with pytest.raises(ValueError, match="bf16"):
        fa.flash_attention_fwd(q.float(), K, V, mask, 1.0)
    with pytest.raises(ValueError, match="memory_mask"):
        fa.flash_attention_fwd(q, K, V, mask[:, :4], 1.0)
