"""Tests of the port that need an NVIDIA card: the CUDA kernels have no CPU
mode, so these skip without one.  This file imports neither jax nor the JAX
package, so it runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest`` skips ``tests/conftest.py``, which configures jax.)"""
import pytest
import torch

from mamba_tts_torch.config import DecoderConfig, MambaConfig
from mamba_tts_torch.infer.quant_decode import quantize_decoder_params
from mamba_tts_torch.models.attention import CrossAttention
from mamba_tts_torch.models.decoder import MambaTTSDecoder
from mamba_tts_torch.models.layers import seed_init
from mamba_tts_torch.models.mamba import MambaBlock
from mamba_tts_torch.ops import decode_megakernel as mk
from mamba_tts_torch.ops import int8_matvec as tq

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("B", [1, 4, 16])
def test_int8_matvec_kernel_matches_plain_on_card(card, B):
    g = torch.Generator(device=card).manual_seed(B)
    x = torch.randn((B, 512), generator=g, device=card).bfloat16()
    w_q, s = tq.quantize_weight(torch.randn((512, 2048), generator=g, device=card) * 0.05)
    before = tq.int8_matvec.launches
    got = tq.int8_matvec(x, w_q, s)
    torch.cuda.synchronize()
    assert tq.int8_matvec.launches == before + 1
    want = tq.int8_matvec_ref(x, w_q, s)
    # one bf16 ulp relative plus 1e-2 absolute, for summation order
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7, atol=1e-2)


def _small_plan(card, B, wd, kvd, frames=4):
    cfg = DecoderConfig(codebook_size=16, d_model=64, n_layers=2, n_heads=4, d_ff=128, d_style=32,
                        max_len=256, num_quantizers=2, dtype="bfloat16", scan_chunk=8,
                        use_pallas=False, mamba=MambaConfig(d_model=64, d_state=4))
    dec = seed_init(MambaTTSDecoder(cfg), 0).to(card).eval()
    g = torch.Generator(device=card).manual_seed(B)
    th = torch.randn((B, 7, 64), generator=g, device=card).bfloat16()
    z = torch.randn((B, 32), generator=g, device=card).bfloat16()
    rh = torch.randn((B, 11, 64), generator=g, device=card).bfloat16()
    tm = torch.ones((B, 7), dtype=torch.bool, device=card)
    tm[:, 5:] = False
    with torch.no_grad():
        KV, mm, films = dec.project_memories(th, tm, rh, None, z)
    plan = mk._build_plan(cfg, quantize_decoder_params(dec), KV, mm, films, frames,
                          weight_dtype=wd, kv_dtype=kvd)
    return cfg, plan, frames


@pytest.mark.parametrize("B", [1, 2, 3, 8])  # batch tiles 1, 2, 4, 8
@pytest.mark.parametrize("wd,kvd", mk._DTYPE_LADDER)
def test_decode_megakernel_matches_plain_on_card(card, B, wd, kvd):
    cfg, plan, frames = _small_plan(card, B, wd, kvd)
    total = cfg.num_quantizers * frames
    g = torch.Generator(device=card).manual_seed(1)
    forced = torch.randint(2, cfg.vocab_size_audio, (total, B), generator=g, device=card,
                           dtype=torch.int32)
    before = mk._megakernel_call.launches
    got = mk._megakernel_call(cfg, plan, frames, forced)
    torch.cuda.synchronize()
    assert mk._megakernel_call.launches == before + 1
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
    """The diagnostic stamps: two per grid barrier of the middle step, rising,
    and the logits do not depend on whether they are taken."""
    cfg, plan, frames = _small_plan(card, 1, "bfloat16", "bfloat16")
    n = 2 * len(mk.stage_names(cfg))
    clocks = torch.zeros(n, dtype=torch.int64, device=card)
    with_clocks = mk._megakernel_call(cfg, plan, frames, stage_clocks=clocks).logits
    stamps = clocks.cpu()
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


def test_unported_full_sequence_paths_raise_on_card(card):
    block = MambaBlock(MambaConfig(d_model=16, d_state=4), dtype=torch.float32).to(card)
    with pytest.raises(NotImplementedError, match="pallas_scan"):
        block(torch.zeros((1, 5, 16), device=card))
    attn = CrossAttention(16, 4, dtype=torch.float32).to(card)
    K = V = torch.zeros((1, 4, 7, 4), device=card)
    with pytest.raises(NotImplementedError, match="flash"):
        attn.attend(torch.zeros((1, 128, 16), device=card), K, V)
