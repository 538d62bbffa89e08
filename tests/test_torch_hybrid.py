"""The jamba decoder (``mamba_tts_torch/models/hybrid.py``) against the plain
reference ``reference/hybrid_tts.py`` on seeded random weights, at a small
size on the CPU: teacher-forced logits, loss and gradients; prefill then
cached steps against the full forward; padding kept out of every row's
state.  Also: ``TTSConfig()`` builds the model it built before, and the
published configuration's layer pattern and parameter count.

The ``cuda`` tests (they skip without a card; this file imports no jax) hold
the grouped decode-attention kernel to its plain version and the captured
hybrid decode to its eager steps.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import pytest
import torch

from mamba_tts_torch.config import DecoderConfig, MambaConfig, TTSConfig, from_json
from mamba_tts_torch.infer.synthesize import Synthesizer
from mamba_tts_torch.models import hybrid as hy
from mamba_tts_torch.models.layers import seed_init
from mamba_tts_torch.models.tts import MambaTTS, codec_ce_loss
from mamba_tts_torch.ops import decode_attention as da
from reference.hybrid_tts import HybridConfig, HybridTTSDecoder

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "portbench" / "configs" / "jamba2-3b-tts.json"
Q, F_, S_VOICE, L_TEXT, D_TEXT = 2, 6, 8, 12, 24


def small_cfg(dtype: str = "float32") -> DecoderConfig:
    """d_model 64, 4 layers (attention at layer 2), 4 query heads on 1 K/V
    head of 16, d_state 16, dt_rank 4, d_ff 128."""
    return DecoderConfig(
        block="jamba", codebook_size=30, d_model=64, n_layers=4, n_heads=4, n_kv_heads=1,
        d_ff=128, d_style=8, max_len=16, num_quantizers=Q, attn_layer_offset=2,
        attn_layer_period=4, dtype=dtype,
        mamba=MambaConfig(d_model=64, d_state=16, d_conv=4, expand=2, dt_rank=4))


def reference_for(dec: hy.HybridDecoder, fake=None) -> HybridTTSDecoder:
    ref = HybridTTSDecoder(HybridConfig.from_dict(dataclasses.asdict(dec.cfg), D_TEXT), fake)
    mine, theirs = dict(dec.named_parameters()), dict(ref.named_parameters())
    assert set(mine) == set(theirs)
    with torch.no_grad():
        for n, p in theirs.items():
            p.copy_(mine[n].float())
    return ref


def build(dtype: str = "float32", seed: int = 0) -> hy.HybridDecoder:
    dec = hy.HybridDecoder(small_cfg(dtype), D_TEXT)
    seed_init(dec, seed)
    with torch.no_grad():  # non-trivial norms and biases, so that each is tested
        g = torch.Generator().manual_seed(seed + 1)
        for n, p in dec.named_parameters():
            if n.endswith("norm.weight") or "norm_" in n:
                p.add_(0.2 * torch.randn(p.shape, generator=g))
            elif n.endswith(".bias"):
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return dec


def inputs(B: int = 3, seed: int = 0):
    """Rows with different prefix lengths: text valid to 12, 7 and 3
    positions (the rest noise of 1e3, which must never be read), voice
    grids with 8, 5 and 6 valid frames (PAD past them)."""
    g = torch.Generator().manual_seed(seed)
    text_len, voice_len = [12, 7, 3][:B], [8, 5, 6][:B]
    text = torch.randn((B, L_TEXT, D_TEXT), generator=g)
    mask = torch.arange(L_TEXT)[None] < torch.tensor(text_len)[:, None]
    text = torch.where(mask[..., None], text, 1e3 * torch.randn(text.shape, generator=g))
    z = torch.randn((B, 8), generator=g)
    voice = torch.randint(2, 32, (B, S_VOICE, Q), generator=g)
    voice = torch.where(torch.arange(S_VOICE)[None, :, None] < torch.tensor(voice_len)[:, None,
                                                                                       None],
                        voice, torch.zeros_like(voice))
    tokens = torch.randint(2, 32, (B, Q * F_), generator=g)
    return text, mask, z, voice, tokens


def program_forward(dec, text, mask, z, voice, tokens):
    """The system's teacher-forced logits as ``compute_losses`` computes them."""
    B = tokens.shape[0]
    v3 = voice.transpose(1, 2)
    ref_hidden = dec.embed_codec_tokens(v3)
    ref_mask = v3.reshape(B, -1) != 0
    inp = torch.cat([torch.full((B, 1), 1), tokens[:, :-1]], dim=1)
    quant = torch.arange(Q).repeat_interleave(F_)[None]
    pos = torch.arange(F_).repeat(Q)[None]
    return dec(inp, text, z, mask, ref_hidden, ref_mask, quant_ids=quant, pos_ids=pos)


def reference_logits(ref, text, mask, z, voice, tokens):
    return [ref.logits(text[b][mask[b]], z[b], voice[b], tokens[b]) for b in range(len(tokens))]


def fp8(x):
    s = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


def test_teacher_forced_logits_loss_and_gradients():
    """f32 against f32: every logit within 2e-4 of the reference's (the two
    differ only in the order of f32 sums: SDPA, a step-by-step scan and a
    chunked one), the loss within 1e-5 relative and every leaf's gradient
    within 1e-3 of its norm (the backward of the same sums)."""
    dec = build()
    ref = reference_for(dec)
    text, mask, z, voice, tokens = inputs()
    logits = program_forward(dec, text, mask, z, voice, tokens)
    want = reference_logits(ref, text, mask, z, voice, tokens)
    for b in range(3):
        assert (logits[b] - want[b]).abs().max() < 2e-4
    loss = codec_ce_loss(logits, tokens)
    rows = [{"text_hidden": text[b][mask[b]], "z_style": z[b], "voice_ids": voice[b],
             "tokens": tokens[b]} for b in range(3)]
    ref_loss = ref.loss(rows)
    a, r = float(loss.detach()), float(ref_loss.detach())
    assert abs(a - r) < 1e-5 * abs(r)
    loss.backward()
    ref_loss.backward()
    theirs = dict(ref.named_parameters())
    for n, p in dec.named_parameters():
        g, r = p.grad, theirs[n].grad
        assert g is not None and r is not None, n
        assert (g - r).norm() <= 1e-3 * r.norm() + 1e-7, n


def test_bf16_logits_sit_between_the_reference_and_float8():
    """The configuration's precision (bf16 compute, bf16 matrices) reads
    within 0.3 of the f32 reference's logits (logits of a few units; bf16
    keeps 8 bits, and 0.12 was read here), while the same reference with
    every product's operands in float8 e4m3 (3 bits) misses by more (0.87):
    the tolerance tells the two precisions apart."""
    dec = build("bfloat16")
    ref = reference_for(dec)
    low = reference_for(dec, fake=fp8)
    text, mask, z, voice, tokens = inputs()
    with torch.no_grad():
        logits = program_forward(dec, text, mask, z, voice, tokens)
        want = reference_logits(ref, text, mask, z, voice, tokens)
        lo = reference_logits(low, text, mask, z, voice, tokens)
    got = max(float((logits[b] - want[b]).abs().max()) for b in range(3))
    fp8_gap = max(float((lo[b] - want[b]).abs().max()) for b in range(3))
    assert got < 0.3 < fp8_gap, (got, fp8_gap)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 0.3)])
def test_prefill_then_cached_steps_match_the_full_forward(dtype, tol):
    """The decode (prefill of rows of different prefix lengths, then cached
    steps in lockstep, eager on the CPU) gives at every step the logits that
    the reference's full forward over prefix + served tokens gives: within
    2e-4 in f32 (sums in another order), 0.3 in bf16 (as above)."""
    dec = build(dtype)
    ref = reference_for(dec)
    text, mask, z, voice, _ = inputs()
    v3 = voice.transpose(1, 2)
    res = hy.hybrid_greedy_decode(dec, text, z, F_, text_mask=mask,
                                  ref_hidden=dec.embed_codec_tokens(v3),
                                  ref_mask=v3.reshape(3, -1) != 0, collect_logits=True)
    assert res.tokens.shape == (3, Q * F_) and int(res.tokens.min()) >= 2
    with torch.no_grad():
        want = reference_logits(ref, text, mask, z, voice, res.tokens)
    for b in range(3):
        assert (res.logits[b, :, 2:] - want[b][:, 2:]).abs().max() < tol


def test_padding_never_reaches_a_rows_state():
    """Prefilled together, each row's Mamba states and K/V equal those of the
    row prefilled alone (no padding at all), though its padded positions
    hold noise of 1e3: the scan carries the state through them unchanged,
    the conv window ends at the row's length, attention is causal."""
    dec = build()
    text, mask, z, voice, _ = inputs()
    v3 = voice.transpose(1, 2)
    rh, rm = dec.embed_codec_tokens(v3), v3.reshape(3, -1) != 0
    with torch.no_grad():
        prefix, lengths = dec.prefix(text, mask, z, rh, rm)
        states, kvs = dec.prefill(prefix, lengths)
        assert lengths.tolist() == [1 + 8 * Q + 12, 1 + 5 * Q + 7, 1 + 6 * Q + 3]
        for b in range(3):
            p1, l1 = dec.prefix(text[b:b + 1], mask[b:b + 1], z[b:b + 1], rh[b:b + 1],
                                rm[b:b + 1])
            assert p1.shape[1] == int(l1[0]) == int(lengths[b])
            s1, kv1 = dec.prefill(p1, l1)
            for st, one in zip(states, s1):
                assert torch.allclose(st.ssm[b], one.ssm[0], rtol=1e-5, atol=1e-6)
                assert torch.allclose(st.conv[b], one.conv[0], rtol=1e-5, atol=1e-6)
            n = int(lengths[b])
            for (k, v), (k1, v1) in zip(kvs, kv1):
                assert torch.allclose(k[b, :n], k1[0], rtol=1e-5, atol=1e-5)
                assert torch.allclose(v[b, :n], v1[0], rtol=1e-5, atol=1e-5)


def test_default_configuration_builds_the_model_it_built_before():
    """``TTSConfig()`` keeps the MAVE decoder: no jamba field changes it, and
    its decoder has the 46.1M parameters (and names) it had."""
    cfg = TTSConfig()
    assert cfg.decoder.block == "mave" and not cfg.decoder.hybrid
    assert set(cfg.decoder.layer_kinds()) == {"mamba"}
    with torch.device("meta"):
        model = MambaTTS(cfg)
    params = dict(model.decoder.named_parameters())
    assert sum(p.numel() for p in params.values()) == 46_139_906
    assert not any(n.endswith(("dt_norm.weight", "b_norm.weight", "c_norm.weight"))
                   for n in params)
    assert all(p.dtype == torch.float32 for p in params.values())
    for name in ("tts512x8", "tts512x8-megakernel"):
        conf = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
        assert from_json(json.dumps(conf["model"])) == cfg


def test_published_configuration_layer_pattern_and_parameter_count():
    """The configuration file's decoder: attention at layers 7 and 21 of 28,
    26 Mamba layers of 104.2M and 2 attention layers of 76.7M, 2.862B
    parameters in the layers, counted from the configuration alone."""
    conf = json.loads(CONFIG.read_text())
    dc = from_json(json.dumps(conf["model"])).decoder
    kinds = dc.layer_kinds()
    assert [i for i, k in enumerate(kinds) if k == "attention"] == [7, 21]
    assert (dc.d_model, dc.n_heads, dc.kv_heads, dc.d_ff) == (2560, 20, 1, 8192)
    m = dc.with_mamba_dims().mamba
    assert (m.d_inner, m.d_state, m.dt_rank_actual) == (5120, 16, 160)
    counts = hy.layer_param_counts(dc)
    assert round(counts["mamba"] / 1e6, 1) == 104.2
    assert round(counts["attention"] / 1e6, 1) == 76.7
    assert round(counts["layers"] / 1e9, 3) == 2.862
    assert conf["num_hidden_layers"] == dc.n_layers and conf["hidden_size"] == dc.d_model
    assert conf["vocab_size"] == dc.vocab_size_audio and conf["reduced"] == ["vocab_size"]


def test_parameter_count_follows_the_modules():
    """``layer_param_counts`` counts what the modules hold (small model)."""
    dec = build()
    counts = hy.layer_param_counts(dec.cfg)
    got = sum(p.numel() for n, p in dec.named_parameters() if n.startswith("layer_"))
    assert got == counts["layers"]


def test_serving_the_jamba_decoder_takes_no_other_path():
    """The planner serves the jamba decoder through its captured decode only:
    the megakernel and the int8 paths raise."""
    cfg = dataclasses.replace(TTSConfig(), decoder=small_cfg("bfloat16"))
    with torch.device("meta"):
        model = MambaTTS(cfg)
    for quant in ("megakernel", "int8", "int8_kv"):
        with pytest.raises(ValueError, match="jamba"):
            Synthesizer(cfg, model, quant=quant, device="cpu")


def test_grouped_launch_plan_fits_the_card():
    """At the narration shape (B = 16, one K/V head of 128 serving 20 query
    heads, 4,100 keys) the grouped plan splits the heads into 5 groups of 4
    (the fewest that fill the card at full clusters), slices the cache over
    7-block clusters, keeps a slice's scores in shared memory and reads K
    and V in tiles; two blocks fit an SM.  A slice whose scores leave no
    room for a tile has no plan."""
    plan = da.grouped_launch_plan(16, 1, 20, 128, 4100)
    assert plan.head_groups == 5 and plan.cluster == 7 and plan.blocks == 16 * 5 * 7
    assert plan.keys * 7 >= 4100 > plan.keys * 6 and plan.tile < plan.keys
    assert 2 * (plan.smem_bytes + 1024) <= 233_472 and plan.tile % da.KEY_ALIGN == 0
    assert plan.smem_bytes == da.grouped_smem_bytes(128, 4, 7, plan.keys, plan.tile)
    short = da.grouped_launch_plan(1, 1, 20, 128, 1)
    assert short.head_groups == 20 and short.cluster == 1 and short.tile == short.keys == 16
    with pytest.raises(ValueError, match="no shared memory"):
        da.grouped_launch_plan(1, 1, 20, 128, 400_000)


def test_grouped_plain_version_repeats_each_kv_head():
    """The plain version of a grouped call equals ungrouped attention over
    each K/V head repeated for its query heads."""
    g = torch.Generator().manual_seed(3)
    B, Hkv, G, hd, Tm = 2, 2, 3, 16, 9
    q = torch.randn((B, 1, Hkv * G * hd), generator=g)
    K, V = (torch.randn((B, Hkv, Tm, hd), generator=g) for _ in range(2))
    mask = torch.rand((B, Tm), generator=g) > 0.3
    mask[:, 0] = True
    got = da.decode_attention_ref(q, K, V, mask, hd ** -0.5)
    Kr, Vr = K.repeat_interleave(G, 1), V.repeat_interleave(G, 1)
    want = da.decode_attention_ref(q, Kr, Vr, mask, hd ** -0.5)
    assert torch.equal(got, want)
    qh = q.reshape(B, Hkv * G, hd)
    s = torch.einsum("bhd,bhtd->bht", qh, Kr) * hd ** -0.5
    p = torch.softmax(s.masked_fill(~mask[:, None], -math.inf), -1)
    assert torch.allclose(got.reshape(B, -1, hd), torch.einsum("bht,bhtd->bhd", p, Vr),
                          atol=1e-5)


# ---------------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the grouped decode-attention kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("valid", [1, 1538, 4100])
def test_grouped_kernel_against_its_plain_version(card, B, valid):
    """Head_dim 128, 20 query heads on 1 K/V head, a 4,100-key cache of
    which each row's first ``valid`` keys (less 7 a row) are valid: within
    one bf16 unit of the largest output of the plain version (the kernel
    rounds at the plain version's points; only the order of its f32 sums
    differs), and a rerun is bit-identical."""
    g = torch.Generator(device=card).manual_seed(B * 7 + valid)
    Tm, Hkv, G, hd = 4100, 1, 20, 128
    q = torch.randn((B, 1, Hkv * G * hd), generator=g, device=card).bfloat16()
    cache = torch.randn((2, B, Tm, Hkv, hd), generator=g, device=card).bfloat16()
    K, V = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
    n = torch.clamp(valid - 7 * torch.arange(B, device=card), min=1)
    mask = torch.arange(Tm, device=card)[None] < n[:, None]
    with torch.no_grad():
        got = da.decode_attention(q, K, V, mask, hd ** -0.5)
        again = da.decode_attention(q, K, V, mask, hd ** -0.5)
        want = da.decode_attention_ref(q, K, V, mask, hd ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2 ** -7 * float(want.float().abs().max()), err


@pytest.mark.cuda
def test_captured_hybrid_decode_equals_its_eager_steps(card):
    """The captured decode (eager warm-up, then 4-step CUDA graphs) gives
    the tokens and logits of the same steps run eagerly, bit for bit (a
    small jamba decoder at the kernel's head size: 4 query heads of 128 on
    1 K/V head)."""
    cfg = dataclasses.replace(small_cfg("bfloat16"), d_model=512, d_style=8,
                              mamba=MambaConfig(d_model=512, d_state=16, dt_rank=32))
    dec = hy.HybridDecoder(cfg, D_TEXT)
    seed_init(dec, 0)
    dec = dec.to(card)
    text, mask, z, voice, _ = (t.to(card) for t in inputs())
    v3 = voice.transpose(1, 2)
    kw = dict(text_mask=mask, ref_hidden=dec.embed_codec_tokens(v3),
              ref_mask=v3.reshape(3, -1) != 0, collect_logits=True)
    captured = hy.hybrid_greedy_decode(dec, text, z, F_, **kw)
    import mamba_tts_torch.models.decoder as mod

    real = mod.on_card
    try:
        mod.on_card = lambda t: False  # the eager step loop, on the same card tensors
        eager = hy.hybrid_greedy_decode(dec, text, z, F_, **kw)
    finally:
        mod.on_card = real
    assert torch.equal(captured.tokens, eager.tokens)
    assert torch.equal(captured.logits, eager.logits)
