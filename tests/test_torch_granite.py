"""The granite decoder (``mamba_tts_torch/models/granite.py``: Mamba-2 mixers,
grouped NoPE attention, a mixture of experts held in part, with a shared
MLP) against the plain reference ``portbench/reference_granite/`` on seeded
random weights, at a small size on the CPU: teacher-forced logits; prefill
then cached steps against the full forward; the chunked SSD against the
recurrence one step at a time; the held experts' shares against the uncut
layer; the router.  Also: the published configuration's layer pattern and
parameter count, and the plain Mamba-2 state step.

The ``cuda`` tests (they skip without a card; this file imports no jax) hold
the Mamba-2 state kernel to its plain version and the captured granite
decode to its eager steps at the published widths.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from mamba_tts_torch.config import (
    DecoderConfig,
    Mamba2Config,
    MoEConfig,
    TTSConfig,
    from_json,
)
from mamba_tts_torch.infer.synthesize import Synthesizer
from mamba_tts_torch.models import granite as gr
from mamba_tts_torch.models import hybrid as hy
from mamba_tts_torch.models.layers import seed_init
from mamba_tts_torch.models.mamba2 import Mamba2Mixer, ssd_chunked
from mamba_tts_torch.models.moe import MoE
from mamba_tts_torch.models.tts import MambaTTS
from mamba_tts_torch.ops import mamba_step as ms
from portbench.reference_granite import granite_tts as ref_mod
from portbench.reference_granite.granite_tts import GraniteConfig, GraniteTTSDecoder

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "portbench" / "configs" / "granite-4.0-h-small-tts.json"
Q, F_, S_VOICE, L_TEXT, D_TEXT = 2, 6, 8, 12, 24
KINDS = ("mamba", "mamba", "attention", "mamba", "mamba", "mamba")


def small_cfg(dtype: str = "float32", first: int = 0, held: int = 3) -> DecoderConfig:
    """d_model 64, 6 layers (attention at layer 2: 4 query heads of 16 on 2
    K/V heads), Mamba-2 of 8 heads of 16 with d_state 16 and chunks of 8, 8
    experts of 24 with ``held`` held from ``first`` and top-2, a shared MLP of
    32, granite's multipliers."""
    return DecoderConfig(
        block="granite", codebook_size=30, d_model=64, n_layers=6, n_heads=4, n_kv_heads=2,
        d_style=8, max_len=16, num_quantizers=Q, layer_types=KINDS, norm_eps=1e-5, dtype=dtype,
        mamba2=Mamba2Config(n_heads=8, head_dim=16, d_state=16, chunk=8),
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=24, d_shared=32, experts_held=held,
                      first_expert=first),
        embedding_multiplier=12.0, residual_multiplier=0.22, attention_multiplier=1 / 16,
        logits_scaling=16.0)


def build(dtype: str = "float32", seed: int = 0, **kw) -> gr.GraniteDecoder:
    dec = gr.GraniteDecoder(small_cfg(dtype, **kw), D_TEXT)
    seed_init(dec, seed)
    with torch.no_grad():  # non-trivial norms and biases, so that each is tested
        g = torch.Generator().manual_seed(seed + 1)
        for n, p in dec.named_parameters():
            if n.endswith("norm.weight") or "norm_" in n:
                p.add_(0.2 * torch.randn(p.shape, generator=g))
            elif n.endswith(".bias") or n.endswith("conv_b"):
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return dec


def reference_for(dec: gr.GraniteDecoder, fake=None) -> GraniteTTSDecoder:
    ref = GraniteTTSDecoder(GraniteConfig.from_dict(dataclasses.asdict(dec.cfg), D_TEXT), fake)
    mine, theirs = dict(dec.named_parameters()), dict(ref.named_parameters())
    assert set(mine) == set(theirs)
    with torch.no_grad():
        for n, p in theirs.items():
            p.copy_(mine[n].float())
    return ref


def inputs(B: int = 3, seed: int = 0):
    """Rows of different prefix lengths: text valid to 12, 7 and 3 positions
    (the rest noise of 1e3, never to be read), voice grids of 8, 5 and 6
    valid frames (PAD past them)."""
    g = torch.Generator().manual_seed(seed)
    text_len, voice_len = [12, 7, 3][:B], [8, 5, 6][:B]
    text = torch.randn((B, L_TEXT, D_TEXT), generator=g)
    mask = torch.arange(L_TEXT)[None] < torch.tensor(text_len)[:, None]
    text = torch.where(mask[..., None], text, 1e3 * torch.randn(text.shape, generator=g))
    z = torch.randn((B, 8), generator=g)
    voice = torch.randint(2, 32, (B, S_VOICE, Q), generator=g)
    keep = torch.arange(S_VOICE)[None, :, None] < torch.tensor(voice_len)[:, None, None]
    voice = torch.where(keep, voice, torch.zeros_like(voice))
    tokens = torch.randint(2, 32, (B, Q * F_), generator=g)
    return text, mask, z, voice, tokens


def program_forward(dec, text, mask, z, voice, tokens):
    B = tokens.shape[0]
    v3 = voice.transpose(1, 2)
    inp = torch.cat([torch.full((B, 1), 1), tokens[:, :-1]], dim=1)
    quant = torch.arange(Q).repeat_interleave(F_)[None]
    pos = torch.arange(F_).repeat(Q)[None]
    return dec(inp, text, z, mask, dec.embed_codec_tokens(v3), v3.reshape(B, -1) != 0,
               quant_ids=quant, pos_ids=pos)


def reference_logits(ref, text, mask, z, voice, tokens):
    return [ref.logits(text[b][mask[b]], z[b], voice[b], tokens[b]) for b in range(len(tokens))]


def fp8(x):
    s = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


def largest(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def test_teacher_forced_logits_match_the_reference():
    """(a) f32 against f32: every logit within 1e-5 of the reference's (the
    logits are a few tenths after ``logits_scaling``; the two differ only in
    the order of f32 sums: SDPA against materialized attention, the chunked
    SSD's products against the reference's segment sums, the experts'
    scatter-add)."""
    dec = build()
    ref = reference_for(dec)
    text, mask, z, voice, tokens = inputs()
    with torch.no_grad():
        got = program_forward(dec, text, mask, z, voice, tokens)
        want = reference_logits(ref, text, mask, z, voice, tokens)
    assert 0.05 < max(float(w.abs().max()) for w in want) < 5.0
    assert largest(got, want) < 1e-5


def test_bf16_logits_sit_between_the_reference_and_float8():
    """The configuration's precision (bf16 compute and matrices) reads within
    3e-3 of the f32 reference's logits (logits of a few tenths; bf16 keeps 8
    bits: 1.7e-3 read here), while the reference with every product's
    operands in float8 e4m3 (3 bits) misses by more (4.6e-3): the tolerance
    tells the two precisions apart."""
    dec = build("bfloat16")
    ref = reference_for(dec)
    low = reference_for(dec, fake=fp8)
    text, mask, z, voice, tokens = inputs()
    with torch.no_grad():
        got = program_forward(dec, text, mask, z, voice, tokens)
        want = reference_logits(ref, text, mask, z, voice, tokens)
        lo = reference_logits(low, text, mask, z, voice, tokens)
    gap, fp8_gap = largest(got, want), largest(lo, want)
    assert gap < 3e-3 < fp8_gap, (gap, fp8_gap)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-3)])
def test_prefill_then_cached_steps_match_the_full_forward(dtype, tol):
    """(b) The decode (prefill of rows of different prefix lengths, then
    cached steps in lockstep, eager on the CPU: the plain conv and Mamba-2
    steps, the dense-over-held MoE step) gives at every step the logits the
    reference's full forward over prefix and served tokens gives: within
    1e-5 in f32 (sums in another order), 3e-3 in bf16 (as above)."""
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
    assert largest([res.logits[b, :, 2:] for b in range(3)],
                   [want[b][:, 2:] for b in range(3)]) < tol


def test_chunked_ssd_at_uneven_lengths_matches_the_recurrence():
    """(c) The system's chunked SSD (chunks of 8 over 29 positions, rows
    masked to 29, 17 and 5 positions as the prefill masks them) gives the
    outputs and, for each row, the state after its own length that the
    recurrence one step at a time (the reference's ``ssd_steps``) gives
    over that row alone, the state read out by N further steps with no
    decay and no input, C the unit vectors (1e-5 of values of order one:
    sums in another order); the reference's chunked form equals its own
    recurrence likewise."""
    g = torch.Generator().manual_seed(4)
    B, T, H, P, N = 3, 29, 4, 8, 6
    x = torch.randn((B, T, H, P), generator=g)
    delta = torch.rand((B, T, H), generator=g) * 0.5
    A = -torch.rand(H, generator=g) * 4 - 0.1
    Bm, Cm = torch.randn((B, T, N), generator=g), torch.randn((B, T, N), generator=g)
    lengths = torch.tensor([29, 17, 5])
    masked = delta * (torch.arange(T)[None] < lengths[:, None])[..., None]
    y, h = ssd_chunked(x, masked, A, Bm, Cm, 8)
    for b, n in enumerate(lengths.tolist()):
        ys = ref_mod.ssd_steps(x[b, :n], delta[b, :n], A, Bm[b, :n], Cm[b, :n])
        assert (y[b, :n] - ys).abs().max() < 1e-5
        # the state after the row's length: one step past it reads it through C = e_n
        hs = ref_mod.ssd_steps(torch.cat([x[b, :n], torch.zeros_like(x[b, :N])]),
                               torch.cat([delta[b, :n], torch.zeros_like(delta[b, :N])]), A,
                               torch.cat([Bm[b, :n], torch.zeros((N, N))]),
                               torch.cat([Cm[b, :n], torch.eye(N)]))[n:]  # (N, H, P)
        assert (h[b] - hs.permute(1, 2, 0)).abs().max() < 1e-5
    r = ref_mod.ssd_chunks(x[0], delta[0], A, Bm[0], Cm[0], 8)
    assert (r - ref_mod.ssd_steps(x[0], delta[0], A, Bm[0], Cm[0])).abs().max() < 1e-5


def test_a_mixer_prefilled_with_padding_keeps_each_rows_state():
    """Rows prefilled together at lengths 29, 17 and 5 (padding noise of
    1e3 past them) leave the conv window and state each row leaves alone."""
    c = Mamba2Config(n_heads=4, head_dim=8, d_state=6, chunk=8)
    mix = Mamba2Mixer(c, 32, 1e-5, torch.float32)
    seed_init(mix, 2)
    g = torch.Generator().manual_seed(5)
    u = torch.randn((3, 29, 32), generator=g)
    lengths = torch.tensor([29, 17, 5])
    pad = torch.arange(29)[None] >= lengths[:, None]
    u = torch.where(pad[..., None], 1e3 * torch.randn(u.shape, generator=g), u)
    with torch.no_grad():
        _, st = mix(u, lengths)
        for b, n in enumerate(lengths.tolist()):
            _, one = mix(u[b:b + 1, :n])
            assert torch.allclose(st.conv[b], one.conv[0], atol=1e-6)
            assert torch.allclose(st.ssm[b], one.ssm[0], rtol=1e-5, atol=1e-6)


def test_the_held_shares_add_up_to_the_uncut_layer():
    """(d) The MoE layer held as the disjoint sets {0, 1, 2}, {3, 4, 5} and
    {6, 7} of its 8 experts: the three shares less the shared MLP, plus the
    shared MLP once, give the layer that holds all 8 (f32, 1e-6: sums in
    another order), in the prefill's form and the step's."""
    d, full_cfg = 64, MoEConfig(n_experts=8, top_k=2, d_expert=24, d_shared=32)
    full = MoE(d, full_cfg, torch.float32)
    seed_init(full, 3)
    x = torch.randn((5, 7, d), generator=torch.Generator().manual_seed(6))
    parts = []
    for first, held in ((0, 3), (3, 3), (6, 2)):
        part = MoE(d, dataclasses.replace(full_cfg, first_expert=first, experts_held=held),
                   torch.float32)
        sd = dict(full.state_dict())
        sd["input_linear"] = sd["input_linear"][first:first + held]
        sd["output_linear"] = sd["output_linear"][first:first + held]
        part.load_state_dict(sd)
        parts.append(part)
    with torch.no_grad():
        shared = full.shared_mlp(x)
        whole = full(x)
        summed = sum(p(x) - shared for p in parts) + shared
        assert (summed - whole).abs().max() < 1e-6
        step = sum(p.step(x[:, :1]) - shared[:, :1] for p in parts) + shared[:, :1]
        assert (step - full.step(x[:, :1])).abs().max() < 1e-6
        assert (full.step(x[:, :1]) - whole[:, :1]).abs().max() < 1e-6


def test_the_router_keeps_its_width_and_drops_unheld_gates():
    """(e) The router scores all 8 experts; each token's gates are the
    softmax over its top 2 logits, 0 for the others; a device holding
    experts 3-5 keeps those columns and renormalises nothing."""
    cfg = MoEConfig(n_experts=8, top_k=2, d_expert=4, d_shared=0, experts_held=3,
                    first_expert=3)
    moe = MoE(16, cfg, torch.float32)
    seed_init(moe, 1)
    x = torch.randn((40, 16), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        logits = x @ moe.router.weight.T
        g = moe.gates(x)
    assert g.shape == (40, 3)
    top, idx = logits.topk(2, dim=-1)
    want = torch.zeros_like(logits).scatter(-1, idx, torch.softmax(top, -1))
    assert torch.equal(g, want[:, 3:6])
    assert (want.sum(-1) - 1).abs().max() < 1e-6 and (g.sum(-1) < 1 - 1e-3).any()
    assert ((g > 0).sum(-1) <= 2).all()


def layer_param_counts(cfg: DecoderConfig) -> dict:
    """Parameters of one layer of each kind, counted from the configuration:
    the ``mamba`` and ``attention`` mixers, the held experts (``experts``),
    the router, the shared MLP and the two norms (``moe``), each layer
    (``mamba``, ``attention``), and ``layers``, the whole stack's."""
    d, m, e = cfg.d_model, cfg.mamba2, cfg.moe
    di, N, H = m.d_inner, m.d_state, m.n_heads
    mixer = (d * (2 * di + 2 * m.n_groups * N + H) + m.d_conv * m.conv_dim
             + (m.conv_dim if m.conv_bias else 0) + 3 * H + di + di * d)
    hd = d // cfg.n_heads
    attn = 2 * d * cfg.n_heads * hd + 2 * d * cfg.kv_heads * hd
    lo, hi = e.held
    experts = (hi - lo) * 3 * d * e.d_expert
    moe = d * e.n_experts + experts + 3 * d * e.d_shared + 2 * d
    out = {"mamba_mixer": mixer, "attention_mixer": attn, "experts": experts, "moe": moe,
           "mamba": mixer + moe, "attention": attn + moe}
    out["layers"] = sum(out[k] for k in cfg.layer_kinds())
    return out


def test_the_plain_mamba2_step_is_one_step_of_the_recurrence():
    """``mamba2_step_ref`` (what the kernel is held to) is one step of the
    recurrence with delta = softplus(dt + dt_bias), then y + D·x times
    SiLU(z); in place it writes the state it returns."""
    g = torch.Generator().manual_seed(7)
    B, H, P, N = 2, 3, 4, 5
    x, z = torch.randn((B, H * P), generator=g), torch.randn((B, H * P), generator=g)
    Bm, Cm = torch.randn((B, N), generator=g), torch.randn((B, N), generator=g)
    dt, dt_bias = torch.randn((B, H), generator=g), torch.randn(H, generator=g)
    A_log, D = torch.rand(H, generator=g), torch.randn(H, generator=g)
    h = torch.randn((B, H, P, N), generator=g)
    y, new = ms.mamba2_step_ref(x, Bm, Cm, z, dt, dt_bias, A_log, D, h)
    delta = F.softplus(dt + dt_bias)
    want = torch.exp(delta * -torch.exp(A_log))[..., None, None] * h \
        + (delta[..., None] * x.reshape(B, H, P))[..., None] * Bm[:, None, None]
    assert torch.allclose(new, want, atol=1e-6)
    yy = (torch.einsum("bhpn,bn->bhp", want, Cm) + x.reshape(B, H, P) * D[:, None])
    assert torch.allclose(y, yy.reshape(B, -1) * F.silu(z), atol=1e-6)
    carry = h.clone()
    y2, out = ms.mamba2_step(x, Bm, Cm, z, dt, dt_bias, A_log, D, carry, inplace=True)
    assert out is carry and torch.equal(out, new) and torch.equal(y2, y)


def test_published_configuration_layer_pattern_and_parameter_count():
    """The configuration file's decoder: attention at layers 5, 15, 25 and 35
    of 40; Mamba-2 mixers of 102.3M, 9 held experts of 9.44M a layer; 8.01B
    parameters in the layers, counted from the configuration alone; every
    width as published, the router at 72 with top-10."""
    conf = json.loads(CONFIG.read_text())
    dc = from_json(json.dumps(conf["model"])).decoder
    kinds = dc.layer_kinds()
    assert [i for i, k in enumerate(kinds) if k == "attention"] == [5, 15, 25, 35]
    assert list(kinds) == conf["layer_types"] and len(kinds) == conf["num_hidden_layers"]
    m, e = dc.mamba2, dc.moe
    assert (dc.d_model, dc.n_heads, dc.kv_heads) == (4096, 32, 8)
    assert (m.n_heads, m.head_dim, m.d_state, m.n_groups, m.d_conv, m.chunk) == \
        (128, 64, 128, 1, 4, 256)
    assert (e.n_experts, e.top_k, e.d_expert, e.d_shared, e.held) == (72, 10, 768, 1536, (0, 9))
    assert (dc.embedding_multiplier, dc.residual_multiplier, dc.attention_multiplier,
            dc.logits_scaling, dc.norm_eps) == (12, 0.22, 1 / 128, 16, 1e-5)
    counts = layer_param_counts(dc)
    assert round(counts["mamba_mixer"] / 1e6, 1) == 102.3
    assert round(counts["experts"] / 9 / 1e6, 2) == 9.44
    assert round(counts["layers"] / 1e9, 2) == 8.01
    assert conf["num_local_experts"] == 9 and conf["vocab_size"] == dc.vocab_size_audio == 1026
    assert conf["reduced"] == ["num_local_experts", "vocab_size"]
    assert conf["published"]["num_local_experts"]["value"] == 72


def test_parameter_count_follows_the_modules():
    dec = build()
    got = sum(p.numel() for n, p in dec.named_parameters() if n.startswith("layer_"))
    assert got == layer_param_counts(dec.cfg)["layers"]


def test_serving_the_granite_decoder_takes_no_other_path():
    """The granite decoder is served through its captured decode only; its
    matrices are held in bf16 (the router's in f32) and nothing else."""
    cfg = dataclasses.replace(TTSConfig(), decoder=small_cfg("bfloat16"))
    with torch.device("meta"):
        model = MambaTTS(cfg)
    assert isinstance(model.decoder, gr.GraniteDecoder)
    for quant in ("megakernel", "int8", "int8_kv"):
        with pytest.raises(ValueError, match="granite"):
            Synthesizer(cfg, model, quant=quant, device="cpu")
    layer = model.decoder.layers[0]
    assert layer.moe.router.weight.dtype == torch.float32
    assert layer.moe.input_linear.dtype == layer.mamba.in_proj.weight.dtype == torch.bfloat16
    assert layer.mamba.conv_w.dtype == torch.bfloat16 and layer.mamba.A_log.dtype == torch.float32


def test_traced_prefill_has_a_span_a_part_of_each_layer_and_the_step_its_counters():
    """Traced (``profiling.enable()``), the decode keeps ``decode.prefill``
    (its ``rows``, ``positions`` and ``lengths``) with one ``prefill.mamba2``
    or ``prefill.attention`` and one ``prefill.moe`` a layer inside it, in
    layer order; ``decode.run`` (``path`` ``eager`` off the card); the
    step's products counted, none casting (the decoder as served), and no
    kernel counter where no kernel ran (the CPU)."""
    from mamba_tts_torch.models.layers import hold_in_compute_dtype
    from mamba_tts_torch.utils import profiling

    dec = build("bfloat16")
    hold_in_compute_dtype(dec)
    text, mask, z, voice, _ = inputs()
    v3 = voice.transpose(1, 2)
    profiling.reset()
    profiling.enable()
    try:
        hy.hybrid_greedy_decode(dec, text, z, F_, text_mask=mask,
                                ref_hidden=dec.embed_codec_tokens(v3),
                                ref_mask=v3.reshape(3, -1) != 0)
        got, counts = profiling.spans(), profiling.counters()
    finally:
        profiling.disable()
        profiling.reset()
    (pre,) = [s for s in got if s.name == "decode.prefill"]
    assert pre.attrs["rows"] == 3 and pre.attrs["positions"] == 1 + 8 * Q + 12
    assert list(pre.attrs["lengths"]) == [1 + 8 * Q + 12, 1 + 5 * Q + 7, 1 + 6 * Q + 3]
    inner = [s.name for s in got if s.parent == pre.id]
    want = []
    for k in KINDS:
        want += ["prefill.mamba2" if k == "mamba" else "prefill.attention", "prefill.moe"]
    assert inner == want
    (run,) = [s for s in got if s.name == "decode.run"]
    assert run.attrs["path"] == "eager" and run.attrs["steps"] == Q * F_
    # a step: in_proj, out_proj and the shared MLP's two a Mamba-2 layer; q, k, v, o and
    # the shared MLP's two at the attention layer; each router and the two expert stacks
    per_step = 5 * 4 + 6 + 6 * 3
    assert counts["decode.dense_products"] == per_step * Q * F_
    assert "decode.dense_casts" not in counts
    assert "decode.mamba_step_launches" not in counts
    assert "decode.self_attention_launches" not in counts


# ---------------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the Mamba-2 state kernel has no CPU mode")
    return torch.device("cuda")


def _step_operands(card, B, dtype, seed):
    """A step's operands at granite's widths (128 heads of 64, d_state 128),
    laid out as the mixer lays them: x, B, C slices of one conv output, z
    and dt slices of one in_proj output."""
    g = torch.Generator(device=card).manual_seed(seed)
    H, P, N = 128, 64, 128
    xc = torch.randn((B, H * P + 2 * N), generator=g, device=card).to(dtype)
    proj = torch.randn((B, 2 * H * P + 2 * N + H), generator=g, device=card).to(dtype)
    x, Bm, Cm = torch.split(xc, [H * P, N, N], dim=-1)
    z, dt = proj[:, :H * P], proj[:, -H:]
    dt_bias = torch.randn(H, generator=g, device=card) - 3
    A_log = torch.log(1 + 15 * torch.rand(H, generator=g, device=card))
    D = torch.randn(H, generator=g, device=card)
    h = torch.randn((B, H, P, N), generator=g, device=card)
    return x, Bm, Cm, z, dt, dt_bias, A_log, D, h


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mamba2_kernel_against_its_plain_version(card, B, dtype):
    """The kernel's state equals the plain version's bit for bit (the same
    IEEE operations in the same order) over 64 steps in place; y within
    1e-5 of its largest value (only the order of the sum over N differs);
    a rerun is bit-identical; one launch a call."""
    x, Bm, Cm, z, dt, dt_bias, A_log, D, h = _step_operands(card, B, dtype, B)
    mine, plain = h.clone(), h.clone()
    with torch.no_grad():
        for _ in range(64):
            before = ms.launches
            y, out = ms.mamba2_step(x, Bm, Cm, z, dt, dt_bias, A_log, D, mine, inplace=True)
            assert ms.launches == before + 1 and out is mine
            want, plain = ms.mamba2_step_ref(x, Bm, Cm, z, dt, dt_bias, A_log, D, plain)
            assert torch.equal(mine, plain)
            err = float((y - want).abs().max())
            assert err <= 1e-5 * float(want.abs().max()), err
        again = h.clone()
        y1, _ = ms.mamba2_step(x, Bm, Cm, z, dt, dt_bias, A_log, D, again)
        y2, _ = ms.mamba2_step(x, Bm, Cm, z, dt, dt_bias, A_log, D, again)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)


@pytest.mark.cuda
def test_mamba2_kernel_refuses_what_it_does_not_take(card):
    x, Bm, Cm, z, dt, dt_bias, A_log, D, h = _step_operands(card, 2, torch.bfloat16, 0)
    with pytest.raises(ValueError, match="size"):
        ms.mamba2_step(x[:, :64 * 64], Bm, Cm, z[:, :64 * 64], dt[:, :64], dt_bias[:64],
                       A_log[:64], D[:64], h[:, :64, :, :64].contiguous())
    with pytest.raises(ValueError, match="dtype"):
        ms.mamba2_step(x, Bm, Cm, z.float(), dt, dt_bias, A_log, D, h)


@pytest.mark.cuda
def test_captured_granite_decode_equals_its_eager_steps(card):
    """At the published widths (d_model 4,096; Mamba-2 128 heads of 64,
    d_state 128; attention 32 heads on 8 K/V heads of 128; a router of 72,
    top-10, 9 experts of 768 held; a shared MLP of 1,536), three layers
    (Mamba-2, attention, Mamba-2): the captured decode (eager warm-up, then
    4-step CUDA graphs) gives the tokens and logits of the same steps run
    eagerly, bit for bit, with two state-step launches a Mamba-2 layer and
    one attention launch a step."""
    conf = json.loads(CONFIG.read_text())
    dc = from_json(json.dumps(conf["model"])).decoder
    cfg = dataclasses.replace(dc, n_layers=3, layer_types=("mamba", "attention", "mamba"),
                              codebook_size=30, d_style=8, max_len=16, num_quantizers=Q)
    with torch.device(card):
        dec = gr.GraniteDecoder(cfg, D_TEXT)
    seed_init(dec, 0)
    text, mask, z, voice, _ = (t.to(card) for t in inputs())
    v3 = voice.transpose(1, 2)
    kw = dict(text_mask=mask, ref_hidden=dec.embed_codec_tokens(v3),
              ref_mask=v3.reshape(3, -1) != 0, collect_logits=True)
    from mamba_tts_torch.ops import decode_attention as da

    before, attn = ms.launches, da.decode_attention.launches
    captured = hy.hybrid_greedy_decode(dec, text, z, F_, **kw)
    assert ms.launches - before == 2 * 2 * Q * F_
    assert da.decode_attention.launches - attn == Q * F_
    import mamba_tts_torch.models.decoder as mod

    real = mod.on_card
    try:
        mod.on_card = lambda t: False  # the eager step loop, on the same card tensors
        eager = hy.hybrid_greedy_decode(dec, text, z, F_, **kw)
    finally:
        mod.on_card = real
    assert torch.equal(captured.tokens, eager.tokens)
    assert torch.equal(captured.logits, eager.logits)
