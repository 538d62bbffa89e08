"""The one-query attention kernel of the decode step, rehearsed on the CPU.

``ops/csrc/decode_attention.cu`` cannot run here, so a plain emulation of
its dataflow, written in this file, takes its launch plan's memory slices,
scores each slice in f32 (the dot, times the scale, then the mask's -1e9),
exchanges the slice maxima and then the slice sums, rounds every
probability to bf16 with the global max and sum, and adds the slices' P V
partials in rank order.  It is held to the port's plain version
``flash_attention_ref`` and to the JAX package's ``CrossAttention.attend``
at one query (its ``_naive`` materialized softmax) at the tolerance of
``tests/test_torch_flash.py``.  The launch plan, the dispatch of
``CrossAttention.attend`` (with a stub library), and the benchmark's reader
of the kernel's launch counter are checked too.
"""
import contextlib
import importlib.util
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mamba_tts_tpu.models.attention import CrossAttention as JCrossAttention
from mamba_tts_torch.models import attention as t_attention
from mamba_tts_torch.models.attention import CrossAttention
from mamba_tts_torch.ops import decode_attention as da
from mamba_tts_torch.ops import flash_attention as fa

TOL = 2e-2  # tests/test_torch_flash.py: the flash kernels' limit, bf16 outputs
H = 2
SCALE = 64 ** -0.5
REPO = Path(__file__).resolve().parents[1]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def emulate(q, K, V, mask, scale):
    """The kernel's dataflow in f32 on bf16 values: q (B, H, 64), K and V
    (B, H, Tm, 64), mask (B, Tm) bool or None -> (B, H, 64), bf16 values."""
    B, Hh, Tm, _ = K.shape
    plan = da.launch_plan(B, Hh, Tm)
    bias = torch.zeros((B, Tm)) if mask is None else torch.where(mask, 0.0, fa.NEG_INF)
    slices = [(r * plan.keys, min((r + 1) * plan.keys, Tm)) for r in range(plan.cluster)]
    scores = [(q[:, :, None, :] * K[:, :, lo:hi]).sum(-1) * scale + bias[:, None, lo:hi]
              for lo, hi in slices]
    gmax = torch.stack([s.amax(-1) for s in scores]).amax(0)  # the exchanged maxima
    exps = [torch.exp(s - gmax[..., None]) for s in scores]
    gsum = torch.zeros_like(gmax)
    for e in exps:  # the exchanged sums, in rank order
        gsum = gsum + e.sum(-1)
    out = torch.zeros(q.shape)
    for e, (lo, hi) in zip(exps, slices):  # the partials, in rank order
        out = out + (_bf16(e / gsum[..., None])[..., None] * V[:, :, lo:hi]).sum(-2)
    return _bf16(out)


# and one memory whose slices the kernel reads in two tiles each
CASES = [(B, Tm) for B in (1, 3, 8) for Tm in (1, 77, 1000, 1536)] + [(1, 7000)]


def _inputs(B, Tm, seed=0):
    """bf16 values from numpy; a ragged mask (row b loses its last b·Tm/2B
    keys) and, where the plan has two slices or more, a whole slice masked
    in row 0 (the second) and in the last row (the first)."""
    rng = np.random.default_rng(seed + 1000 * B + Tm)

    def bf16_values(*shape):
        return _bf16(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)))

    q, K, V = bf16_values(B, H, 64), bf16_values(B, H, Tm, 64), bf16_values(B, H, Tm, 64)
    mask = torch.ones((B, Tm), dtype=torch.bool)
    for b in range(B):
        mask[b, Tm - (b * Tm) // (2 * B):] = False
    plan = da.launch_plan(B, H, Tm)
    if plan.cluster > 1:
        mask[0, plan.keys:2 * plan.keys] = False
        mask[B - 1, :plan.keys] = False
        mask[B - 1, -1] = True  # a valid key left in the last row
    return q, K, V, mask


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_attend(q, K, V, mask):
    """The JAX package's ``CrossAttention.attend`` at Tq = 1 on the CPU (f32,
    identity projections, so that it attends over q, K, V themselves)."""
    B, Hh, Tm, hd = K.shape
    d = Hh * hd
    jm = JCrossAttention(d, Hh, dtype=jnp.float32)
    shapes = jm.init(jax.random.PRNGKey(0), jnp.zeros((B, 1, d)), jnp.zeros((B, Tm, d)),
                     jnp.asarray(mask.numpy()))["params"]
    eye = {"kernel": np.eye(d, dtype=np.float32), "bias": np.zeros((d,), np.float32)}
    params = {name: eye for name in shapes}
    y = jm.apply({"params": params}, jnp.asarray(q.reshape(B, 1, d).numpy()), jnp.asarray(K.numpy()),
                 jnp.asarray(V.numpy()), jnp.asarray(mask.numpy()), method=JCrossAttention.attend)
    return np.asarray(y).reshape(B, Hh, hd)


@pytest.mark.parametrize("B,Tm", CASES)
def test_emulated_kernel_matches_plain_version(B, Tm):
    """Against ``flash_attention_ref`` on bf16 tensors (f32 logits and
    softmax, bf16 probabilities and P V), as the card runs it."""
    q, K, V, mask = _inputs(B, Tm)
    got = emulate(q, K, V, mask, SCALE)
    want = fa.flash_attention_ref(q[:, :, None].bfloat16(), K.bfloat16(), V.bfloat16(), mask, SCALE)
    assert _rel(got, want[:, :, 0].float()) <= TOL
    no_mask = fa.flash_attention_ref(q[:, :, None].bfloat16(), K.bfloat16(), V.bfloat16(), None, SCALE)
    assert _rel(emulate(q, K, V, None, SCALE), no_mask[:, :, 0].float()) <= TOL


@pytest.mark.parametrize("B,Tm", CASES)
def test_emulated_kernel_matches_jax_attend(B, Tm):
    q, K, V, mask = _inputs(B, Tm, seed=1)
    assert _rel(emulate(q, K, V, mask, SCALE), _jax_attend(q, K, V, mask)) <= TOL


@pytest.mark.parametrize("B,Hh,Tm", [(8, 8, 1536), (1, 8, 1536), (3, 2, 77), (2, 8, 1000),
                                     (8, 8, 1), (16, 8, 6000), (1, 1, 6912), (64, 16, 4097),
                                     (2, 2, 33), (1, 1, 6913), (2, 8, 100_000),
                                     (1, 8, 1_000_003)])
def test_launch_plan_covers_every_key_once_and_fits_a_block(B, Hh, Tm):
    """Every key in exactly one slice and, within it, in exactly one tile;
    tiles fit a block's shared memory; a workspace exactly where a slice is
    longer than a tile, one slot a key of every slice."""
    plan = da.launch_plan(B, Hh, Tm)
    assert 1 <= plan.cluster <= da.MAX_CLUSTER and plan.blocks == B * Hh * plan.cluster
    assert plan.keys % da.KEY_ALIGN == 0 and plan.tile % da.KEY_ALIGN == 0
    assert da.KEY_ALIGN <= plan.tile <= min(plan.keys, da.MAX_TILE)
    covered = np.zeros(Tm, int)
    for r in range(plan.cluster):
        lo, hi = r * plan.keys, min((r + 1) * plan.keys, Tm)
        assert hi > lo, "empty slice"
        for t in range(lo, hi, plan.tile):
            covered[t:min(t + plan.tile, hi)] += 1
    assert (covered == 1).all()
    assert plan.smem_bytes == da.smem_bytes(plan.tile) <= da.MAX_SMEM_BYTES
    assert plan.workspace == (B * Hh * plan.cluster * plan.keys if plan.tile < plan.keys else 0)


def test_launch_plan_shared_memory_matches_the_kernel_layout():
    """The CUDA source's layout, written out: 192 keys of K and V (128 bytes
    each) and their f32 scores, 8 + 2 x 8 f32 reductions and exchanged
    values, 8 + 8 rows of 64 f32 partials, 32 bytes of mbarriers; and a
    memory too long for 8 one-tile slices is read in two tiles a slice,
    its scores in the workspace."""
    assert da.launch_plan(8, 8, 1536) == da.LaunchPlan(cluster=8, keys=192, tile=192, blocks=512,
                                                       smem_bytes=192 * 260 + 96 + 4096 + 32,
                                                       workspace=0)
    assert da.smem_bytes(da.MAX_TILE) <= da.MAX_SMEM_BYTES < da.smem_bytes(da.MAX_TILE + da.KEY_ALIGN)
    long = da.launch_plan(1, 1, da.MAX_CLUSTER * da.MAX_TILE + 1)
    assert long.cluster == da.MAX_CLUSTER and long.tile < long.keys <= 2 * long.tile
    assert long.workspace == da.MAX_CLUSTER * long.keys


def _memory(attn, B, Tm, seed=0):
    g = torch.Generator().manual_seed(seed)
    memory = torch.randn((B, Tm, attn.d_model), generator=g)
    with torch.no_grad():
        return attn.project_memory(memory)


@pytest.fixture
def card_stub(monkeypatch):
    """``on_card`` says yes; the kernel's library records each launch."""
    monkeypatch.setattr(t_attention, "on_card", lambda t: True)
    monkeypatch.setattr(da, "on_card", lambda t: True)
    launches = []

    class Lib:
        def decode_attention_launch(self, *args):
            launches.append(args)
            return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(da, "_library", Lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: Stream())
    return launches


def test_one_query_without_gradient_launches_the_kernel_and_leaves_k_v_alone(card_stub):
    """Tq = 1, no gradient, bf16 K/V as ``_split`` leaves them: one launch a
    call with the plan's numbers, its output returned through ``o_proj``,
    and no torch op reads K or V."""
    attn = CrossAttention(128, 2, dtype=torch.bfloat16)
    K, V = _memory(attn, 3, 77)
    mask = torch.ones((3, 77), dtype=torch.bool)
    seen = []

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            flat = [a for a in list(args) + list((kwargs or {}).values())]
            flat += [b for a in flat if isinstance(a, (list, tuple)) for b in a]
            seen.append((str(func), [a for a in flat if isinstance(a, torch.Tensor)]))
            return func(*args, **(kwargs or {}))

    before = da.decode_attention.launches
    with torch.no_grad(), Ops():
        y = attn.attend(torch.zeros((3, 1, 128), dtype=torch.bfloat16), K, V, mask)
    assert y.shape == (3, 1, 128)
    assert len(card_stub) == 1 and da.decode_attention.launches == before + 1
    args = card_stub[0]
    plan = da.launch_plan(3, 2, 77)
    assert args[1:4] == (K.data_ptr(), V.data_ptr(), mask.data_ptr())
    assert args[5] is None  # no workspace: one tile a slice
    assert args[6:14] == (3, 2, 77, plan.cluster, plan.keys, plan.tile, plan.smem_bytes, SCALE)
    storages = {K.untyped_storage().data_ptr(), V.untyped_storage().data_ptr()}
    for name, tensors in seen:
        assert not any(t.untyped_storage().data_ptr() in storages for t in tensors), name


@pytest.mark.parametrize("case", ["gradient", "few_queries", "long_queries", "f32_kv",
                                  "head_dim_32"])
def test_other_calls_keep_their_path(card_stub, monkeypatch, case):
    """With a gradient recorded, at 1 < Tq < 128, with K/V in another dtype
    or another head size, the call takes ``flash_attention_ref``; at
    Tq >= 128 it takes ``flash_attention``."""
    calls = []

    def plain(q, *a):
        calls.append(("plain", q.shape[2]))
        return fa.flash_attention_ref(q, *a)

    def flash(q, *a):
        calls.append(("flash", q.shape[2]))
        return fa.flash_attention_ref(q, *a)

    monkeypatch.setattr(t_attention, "flash_attention_ref", plain)
    monkeypatch.setattr(t_attention, "flash_attention", flash)
    d, heads, Tq, Tm, grad = 128, 2, 1, 77, False
    if case == "few_queries":
        Tq = 5
    elif case == "long_queries":
        Tq = 128
    elif case == "head_dim_32":
        heads = 4
    attn = CrossAttention(d, heads, dtype=torch.bfloat16)
    K, V = _memory(attn, 2, Tm)
    if case == "f32_kv":
        K, V = K.float(), V.float()
    x = torch.zeros((2, Tq, d), dtype=torch.bfloat16)
    if case == "gradient":
        y = attn.attend(x.requires_grad_(), K, V)
        y.float().sum().backward()
        assert x.grad is not None
    else:
        with torch.no_grad():
            y = attn.attend(x, K, V)
    assert y.shape == (2, Tq, d)
    assert calls == [("flash" if case == "long_queries" else "plain", Tq)]
    assert not card_stub


@pytest.mark.parametrize("case", ["contiguous_kv", "misaligned_kv", "int_mask", "f32_query"])
def test_one_query_calls_the_kernel_does_not_take_raise(card_stub, case):
    """A one-query call on the card with head size 64 and bf16 K/V is the
    kernel's: where its tensors are in a layout the kernel does not take,
    the call raises and nothing is launched; it never falls back to the
    plain version."""
    attn = CrossAttention(128, 2, dtype=torch.bfloat16)
    K, V = _memory(attn, 2, 77)
    mask = torch.ones((2, 77), dtype=torch.bool)
    q = torch.zeros((2, 1, 128), dtype=torch.bfloat16)
    if case == "contiguous_kv":
        K, V = K.contiguous(), V.contiguous()
    elif case == "misaligned_kv":
        flat = torch.zeros(2 * 77 * 128 + 1, dtype=torch.bfloat16)[1:].reshape(2, 77, 128)
        K = flat.reshape(2, 77, 2, 64).transpose(1, 2)
    elif case == "int_mask":
        mask = mask.to(torch.int32)
    with torch.no_grad(), pytest.raises(ValueError, match="does not take"):
        if case == "f32_query":
            da.decode_attention(q.float(), K, V, mask, SCALE)
        else:
            attn.attend(q, K, V, mask)
    assert not card_stub


def test_long_memory_takes_the_kernel_with_a_workspace(card_stub):
    """A memory longer than 8 one-tile slices still goes to the kernel, one
    launch, with the plan's tiles and a workspace of one f32 score a key."""
    attn = CrossAttention(128, 2, dtype=torch.bfloat16)
    Tm = da.MAX_CLUSTER * da.MAX_TILE + 1
    K, V = _memory(attn, 1, Tm)
    with torch.no_grad():
        y = attn.attend(torch.zeros((1, 1, 128), dtype=torch.bfloat16), K, V)
    assert y.shape == (1, 1, 128) and len(card_stub) == 1
    args, plan = card_stub[0], da.launch_plan(1, 2, Tm)
    assert plan.tile < plan.keys and args[5] is not None and args[3] is None
    assert args[6:12] == (1, 2, Tm, plan.cluster, plan.keys, plan.tile)


def _reader():
    path = REPO / "portbench" / "metrics" / "decode_attention_launches.serve.py"
    spec = importlib.util.spec_from_file_location("decode_attention_launches_serve", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_benchmark_reader_takes_launches_over_replayed_steps(monkeypatch):
    """``decode_attention_launches.serve`` divides the counter by the steps
    of the traced requests' ``decode.capture`` (the warm-up) and
    ``decode.run`` spans; a program without the counter, or without the
    tracer, reads None and raises nothing."""
    from mamba_tts_torch.utils import profiling

    reader = _reader()
    traced = {"profile": {"window": (0.0, 1e12), "kernels": []}, "records": []}
    profiling.reset()
    profiling.enable()
    try:
        with profiling.annotate("synth.request"):
            with profiling.annotate("decode.capture", steps=4):
                pass
            with profiling.annotate("decode.run", steps=1916, path="graph"):
                pass
            profiling.count("decode.attention_launches", 8 * 1920)
        with profiling.annotate("synth.request"):
            with profiling.annotate("decode.capture", steps=1):
                pass
            with profiling.annotate("decode.run", steps=1276, path="graph"):
                pass
            profiling.count("decode.attention_launches", 8 * 1277)
        assert reader.read(traced) == 8.0
        assert reader.read({"records": []}) is None
        profiling.reset()
        with profiling.annotate("synth.request"):
            with profiling.annotate("decode.run", steps=4, path="megakernel"):
                pass
        assert reader.read(traced) is None  # a program that counts no such launches
    finally:
        profiling.disable()
        profiling.reset()
    bare = types.ModuleType("mamba_tts_torch.utils.profiling")
    monkeypatch.setitem(sys.modules, "mamba_tts_torch.utils.profiling", bare)
    import mamba_tts_torch.utils as utils

    monkeypatch.setattr(utils, "profiling", bare, raising=False)
    assert reader.read(traced) is None
