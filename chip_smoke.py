#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mamba_tts_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and exits non-zero:

1. build   — compile every CUDA kernel under mamba_tts_torch/ops/csrc/ (one
             nvcc per source, together) and print the card's name and power
             limit as nvidia-smi reports them.
2. kernels — hold ``int8_matvec`` against its plain PyTorch version on the
             card at every decode shape, B in {1, 4, 16}, with and without
             bias (tolerance: 1 bf16 ulp relative + 1e-2 absolute); time the
             kernel, the plain version and a ``torch.matmul`` yardstick, with
             the weight stream cold in L2 (rotating copies) and hot.
3. slice   — serve through ``load_synthesizer(TTSConfig(), quant=...)`` at full
             default width with seeded random weights: (a) int8_kv, 1024 frames
             (12.8 s, 5,120 tokens); (b) int8, a batch of 4 at 256 frames;
             (c) int8, ``register_voice`` then ``synthesize`` by name.  Each
             request checks finite waveforms of frames*200 samples and that the
             kernel ran exactly 6 * n_layers times per decode step, and splits
             its wall into the decode and everything outside it.
4. parity  — 64 int8 decode steps at full width on the card against the same
             steps on the CPU (plain versions), both fed the CPU's greedy
             tokens: relative max logit error <= 3e-2, argmax agreement >= 90%
             (the int8 tolerances of tests/test_decode_megakernel.py).
5. profile — torch.profiler over a window of decode steps: device busy share
             and the kernels that take the time.

The line before the last is the card's ``name, power.limit``; the one before
it is the kernel table; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a card, or without the repository beside it, it exits non-zero and
prints no result.
"""
import copy
import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core peak
L2_BYTES = 50 * 2 ** 20
DECODE_SHAPES = [  # (name, K, N) of the six int8 products of one decoder layer step
    ("in_proj", 512, 2048), ("out_proj", 1024, 512), ("q_proj", 512, 512),
    ("o_proj", 512, 512), ("ff1", 512, 2048), ("ff2", 2048, 512),
]
TEXT = "The quick brown fox jumps over the lazy dog, then rests beside the quiet river."
STYLE = "a calm female voice speaking slowly"


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, iters, sleep_ms=60.0):
    """Device time per call of ``fn(i)``: a sleep kernel holds the stream
    while the host enqueues every call, so the events bracket back-to-back
    device work and not the host's launch rate."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(sleep_ms * 1e-3 * 2.0e9))
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    from mamba_tts_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {s: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for s, log in logs.items()}
    emit({"phase": "build", "sources": _build.sources(), "built": sorted(logs),
          "seconds": seconds, "ptxas": ptxas, "card": nvidia_smi_line()})


def phase_kernels(torch):
    from mamba_tts_torch.ops.int8_matvec import int8_matvec, int8_matvec_ref, quantize_weight

    g = torch.Generator(device="cuda").manual_seed(0)
    worst, rows = 0.0, []
    for name, K, N in DECODE_SHAPES:
        w_q, scale = quantize_weight(torch.randn((K, N), generator=g, device="cuda") * 0.04)
        bias = torch.randn((N,), generator=g, device="cuda") * 0.1
        for B in (1, 4, 16):
            x = torch.randn((B, K), generator=g, device="cuda").bfloat16()
            for b in (None, bias):
                got = int8_matvec(x, w_q, scale, b)
                torch.cuda.synchronize()
                want = int8_matvec_ref(x, w_q, scale, b)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs()
                lim = want.float().abs() * 2 ** -7 + 1e-2
                check(bool((err <= lim).all()), f"int8_matvec {name} B={B} bias={b is not None}: "
                      f"max err {float(err.max())} beyond 1 bf16 ulp + 1e-2")
                worst = max(worst, float(err.max()))
            # timing: weights rotated through > 2x L2 (cold) and one copy (hot)
            R = max(1, -(-2 * L2_BYTES // (K * N)))
            ws = [w_q.clone() for _ in range(R)]
            ss = [scale.clone() for _ in range(R)]
            R_lib = max(1, -(-2 * L2_BYTES // (2 * K * N)))
            w_lib = [(ws[i % R].float() * ss[i % R][None]).bfloat16() for i in range(R_lib)]
            iters = 200
            kernel_ms = device_ms(torch, lambda i: int8_matvec(x, ws[i % R], ss[i % R]), iters)
            kernel_hot_ms = device_ms(torch, lambda i: int8_matvec(x, w_q, scale), iters)
            plain_ms = device_ms(torch, lambda i: int8_matvec_ref(x, ws[i % R], ss[i % R]), iters)
            library_ms = device_ms(torch, lambda i: torch.matmul(x, w_lib[i % R_lib]), iters)
            nbytes = K * N + 4 * N + 2 * B * K + 2 * B * N
            bound_ms = max(nbytes / HBM_BYTES_PER_S, 2 * B * K * N / BF16_OPS_PER_S) * 1e3
            row = {"phase": "kernels", "name": name, "K": K, "N": N, "B": B,
                   "kernel_ms": kernel_ms, "kernel_l2_hot_ms": kernel_hot_ms,
                   "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                   "bound_by": "bytes", "max_abs_err": worst}
            rows.append(row)
            emit(row)
            del ws, ss, w_lib
    return rows, worst


def _voice(seconds=3.0, sr=16000, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 140 + 20 * np.sin(2 * np.pi * 0.7 * t)
    wav = sum(0.25 / k * np.sin(2 * np.pi * k * np.cumsum(f0) / sr) for k in (1, 2, 3))
    return (wav + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)


def phase_slice(torch):
    import numpy as np

    from mamba_tts_torch.config import TTSConfig
    from mamba_tts_torch.infer.synthesize import load_synthesizer
    from mamba_tts_torch.ops.int8_matvec import int8_matvec

    cfg = TTSConfig()
    d = cfg.decoder
    check((d.d_model, d.n_layers, d.n_heads, d.d_ff, d.vocab_size_audio) == (512, 8, 8, 2048, 1026),
          "default decoder width")
    hop = cfg.codec.hop_length
    per_step = 6 * d.n_layers
    voice = _voice()
    t0 = time.perf_counter()
    synth_kv = load_synthesizer(cfg, seed=0, quant="int8_kv", device="cuda")
    synth_q = load_synthesizer(cfg, seed=0, quant="int8", device="cuda")
    torch.cuda.synchronize()
    emit({"phase": "slice", "setup_seconds": time.perf_counter() - t0,
          "params": {"decoder": sum(p.numel() for p in synth_q.decoder.parameters()),
                     "bert": sum(p.numel() for p in synth_q.style_encoder.module.parameters()),
                     "facodec": sum(p.numel() for p in synth_q.tokenizer.module.parameters())}})
    results, launches, decode_s = {}, 0, []

    def time_decode(synth):
        """Time each ``decode_tokens`` call (conditioning + the step loop)
        so that a request's wall splits into decode and everything else."""
        inner = synth.decode_tokens

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = inner(*args, **kw)
            torch.cuda.synchronize()
            decode_s.append(time.perf_counter() - t)
            return out

        synth.decode_tokens = timed

    time_decode(synth_kv)
    time_decode(synth_q)

    def serve(tag, fn, frames, batch):
        nonlocal launches
        int8_matvec.launches = 0
        decode_s.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        wavs, info = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        n = int8_matvec.launches
        steps = d.num_quantizers * frames
        check(n == per_step * steps, f"{tag}: {n} int8_matvec launches, expected "
              f"{per_step} x {steps} = {per_step * steps}")
        wavs = np.asarray(wavs).reshape(batch, -1)
        check(wavs.shape[1] == frames * hop, f"{tag}: {wavs.shape[1]} samples, expected {frames * hop}")
        check(bool(np.isfinite(wavs).all()), f"{tag}: non-finite waveform")
        tokens = batch * steps
        audio = batch * frames / 80.0
        decode = sum(decode_s)
        row = {"phase": "slice", "request": tag, "batch": batch, "frames": frames,
               "tokens": tokens, "wall_seconds": wall, "tokens_per_s": tokens / wall,
               "rtf": wall / audio, "decode_seconds": decode,
               "decode_ms_per_step": decode / steps * 1e3,
               "outside_decode_seconds": wall - decode, "int8_matvec_launches": n}
        emit(row)
        results[tag] = row
        launches += n
        return wavs

    serve("a_int8_kv_12.8s", lambda: synth_kv.synthesize(TEXT, STYLE, voice, frames=1024),
          1024, 1)
    texts = [TEXT, "Hello there.", "Numbers like 42 and 1999 are spoken too.",
             "A short one, with a pause; then more."]
    wb = serve("b_int8_batch4", lambda: synth_q.synthesize_batch(
        texts, [STYLE, "fast and loud", "whispering", STYLE], [voice] * 4, frames=256), 256, 4)
    for i in range(4):
        for j in range(i + 1, 4):
            check(not np.allclose(wb[i], wb[j]), f"batch rows {i} and {j} are identical")
    synth_q.register_voice("speaker_0", voice)
    serve("c_int8_registered_voice",
          lambda: synth_q.synthesize(TEXT, STYLE, "speaker_0", frames=128), 128, 1)
    return synth_q, results, launches


def _condition(torch, synth, B=1):
    ids, _, mask = synth.frontend.encode_batch([TEXT] * B, pad_to=synth.cfg.data.max_text_len)
    voice_codec = synth._encode_voice([_voice()] * B)
    ids, mask, voice = synth._tensors(ids, mask, voice_codec)
    style = synth.style_encoder.embed([STYLE] * B)
    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        th = synth.model.encode_text(ids, mask)
        z = synth.model.sample_style(style, g)
        rh, rm = synth.model.embed_voice(voice)
    return th, mask, rh, rm, z


def phase_parity(torch, synth, steps=64, frames=1024):
    from mamba_tts_torch.infer.quant_decode import quant_step_with_kv

    th, mask, rh, rm, z = _condition(torch, synth)
    dec_gpu = synth.decoder
    dec_cpu = copy.deepcopy(dec_gpu).cpu()
    q_cpu = _tree_to(synth._qparams, "cpu")
    cfg = dec_gpu.cfg
    ns = cfg.num_special_tokens

    def run(dec, qp, cond, forced):
        th_, mask_, rh_, rm_, z_ = cond
        KV, mm, films = dec.project_memories(th_, mask_, rh_, rm_, z_)
        states = dec.init_states(1)
        tok = torch.full((1, 1), cfg.bos_id, dtype=torch.long, device=th_.device)
        logits, toks = [], []
        for t in range(steps):
            lg, states = quant_step_with_kv(qp, cfg, tok, KV, mm, films, states, t, frames)
            lg = lg[:, 0].float()
            logits.append(lg)
            masked = lg.clone()
            masked[:, :ns] = -1e9
            nxt = torch.argmax(masked, dim=-1, keepdim=True)
            toks.append(nxt)
            tok = forced[:, t:t + 1].to(th_.device) if forced is not None else nxt
        return torch.cat(logits).cpu(), torch.cat(toks, dim=1).cpu()

    with torch.no_grad():
        cond_cpu = tuple(t.cpu() for t in (th, mask, rh, rm, z))
        lg_cpu, tok_cpu = run(dec_cpu, q_cpu, cond_cpu, None)
        lg_gpu, tok_gpu = run(dec_gpu, synth._qparams, (th, mask, rh, rm, z), tok_cpu)
    rel = float((lg_gpu - lg_cpu).abs().max() / lg_cpu.abs().max().clamp(min=1e-6))
    agree = float((lg_gpu[:, ns:].argmax(-1) == lg_cpu[:, ns:].argmax(-1)).float().mean())
    row = {"phase": "parity", "steps": steps, "rel_max_logit_err": rel,
           "argmax_agreement": agree, "limits": {"rel": 3e-2, "agree": 0.9}}
    emit(row)
    check(rel <= 3e-2, f"card vs CPU logits: relative max error {rel}")
    check(agree >= 0.9, f"card vs CPU argmax agreement {agree}")
    return row


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device) if tree is not None else None


def phase_profile(torch, synth, steps=32, frames=1024):
    """Device busy share of the int8 step decode at B=1, and its top kernels."""
    from torch.profiler import ProfilerActivity, profile

    from mamba_tts_torch.infer.quant_decode import quant_step_with_kv

    th, mask, rh, rm, z = _condition(torch, synth)
    dec, cfg = synth.decoder, synth.decoder.cfg
    with torch.no_grad():
        KV, mm, films = dec.project_memories(th, mask, rh, rm, z)
        states = dec.init_states(1)
        tok = torch.full((1, 1), cfg.bos_id, dtype=torch.long, device="cuda")

        def window(n, states):
            for t in range(n):
                lg, states = quant_step_with_kv(synth._qparams, cfg, tok, KV, mm, films,
                                                states, t, frames)
            return states

        states = window(4, states)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        window(steps, states)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            window(steps, states)
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - t0) * 1e3
    # device rows only: an operator's row repeats the time of the kernels it launched
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    row = {"phase": "profile", "steps": steps, "wall_ms_per_step": wall_ms / steps,
           "profiled_wall_ms_per_step": prof_wall_ms / steps,
           "device_busy_ms_per_step": busy_ms / steps if busy_ms else None,
           "device_idle_share": 1 - busy_ms / wall_ms if busy_ms else None,
           "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
           "top_kernels": [{"name": e.key[:80], "device_ms_per_step": dev_us(e) / 1e3 / steps,
                            "calls_per_step": e.count / steps} for e in top]}
    emit(row)
    return row


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script drives the port on an NVIDIA card",
              file=sys.stderr)
        return 2
    import mamba_tts_torch  # noqa: F401  (fails where the repository is absent)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t_start = time.perf_counter()
    card = nvidia_smi_line()
    phase_build()
    rows, worst = phase_kernels(torch)
    synth, _, launches = phase_slice(torch)
    phase_parity(torch, synth)
    phase_profile(torch, synth)

    b1 = [r for r in rows if r["B"] == 1]

    def mean(key):
        return sum(r[key] for r in b1) / len(b1)

    emit({"kernels": [{
        "name": "int8_matvec", "route": "cuda", "source": "mamba_tts_torch/ops/csrc/int8_matvec.cu",
        "replaces": "mamba_tts_tpu/ops/int8_matvec.py:38", "launches": launches,
        "max_abs_err": worst, "ms": mean("kernel_ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"), "bound_by": "bytes", "library_ms": mean("library_ms"),
        "at": "mean per launch over the six decode shapes at B=1, weights cold in L2",
    }], "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
