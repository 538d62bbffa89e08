#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mamba_tts_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and exits non-zero:

1. build   — compile every CUDA kernel under mamba_tts_torch/ops/csrc/ (one
             nvcc per source, together) and print the card's name and power
             limit as nvidia-smi reports them.
2. kernels — hold ``int8_matvec`` against its plain PyTorch version on the
             card at every decode shape, B in {1, 4, 16}, with and without
             bias (tolerance: 1 bf16 ulp relative + 1e-2 absolute; reruns
             bit-identical); time the kernel with and without its fused bias,
             the plain version and a ``torch.matmul`` yardstick, with the
             weight stream cold in L2 (rotating copies) and hot; one
             torch.profiler window over one call of every case must show one
             device kernel per call.
2b. decode attention — ``decode_attention`` (the default decode's one-query
             cross-attention) against its plain version ``decode_attention_ref``
             on the card at the narration batch (B=8, H=8, Tm=1,536, a ragged
             mask), at B=1 on the same memory, and on a ragged 20,000-key
             memory whose slices are read in tiles: every output within one
             bf16 ulp of the plain version's plus 2^-8 of the largest output
             (both round the same bf16 probabilities; only the sums' order
             differs); reruns bit-identical; ms per call (CUDA events) beside
             the plain version, ``scaled_dot_product_attention`` and the bound
             (K and V read once, 2 * B * H * Tm * 128 bytes, at 3.35 TB/s).
2c. grouped decode attention — the same source's grouped kernel (the
             self-attention step of the jamba decoder: head_dim 128, 20 query
             heads on one K/V head; and of the granite decoder: 4 query heads
             on each of 8 K/V heads) against ``decode_attention_ref`` at
             B = 16 over a 4,100-key cache with 1,538, 2,818 and 4,100 valid
             keys (granite: 2,818 and 4,100), and at B = 1: the tolerance of
             2b; reruns bit-identical; ms per call beside the plain version
             and the bound (each valid K/V byte once a K/V head, q and the
             output, at 3.35 TB/s).
2d. mamba step — ``conv_step`` and ``ssm_step`` (the Mamba decode step
             between its projections, both captured decodes) against their
             plain versions ``conv_step_ref`` and ``ssm_step_ref`` on the
             card at narration's shape (B = 8, d_inner 1,024, f32 taps, no
             inner norms) and the jamba mixer's (B = 16, d_inner 5,120, bf16
             taps, the B/C RMSNorms), the operands laid out as the decode
             lays them (x and z halves, B and C slices of one projection
             each): the new window equal, x_conv and y within a bf16 unit
             (2^-7 of the largest; y 2^-6 with the norms, which round B and
             C to bf16 after sums of squares in another order), the state
             within 1e-4 of its largest (2^-8 with the norms); the in-place
             form equal to the functional one; reruns bit-identical; µs per
             call (CUDA events, the window and the state rotated through
             more than twice the L2) beside each plain version, the plain
             chain with the decode's two carry copies, and the byte bound
             (every operand read once, the window, the state and the
             outputs written once, at 3.35 TB/s).
2e. mamba-2 step — the granite decoder's Mamba-2 step between its
             projections: ``conv_step`` at its xBC (8,448 channels, bf16
             taps and f32 bias, as served) and ``mamba2_step`` (128 heads of 64, d_state
             128, one group) against ``conv_step_ref`` and
             ``mamba2_step_ref`` on the card at B = 16 and B = 1 in
             bfloat16, the operands laid out as ``Mamba2Mixer.step`` lays
             them (z, xBC and dt slices of one in_proj output; x, B and C
             slices of the conv's): the new window equal and x_conv within
             2^-7 of its largest; the state bit-equal (the same IEEE
             operations in the same order), y within 1e-5 of its largest
             (only the order of the sum over the state differs); one
             ``mamba2_step`` launch a call, counted from 0; the in-place form
             equal to the functional one; reruns bit-identical; µs per call
             (CUDA events, the window and the state rotated through more
             than twice the L2) beside the plain versions and the byte bound
             (the state read and written once, every operand read and the
             output written once, at 3.35 TB/s).
3. slice   — serve through ``load_synthesizer(TTSConfig(), quant=...)`` at full
             default width with seeded random weights: (a) int8_kv, 256 frames
             (3.2 s, 1,280 tokens; 1,024 frames before the megakernel requests
             joined this script); (b) int8, a batch of 4 at 256 frames;
             (c) int8, ``register_voice`` then ``synthesize`` by name.  The
             step loop replays a captured CUDA graph.  Each request checks
             finite waveforms of frames*200 samples and that the kernel ran
             exactly 6 * n_layers times per decode step (kernel executions:
             graph replays count), and splits its wall into the decode and
             everything outside it.
4. parity  — 64 int8 decode steps at full width on the card against the same
             steps on the CPU (plain versions), both fed the CPU's greedy
             tokens: relative max logit error <= 3e-2, argmax agreement >= 90%
             (the int8 tolerances of tests/test_decode_megakernel.py).
   captured — request (a)'s decode from the replayed graph against the
             eager step loop over its first 256 steps: equal tokens and logits.
5. profile — torch.profiler over the int8_kv decode at B=1 as serving runs
             it (condition, capture, replay) at 32 and 96 frames: wall per
             step (unprofiled), device busy and idle share (against the
             profiled call's own wall), device kernels per step and
             the kernels that take the time, for the whole 480-step call and
             for the 320 steps between the two (the per-call costs drop
             out); the same for a window of the eager step loop, for the
             record.
5b. default decode — ``load_synthesizer(TTSConfig(), quant="none")``, the
             CLI's default, whose step loop is captured too: (a') B=1, 256
             frames and (d') 1,024 frames (wall, decode ms per step, RTF; no
             int8_matvec or megakernel launch, and exactly n_layers
             ``decode_attention`` and 2 * n_layers Mamba step kernel
             executions a decode step, the graph's replays counted); the
             captured decode against
             the eager in-place step loop over 256 steps (equal tokens,
             bit-identical logits), both timed; torch.profiler over 32
             steps of the eager loop (device busy and idle share, kernels
             per step) and phase 5's profile of the captured decode at 8
             and 24 frames.
6. megakernel kernel — the one-launch decode kernel against its plain PyTorch
             version on the card at full width (8 layers, memory 1,536), 8
             frames = 40 steps, B in {1, 2, 4} on the three dtype rungs (every
             batch tile the requests launch; 2 is the chunked request's
             remainder) and B = 8 (the most one launch takes) on the first and
             the last, both teacher-forced with the same tokens: relative max logit error
             <= 3e-2 over the real token columns, argmax agreement >= 90%,
             final conv state within 3e-2 and SSM state within 1e-1 of their
             largest magnitude; one sampled run with a given noise tensor; and
             the feedback path exactly: a free run, then a teacher-forced run
             on the tokens it produced, give bit-identical logits, and two
             free runs are bit-identical.
7. megakernel slice — ``load_synthesizer(TTSConfig(), quant="megakernel")``:
             (d) the flagship request, B=1, 1,024 frames (12.8 s, 5,120
             tokens); (e) a batch of 4 at 256 frames; (f) a batch of 10 at 64
             frames, more than one launch takes, so that it runs as chunks;
             (g) a sampled request (temperature 0.8), repeated with the same
             seed and with another.  Checks: finite waveforms of frames*200
             samples, rows differ, one launch per chunk, no int8_matvec
             launch, same seed repeats and another seed differs.
8. megakernel times — µs per step of whole flagship decodes (CUDA events) at
             B=1, 4 and 8 for each rung, with the launch plan (grid, cluster
             size, resident weights) and three bounds: every input read once,
             this plan's (its streamed bytes from L2 every step, what exceeds
             the L2 from device memory), and no residency; one launch at
             64 frames (320 steps, the chunked request's length) timed against
             the plain version, their outputs held to phase 6's limits so that
             late steps are checked too; one step split into
             each stage's work and each grid barrier's wait (the kernel's
             ``stage_clocks`` diagnostic, its stamps checked: all written,
             rising, none beyond the step) with the barriers per step counted
             from the stamps;
             torch.profiler over the flagship request for the device's idle
             share.  Then the flagship-length check: 5,120 greedy steps of
             the captured int8 step decode (B=1), and the megakernel (int8
             weights, bf16 K/V) teacher-forced on the tokens it chose: relative
             max logit error <= 3e-2 and argmax agreement >= 90% over all
             steps and over the last 1,024.
9. scan kernels — the selective-scan forward, checkpointing forward and
             backward wrappers against their plain versions at B=2 and B=8,
             T=5,120 (the flagship's flattened grid), D=1,024, N=16, bf16
             u/B/C, and at a ragged T=5,117 with a given h0 (the two
             forwards bit-identical, backward reruns bit-identical); ms per
             call with the SM clock, each wrapper's device kernels (three
             launches a direction), the plain version's ms and the bound (the
             largest of bytes, FMA-pipe operations and one exp per element
             on the special-function units).
10. flash kernels — forward and backward against autograd through the plain
             materialized softmax at B=2, H=8, Tq=5,120, Tk=5,376 (a third of
             one row's keys masked) and a ragged Tq=640, Tk=1,427; µs per
             launch beside the plain version and scaled_dot_product_attention,
             achieved TFLOP/s and share of the bound.
11. forward vs decode — with the training kernels' counts set to 0: the
             teacher-forced forward without a gradient (no-checkpoint scan and
             flash forward) against 128 plain bf16 step-decode steps on the
             same tokens, at full width.
12. train CLI — ``mamba_tts_torch.train.train.main`` at its defaults (full
             width, B=10, synthetic data): 4 steps with checkpoints, then
             --resume to step 6; finite losses, ms per step.
12b. checkpoint serving — ``load_synthesizer(checkpoint_dir=...)`` with no
             config on what phase 12 wrote: the CLI's config, checkpoint 6's
             parameters bit for bit (``style_pipe`` included), not the
             seeded init, load seconds; one 128-frame request each with
             quant none (2 x n_layers Mamba step kernel executions a step),
             int8 (6 x n_layers int8_matvec executions a step) and
             megakernel (one launch); the megakernel on the trained
             weights against its plain version, teacher-forced (phase 6's
             limits).
12c. released weights — FACodec and BERT state dicts in the released
             files' naming and shapes (tests/data/*_manifest.json), drawn
             from a seed, saved with torch.save and served: one megakernel
             request through ``load_synthesizer(codec_ckpts=...)`` with
             ``StyleTextEncoder(checkpoint=...)``; every key read, every
             fused FACodec weight g * v / ||v|| of the file, finite audio.
13. flagship step — B=8, 1,024 target frames (Tq=5,120) and 1,024-frame
             voice prompts from the port's BatchPreparer: 3 optimizer steps,
             ms per step, tokens/s, peak memory, 8 calls per step of each
             training kernel, device idle share and top kernels; then the
             counts of phases 11-13 must show every training kernel.
13b. style branch — ``MambaTTS.nar_frames`` at full width for the four
             texts (B=4, max_frame_len 1,024; 1,200, 256, 640 and 512
             frames spread over their phonemes), card against CPU within 2e-2
             of the largest magnitude; ``make_train_step(...,
             use_nar_branch=True)`` at B=10 beside the default step: finite
             losses, every style_pipe gradient exactly zero, ms per step,
             and device busy ms and kernels per step under torch.profiler.
15. codec training — ``python -m mamba_tts_torch.train.train_codec
             --synthetic`` at its defaults (full-width FACodec, 28.8M
             parameters, B=8, 0.8 s segments), 5 steps, then again with
             --adversarial (three discriminator resolutions), cuDNN TF32 as
             PyTorch leaves it (on): finite losses under the JAX metric
             names, a checkpoint; ms a step (median, first step excluded),
             peak memory, device busy and idle share under torch.profiler.
             Then one GAN step at the smoke config's codec on the card
             against the CPU: losses within 1e-2, each component's gradient
             within 5e-2 of its largest magnitude.
16. preprocessing — ``DatasetPreprocessor`` and ``ParallelDatasetPreprocessor``
             (2 spawned G2P workers, BERT-base and FACodec on the card in
             chunks of 16) over 32 synthetic items: 32 x 4 tensors each,
             equal codec ids, items/s of each.
17. training from preprocessed data — the train CLI at its defaults with
             --preprocessed_dir for 4 steps, --resume to 6, then --loader
             grain --grain_workers 2 for 4 steps, the training kernels'
             counts set to 0 just before each and read just after (the
             checkpointing scan, the scan backward and both flash kernels
             launched in each); ms a step; data seconds per batch at B=10 of
             ``OfflineDataset.batches``, ``dataset.batches`` + ``BatchPreparer``
             and the worker loader + ``BatchPreparer``.
18. parallel — two ranks share the card over gloo (NCCL refuses two ranks
             on one device), spawned by ``mamba_tts_torch/parallel/dryrun.py``;
             first each of all_reduce, all_gather and broadcast on CUDA
             tensors.  (a) the time-sharded scan at T=5,120, D=1,024, N=16,
             B=2 and 8 (f32 u/B/C, so that the limit reads the hand-off, not
             bf16 rounding) against the one-rank kernel scan: y and h_T
             within 2e-4, every gradient within 2e-3 of the largest
             magnitude; pass 1's device kernels (two launches: summary and
             carry).  (b) the train CLI at its defaults, 2 steps each with
             --mesh 2,1, --mesh 1,2, and --mesh 1,2 and --mesh 2,1 with
             decoder.use_sp_scan from --config_json (on 2,1 the scan's time
             axis is split over the two data ranks, rows gathered first; the
             scan and flash launches per rank and run); one deterministic
             full-width step at (2, 1) and (1, 2) on a batch of uneven text
             and frame lengths against the single-rank step: with the text
             encoder and duration predictor in f32, every loss and the
             gradient norm within 5e-4 relative; at the CLI's dtypes (bf16)
             within BF16_STEP_TOL, beside one rank's steps on each data
             rank's rows alone, recombined (the rounding of the batch size
             without any collective).
             (c) ``load_synthesizer(quant=..., mesh=...)``, megakernel and
             none, 3 rows at 64 frames with the style pinned to the mixture
             mean: each rank's rows equal a single run on the same row batch,
             and each row's tokens agree >= 90% with its teacher-forced
             rerun at B = 1 (the megakernel; the forward for none); one
             ``--dp_serving --quant int8`` CLI request.  (d) the checkpoint
             that --mesh 1,2 wrote, served by ``load_synthesizer
             (checkpoint_dir=...)`` in this process.  Walls are two ranks
             sharing one card, not a scaling figure; the launch counts of
             the parallel paths in (a)-(c) (the comparisons with one rank
             excluded), summed over the ranks, are each kernel row's
             ``parallel_launches``.
14. card vs CPU — 2 layers at full width, one batch, deterministic: losses
             and each component's gradient on the card against the CPU's
             plain path; 10 steps on a fixed batch lower the codec loss.

The line before the last is the card's ``name, power.limit``; the one before
it is the kernel table; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a card, or without the repository beside it, it exits non-zero and
prints no result.
"""
import copy
import dataclasses
import json
import pathlib
import re
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core peak
L2_BYTES = 50 * 2 ** 20
# The SMs' read rate from an L2-resident buffer: the largest that
# mamba_tts_torch/diag/card_probes.py measured (8-40 MiB buffers, 7.39e12 at
# 32 MiB) on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6); no published
# figure exists, and the peak is at least this.
L2_READ_BYTES_PER_S = 7.39e12
DECODE_SHAPES = [  # (name, K, N) of the six int8 products of one decoder layer step
    ("in_proj", 512, 2048), ("out_proj", 1024, 512), ("q_proj", 512, 512),
    ("o_proj", 512, 512), ("ff1", 512, 2048), ("ff2", 2048, 512),
]
TEXT = "The quick brown fox jumps over the lazy dog, then rests beside the quiet river."
STYLE = "a calm female voice speaking slowly"
TEXTS = [TEXT, "Hello there.", "Numbers like 42 and 1999 are spoken too.",
         "A short one, with a pause; then more."]
STYLES = [STYLE, "fast and loud", "whispering", STYLE]


_T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's row also carries the script's elapsed seconds."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _T0}
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


def _device_kernels(prof):
    """The profiler's device rows: an operator's row repeats the time of the
    kernels it launched, so only these are summed.  The device side of a
    named range (the program's spans) is no kernel."""
    return [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)]


def _dev_us(e):
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def phase_kernels(torch):
    from torch.profiler import ProfilerActivity, profile

    from mamba_tts_torch.ops.int8_matvec import (int8_matvec, int8_matvec_ref, launch_plan,
                                                 quantize_weight)

    g = torch.Generator(device="cuda").manual_seed(0)
    worst, rows, calls = 0.0, [], []
    for name, K, N in DECODE_SHAPES:
        w_q, scale = quantize_weight(torch.randn((K, N), generator=g, device="cuda") * 0.04)
        bias = torch.randn((N,), generator=g, device="cuda") * 0.1
        for B in (1, 4, 16):
            x = torch.randn((B, K), generator=g, device="cuda").bfloat16()
            for b in (None, bias):
                got = int8_matvec(x, w_q, scale, b)
                again = int8_matvec(x, w_q, scale, b)
                torch.cuda.synchronize()
                want = int8_matvec_ref(x, w_q, scale, b)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs()
                lim = want.float().abs() * 2 ** -7 + 1e-2
                check(bool((err <= lim).all()), f"int8_matvec {name} B={B} bias={b is not None}: "
                      f"max err {float(err.max())} beyond 1 bf16 ulp + 1e-2")
                check(torch.equal(got, again), f"int8_matvec {name} B={B}: reruns differ")
                worst = max(worst, float(err.max()))
                calls.append((x, w_q, scale, b))
            # timing: weights rotated through > 2x L2 (cold) and one copy (hot)
            R = max(1, -(-2 * L2_BYTES // (K * N)))
            ws = [w_q.clone() for _ in range(R)]
            ss = [scale.clone() for _ in range(R)]
            R_lib = max(1, -(-2 * L2_BYTES // (2 * K * N)))
            w_lib = [(ws[i % R].float() * ss[i % R][None]).bfloat16() for i in range(R_lib)]
            iters = 200
            kernel_ms = device_ms(torch, lambda i: int8_matvec(x, ws[i % R], ss[i % R]), iters)
            kernel_hot_ms = device_ms(torch, lambda i: int8_matvec(x, w_q, scale), iters)
            bias_ms = device_ms(torch, lambda i: int8_matvec(x, ws[i % R], ss[i % R], bias), iters)
            bias_hot_ms = device_ms(torch, lambda i: int8_matvec(x, w_q, scale, bias), iters)
            plain_ms = device_ms(torch, lambda i: int8_matvec_ref(x, ws[i % R], ss[i % R]), iters)
            library_ms = device_ms(torch, lambda i: torch.matmul(x, w_lib[i % R_lib]), iters)
            library_hot_ms = device_ms(torch, lambda i: torch.matmul(x, w_lib[0]), iters)
            nbytes = K * N + 4 * N + 2 * B * K + 2 * B * N
            bound_ms = max(nbytes / HBM_BYTES_PER_S, 2 * B * K * N / BF16_OPS_PER_S) * 1e3
            row = {"phase": "kernels", "name": name, "K": K, "N": N, "B": B,
                   "plan": launch_plan(B, K, N)._asdict(),
                   "kernel_ms": kernel_ms, "kernel_l2_hot_ms": kernel_hot_ms,
                   "kernel_bias_ms": bias_ms, "kernel_bias_l2_hot_ms": bias_hot_ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "library_l2_hot_ms": library_hot_ms, "bound_ms": bound_ms,
                   "bound_by": "bytes", "max_abs_err": worst}
            rows.append(row)
            emit(row)
            del ws, ss, w_lib
    # one device kernel per call, bias included: one profiler window over one
    # call of every checked (shape, batch, bias) case.  The process's first
    # window only starts the device tracer, and the counted window leaves idle
    # time at both ends: the profiler drops a kernel whose device timestamp,
    # mapped to the host's clock, falls outside its window.
    def window():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            for x, w_q, scale, b in calls:
                int8_matvec(x, w_q, scale, b)
            torch.cuda.synchronize()
            time.sleep(0.02)
        return prof

    window()
    kernels = _device_kernels(window())
    n_kernels = sum(e.count for e in kernels)
    emit({"phase": "kernels", "check": "one_kernel_per_call", "calls": len(calls),
          "device_kernels": n_kernels, "names": sorted({e.key[:60] for e in kernels})})
    check(n_kernels == len(calls), f"int8_matvec: {n_kernels} device kernels for {len(calls)} calls")
    return rows, worst


DECODE_ATTENTION_CASES = [  # (name, B, H, Tm): the narration batch, one row, a tiled memory
    ("narration", 8, 8, 1536), ("b1", 1, 8, 1536), ("tiled", 2, 8, 20000),
]


def phase_decode_attention(torch, iters=200):
    """Phase 2b: see the module docstring.  Returns one row a case."""
    import torch.nn.functional as F

    from mamba_tts_torch.ops import decode_attention as da

    scale, rows = 64 ** -0.5, []
    for name, B, H, Tm in DECODE_ATTENTION_CASES:
        g = torch.Generator(device="cuda").manual_seed(B * 100_000 + Tm)
        mem = [torch.randn((B, Tm, H * 64), generator=g, device="cuda").bfloat16() for _ in range(2)]

        def heads(t):  # (B, Tm, H·64) -> (B, H, Tm, 64), as CrossAttention._split leaves it
            return t.reshape(B, Tm, H, 64).transpose(1, 2)

        K, V = heads(mem[0]), heads(mem[1])
        q = torch.randn((B, 1, H * 64), generator=g, device="cuda").bfloat16()
        mask = torch.ones((B, Tm), dtype=torch.bool, device="cuda")
        for b in range(B):  # row b loses its last (b + 1) / 3B of the keys
            mask[b, Tm - ((b + 1) * Tm) // (3 * B):] = False
        plan = da.launch_plan(B, H, Tm)
        got = da.decode_attention(q, K, V, mask, scale)
        again = da.decode_attention(q, K, V, mask, scale)
        want = da.decode_attention_ref(q, K, V, mask, scale)
        torch.cuda.synchronize()
        w = want.float()
        err = (got.float() - w).abs()
        top = float(w.abs().max())
        ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)  # one bf16 ulp of w
        lim = ulp + 2.0 ** -9 * top
        check(bool((err <= lim).all()), f"decode_attention {name}: max err {float(err.max())} "
              f"beyond one bf16 ulp + 2^-9 of the largest output {top}")
        check(torch.equal(got, again), f"decode_attention {name}: reruns differ")
        # timing: K and V rotated through > 2x L2, so that every call reads them from HBM
        nbytes = 2 * B * H * Tm * 128
        R = max(1, -(-2 * L2_BYTES // nbytes))
        kv = [(heads(mem[0].clone()), heads(mem[1].clone())) for _ in range(R)]
        bias_mask = mask[:, None, None, :]
        q4 = q.reshape(B, 1, H, 64).transpose(1, 2)
        ms = device_ms(torch, lambda i: da.decode_attention(q, *kv[i % R], mask, scale), iters)
        plain_ms = device_ms(torch, lambda i: da.decode_attention_ref(q, *kv[i % R], mask, scale),
                             iters)
        library_ms = device_ms(torch, lambda i: F.scaled_dot_product_attention(
            q4, *kv[i % R], attn_mask=bias_mask, scale=scale), iters)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        row = {"phase": "decode_attention", "case": name, "B": B, "H": H, "Tm": Tm,
               "plan": plan._asdict(), "max_abs_err": float(err.max()),
               "max_rel_err": float(err.max()) / top,
               "equal_outputs": float((got == want).float().mean()), "ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": "bytes", "bound_share": bound_ms / ms}
        emit(row)
        rows.append(row)
        del kv, mem, K, V
    return rows


GROUPED_CASES = [  # (name, B, valid keys, query heads a K/V head, K/V heads of 128, scale)
    ("jamba B=16 valid=1538", 16, 1538, 20, 1, 128 ** -0.5),
    ("jamba B=16 valid=2818", 16, 2818, 20, 1, 128 ** -0.5),
    ("jamba B=16 valid=4100", 16, 4100, 20, 1, 128 ** -0.5),
    ("jamba B=1 valid=2818", 1, 2818, 20, 1, 128 ** -0.5),
    ("granite B=16 valid=2818", 16, 2818, 4, 8, 1 / 128),  # attention_multiplier 1/128
    ("granite B=16 valid=4100", 16, 4100, 4, 8, 1 / 128),
    ("granite B=1 valid=2818", 1, 2818, 4, 8, 1 / 128)]


def phase_grouped_attention(torch, iters=200, Tm=4100, hd=128):
    """Phase 2c: see the module docstring.  Returns one row a case."""
    from mamba_tts_torch.ops import decode_attention as da

    rows = []
    for name, B, valid, G, Hkv, scale in GROUPED_CASES:
        g = torch.Generator(device="cuda").manual_seed(B * 100_000 + valid + Hkv)
        cache = torch.randn((2, B, Tm, Hkv, hd), generator=g, device="cuda").bfloat16()
        K, V = cache[0].transpose(1, 2), cache[1].transpose(1, 2)  # as SelfAttention.step
        q = torch.randn((B, 1, G * Hkv * hd), generator=g, device="cuda").bfloat16()
        n = torch.clamp(valid - 7 * torch.arange(B, device="cuda"), min=1)
        mask = torch.arange(Tm, device="cuda")[None] < n[:, None]
        got = da.decode_attention(q, K, V, mask, scale)
        again = da.decode_attention(q, K, V, mask, scale)
        want = da.decode_attention_ref(q, K, V, mask, scale)
        torch.cuda.synchronize()
        w = want.float()
        err = (got.float() - w).abs()
        top = float(w.abs().max())
        ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)
        check(bool((err <= ulp + 2.0 ** -9 * top).all()),
              f"grouped decode_attention {name}: max err {float(err.max())} (largest {top})")
        check(torch.equal(got, again), f"grouped decode_attention {name}: reruns differ")
        ms = device_ms(torch, lambda i: da.decode_attention(q, K, V, mask, scale), iters)
        plain_ms = device_ms(torch, lambda i: da.decode_attention_ref(q, K, V, mask, scale),
                             iters)
        nbytes = 2 * 2 * int(n.sum()) * Hkv * hd + 2 * 2 * B * G * Hkv * hd
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        row = {"phase": "grouped_attention", "case": name, "B": B, "G": G, "kv_heads": Hkv,
               "head_dim": hd, "Tm": Tm,
               "plan": da.grouped_launch_plan(B, Hkv, G, hd, Tm)._asdict(),
               "max_abs_err": float(err.max()), "max_rel_err": float(err.max()) / top,
               "equal_outputs": float((got == want).float().mean()), "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
               "bound_share": bound_ms / ms}
        emit(row)
        rows.append(row)
        del cache, K, V
    return rows


MAMBA_STEP_CASES = [  # (name, B, d_inner, dt_rank, taps dtype, inner norms)
    ("narration", 8, 1024, 32, "float32", False), ("jamba", 16, 5120, 160, "bfloat16", True)]


def _mamba_step_bytes(B, Dm, N, K, tap_bytes, norms):
    """Each operand read once, the window, the state and the outputs written
    once: (conv_step's bytes, ssm_step's)."""
    conv = 2 * B * (K - 1) * Dm * 2 + B * Dm * 2 + K * Dm * tap_bytes + Dm * 4 + B * Dm * 2
    ssm = (3 * B * Dm * 2 + 2 * B * N * 2 + Dm * N * 4 + Dm * 4 + (2 * N * 4 if norms else 0)
           + 2 * B * N * Dm * 4 + B * Dm * 2)
    return conv, ssm


def phase_mamba_step(torch, iters=100, plain_iters=8, N=16, K=4, eps=1e-6):
    """Phase 2d: see the module docstring.  The plain versions run about 30
    kernels a call, so they are timed over ``plain_iters`` calls: all their
    launches fit the launch queue while the sleep kernel holds the stream.
    Returns one row a case."""
    from mamba_tts_torch.models.layers import RMSNorm
    from mamba_tts_torch.ops import mamba_step as ms

    def rel(got, want):
        got, want = got.float(), want.float()
        return float((got - want).abs().max() / want.abs().max())

    rows = []
    for name, B, Dm, r, taps, with_norms in MAMBA_STEP_CASES:
        g = torch.Generator(device="cuda").manual_seed(B * 100_000 + Dm)

        def randn(*shape, scale=1.0):
            return torch.randn(shape, generator=g, device="cuda") * scale

        xz = randn(B, 2 * Dm).bfloat16()  # in_proj's output: x and z halves
        xin, z = xz[:, :Dm], xz[:, Dm:]
        proj = randn(B, r + 2 * N).bfloat16()  # x_proj's output: dt_raw, B, C
        Bm, Cm = proj[:, r:r + N], proj[:, r + N:]
        window = randn(B, K - 1, Dm).bfloat16()
        w = randn(K, Dm, scale=0.5).to(getattr(torch, taps))
        b = randn(Dm, scale=0.1)
        dt = (randn(B, Dm) - 4.0).bfloat16()  # softplus^-1 of about [1e-3, 0.1]
        A_log = torch.log(torch.arange(1, N + 1, device="cuda", dtype=torch.float32)).expand(
            Dm, N).contiguous()
        D = 1.0 + randn(Dm, scale=0.1)
        h = randn(B, N, Dm)
        norms = None
        if with_norms:
            norms = tuple(RMSNorm(N, eps, torch.bfloat16).cuda() for _ in range(2))
            for n in norms:
                n.weight.data = 1.0 + randn(N, scale=0.1)
        with torch.no_grad():
            x_conv, new_window = ms.conv_step(xin, window, w, b)
            x_conv2, new_window2 = ms.conv_step(xin, window, w, b)
            want_x, want_window = ms.conv_step_ref(xin, window, w, b)
            u = want_x.contiguous()
            y, h_new = ms.ssm_step(dt, A_log, u, z, Bm, Cm, D, h, norms)
            y2, h_new2 = ms.ssm_step(dt, A_log, u, z, Bm, Cm, D, h, norms)
            want_y, want_h = ms.ssm_step_ref(dt, A_log, u, z, Bm, Cm, D, h, norms)
            win_in, h_in = window.clone(), h.clone()
            x_conv3, win_in = ms.conv_step(xin, win_in, w, b, inplace=True)
            y3, h_in = ms.ssm_step(dt, A_log, u, z, Bm, Cm, D, h_in, norms, inplace=True)
        torch.cuda.synchronize()
        errs = {"x_conv": rel(x_conv, want_x), "state": rel(h_new, want_h), "y": rel(y, want_y)}
        lims = {"x_conv": 2.0 ** -7, "state": 2.0 ** -8 if with_norms else 1e-4,
                "y": 2.0 ** -6 if with_norms else 2.0 ** -7}
        check(torch.equal(new_window, want_window), f"mamba conv_step {name}: the window differs")
        for k, e in errs.items():
            check(e <= lims[k], f"mamba step {name}: {k} error {e} over {lims[k]} of its largest")
        check(torch.equal(x_conv, x_conv2) and torch.equal(new_window, new_window2)
              and torch.equal(y, y2) and torch.equal(h_new, h_new2),
              f"mamba step {name}: reruns differ")
        check(torch.equal(x_conv3, x_conv) and torch.equal(win_in, new_window)
              and torch.equal(y3, y) and torch.equal(h_in, h_new),
              f"mamba step {name}: the in-place form differs from the functional one")
        # timing: the window and the state rotated through > 2x L2, as the
        # decode's 8 or 26 layers stream them from device memory
        conv_bytes, ssm_bytes = _mamba_step_bytes(B, Dm, N, K, w.element_size(), with_norms)
        R = max(1, -(-2 * L2_BYTES // (window.nbytes + h.nbytes)))
        states = [(window.clone(), h.clone()) for _ in range(R)]

        def chain(i):
            win, hh = states[i % R]
            xc, nw = ms.conv_step_ref(xin, win, w, b)
            yy, nh = ms.ssm_step_ref(dt, A_log, xc, z, Bm, Cm, D, hh, norms)
            win.copy_(nw)
            hh.copy_(nh)

        with torch.no_grad():
            t = {
                "conv_step_ms": device_ms(torch, lambda i: ms.conv_step(
                    xin, states[i % R][0], w, b, inplace=True), iters, 200.0),
                "ssm_step_ms": device_ms(torch, lambda i: ms.ssm_step(
                    dt, A_log, u, z, Bm, Cm, D, states[i % R][1], norms, inplace=True),
                    iters, 200.0),
                "conv_step_plain_ms": device_ms(torch, lambda i: ms.conv_step_ref(
                    xin, states[i % R][0], w, b), plain_iters, 200.0),
                "ssm_step_plain_ms": device_ms(torch, lambda i: ms.ssm_step_ref(
                    dt, A_log, u, z, Bm, Cm, D, states[i % R][1], norms), plain_iters, 200.0),
                "plain_chain_ms": device_ms(torch, chain, plain_iters, 200.0),
            }
        row = {"phase": "mamba_step", "case": name, "B": B, "d_inner": Dm, "d_state": N,
               "taps": taps, "inner_norms": with_norms, "max_rel_err": errs, "limits": lims,
               **t, "conv_step_bound_ms": conv_bytes / HBM_BYTES_PER_S * 1e3,
               "ssm_step_bound_ms": ssm_bytes / HBM_BYTES_PER_S * 1e3,
               "conv_step_bytes": conv_bytes, "ssm_step_bytes": ssm_bytes, "bound_by": "bytes",
               "state_copies": R}
        row["conv_step_bound_share"] = row["conv_step_bound_ms"] / t["conv_step_ms"]
        row["ssm_step_bound_share"] = row["ssm_step_bound_ms"] / t["ssm_step_ms"]
        emit(row)
        rows.append(row)
        del states
    return rows


MAMBA2_STEP_CASES = [("granite B=16", 16), ("granite B=1", 1)]  # (name, B)


def _mamba2_step_bytes(B, H, P, N):
    """``mamba2_step``'s bytes: the f32 state read and written; x, z, B, C
    and dt (bf16) and dt_bias, A_log, D (f32) read; y (f32) written."""
    return 2 * 4 * B * H * P * N + 2 * B * (2 * H * P + 2 * N + H) + 4 * 3 * H + 4 * B * H * P


def phase_mamba2_step(torch, iters=100, plain_iters=8, H=128, P=64, N=128, K=4):
    """Phase 2e: see the module docstring.  Returns one row a case."""
    from mamba_tts_torch.ops import mamba_step as ms

    def rel(got, want):
        got, want = got.float(), want.float()
        return float((got - want).abs().max() / want.abs().max())

    di, conv_dim = H * P, H * P + 2 * N
    rows = []
    for name, B in MAMBA2_STEP_CASES:
        g = torch.Generator(device="cuda").manual_seed(B * 100_000 + N)

        def randn(*shape, scale=1.0):
            return torch.randn(shape, generator=g, device="cuda") * scale

        proj = randn(B, di + conv_dim + H).bfloat16()  # in_proj's output: z, xBC, dt
        z, xBC, dt = torch.split(proj, [di, conv_dim, H], dim=-1)
        window = randn(B, K - 1, conv_dim).bfloat16()
        w, b = randn(K, conv_dim, scale=0.5).bfloat16(), randn(conv_dim, scale=0.1)  # as served
        dt_bias = randn(H) - 3.0  # softplus of about [1e-3, 0.3]
        A_log = torch.log(1.0 + 15.0 * torch.rand(H, generator=g, device="cuda"))
        D = randn(H)
        h = randn(B, H, P, N)
        with torch.no_grad():
            x_conv, new_window = ms.conv_step(xBC, window, w, b)
            want_x, want_window = ms.conv_step_ref(xBC, window, w, b)
            xs, Bm, Cm = torch.split(want_x.contiguous(), [di, N, N], dim=-1)
            ms.launches = 0
            y, h_new = ms.mamba2_step(xs, Bm, Cm, z, dt, dt_bias, A_log, D, h)
            launches = ms.launches
            y2, h_new2 = ms.mamba2_step(xs, Bm, Cm, z, dt, dt_bias, A_log, D, h)
            want_y, want_h = ms.mamba2_step_ref(xs, Bm, Cm, z, dt, dt_bias, A_log, D, h)
            win_in, h_in = window.clone(), h.clone()
            x_conv3, win_in = ms.conv_step(xBC, win_in, w, b, inplace=True)
            y3, h_in = ms.mamba2_step(xs, Bm, Cm, z, dt, dt_bias, A_log, D, h_in, inplace=True)
        torch.cuda.synchronize()
        errs = {"x_conv": rel(x_conv, want_x), "y": rel(y, want_y)}
        lims = {"x_conv": 2.0 ** -7, "y": 1e-5}
        check(launches == 1, f"mamba2_step {name}: {launches} launches for one call")
        check(torch.equal(new_window, want_window), f"conv_step {name}: the window differs")
        check(torch.equal(h_new, want_h), f"mamba2_step {name}: the state differs from the plain "
              f"version's (largest difference {float((h_new - want_h).abs().max())})")
        for k, e in errs.items():
            check(e <= lims[k], f"mamba-2 step {name}: {k} error {e} over {lims[k]} of its largest")
        check(torch.equal(y, y2) and torch.equal(h_new, h_new2),
              f"mamba2_step {name}: reruns differ")
        check(torch.equal(x_conv3, x_conv) and torch.equal(win_in, new_window)
              and torch.equal(y3, y) and torch.equal(h_in, h_new),
              f"mamba-2 step {name}: the in-place form differs from the functional one")
        conv_bytes = _mamba_step_bytes(B, conv_dim, N, K, w.element_size(), False)[0]
        step_bytes = _mamba2_step_bytes(B, H, P, N)
        R = max(1, -(-2 * L2_BYTES // (window.nbytes + h.nbytes)))
        states = [(window.clone(), h.clone()) for _ in range(R)]
        with torch.no_grad():
            t = {
                "conv_step_ms": device_ms(torch, lambda i: ms.conv_step(
                    xBC, states[i % R][0], w, b, inplace=True), iters, 200.0),
                "mamba2_step_ms": device_ms(torch, lambda i: ms.mamba2_step(
                    xs, Bm, Cm, z, dt, dt_bias, A_log, D, states[i % R][1], inplace=True),
                    iters, 200.0),
                "conv_step_plain_ms": device_ms(torch, lambda i: ms.conv_step_ref(
                    xBC, states[i % R][0], w, b), plain_iters, 200.0),
                "mamba2_step_plain_ms": device_ms(torch, lambda i: ms.mamba2_step_ref(
                    xs, Bm, Cm, z, dt, dt_bias, A_log, D, states[i % R][1]), plain_iters, 200.0),
            }
        row = {"phase": "mamba2_step", "case": name, "B": B, "heads": H, "head_dim": P,
               "d_state": N, "conv_channels": conv_dim, "dtype": "bfloat16",
               "max_rel_err": errs, "limits": lims, "state_equal": True, "launches": launches,
               **t, "conv_step_bound_ms": conv_bytes / HBM_BYTES_PER_S * 1e3,
               "mamba2_step_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
               "conv_step_bytes": conv_bytes, "mamba2_step_bytes": step_bytes,
               "bound_by": "bytes", "state_copies": R}
        row["conv_step_bound_share"] = row["conv_step_bound_ms"] / t["conv_step_ms"]
        row["mamba2_step_bound_share"] = row["mamba2_step_bound_ms"] / t["mamba2_step_ms"]
        emit(row)
        rows.append(row)
        del states
    return rows


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

    cfg = TTSConfig()
    d = cfg.decoder
    check((d.d_model, d.n_layers, d.n_heads, d.d_ff, d.vocab_size_audio) == (512, 8, 8, 2048, 1026),
          "default decoder width")
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
    results, launches = {}, 0

    def serve(tag, synth, fn, frames, batch):
        nonlocal launches
        read = _zero_counts()
        wavs, row = _timed_request(torch, synth, fn, frames, batch,
                                   {"phase": "slice", "request": tag})
        n = read()["int8_matvec"]
        steps = d.num_quantizers * frames
        check(n == per_step * steps, f"{tag}: {n} int8_matvec launches, expected "
              f"{per_step} x {steps} = {per_step * steps}")
        row["int8_matvec_launches"] = n
        emit(row)
        results[tag] = row
        launches += n
        return wavs

    serve("a_int8_kv_3.2s", synth_kv, lambda: synth_kv.synthesize(TEXT, STYLE, voice, frames=256),
          256, 1)
    wb = serve("b_int8_batch4", synth_q, lambda: synth_q.synthesize_batch(
        TEXTS, STYLES, [voice] * 4, frames=256), 256, 4)
    for i in range(4):
        for j in range(i + 1, 4):
            check(not np.allclose(wb[i], wb[j]), f"batch rows {i} and {j} are identical")
    synth_q.register_voice("speaker_0", voice)
    serve("c_int8_registered_voice", synth_q,
          lambda: synth_q.synthesize(TEXT, STYLE, "speaker_0", frames=128), 128, 1)
    return synth_q, results, launches


def _condition(torch, synth, B=1):
    ids, _, mask = synth.frontend.encode_batch([TEXTS[i % 4] for i in range(B)],
                                               pad_to=synth.cfg.data.max_text_len)
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
        index = torch.arange(steps, device=th_.device)
        logits, toks = [], []
        for t in range(steps):
            lg, states = quant_step_with_kv(qp, cfg, tok, KV, mm, films, states,
                                            index[t:t + 1], frames)
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


def phase_captured_vs_eager(torch, synth, steps=256, frames=256):
    """Request (a)'s decode (int8_kv, B=1, 256 frames) as serving runs it,
    from a replayed CUDA graph, against the eager step loop over its first
    256 steps: tokens and logits must be equal."""
    from mamba_tts_torch.infer import quant_decode as qd
    from mamba_tts_torch.models import decoder as dm

    th, mask, rh, rm, z = _condition(torch, synth)
    dec, cfg = synth.decoder, synth.decoder.cfg
    with torch.no_grad():
        got = qd.greedy_decode_int8(dec, synth._qparams, th, z, frames, text_mask=mask,
                                    ref_hidden=rh, ref_mask=rm, collect_logits=True,
                                    int8_kv=True)
        KV, mm, films = dec.project_memories(th, mask, rh, rm, z)
        KV = qd.quantize_kv(KV)
        carry = dm.init_carry(cfg, 1, cfg.num_quantizers * frames, dec.dtype, th.device, True)
        for _ in range(steps):
            dm.decode_step_(lambda tok, st, i: qd.quant_step_with_kv(synth._qparams, cfg, tok, KV,
                                                                     mm, films, st, i, frames),
                            carry, cfg.num_special_tokens)
    torch.cuda.synchronize()
    same_tokens = torch.equal(got.tokens[:, :steps], carry.tokens[:, :steps])
    diff = float((got.logits[:, :steps] - carry.logits[:, :steps]).abs().max())
    row = {"phase": "captured_vs_eager", "request": "a_int8_kv_3.2s", "steps": steps,
           "tokens_equal": same_tokens, "max_abs_logit_diff": diff}
    emit(row)
    check(same_tokens and diff == 0.0, f"captured decode differs from the eager loop: {row}")
    return row


def _device(prof):
    kernels = _device_kernels(prof)
    return kernels, sum(_dev_us(e) for e in kernels) / 1e3, sum(e.count for e in kernels)


def _top(kernels, n):
    return [{"name": e.key[:80], "device_ms_per_step": _dev_us(e) / 1e3 / n,
             "calls_per_step": e.count / n}
            for e in sorted(kernels, key=_dev_us, reverse=True)[:8]]


def _profile_served(torch, served, steps_per_frame, frames=(32, 96)):
    """``served(f)`` (one decode call as serving runs it: condition, capture
    once, replay) at two lengths, so that the per-call costs (conditioning,
    capture) drop out of the difference: wall per step (both lengths timed
    before either is profiled), and device busy and idle share and device
    kernels per step under torch.profiler (the idle share against the
    profiled call's own wall), of the whole longer call and of the steps
    between the two."""
    from torch.profiler import ProfilerActivity, profile

    wall, pwall, busy, count, kernels = {}, {}, {}, {}, None
    for f in frames:
        served(f)
    for f in frames:
        t0 = time.perf_counter()
        served(f)
        wall[f] = (time.perf_counter() - t0) * 1e3
    for f in frames:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            served(f)
            pwall[f] = (time.perf_counter() - t0) * 1e3
        kernels, busy[f], count[f] = _device(prof)
    lo, hi = frames
    n_hi, n = steps_per_frame * hi, steps_per_frame * (hi - lo)
    steady_busy, steady_pwall = (busy[hi] - busy[lo]) / n, (pwall[hi] - pwall[lo]) / n
    return {"mode": "captured", "steps": n_hi, "wall_ms_per_step": wall[hi] / n_hi,
            "profiled_wall_ms_per_step": pwall[hi] / n_hi,
            "device_busy_ms_per_step": busy[hi] / n_hi,
            "device_idle_share": 1 - busy[hi] / pwall[hi],
            "kernel_launches_per_step": count[hi] / n_hi,
            "steady_steps": n, "steady_wall_ms_per_step": (wall[hi] - wall[lo]) / n,
            "steady_profiled_wall_ms_per_step": steady_pwall,
            "steady_device_busy_ms_per_step": steady_busy,
            "steady_device_idle_share": 1 - steady_busy / steady_pwall,
            "steady_kernel_launches_per_step": (count[hi] - count[lo]) / n,
            "top_kernels": _top(kernels, n_hi)}


def phase_profile(torch, synth, steps=32, frames=(32, 96)):
    """The int8_kv decode at B=1 as serving runs it (``greedy_decode_int8``)
    through ``_profile_served``; then a window of the eager step loop of the
    earlier slices, for the record."""
    from torch.profiler import ProfilerActivity, profile

    from mamba_tts_torch.infer.quant_decode import greedy_decode_int8, quant_step_with_kv

    th, mask, rh, rm, z = _condition(torch, synth)
    dec, cfg = synth.decoder, synth.decoder.cfg

    with torch.no_grad():
        def served(f):
            greedy_decode_int8(dec, synth._qparams, th, z, f, text_mask=mask, ref_hidden=rh,
                               ref_mask=rm, int8_kv=True)
            torch.cuda.synchronize()

        captured = _profile_served(torch, served, cfg.num_quantizers, frames)
        emit({"phase": "profile", **captured})
        hi = frames[1]

        KV, mm, films = dec.project_memories(th, mask, rh, rm, z)
        states = dec.init_states(1)
        tok = torch.full((1, 1), cfg.bos_id, dtype=torch.long, device="cuda")
        index = torch.arange(steps, device="cuda")

        def window(n, states):
            for t in range(n):
                lg, states = quant_step_with_kv(synth._qparams, cfg, tok, KV, mm, films,
                                                states, index[t:t + 1], hi)
            return states

        states = window(4, states)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        window(steps, states)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            window(steps, states)
            torch.cuda.synchronize()
    kernels, busy_ms, n_kernels = _device(prof)
    eager = {"mode": "eager_step_loop", "steps": steps, "wall_ms_per_step": wall_ms / steps,
             "device_busy_ms_per_step": busy_ms / steps,
             "device_idle_share": 1 - busy_ms / wall_ms,
             "kernel_launches_per_step": n_kernels / steps, "top_kernels": _top(kernels, steps)}
    emit({"phase": "profile", **eager})
    check(captured["kernel_launches_per_step"] > 0, "the profiler saw no kernel of the replays")
    return captured, eager


def _timed_request(torch, synth, fn, frames, batch, row):
    """Serve one request ``fn() -> (wavs, info)`` with ``decode_tokens``
    timed, so that its wall splits into the decode and everything else;
    check finite waveforms of ``frames * hop`` samples a row.  Returns
    (wavs (batch, samples), ``row`` with the request's numbers added)."""
    import numpy as np

    decode_s = []
    inner = synth.decode_tokens

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(*args, **kw)
        torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t)
        return out

    synth.decode_tokens = timed
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        wavs, _ = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        del synth.decode_tokens
    tag, hop = row["request"], synth.cfg.codec.hop_length
    wavs = np.asarray(wavs).reshape(batch, -1)
    check(wavs.shape[1] == frames * hop, f"{tag}: {wavs.shape[1]} samples, expected {frames * hop}")
    check(bool(np.isfinite(wavs).all()), f"{tag}: non-finite waveform")
    steps = synth.cfg.decoder.num_quantizers * frames
    decode = sum(decode_s)
    return wavs, {**row, "batch": batch, "frames": frames, "tokens": batch * steps,
                  "wall_seconds": wall, "tokens_per_s": batch * steps / wall,
                  "rtf": wall / (batch * frames / 80.0), "decode_seconds": decode,
                  "decode_ms_per_step": decode / steps * 1e3, "outside_decode_seconds": wall - decode}


def _zero_counts():
    from mamba_tts_torch.ops import decode_megakernel as mk
    from mamba_tts_torch.ops import mamba_step
    from mamba_tts_torch.ops.decode_attention import decode_attention
    from mamba_tts_torch.ops.int8_matvec import int8_matvec

    mk._megakernel_call.launches = 0
    int8_matvec.launches = 0
    decode_attention.launches = 0
    mamba_step.launches = 0
    return lambda: {"int8_matvec": int8_matvec.launches,
                    "decode_megakernel": mk._megakernel_call.launches,
                    "decode_attention": decode_attention.launches,
                    "mamba_step": mamba_step.launches}


def phase_default_decode(torch, voice, eager_steps=256, eager_profiled=32,
                         profile_frames=(8, 24)):
    """``quant="none"``, the CLI's default, at full width: (a') B=1, 256
    frames and (d') the flagship, 1,024 frames, through the captured decode
    (its custom kernels: ``decode_attention`` once a layer a step, the
    Mamba step's two kernels twice; the rest is plain products); the
    captured decode
    against the eager in-place step loop over its first 256 steps (equal
    tokens, bit-identical logits), both timed; torch.profiler over the eager
    loop's next 32 steps (device busy, idle share against the unprofiled
    wall of the 32 steps before them, as phase 5 does for the int8 loop) and
    over the served decode at 8 and 24 frames (fewer than phase 5's, to keep
    the profiler's cost down).  Returns the synthesizer and the
    ``decode_attention`` and Mamba step launches of (a') and (d')."""
    from torch.profiler import ProfilerActivity, profile

    from mamba_tts_torch.config import TTSConfig
    from mamba_tts_torch.infer.synthesize import load_synthesizer
    from mamba_tts_torch.models import decoder as dm

    cfg = TTSConfig()
    t0 = time.perf_counter()
    synth = load_synthesizer(cfg, seed=0, quant="none", device="cuda")
    torch.cuda.synchronize()
    emit({"phase": "default_decode", "setup_seconds": time.perf_counter() - t0})
    launches = {"decode_attention": 0, "mamba_step": 0}
    for tag, frames in (("a'_none_3.2s", 256), ("d'_none_12.8s", 1024)):
        read = _zero_counts()
        row = _timed_request(torch, synth, lambda: synth.synthesize(TEXT, STYLE, voice, frames=frames),
                             frames, 1, {"phase": "default_decode", "request": tag})[1]
        n = read()
        steps = cfg.decoder.num_quantizers * frames
        want = {"int8_matvec": 0, "decode_megakernel": 0,
                "decode_attention": cfg.decoder.n_layers * steps,
                "mamba_step": 2 * cfg.decoder.n_layers * steps}
        check(n == want, f"{tag}: launches {n}, expected {want}")
        emit({**row, "decode_attention_launches": n["decode_attention"],
              "mamba_step_launches": n["mamba_step"]})
        launches = {k: launches[k] + n[k] for k in launches}

    th, mask, rh, rm, z = _condition(torch, synth)
    dec, dc = synth.decoder, synth.decoder.cfg
    frames = 256
    with torch.no_grad():
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = dm.greedy_decode(dec, th, z, frames, text_mask=mask, ref_hidden=rh, ref_mask=rm,
                               collect_logits=True)
        torch.cuda.synchronize()
        captured_ms = (time.perf_counter() - t) * 1e3 / (dc.num_quantizers * frames)
        KV, mm, films = dec.project_memories(th, mask, rh, rm, z)
        carry = dm.init_carry(dc, 1, dc.num_quantizers * frames, dec.dtype, th.device, True)

        def eager(n):
            for _ in range(n):
                dm.decode_step_(lambda tok, st, i: dec.step_with_kv(tok, KV, mm, films, st, i,
                                                                    frames),
                                carry, dc.num_special_tokens)
            torch.cuda.synchronize()

        eager(1)
        t = time.perf_counter()
        eager(eager_steps - 1)
        eager_ms = (time.perf_counter() - t) * 1e3 / (eager_steps - 1)
        same = torch.equal(got.tokens[:, :eager_steps], carry.tokens[:, :eager_steps])
        diff = float((got.logits[:, :eager_steps] - carry.logits[:, :eager_steps]).abs().max())
        t = time.perf_counter()
        eager(eager_profiled)
        window_ms = (time.perf_counter() - t) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            eager(eager_profiled)
            profiled_ms = (time.perf_counter() - t) * 1e3
    kernels, busy_ms, n_kernels = _device(prof)
    row = {"phase": "default_decode", "check": "captured_vs_eager", "steps": eager_steps,
           "tokens_equal": same, "max_abs_logit_diff": diff,
           "captured_ms_per_step": captured_ms, "eager_ms_per_step": eager_ms}
    emit(row)
    check(same and diff == 0.0, f"captured default decode differs from the eager loop: {row}")
    n = eager_profiled
    emit({"phase": "default_decode", "profile": True, "mode": "eager_step_loop", "steps": n,
          "wall_ms_per_step": window_ms / n, "profiled_wall_ms_per_step": profiled_ms / n,
          "device_busy_ms_per_step": busy_ms / n, "device_idle_share": 1 - busy_ms / window_ms,
          "profiled_device_idle_share": 1 - busy_ms / profiled_ms,
          "kernel_launches_per_step": n_kernels / n, "top_kernels": _top(kernels, n)})
    check(n_kernels > 0, "the profiler saw no kernel of the eager default decode")

    t = time.perf_counter()
    with torch.no_grad():
        def served(f):
            dm.greedy_decode(dec, th, z, f, text_mask=mask, ref_hidden=rh, ref_mask=rm)
            torch.cuda.synchronize()

        prof = _profile_served(torch, served, dc.num_quantizers, profile_frames)
    emit({"phase": "default_decode", "profile": True, **prof,
          "profile_seconds": time.perf_counter() - t})
    check(prof["kernel_launches_per_step"] > 0, "the profiler saw no kernel of the replays")
    return synth, launches


# ---------------------------------------------------------------- megakernel


def _step_bytes(mk, cfg, B, memory_len, wd, kvd):
    """Bytes one decode step must read: the plan (weights, K/V, scales, mask,
    FiLM), the state and the step's rows.  The token-embedding table is read
    one row per batch row, so its other rows are taken off."""
    Vpad = -(-cfg.vocab_size_audio // 128) * 128
    whole = mk.plan_resident_bytes(cfg, B, memory_len, wd, kvd, total_steps=1)
    return whole - Vpad * cfg.d_model * 2 + B * cfg.d_model * 2


def _step_ops(cfg, B, Tmp):
    """Multiply-adds of one step, times two: the six projections, the x/dt
    projections, the attention products and the vocab head."""
    m = cfg.with_mamba_dims().mamba
    d, di, dff = cfg.d_model, m.d_inner, cfg.d_ff
    Vpad = -(-cfg.vocab_size_audio // 128) * 128
    per_layer = (d * 2 * di + di * (m.dt_rank_actual + 2 * m.d_state) + m.dt_rank_actual * di
                 + di * d + 2 * d * d + 2 * d * Tmp + 2 * d * dff)
    return 2 * B * (cfg.n_layers * per_layer + d * Vpad)


def _onchip_bytes(cfg, lp, wd):
    """Bytes of a step's plan and state that a launch laid out by ``lp``
    keeps in shared memory for the whole launch: the resident weights (their
    slices over all blocks cover each whole), and the owned channels' conv
    and x/dt-projection weights, conv bias, dt bias, A, D and state."""
    m = cfg.with_mamba_dims().mamba
    L, d, di, N, r, dc, dff = (cfg.n_layers, cfg.d_model, m.d_inner, m.d_state,
                               m.dt_rank_actual, m.d_conv, cfg.d_ff)
    wb, B = (1 if wd == "int8" else 2), lp.batch
    Vpad = -(-cfg.vocab_size_audio // 128) * 128
    whole = {"in_w": L * d * 2 * di * wb, "out_w": L * di * d * wb, "q_w": L * d * d * wb,
             "o_w": L * d * d * wb, "ff1_w": L * d * dff * wb, "ff2_w": L * dff * d * wb,
             "head_w": d * Vpad * 2}
    n = sum(whole[w] for w in lp.resident)
    n += L * di * (dc * 2 + 4 + (r + 2 * N) * 2 + r * 2 + 4 + N * 4 + 4)
    return n + L * (dc - 1) * B * di * 2 + L * B * N * di * 4


def _launch_bounds(mk, cfg, lp, Tm, wd, kvd, steps, teacher_force=False):
    """Three least times of one launch of ``steps`` steps, in ms, each the
    larger of its bytes over their rate and the operations over the bf16
    peak: every input read once and every output written once (the kernel
    table's ``bound_ms``); this launch plan's, where each step reads its
    streamed set (the plan less what ``lp`` keeps on chip) from the L2 and
    the part beyond the L2 from device memory (HBM bytes also pass the L2, so
    the two rates overlap and the larger time bounds); and without
    residency, the whole plan from device memory every step."""
    B = lp.batch
    once = mk.plan_resident_bytes(cfg, B, Tm, wd, kvd, total_steps=steps,
                                  teacher_force=teacher_force)
    step = _step_bytes(mk, cfg, B, Tm, wd, kvd)
    streamed = step - _onchip_bytes(cfg, lp, wd)
    beyond = max(0, streamed - L2_BYTES)
    ops_s = steps * _step_ops(cfg, B, -(-Tm // 128) * 128) / BF16_OPS_PER_S
    once_s = once / HBM_BYTES_PER_S
    return {
        "bound_read_once_ms": max(once_s, ops_s) * 1e3,
        "bound_read_once_by": "bytes" if once_s >= ops_s else "operations",
        "bound_with_plan_ms": max((once + steps * beyond) / HBM_BYTES_PER_S,
                                  steps * streamed / L2_READ_BYTES_PER_S, ops_s) * 1e3,
        "bound_no_residency_ms": max(steps * step / HBM_BYTES_PER_S, ops_s) * 1e3,
        "streamed_bytes_per_step": streamed, "beyond_l2_bytes_per_step": beyond,
    }


def _forced(torch, cfg, total, B, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    forced = torch.randint(cfg.num_special_tokens, cfg.vocab_size_audio, (total, B),
                           generator=g, device="cuda", dtype=torch.int32)
    forced[0] = cfg.bos_id
    return forced


def _hold_to_plain(torch, cfg, got, want, tag, **row):
    """One kernel run against the plain version's run on the same plan and
    forced tokens: logits over the real token columns and the final states,
    within the megakernel's limits.  Returns the largest absolute logit error."""
    V, sp = cfg.vocab_size_audio, cfg.num_special_tokens
    g, w = got.logits[:, :, sp:V], want.logits[:, :, sp:V]
    check(bool(torch.isfinite(g).all()), f"{tag}: non-finite logits")
    err = float((g - w).abs().max())
    rel = err / float(w.abs().max())
    agree = float((g.argmax(-1) == w.argmax(-1)).float().mean())
    conv = float((got.conv_state.float() - want.conv_state.float()).abs().max()
                 / want.conv_state.float().abs().max())
    ssm = float((got.ssm_state - want.ssm_state).abs().max() / want.ssm_state.abs().max())
    emit({"phase": "megakernel_kernel", "check": tag, **row, "steps": g.shape[0],
          "rel_max_logit_err": rel, "max_abs_logit_err": err, "argmax_agreement": agree,
          "conv_state_rel_err": conv, "ssm_state_rel_err": ssm,
          "limits": {"rel": 3e-2, "agree": 0.9, "conv": 3e-2, "ssm": 1e-1}})
    check(rel <= 3e-2, f"{tag}: relative max logit error {rel}")
    check(agree >= 0.9, f"{tag}: argmax agreement {agree}")
    check(conv <= 3e-2, f"{tag}: conv state relative error {conv}")
    check(ssm <= 1e-1, f"{tag}: SSM state relative error {ssm}")
    return err


def phase_megakernel_kernel(torch, synth, frames=8):
    """The kernel against its plain version at full width, at every batch tile
    the requests launch (1, the chunked request's remainder 2, 4 and the
    kernel's largest batch), and the feedback path exactly.  Returns the
    largest absolute logit error seen."""
    from mamba_tts_torch.ops import decode_megakernel as mk

    dec, cfg = synth.decoder, synth.decoder.cfg
    total = cfg.num_quantizers * frames
    worst = 0.0

    def versus_plain(tag, plan, forced, **row):
        nonlocal worst
        got = mk._megakernel_call(cfg, plan, frames, forced)
        torch.cuda.synchronize()
        want = mk.decode_megakernel_ref(cfg, plan, frames, forced)
        torch.cuda.synchronize()
        worst = max(worst, _hold_to_plain(torch, cfg, got, want, tag, **row))
        return got

    with torch.no_grad():
        for B in (1, 2, 4, mk.MEGAKERNEL_MAX_BATCH):
            th, mask, rh, rm, z = _condition(torch, synth, B)
            KV, mm, films = dec.project_memories(th, mask, rh, rm, z)
            check(KV[0][0].shape[2] == 1536, f"memory length {KV[0][0].shape[2]}, expected 1536")
            forced = _forced(torch, cfg, total, B, seed=B)
            # every rung up to B = 4; the kernel's largest batch on the first and last
            for wd, kvd in mk._DTYPE_LADDER[::1 if B <= 4 else 2]:
                plan = mk._build_plan(cfg, synth._qparams, KV, mm, films, frames, weight_dtype=wd,
                                      kv_dtype=kvd, weight_plan=synth._weight_plans[wd])
                versus_plain("teacher_forced", plan, forced, B=B, weights=wd, kv=kvd)
            if B > 1:
                continue
            # the feedback path, exactly (plan: the last rung, int8/int8)
            free = mk._megakernel_call(cfg, plan, frames).logits
            again = mk._megakernel_call(cfg, plan, frames).logits
            tokens = free.argmax(-1).to(torch.int32)  # (total, B)
            bos = torch.full((1, B), cfg.bos_id, dtype=torch.int32, device="cuda")
            tf = mk._megakernel_call(cfg, plan, frames, torch.cat([bos, tokens[:-1]])).logits
            check(torch.equal(free, again), "two free runs differ")
            check(torch.equal(free, tf), "free run and teacher-forced rerun differ")
            check(torch.equal(tf.argmax(-1).to(torch.int32), tokens), "argmax(logits) != tokens")
            # one sampled run with a given noise tensor: the kernel fed back
            # argmax(logits + noise) if and only if forcing those tokens repeats it
            g = torch.Generator(device="cuda").manual_seed(7)
            noise = 0.8 * mk.gumbel_noise((total, B, plan.token_embed.shape[0]), g, "cuda")
            sampled = mk._megakernel_call(cfg, plan, frames, gumbel=noise).logits
            stoks = (sampled + noise).argmax(-1).to(torch.int32)
            forced_s = torch.cat([bos, stoks[:-1]])
            stf = versus_plain("sampled_then_forced", plan, forced_s, B=B, weights=wd, kv=kvd)
            check(torch.equal(sampled, stf.logits), "sampled run and its teacher-forced rerun differ")
            check(not torch.equal(stoks, tokens), "the noise changed no token")
            emit({"phase": "megakernel_kernel", "check": "feedback", "free_equals_free": True,
                  "free_equals_teacher_forced": True, "sampled_equals_teacher_forced": True,
                  "sampled_tokens_changed": int((stoks != tokens).sum())})
    return worst


def phase_megakernel_slice(torch, voice):
    import numpy as np

    from mamba_tts_torch.config import TTSConfig
    from mamba_tts_torch.infer import synthesize as syn
    from mamba_tts_torch.ops import decode_megakernel as mk

    cfg = TTSConfig()
    d = cfg.decoder
    t0 = time.perf_counter()
    synth = syn.load_synthesizer(cfg, seed=0, quant="megakernel", device="cuda")
    torch.cuda.synchronize()
    emit({"phase": "megakernel_slice", "setup_seconds": time.perf_counter() - t0})
    memory_len = 256 * d.num_quantizers + cfg.data.max_text_len  # 3 s prompt bucket + padded text
    max_batch = mk.megakernel_max_batch(d, memory_len)
    results, launches = {}, 0

    def serve(tag, fn, frames, batch, sampled=False):
        nonlocal launches
        read = _zero_counts()
        wavs, row = _timed_request(torch, synth, fn, frames, batch,
                                   {"phase": "megakernel_slice", "request": tag})
        n = read()
        chunks = -(-batch // max_batch)
        check(n["decode_megakernel"] == chunks, f"{tag}: {n['decode_megakernel']} megakernel "
              f"launches, expected {chunks} chunks")
        check(n["int8_matvec"] == 0, f"{tag}: {n['int8_matvec']} int8_matvec launches: "
              "a request of this slice took the step decode")
        rung = syn._megakernel_dtypes(d, min(batch, max_batch), memory_len, sampled=sampled)
        row.update({"decode_us_per_step": row["decode_seconds"] / (chunks * d.num_quantizers
                                                                   * frames) * 1e6,
                    "megakernel_launches": n["decode_megakernel"], "int8_matvec_launches": 0,
                    "rung": list(rung), "max_batch": max_batch})
        emit(row)
        results[tag] = row
        launches += n["decode_megakernel"]
        return wavs

    def rows_differ(tag, w):
        for i in range(len(w)):
            for j in range(i + 1, len(w)):
                check(not np.allclose(w[i], w[j]), f"{tag}: rows {i} and {j} are identical")

    serve("d_megakernel_12.8s", lambda: synth.synthesize(TEXT, STYLE, voice, frames=1024), 1024, 1)
    rows_differ("e", serve("e_megakernel_batch4", lambda: synth.synthesize_batch(
        TEXTS, STYLES, [voice] * 4, frames=256), 256, 4))
    big = max_batch + 2
    texts = [TEXTS[i % 4] + " Take %d." % i for i in range(big)]
    rows_differ("f", serve("f_megakernel_chunked", lambda: synth.synthesize_batch(
        texts, [STYLES[i % 4] for i in range(big)], [voice] * big, frames=64), 64, big))

    def sample(seed):
        return serve(f"g_megakernel_sampled_seed{seed}", lambda: synth.synthesize(
            TEXT, STYLE, voice, frames=128, temperature=0.8, seed=seed), 128, 1, sampled=True)

    s0, s0b, s1 = sample(0), sample(0), sample(1)
    check(np.array_equal(s0, s0b), "sampled request: the same seed gave another waveform")
    check(not np.allclose(s0, s1), "sampled request: another seed gave the same waveform")
    return synth, results, launches


def megakernel_rung_times(torch, synth, batches, frames=1024):
    """Launch ms of whole ``frames``-frame decodes (CUDA events), one launch
    per batch size and dtype rung: {(B, weights, kv): (ms, memory length,
    padded memory length)}.  It calls only the host-side functions every
    version of the kernel has had, so it can time another tree's kernel too."""
    from mamba_tts_torch.ops import decode_megakernel as mk

    dec, cfg = synth.decoder, synth.decoder.cfg
    out = {}
    with torch.no_grad():
        for B in batches:
            th, mask, rh, rm, z = _condition(torch, synth, B)
            KV, mm, films = dec.project_memories(th, mask, rh, rm, z)
            for wd, kvd in mk._DTYPE_LADDER:
                plan = mk._build_plan(cfg, synth._qparams, KV, mm, films, frames, weight_dtype=wd,
                                      kv_dtype=kvd, weight_plan=synth._weight_plans[wd])
                ms, _ = _events_ms(torch, lambda: mk._megakernel_call(cfg, plan, frames))
                out[(B, wd, kvd)] = (ms, KV[0][0].shape[2], plan.K.shape[3])
                del plan
    return out


def phase_megakernel_times(torch, synth, voice, frames=1024):
    """Whole flagship decodes by CUDA events for every rung at B=1, 4 and 8,
    one 64-frame launch beside the plain version (timed, and held to it), one
    step split into stages and barrier waits, and the device's idle share
    over the flagship request."""
    from torch.profiler import ProfilerActivity, profile

    from mamba_tts_torch.ops import decode_megakernel as mk

    dec, cfg = synth.decoder, synth.decoder.cfg
    steps = cfg.num_quantizers * frames
    rows = {}
    times = megakernel_rung_times(torch, synth, (1, 4, mk.MEGAKERNEL_MAX_BATCH), frames)
    for (B, wd, kvd), (ms, Tm, Tmp) in times.items():
        lp = mk._card_plan(cfg, B, Tmp, wd, kvd, torch.device("cuda"))
        bounds = _launch_bounds(mk, cfg, lp, Tm, wd, kvd, steps)
        row = {"phase": "megakernel_times", "B": B, "weights": wd, "kv": kvd,
               "frames": frames, "steps": steps, "launch_ms": ms,
               "us_per_step": ms / steps * 1e3, "tokens_per_s": B * steps / ms * 1e3,
               "step_bytes": _step_bytes(mk, cfg, B, Tm, wd, kvd), **bounds,
               **{k.replace("_ms", "_us_per_step"): v / steps * 1e3
                  for k, v in bounds.items() if k.endswith("_ms")},
               "grid": lp.grid, "cluster": lp.cluster, "resident": list(lp.resident),
               "smem_bytes": lp.smem_bytes}
        emit(row)
        rows[(B, wd, kvd)] = row
    with torch.no_grad():
        # one launch at 64 frames (the chunked request's budget) against the plain version
        f64 = 64
        th, mask, rh, rm, z = _condition(torch, synth, 1)
        KV, mm, films = dec.project_memories(th, mask, rh, rm, z)
        wd, kvd = mk._DTYPE_LADDER[0]
        plan = mk._build_plan(cfg, synth._qparams, KV, mm, films, f64, weight_dtype=wd,
                              kv_dtype=kvd, weight_plan=synth._weight_plans[wd])
        n64 = cfg.num_quantizers * f64
        forced = _forced(torch, cfg, n64, 1, seed=3)
        mk._megakernel_call(cfg, plan, f64, forced)
        kernel_ms, got = _events_ms(torch, lambda: mk._megakernel_call(cfg, plan, f64, forced))
        plain_ms, want = _events_ms(torch, lambda: mk.decode_megakernel_ref(cfg, plan, f64, forced))
        err = _hold_to_plain(torch, cfg, got, want, "teacher_forced_320_steps", B=1,
                             weights=wd, kv=kvd)
        lp = mk._card_plan(cfg, 1, plan.K.shape[3], wd, kvd, plan.K.device)
        one = {"phase": "megakernel_times", "launch": "B=1, 64 frames (320 steps), bf16/bf16, "
               "teacher-forced", "ms": kernel_ms, "plain_ms": plain_ms, "max_abs_logit_err": err,
               **_launch_bounds(mk, cfg, lp, KV[0][0].shape[2], wd, kvd, n64, teacher_force=True)}
        emit(one)
        # where a step goes: block 0's cycle stamps at the start of the middle
        # step and around each of its grid barriers; the spare entries beyond
        # them must stay 0, so a kernel that ran more barriers shows
        names = mk.stage_names(cfg)
        need, spare = mk.stage_clock_count(cfg), 64
        clocks = torch.zeros(need + spare, dtype=torch.int64, device="cuda")
        mk._megakernel_call(cfg, plan, f64, stage_clocks=clocks)
        stamps = clocks.cpu().tolist()
        written = sum(1 for v in stamps if v != 0)
        check(all(v == 0 for v in stamps[need:]) and all(v > 0 for v in stamps[:need]),
              f"stage_clocks: {written} stamps written, {need} expected")
        check(all(b > a for a, b in zip(stamps[:need - 1], stamps[1:need])),
              "stage_clocks: the stamps do not rise")
        barriers = (written - 1) // 2
        check(barriers == len(names) <= 66,
              f"stage_clocks: {barriers} grid barriers a step, stage_names has {len(names)}")
        work, wait, prev = {}, {}, stamps[0]
        for i, name in enumerate(names):
            stage = name.split(".")[-1]
            enter, leave = stamps[1 + 2 * i], stamps[2 + 2 * i]
            work[stage] = work.get(stage, 0) + enter - prev
            wait[stage] = wait.get(stage, 0) + leave - enter
            prev = leave
        cycles = stamps[need - 1] - stamps[0]
        one["grid_barriers_per_step"] = barriers
        emit({"phase": "megakernel_times", "stages": "B=1, bf16/bf16, one step, SM cycles of block 0 "
              "summed over the layers: [work, barrier wait]", "grid_barriers_per_step": barriers,
              "step_cycles": cycles, "barrier_share": sum(wait.values()) / cycles,
              "cycles": {k: [work[k], wait[k]] for k in wait}})

    # the device's idle share over the flagship request, end to end
    synth.synthesize(TEXT, STYLE, voice, frames=frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        synth.synthesize(TEXT, STYLE, voice, frames=frames)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _device_kernels(prof)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:5]
    emit({"phase": "megakernel_times", "request": "flagship under torch.profiler",
          "wall_ms": wall_ms, "device_busy_ms": busy_ms or None,
          "device_idle_share": 1 - busy_ms / wall_ms if busy_ms else None,
          "device_kernels": sum(e.count for e in kernels),
          "top_kernels": [{"name": e.key[:80], "device_ms": dev_us(e) / 1e3, "calls": e.count}
                          for e in top]})
    return rows, one


def phase_megakernel_flagship(torch, synth, frames=1024, tail=1024, window=512):
    """The kernel at the flagship length: 5,120 greedy steps of the captured
    int8 step decode (B=1, collect_logits), then the megakernel on int8
    weights and bf16 K/V teacher-forced on [BOS, tokens[:-1]]: relative max
    logit error <= 3e-2 and argmax agreement >= 90% over all steps and over
    the last 1,024 (tests/test_decode_megakernel.py:96-99).  Agreement per
    512-step window says where it falls, if it does."""
    from mamba_tts_torch.infer import quant_decode as qd
    from mamba_tts_torch.ops import decode_megakernel as mk

    th, mask, rh, rm, z = _condition(torch, synth)
    dec, cfg = synth.decoder, synth.decoder.cfg
    sp, V = cfg.num_special_tokens, cfg.vocab_size_audio
    with torch.no_grad():
        t0 = time.perf_counter()
        step = qd.greedy_decode_int8(dec, synth._qparams, th, z, frames, text_mask=mask,
                                     ref_hidden=rh, ref_mask=rm, collect_logits=True)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        bos = torch.full((1, 1), cfg.bos_id, dtype=step.tokens.dtype, device=step.tokens.device)
        forced = torch.cat([bos, step.tokens[:, :-1]], dim=1)
        got = mk.megakernel_greedy_decode(
            dec, synth._qparams, th, z, frames, text_mask=mask, ref_hidden=rh, ref_mask=rm,
            collect_logits=True, forced_tokens=forced, weight_dtype="int8", kv_dtype="bfloat16",
            weight_plan=synth._weight_plans["int8"])
        torch.cuda.synchronize()
    g, w = got.logits[0, :, sp:V].float(), step.logits[0, :, sp:V].float()
    check(bool(torch.isfinite(g).all()), "flagship: non-finite megakernel logits")

    def rel_agree(a, b):
        return (float((a - b).abs().max() / b.abs().max()),
                float((a.argmax(-1) == b.argmax(-1)).float().mean()))

    rel_all, agree_all = rel_agree(g, w)
    rel_tail, agree_tail = rel_agree(g[-tail:], w[-tail:])
    windows = [rel_agree(g[i:i + window], w[i:i + window])[1] for i in range(0, g.shape[0], window)]
    row = {"phase": "megakernel_flagship", "steps": g.shape[0], "step_decode_seconds": step_s,
           "rel_max_logit_err": rel_all, "argmax_agreement": agree_all,
           "last_rel_max_logit_err": rel_tail, "last_argmax_agreement": agree_tail,
           "last_steps": tail, "agreement_per_window": windows, "window": window,
           "limits": {"rel": 3e-2, "agree": 0.9}}
    emit(row)
    check(rel_all <= 3e-2 and rel_tail <= 3e-2, f"flagship: relative max logit error {row}")
    check(agree_all >= 0.9 and agree_tail >= 0.9, f"flagship: argmax agreement {row}")
    return row


# ------------------------------------------------------------------ training

F32_OPS_PER_S = 67e12  # f32 on the FMA pipe, outside the tensor cores
SCAN_OPS = {"fwd": 6, "bwd": 24}  # FMA-pipe f32 operations per (b, t, d, n); exps apart
# exps on the special-function units: 16 a clock on each of the 132 SMs at the
# 1.98 GHz boost clock (H100 SXM)
MUFU_EXPS_PER_S = 132 * 16 * 1.98e9
TRAIN_KERNELS = ("selective_scan_fwd", "selective_scan_fwd_ckpt", "selective_scan_bwd",
                 "flash_attention_fwd", "flash_attention_bwd")
_SCAN_CU, _FLASH_CU = ("mamba_tts_torch/ops/csrc/selective_scan.cu",
                       "mamba_tts_torch/ops/csrc/flash_attention.cu")
TRAIN_SOURCES = {  # kernel -> (source, the TPU kernel it replaces)
    "selective_scan_fwd": (_SCAN_CU, "mamba_tts_tpu/ops/pallas_scan.py:36"),
    "selective_scan_fwd_ckpt": (_SCAN_CU, "mamba_tts_tpu/ops/pallas_scan.py:121"),
    "selective_scan_bwd": (_SCAN_CU, "mamba_tts_tpu/ops/pallas_scan.py:160"),
    "flash_attention_fwd": (_FLASH_CU, "mamba_tts_tpu/models/attention.py:25"),
    "flash_attention_bwd": (_FLASH_CU, "mamba_tts_tpu/models/attention.py:25"),
}


def _events_ms(torch, fn):
    """Device ms of one call of ``fn`` (CUDA events, after a synchronise)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def _errs(got, want):
    """(largest absolute error, that over the reference's largest magnitude)."""
    d = float((got.float() - want.float()).abs().max())
    return d, d / max(float(want.float().abs().max()), 1e-30)


def _wrappers():
    from mamba_tts_torch.ops import flash_attention as fa
    from mamba_tts_torch.ops import pallas_scan as ps

    return {"selective_scan_fwd": ps.selective_scan_fwd,
            "selective_scan_fwd_ckpt": ps.selective_scan_fwd_ckpt,
            "selective_scan_bwd": ps.selective_scan_bwd,
            "flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd": fa.flash_attention_bwd}


def _scan_inputs(torch, B, T, D, N, seed, with_h0):
    """bf16 u/B/C and f32 dt as the Mamba block gives them: dt in the dt_proj
    init range, A the S4D-real init -(n + 1), D = 1."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    u = rnd(B, T, D).bfloat16()
    delta = torch.nn.functional.softplus(rnd(B, T, D) * 0.5 - 3.0)
    A = -torch.arange(1, N + 1, device="cuda", dtype=torch.float32).expand(D, N).contiguous()
    Bm, Cm = rnd(B, T, N).bfloat16(), rnd(B, T, N).bfloat16()
    h0 = rnd(B, N, D) * 0.1 if with_h0 else None
    return u, delta, A, Bm, Cm, torch.ones(D, device="cuda"), h0


def sm_clock():
    """The SM clock now and its maximum, as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kernels_per_call(torch, fn):
    """The scan kernels one call of ``fn`` runs on the device: (name, ms,
    calls).  The call sits between two 20 ms sleep kernels inside the
    profiler window, after an uncounted window that starts the device
    tracer, so that no kernel falls outside the window's edges."""
    from torch.profiler import ProfilerActivity, profile

    gap = int(0.02 * 2.0e9)
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(gap)
            fn()
            torch.cuda._sleep(gap)
            torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and "scan" in e.key:
            us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
            rows.append({"kernel": e.key[:70], "ms": us / 1e3, "calls": e.count})
    return rows


def _scan_bound(k, B, T, D, N, chunk):
    """(bound ms, what sets it, bytes) of one call of scan wrapper ``k``: each
    input read once and each output written once over HBM_BYTES_PER_S, its
    FMA-pipe operations over F32_OPS_PER_S, and one exp per (b, t, d, n) over
    the special-function units' rate; the largest of the three."""
    nc = -(-T // chunk)
    io = B * T * D * (2 + 4) + 2 * B * T * N * 2 + D * N * 4 + D * 4  # u, dt, B, C, A, D
    nbytes = {"selective_scan_fwd": io + B * T * D * 2 + B * N * D * 4,
              "selective_scan_fwd_ckpt": io + B * T * D * 2 + B * N * D * 4 + B * nc * N * D * 4,
              "selective_scan_bwd": io - D * 4 + B * nc * N * D * 4 + B * T * D * 4 + B * N * D * 4
              + 2 * B * T * D * 4 + 2 * B * T * N * 4 + 2 * B * N * D * 4}[k]
    elems = B * T * D * N
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": SCAN_OPS["bwd" if k.endswith("bwd") else "fwd"] * elems / F32_OPS_PER_S * 1e3,
             "exps": elems / MUFU_EXPS_PER_S * 1e3}
    by = max(times, key=times.get)
    return times[by], by, nbytes, times


def phase_scan_kernels(torch, T=5120, D=1024, N=16):
    """The three scan wrappers against their plain versions at the flagship's
    flattened grid (T = 5 x 1,024) at B = 2 and at B = 8 (the flagship
    training step's rows), and at a ragged T with a given h0; ms per call by
    CUDA events with the SM clock beside them, each wrapper's device kernels,
    and the bound.  Limits: y (bf16) within 1e-2 of its largest magnitude
    (one bf16 ulp); h_T and ckpt (f32, another exp and summation order)
    within 1e-4; the backward's f32 outputs within 1e-3.  The two forwards
    must give bit-identical y and h_T, and the backward bit-identical reruns."""
    from mamba_tts_torch.ops import pallas_scan as ps

    out = {k: {"max_abs_err": 0.0} for k in TRAIN_KERNELS[:3]}
    for B, T_, with_h0 in ((2, T, False), (2, T - 3, True), (8, T, False)):
        u, delta, A, Bm, Cm, Dsk, h0 = _scan_inputs(torch, B, T_, D, N, seed=T_ + B, with_h0=with_h0)
        y, hT = ps.selective_scan_fwd(u, delta, A, Bm, Cm, Dsk, h0)
        y2, hT2, ck = ps.selective_scan_fwd_ckpt(u, delta, A, Bm, Cm, Dsk, h0)
        plain_fwd_ms, (y_w, hT_w, ck_w) = _events_ms(
            torch, lambda: ps.scan_ckpt_ref(u, delta, A, Bm, Cm, Dsk, h0))
        check(torch.equal(y, y2) and torch.equal(hT, hT2), "scan: the two forward kernels differ")
        errs = {"y": _errs(y, y_w), "h_T": _errs(hT, hT_w), "ckpt": _errs(ck, ck_w)}
        del y_w, hT_w
        g = torch.Generator(device="cuda").manual_seed(1)
        dy = torch.randn((B, T_, D), generator=g, device="cuda")
        dhT = torch.randn((B, N, D), generator=g, device="cuda")
        got = ps.selective_scan_bwd(u, delta, A, Bm, Cm, ck, dy, dhT)
        again = ps.selective_scan_bwd(u, delta, A, Bm, Cm, ck, dy, dhT)
        check(all(torch.equal(a, b) for a, b in zip(got, again)), "scan backward: reruns differ")
        del again
        plain_bwd_ms, want = _events_ms(torch, lambda: ps.scan_bwd_ref(u, delta, A, Bm, Cm, ck_w, dy, dhT))
        for name, a, b in zip("du ddt dB dC dA_b dh0".split(), got, want):
            errs[name] = _errs(a, b)
        del got, want, ck_w
        emit({"phase": "scan_kernels", "B": B, "T": T_, "D": D, "N": N, "h0": with_h0,
              "abs_and_rel_errors": errs, "limits": {"y": 1e-2, "h_T": 1e-4, "ckpt": 1e-4, "grads": 1e-3}})
        check(errs["y"][1] <= 1e-2, f"scan y: relative error {errs['y'][1]}")
        for k in ("h_T", "ckpt"):
            check(errs[k][1] <= 1e-4, f"scan {k}: relative error {errs[k][1]}")
        for k in "du ddt dB dC dA_b dh0".split():
            check(errs[k][1] <= 1e-3, f"scan backward {k}: relative error {errs[k][1]}")
        fwd_err = max(errs[k][0] for k in ("y", "h_T"))
        out["selective_scan_fwd"]["max_abs_err"] = max(out["selective_scan_fwd"]["max_abs_err"], fwd_err)
        out["selective_scan_fwd_ckpt"]["max_abs_err"] = max(
            out["selective_scan_fwd_ckpt"]["max_abs_err"], fwd_err, errs["ckpt"][0])
        out["selective_scan_bwd"]["max_abs_err"] = max(
            out["selective_scan_bwd"]["max_abs_err"], *(errs[k][0] for k in "du ddt dB dC dA_b dh0".split()))
        if T_ != T:
            continue
        calls = {"selective_scan_fwd": lambda: ps.selective_scan_fwd(u, delta, A, Bm, Cm, Dsk),
                 "selective_scan_fwd_ckpt": lambda: ps.selective_scan_fwd_ckpt(u, delta, A, Bm, Cm, Dsk),
                 "selective_scan_bwd": lambda: ps.selective_scan_bwd(u, delta, A, Bm, Cm, ck, dy, dhT)}
        clock_before = sm_clock()
        times = {k: device_ms(torch, lambda i, f=f: f(), 20 if "fwd" in k else 10) for k, f in calls.items()}
        clock_after = sm_clock()
        plain = {"selective_scan_fwd": plain_fwd_ms, "selective_scan_fwd_ckpt": plain_fwd_ms,
                 "selective_scan_bwd": plain_bwd_ms}
        row = {}
        for k in times:
            bound, by, nbytes, parts = _scan_bound(k, B, T, D, N, ps.CHUNK)
            row[k] = dict(ms=times[k], plain_ms=plain[k], bound_ms=bound, bound_by=by,
                          bound_parts_ms=parts, bytes=nbytes, times_bound=times[k] / bound)
        plan = ps.scan_launch_plan(B, T, D, N)
        emit({"phase": "scan_kernels", "B": B, "T": T, "times": row, "sm_clock_before_after": [clock_before, clock_after],
              "device_kernels_per_call": {k: kernels_per_call(torch, f) for k, f in calls.items()},
              "launch_plan": {f: dataclasses.asdict(getattr(plan, f)) for f in
                              ("fwd_summary", "fwd_carry", "fwd_output", "bwd_summary", "bwd_carry", "bwd_grad")}})
        for k, r in row.items():
            if B == 2:
                out[k].update(r, library_ms=None, at=f"B=2, T={T}, D={D}, N={N}, bf16 u/B/C, f32 dt",
                              sm_clock=clock_after)
            else:
                out[k]["B8"] = dict(r, sm_clock=clock_after)
        del u, delta, Bm, Cm, ck, dy, dhT, y, y2, hT, hT2
        torch.cuda.empty_cache()
    return out


def phase_flash_kernels(torch):
    """The flash kernels against autograd through the plain materialized
    softmax at the flagship training step's shapes (B=2 of its 8 rows) and a
    ragged shape, a third of one row's keys masked; µs per launch forward and
    backward beside the plain version and ``scaled_dot_product_attention``,
    with the achieved TFLOP/s and the share of the bound (the backward's
    bound counts 5 products; its kernels execute 7).  Limit 2e-2 of each
    output's largest magnitude: the kernels round P and dS to bf16 at the
    tensor-core products' inputs, the plain version rounds the probabilities,
    and both round outputs to bf16."""
    import torch.nn.functional as F

    from mamba_tts_torch.ops import flash_attention as fa

    out = {k: {"max_abs_err": 0.0} for k in TRAIN_KERNELS[3:]}
    scale = 64 ** -0.5
    for B, H, Tq, Tk in ((2, 8, 5120, 5376), (2, 8, 640, 1427)):
        g = torch.Generator(device="cuda").manual_seed(Tq + Tk)
        q, K, V, dO = (torch.randn((B, H, T, 64), generator=g, device="cuda").bfloat16()
                       for T in (Tq, Tk, Tk, Tq))
        mask = torch.ones((B, Tk), dtype=torch.bool, device="cuda")
        mask[0, Tk // 3: 2 * Tk // 3] = False

        def run(fn):
            leaves = [t.detach().clone().requires_grad_() for t in (q, K, V)]
            o = fn(*leaves, mask, scale)
            o.backward(dO)
            return [o.detach()] + [t.grad for t in leaves]

        got = run(fa.flash_attention)
        want = run(fa.flash_attention_ref)
        errs = {n: _errs(a, b) for n, a, b in zip(("O", "dq", "dK", "dV"), got, want)}
        emit({"phase": "flash_kernels", "B": B, "H": H, "Tq": Tq, "Tk": Tk,
              "abs_and_rel_errors": errs, "limit": 2e-2})
        for n, (_, rel) in errs.items():
            check(rel <= 2e-2, f"flash {n} at Tq={Tq}, Tk={Tk}: relative error {rel}")
        out["flash_attention_fwd"]["max_abs_err"] = max(out["flash_attention_fwd"]["max_abs_err"], errs["O"][0])
        out["flash_attention_bwd"]["max_abs_err"] = max(
            out["flash_attention_bwd"]["max_abs_err"], *(errs[n][0] for n in ("dq", "dK", "dV")))
        if Tq != 5120:
            continue
        O, lse = fa.flash_attention_fwd(q, K, V, mask, scale)
        fwd_ms = device_ms(torch, lambda i: fa.flash_attention_fwd(q, K, V, mask, scale), 5)
        bwd_ms = device_ms(torch, lambda i: fa.flash_attention_bwd(q, K, V, mask, O, lse, dO, scale), 3)
        plain_fwd_ms, _ = _events_ms(torch, lambda: fa.flash_attention_ref(q, K, V, mask, scale))
        leaves = [t.detach().clone().requires_grad_() for t in (q, K, V)]
        ref = fa.flash_attention_ref(*leaves, mask, scale)
        plain_bwd_ms, _ = _events_ms(torch, lambda: torch.autograd.grad(ref, leaves, dO, retain_graph=True))
        del ref
        bias_mask = mask[:, None, None, :]
        lib_fwd_ms = device_ms(torch, lambda i: F.scaled_dot_product_attention(
            q, K, V, attn_mask=bias_mask, scale=scale), 5)
        lib_leaves = [t.detach().clone().requires_grad_() for t in (q, K, V)]
        lib_out = F.scaled_dot_product_attention(*lib_leaves, attn_mask=bias_mask, scale=scale)
        lib_bwd_ms = device_ms(torch, lambda i: torch.autograd.grad(lib_out, lib_leaves, dO,
                                                                    retain_graph=True), 3)
        del lib_out
        mac = B * H * Tq * Tk * 64
        io = 2 * (B * H * Tq * 64 + 2 * B * H * Tk * 64) + B * Tk
        for k, ms, pms, lms, flops, nbytes in (
                ("flash_attention_fwd", fwd_ms, plain_fwd_ms, lib_fwd_ms, 4 * mac,
                 io + 2 * B * H * Tq * 64 + 4 * B * H * Tq),
                ("flash_attention_bwd", bwd_ms, plain_bwd_ms, lib_bwd_ms, 10 * mac,
                 io + 2 * 2 * B * H * Tq * 64 + 4 * B * H * Tq + 2 * (B * H * Tq * 64 + 2 * B * H * Tk * 64))):
            by_ops, by_bytes = flops / BF16_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
            out[k].update(ms=ms, plain_ms=pms, library_ms=lms, bound_ms=max(by_ops, by_bytes),
                          bound_by="operations" if by_ops >= by_bytes else "bytes", flops=flops,
                          tflops=flops / ms / 1e9, bound_share=max(by_ops, by_bytes) / ms,
                          at=f"B={B}, H={H}, Tq={Tq}, Tk={Tk}, head_dim 64, bf16, a third of one row's keys masked")
        out["flash_attention_bwd"]["executed_tflops"] = 14 * mac / bwd_ms / 1e9  # 7 products
        emit({"phase": "flash_kernels", "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "plain_fwd_ms": plain_fwd_ms,
              "plain_bwd_ms": plain_bwd_ms, "sdpa_fwd_ms": lib_fwd_ms, "sdpa_bwd_ms": lib_bwd_ms,
              "bound_ms": {k: out[k]["bound_ms"] for k in out},
              "tflops": {k: out[k]["tflops"] for k in out},
              "bound_share": {k: out[k]["bound_share"] for k in out},
              "bwd_executed_tflops": out["flash_attention_bwd"]["executed_tflops"]})
    return out


def _full_model(torch, cfg, seed=0, device="cuda"):
    from mamba_tts_torch.models.layers import seed_init
    from mamba_tts_torch.models.tts import MambaTTS

    return seed_init(MambaTTS(cfg), seed).to(device)


def phase_forward_vs_decode(torch, steps=128, frames=1024):
    """The teacher-forced forward without a gradient (the no-checkpoint scan
    kernel and the flash forward) against the plain bf16 step decode's
    logits on the same tokens: ``steps`` greedy decode steps (>= 128 so that
    the forward's attention takes the flash kernel), then one forward over
    [BOS, tokens[:-1]].  Limits of the card-against-CPU decode check:
    relative max logit error <= 3e-2, argmax agreement >= 90%."""
    from mamba_tts_torch.config import TTSConfig

    cfg = TTSConfig()
    model = _full_model(torch, cfg).eval()
    dec, dc = model.decoder, cfg.decoder
    g = torch.Generator(device="cuda").manual_seed(2)
    L = cfg.data.max_text_len
    ids = torch.randint(1, cfg.text_encoder.vocab_size, (1, L), generator=g, device="cuda")
    mask = torch.arange(L, device="cuda")[None] < 40
    voice = torch.randint(2, dc.vocab_size_audio, (1, 256, dc.num_quantizers), generator=g, device="cuda")
    with torch.no_grad():
        th = model.encode_text(ids * mask, mask)
        z = model.sample_style(torch.randn((1, cfg.smsd.bert_dim), generator=g, device="cuda"), g)
        rh, rm = model.embed_voice(voice)
        KV, mm, films = dec.project_memories(th, mask, rh, rm, z)
        states = dec.init_states(1)
        tok = torch.full((1, 1), dc.bos_id, dtype=torch.long, device="cuda")
        index = torch.arange(steps, device="cuda")
        step_logits, toks = [], []
        for t in range(steps):
            lg, states = dec.step_with_kv(tok, KV, mm, films, states, index[t:t + 1], frames)
            step_logits.append(lg[:, 0].float())
            masked = lg[:, 0].float().clone()
            masked[:, :dc.num_special_tokens] = -1e9
            tok = masked.argmax(-1, keepdim=True)
            toks.append(tok)
        toks = torch.cat(toks, dim=1)
        inputs = torch.cat([torch.full((1, 1), dc.bos_id, dtype=torch.long, device="cuda"),
                            toks[:, :-1]], dim=1)
        before = {k: w.launches for k, w in _wrappers().items()}
        fwd = dec(inputs, th, z, mask, rh, rm, quant_ids=torch.zeros_like(inputs),
                  pos_ids=torch.arange(steps, device="cuda")[None])[0].float()
        after = {k: w.launches - before[k] for k, w in _wrappers().items()}
    step_logits = torch.cat(step_logits)
    sp = dc.num_special_tokens
    rel = _errs(fwd[:, sp:], step_logits[:, sp:])[1]
    agree = float((fwd[:, sp:].argmax(-1) == step_logits[:, sp:].argmax(-1)).float().mean())
    row = {"phase": "forward_vs_decode", "steps": steps, "rel_max_logit_err": rel,
           "argmax_agreement": agree, "limits": {"rel": 3e-2, "agree": 0.9}, "launches": after}
    emit(row)
    check(after["selective_scan_fwd"] == dc.n_layers and after["flash_attention_fwd"] == dc.n_layers,
          f"teacher-forced forward: kernel launches {after}")
    check(rel <= 3e-2, f"forward vs step decode: relative max logit error {rel}")
    check(agree >= 0.9, f"forward vs step decode: argmax agreement {agree}")
    return row


def phase_train_cli(torch, tmp):
    """``python -m mamba_tts_torch.train.train`` at the CLI's defaults (full
    width, B = 10, synthetic 0.4 s items -> 128 frames -> Tq = 640): 4 steps
    with a checkpoint every 2, then --resume to step 6."""
    from mamba_tts_torch.train import train as tr

    args = ["--synthetic", "--checkpoint_every", "2", "--checkpoint_dir", str(tmp / "ck"),
            "--log_file", str(tmp / "train.jsonl")]
    t0 = time.perf_counter()
    first = tr.main(args + ["--max_steps", "4"])
    t1 = time.perf_counter()
    second = tr.main(args + ["--max_steps", "6", "--resume"])
    t2 = time.perf_counter()
    losses = [h[k] for run in (first, second) for h in run["history"] for k in h if k != "step"]
    import math

    check(all(math.isfinite(v) for v in losses), "trainer CLI: a non-finite loss")
    check((first["start_step"], first["step"], second["start_step"], second["step"]) == (0, 4, 4, 6),
          f"trainer CLI steps: {first['start_step']}->{first['step']}, resume "
          f"{second['start_step']}->{second['step']}")
    check((tmp / "ck" / "4" / "state.pt").is_file() and (tmp / "ck" / "6" / "state.pt").is_file(),
          "trainer CLI: checkpoints 4 and 6 missing")
    row = {"phase": "train_cli", "ms_per_step": first["ms_per_step"],
           "resumed_ms_per_step": second["ms_per_step"], "wall_seconds": [t1 - t0, t2 - t1],
           "loss_total": [h["loss_total"] for run in (first, second) for h in run["history"]]}
    emit(row)
    return row


def phase_checkpoint_serving(torch, tmp, voice, frames=128):
    """Serve what phase 12's train CLI wrote (``config.json`` and checkpoints
    4 and 6 at full width) through ``load_synthesizer(checkpoint_dir=...)``
    with no config: the CLI's config, the parameters of checkpoint 6 bit for
    bit (``style_pipe`` included) and not the seeded init; one request each
    with quant none, int8 and megakernel (their kernels' counts set to 0
    just before and read just after); the megakernel on the trained weights
    against its plain version, teacher-forced, at phase 6's limits.
    Returns the decode kernels' launch counts."""
    from mamba_tts_torch import config as config_lib
    from mamba_tts_torch.config import TTSConfig
    from mamba_tts_torch.infer.synthesize import Synthesizer, load_synthesizer
    from mamba_tts_torch.models.layers import seed_init
    from mamba_tts_torch.models.tts import MambaTTS
    from mamba_tts_torch.ops import decode_megakernel as mk
    from mamba_tts_torch.train import state as state_lib

    ck = tmp / "ck"
    t0 = time.perf_counter()
    synth = load_synthesizer(checkpoint_dir=str(ck), quant="megakernel", device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cfg = synth.cfg
    check(cfg == config_lib.override(TTSConfig(), "train.max_steps", 6)
          and cfg == config_lib.from_json((ck / "config.json").read_text()),
          "checkpoint serving: the config is not the train CLI's")
    params, restored = state_lib.restore_params(str(ck))
    own = dict(synth.model.named_parameters())
    check(restored and set(own) == set(params), "checkpoint serving: parameter names differ")
    check(all(torch.equal(own[n].cpu(), params[n]) for n in params),
          "checkpoint serving: a parameter differs from checkpoint 6")
    init = dict(seed_init(MambaTTS(cfg), 0).named_parameters())
    moved = sum(not torch.equal(params[n], init[n]) for n in params)
    check(moved > 0 and not torch.equal(params["decoder.head.weight"], init["decoder.head.weight"]),
          "checkpoint serving: the parameters are the seeded init")
    emit({"phase": "checkpoint_serving", "load_seconds": load_s, "step": 6,
          "parameters": len(params), "style_pipe_parameters":
          sum(n.startswith("style_pipe.") for n in params), "moved_from_init": moved})

    per_step = 6 * cfg.decoder.n_layers
    launches = {"int8_matvec": 0, "decode_megakernel": 0, "decode_attention": 0, "mamba_step": 0}
    for quant in ("none", "int8", "megakernel"):
        served = synth if quant == "megakernel" else Synthesizer(
            cfg, synth.model, tokenizer=synth.tokenizer, frontend=synth.frontend,
            style_encoder=synth.style_encoder, quant=quant, device="cuda")
        read = _zero_counts()
        emit(_timed_request(torch, served, lambda: served.synthesize(TEXT, STYLE, voice,
                                                                     frames=frames),
                            frames, 1, {"phase": "checkpoint_serving",
                                        "request": f"trained_{quant}"})[1])
        n = read()
        steps = cfg.decoder.num_quantizers * frames
        want = {"none": {"int8_matvec": 0, "decode_megakernel": 0,
                         "decode_attention": cfg.decoder.n_layers * steps,
                         "mamba_step": 2 * cfg.decoder.n_layers * steps},
                "int8": {"int8_matvec": per_step * steps, "decode_megakernel": 0,
                         "decode_attention": 0, "mamba_step": 0},
                "megakernel": {"int8_matvec": 0, "decode_megakernel": 1,
                               "decode_attention": 0, "mamba_step": 0}}[quant]
        check(n == want, f"checkpoint serving, quant={quant}: launches {n}, expected {want}")
        launches = {k: launches[k] + v for k, v in n.items()}

    dec, dc = synth.decoder, synth.decoder.cfg
    th, mask, rh, rm, z = _condition(torch, synth)
    mframes = 8
    with torch.no_grad():
        KV, mm, films = dec.project_memories(th, mask, rh, rm, z)
        wd, kvd = mk.megakernel_fit(dc, 1, KV[0][0].shape[2])
        plan = mk._build_plan(dc, synth._qparams, KV, mm, films, mframes, weight_dtype=wd,
                              kv_dtype=kvd, weight_plan=synth._weight_plans[wd])
        forced = _forced(torch, dc, dc.num_quantizers * mframes, 1, seed=6)
        got = mk._megakernel_call(dc, plan, mframes, forced)
        want = mk.decode_megakernel_ref(dc, plan, mframes, forced)
    torch.cuda.synchronize()
    _hold_to_plain(torch, dc, got, want, "trained_weights_teacher_forced", B=1, weights=wd, kv=kvd)
    return launches


def phase_released_weights(torch, tmp, voice, frames=128, seed=0):
    """FACodec and BERT state dicts in the released files' naming and shapes
    (``tests/data/*_manifest.json``), drawn from a seed with weight-norm
    ``g = ||v||`` and Snake alpha near 1 so that the fused weights keep the
    init's scale, saved with ``torch.save`` and served: one megakernel
    request through ``load_synthesizer(codec_ckpts=...)`` with a
    ``StyleTextEncoder(checkpoint=...)``.  Checks that every file key was
    read, that every fused FACodec weight equals ``g * v / ||v||`` computed
    from the file, and a finite waveform.  Returns the megakernel launches."""
    import numpy as np

    from mamba_tts_torch.config import TTSConfig
    from mamba_tts_torch.infer.synthesize import load_synthesizer
    from mamba_tts_torch.models import style_text_encoder as ste

    rng = np.random.default_rng(seed)

    def draw(manifest):
        sd = {}
        for k, shape in manifest.items():
            module, leaf = k.rsplit(".", 2)[-2:]
            if leaf.endswith("bias") or leaf == "beta":
                sd[k] = np.zeros(shape, np.float32)
            elif leaf == "alpha":
                sd[k] = (1.0 + 0.05 * rng.standard_normal(shape)).astype(np.float32)
            elif "ln" in module or module == "LayerNorm":
                sd[k] = np.ones(shape, np.float32)
            elif leaf != "weight_g":
                fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else 1
                sd[k] = (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        for k in manifest:  # g = ||v|| over v's axes beyond the first
            if k.endswith(".weight_g"):
                v = sd[k[:-1] + "v"]
                sd[k] = np.sqrt((v ** 2).sum(axis=(1, 2), keepdims=True)).astype(np.float32)
        return {k: torch.from_numpy(v) for k, v in sd.items()}

    man = {n: json.loads((pathlib.Path("tests/data") / f"{n}_manifest.json").read_text())
           for n in ("facodec_consumed", "bert_base_uncased")}
    t0 = time.perf_counter()
    files = {}
    for name, sd in (("encoder", draw(man["facodec_consumed"]["encoder"])),
                     ("decoder", draw(man["facodec_consumed"]["decoder"])),
                     ("bert", draw(man["bert_base_uncased"]["raw_bin"]))):
        files[name] = tmp / f"released_{name}.bin"
        torch.save(sd, files[name])
    cfg = TTSConfig()
    synth = load_synthesizer(cfg, codec_ckpts=(str(files["encoder"]), str(files["decoder"])),
                             quant="megakernel", device="cuda")
    bert_sd = torch.load(files["bert"], weights_only=True)
    synth.style_encoder = ste.StyleTextEncoder(cfg.style_encoder, checkpoint=bert_sd,
                                               device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0

    # every key read: one port parameter per FACodec leaf the files give
    # (the bridge leaves none unset), one BERT parameter per non-head key
    # (weight_g and weight_v fuse into one; in_proj_weight and in_proj_bias
    # split into q, k and v)
    codec_params = list(synth.tokenizer.module.parameters())
    n_codec_keys = sum({"weight_g": 0, "in_proj_weight": 3, "in_proj_bias": 3}.get(
        k.rsplit(".", 1)[-1], 1) for part in ("encoder", "decoder")
        for k in man["facodec_consumed"][part])
    bert_keys = [k for k in bert_sd if not k.startswith(("cls.", "bert.pooler."))]
    check(len(codec_params) == n_codec_keys, f"released FACodec: {len(codec_params)} "
          f"parameters for {n_codec_keys} file tensors")
    check(len(list(synth.style_encoder.module.parameters())) == len(bert_keys),
          "released BERT: a key was not loaded")
    # every fused weight is g * v / ||v|| from the file, in the port's layout
    # (conv and transposed conv as stored, 1x1 convs squeezed to Dense)
    fused = []
    for part in ("encoder", "decoder"):
        sd = torch.load(files[part], weights_only=True)
        for k in sd:
            if k.endswith(".weight_g"):
                v = sd[k[:-1] + "v"].double()
                w = (sd[k].double() * v / v.norm(dim=(1, 2), keepdim=True)).float()
                fused.append(w[:, :, 0] if w.shape[2] == 1 and "quantizer" in k else w)
    by_shape = {}
    for p in codec_params:
        by_shape.setdefault(tuple(p.shape), []).append(p.detach().cpu())
    worst = 0.0
    for w in fused:
        errs = [float((p - w).abs().max() / w.abs().max()) for p in by_shape.get(tuple(w.shape), [])]
        check(bool(errs) and min(errs) <= 1e-5, f"released FACodec: no parameter equals a fused "
              f"weight of shape {tuple(w.shape)}")
        worst = max(worst, min(errs))

    read = _zero_counts()
    emit(_timed_request(torch, synth, lambda: synth.synthesize(TEXT, STYLE, voice, frames=frames),
                        frames, 1, {"phase": "released_weights", "request": "released_megakernel"})[1])
    n = read()
    check(n == {"int8_matvec": 0, "decode_megakernel": 1, "decode_attention": 0, "mamba_step": 0},
          f"released weights: launches {n}")
    emit({"phase": "released_weights", "load_seconds": load_s, "facodec_parameters": len(codec_params),
          "bert_parameters": len(bert_keys), "fused_weights": len(fused),
          "fused_max_rel_err": worst})
    return n["decode_megakernel"]


def phase_style_branch(torch, synth, tmp, steps=5, profiled_steps=2):
    """The NAR style branch at full width: ``nar_frames`` for the script's
    four texts (B=4, max_frame_len 1,024) on the card against the CPU (2e-2
    of the largest magnitude, the bf16 tolerance of the CPU tests), on
    durations that spread 1,200, 256, 640 and 512 frames over each text's
    phonemes (``heuristic_durations``; the random model predicts under a
    frame a phoneme, which would leave every frame empty); then
    ``make_train_step(..., use_nar_branch=True)`` at the CLI's default batch
    (B=10, synthetic data) beside the default step, timed in turns (default,
    branch, branch, default), then each under torch.profiler in the same
    turns (device busy ms and device kernels a step: the branch adds device
    work only, which the host-bound step's wall does not resolve): finite
    losses, every ``style_pipe`` gradient exactly zero and its weights
    unchanged, ms a step of each."""
    import math

    from torch.profiler import ProfilerActivity, profile

    from mamba_tts_torch.config import TTSConfig
    from mamba_tts_torch.data.dataset import VccmTTSDataset, make_synthetic_dataset
    from mamba_tts_torch.models.tts import heuristic_durations
    from mamba_tts_torch.train import state as state_lib
    from mamba_tts_torch.train import train as tr
    from mamba_tts_torch.train.pipeline import BatchPreparer

    model = synth.model
    ids, _, mask = synth.frontend.encode_batch(TEXTS, pad_to=synth.cfg.data.max_text_len)
    ids, mask = (torch.as_tensor(a, device="cuda") for a in (ids, mask))
    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        th = model.encode_text(ids.long(), mask.bool())
        z = model.sample_style(synth.style_encoder.embed(STYLES), g)
        dur = heuristic_durations(mask.bool(), torch.tensor([1200, 256, 640, 512], device="cuda"))
        got = model.nar_frames(th, z, dur.float(), mask.bool(), 1024)
        pipe = copy.deepcopy(model.style_pipe).cpu()
        want = pipe(th.cpu(), z.cpu(), dur.float().cpu(), mask.bool().cpu(), 1024)
    check(torch.equal(got[1].cpu(), want[1]), "nar_frames: frame counts differ, card vs CPU")
    rel = max(float((a.cpu().float() - b.float()).abs().max() / b.float().abs().max())
              for a, b in zip((got[0], got[2], got[3]), (want[0], want[2], want[3])))
    row = {"phase": "style_branch", "check": "nar_frames_card_vs_cpu", "B": 4,
           "frames": [int(n) for n in got[1].tolist()], "max_frame_len": 1024,
           "shape": list(got[0].shape), "rel_max_err": rel, "limit": 2e-2}
    emit(row)
    check(rel <= 2e-2, f"nar_frames card vs CPU: relative error {rel}")

    cfg = TTSConfig()
    B = cfg.train.batch_size
    csv_path, tar_path = make_synthetic_dataset(str(tmp / "style"), n_items=2 * B)
    inputs, target_wav = next(VccmTTSDataset(csv_path, tar_path, seed=0).batches(B, seed=0))
    batch = tr.batch_to_device(BatchPreparer(cfg, device="cuda")(inputs, target_wav),
                               torch.device("cuda"))
    runs = {}
    for branch in (False, True):
        model = _full_model(torch, cfg)
        params = dict(model.named_parameters())
        tx = state_lib.make_optimizer(cfg.train.lr, cfg.train.grad_clip_norm)
        seen, apply = {}, tx.apply

        def spy(params, grads, opt_state, seen=seen, apply=apply, **kw):
            seen.update({n: bool(torch.any(gr)) for n, gr in grads.items()
                         if n.startswith("style_pipe.")})
            return apply(params, grads, opt_state, **kw)

        tx.apply = spy
        runs[branch] = {"step": tr.make_train_step(model, tx, use_nar_branch=branch),
                        "st": state_lib.create_train_state(params, tx), "seen": seen,
                        "params": params, "ms": [], "losses": [],
                        "before": {n: p.detach().clone() for n, p in params.items()
                                   if n.startswith("style_pipe.")}}
        runs[branch]["st"], _ = runs[branch]["step"](runs[branch]["st"], batch)  # warm-up
    for branch in (False, True, True, False):  # in turns: default, branch, branch, default
        r = runs[branch]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            r["st"], lo = r["step"](r["st"], batch)
            r["losses"].append({k: float(v) for k, v in lo.items()})
        torch.cuda.synchronize()
        r["ms"].append((time.perf_counter() - t0) / steps * 1e3)
    for r in runs.values():
        r["busy_ms"], r["kernels"] = [], []
    for branch in (False, True, True, False):
        r = runs[branch]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(profiled_steps):
                r["st"], lo = r["step"](r["st"], batch)
                r["losses"].append({k: float(v) for k, v in lo.items()})
            torch.cuda.synchronize()
        _, busy, count = _device(prof)
        r["busy_ms"].append(busy / profiled_steps)
        r["kernels"].append(count / profiled_steps)
    for branch, r in runs.items():
        nonzero = sum(r["seen"].values())
        changed = sum(not torch.equal(r["before"][n], r["params"][n]) for n in r["before"])
        check(all(math.isfinite(v) for lo in r["losses"] for v in lo.values()),
              f"use_nar_branch={branch}: a non-finite loss")
        check(len(r["seen"]) == len(r["before"]) > 0 and nonzero == 0 and changed == 0,
              f"use_nar_branch={branch}: {nonzero} style_pipe gradients not zero, "
              f"{changed} style_pipe weights changed")
    emit({"phase": "style_branch", "check": "train_step", "B": B, "steps": steps,
          "order": "default, branch, branch, default",
          "default_ms_per_step": runs[False]["ms"], "nar_branch_ms_per_step": runs[True]["ms"],
          "profiled_steps": profiled_steps,
          "default_device_busy_ms_per_step": runs[False]["busy_ms"],
          "nar_branch_device_busy_ms_per_step": runs[True]["busy_ms"],
          "default_kernels_per_step": runs[False]["kernels"],
          "nar_branch_kernels_per_step": runs[True]["kernels"],
          "style_pipe_gradients_all_zero": True,
          "losses": {"default": runs[False]["losses"], "nar_branch": runs[True]["losses"]}})
    return runs


def _flagship_batch(torch, tmp, B=8):
    """The flagship training batch on the card: B = 8, 1,024 target frames
    (Tq = 5,120) and 1,024-frame voice prompts (Tk = 5 x 1,024 + 256), from
    the port's BatchPreparer over 12.8 s synthetic items."""
    from mamba_tts_torch.config import TTSConfig
    from mamba_tts_torch.data.dataset import VccmTTSDataset, make_synthetic_dataset
    from mamba_tts_torch.train import train as tr
    from mamba_tts_torch.train.pipeline import BatchPreparer

    cfg = TTSConfig()
    csv_path, tar_path = make_synthetic_dataset(str(tmp / "flagship"), n_items=B, seconds=12.8)
    inputs, target_wav = next(VccmTTSDataset(csv_path, tar_path, seed=0).batches(B, seed=0))
    batch = tr.batch_to_device(BatchPreparer(cfg, device="cuda")(inputs, target_wav), torch.device("cuda"))
    Q = cfg.decoder.num_quantizers
    check(tuple(batch["target_codec"].shape) == (B, 1024, Q) and tuple(batch["voice_codec"].shape) == (B, 1024, Q),
          f"flagship batch: target {tuple(batch['target_codec'].shape)}, voice {tuple(batch['voice_codec'].shape)}")
    return batch


def phase_flagship_step(torch, batch, steps=3):
    """Flagship-length training steps on :func:`_flagship_batch`'s batch: ms
    per step, target tokens per second, peak memory, calls per step of each
    training kernel, and the device's idle share and top kernels over one
    profiled step."""
    from torch.profiler import ProfilerActivity, profile

    from mamba_tts_torch.config import TTSConfig
    from mamba_tts_torch.train import state as state_lib
    from mamba_tts_torch.train import train as tr

    cfg = TTSConfig()
    B = batch["target_codec"].shape[0]
    Q = cfg.decoder.num_quantizers
    model = _full_model(torch, cfg)
    params = dict(model.named_parameters())
    tx = state_lib.make_optimizer(cfg.train.lr, cfg.train.grad_clip_norm)
    st = state_lib.create_train_state(params, tx)
    step = tr.make_train_step(model, tx)
    st, _ = step(st, batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {k: w.launches for k, w in _wrappers().items()}
    t0 = time.perf_counter()
    losses = []
    for _ in range(steps):
        st, lo = step(st, batch)
        losses.append({k: float(v) for k, v in lo.items()})
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    per_step = {k: (w.launches - before[k]) / steps for k, w in _wrappers().items()}
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        st, _ = step(st, batch)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t1) * 1e3
    kernels = _device_kernels(prof)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    ours = [e for e in kernels if re.search(
        r"::(scan_fwd_summary|scan_fwd_output|scan_bwd_summary|scan_bwd_grad|scan_carry"
        r"|flash_fwd|flash_bwd_dkdv|flash_bwd_dq|flash_bwd_delta)\b", e.key)]
    scan_ms = sum(dev_us(e) for e in ours if "::scan_" in e.key) / 1e3
    tokens = B * 1024 * Q
    row = {"phase": "flagship_step", "B": B, "Tq": 1024 * Q, "Tk": 1024 * Q + cfg.data.max_text_len,
           "ms_per_step": wall * 1e3, "target_tokens_per_s": tokens / wall,
           "max_memory_allocated_gb": peak / 1e9, "kernel_calls_per_step": per_step,
           "profiled_step_ms": prof_wall_ms, "device_busy_ms": busy_ms or None,
           "scan_device_ms": scan_ms, "scan_share_of_busy": scan_ms / busy_ms if busy_ms else None,
           "sm_clock": sm_clock(),
           "device_idle_share": 1 - busy_ms / prof_wall_ms if busy_ms else None,
           "losses": losses,
           "top_kernels": [{"name": e.key[:80], "device_ms": dev_us(e) / 1e3, "calls": e.count}
                           for e in top],
           "training_kernels_us_per_call": {e.key[:60]: dev_us(e) / e.count for e in ours}}
    emit(row)
    import math

    check(all(math.isfinite(v) for lo in losses for v in lo.values()), "flagship step: non-finite loss")
    for k, n in per_step.items():
        check(n == cfg.decoder.n_layers or k == "selective_scan_fwd",
              f"flagship step: {n} calls of {k} per step, expected {cfg.decoder.n_layers}")
    return row


REMAT_TOL = 1e-5  # relative, per component: remat reruns the same kernels on the same inputs


def _grad_diffs(torch, got, want):
    """Per component (each decoder layer on its own, else the top-level
    module): the largest |got - want| over the largest |want|, and whether
    every gradient of it is bit-equal (host tensors)."""
    groups = {}
    for n in want:
        parts = n.split(".")
        groups.setdefault(".".join(parts[:2]) if n.startswith("decoder.layer_") else parts[0], []).append(n)
    rows = {}
    for comp, names in groups.items():
        d = max(float((got[n] - want[n]).abs().max()) for n in names)
        m = max(float(want[n].abs().max()) for n in names)
        rows[comp] = {"rel": d / max(m, 1e-30),
                      "bit_equal": all(torch.equal(got[n], want[n]) for n in names)}
    return rows


def phase_remat_step(torch, batch, steps=3):
    """The flagship training step with ``DecoderConfig.remat`` (each decoder
    layer under ``torch.utils.checkpoint``, recomputed in the backward),
    beside the same step without it, on the same seeded weights and batch.
    Each run's first step gives the gradients before the optimizer (the
    train step's ``out``) and the training kernels' calls; the run without
    remat takes that step twice from the same state, a witness of how far
    two runs of one step differ.  Then ``steps`` timed steps with
    ``torch.cuda.max_memory_allocated()``.  The counts are set to 0 just
    before the remat run and read just after it.  Checks: losses and every
    component's gradients within REMAT_TOL relative of the step without
    remat; per step 2 x n_layers calls of each forward kernel and n_layers
    of each backward under remat, n_layers of each without; lower peak
    memory with remat."""
    import dataclasses
    import math

    from mamba_tts_torch.config import TTSConfig
    from mamba_tts_torch.train import state as state_lib
    from mamba_tts_torch.train import train as tr

    t_phase = time.perf_counter()
    base = TTSConfig()
    L = base.decoder.n_layers
    B, S, Q = batch["target_codec"].shape
    runs = {}
    for remat in (False, True):
        cfg = dataclasses.replace(base, decoder=dataclasses.replace(base.decoder, remat=remat))
        model = _full_model(torch, cfg)
        params = dict(model.named_parameters())
        tx = state_lib.make_optimizer(cfg.train.lr, cfg.train.grad_clip_norm)
        step = tr.make_train_step(model, tx)
        wrappers = _wrappers()

        def first_step():
            """One step from a fresh state with the counts from 0: (state,
            losses, gradients before the optimizer on the host, calls)."""
            for w in wrappers.values():
                w.launches = 0
            out = {}
            st, lo = step(state_lib.create_train_state(params, tx), batch, out=out)
            return (st, {k: float(v) for k, v in lo.items()},
                    {n: g.cpu() for n, g in out["grads"].items()},
                    {k: w.launches for k, w in wrappers.items()})

        if not remat:
            snapshot = {n: p.detach().clone() for n, p in params.items()}
            witness_losses, witness_grads = first_step()[1:3]
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(snapshot[n])
            del snapshot
        st, losses, grads, per_step = first_step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rest = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        for _ in range(steps):
            st, _ = step(st, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps
        runs[remat] = {"ms_per_step": wall * 1e3, "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "resting_gb": rest / 1e9, "kernel_calls_per_step": per_step,
                       "launches": {k: w.launches for k, w in wrappers.items()},
                       "losses": losses, "grads": grads}
        if not remat:
            runs[remat]["witness"] = {"losses": witness_losses, "grads": witness_grads}
        del model, params, st, step, tx
        torch.cuda.empty_cache()
    plain, rem = runs[False], runs[True]

    def loss_rel(a, b):
        return {k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for k in b}

    grad_rel = _grad_diffs(torch, rem["grads"], plain["grads"])
    witness_rel = _grad_diffs(torch, plain["witness"]["grads"], plain["grads"])
    row = {"phase": "remat_step", "B": B, "Tq": S * Q, "Tk": S * Q + base.data.max_text_len,
           "timed_steps": steps,
           **{f"{k}_{tag}": run[k] for tag, run in (("plain", plain), ("remat", rem))
              for k in ("ms_per_step", "max_memory_allocated_gb", "resting_gb", "kernel_calls_per_step",
                        "losses")},
           "peak_saved_gb": plain["max_memory_allocated_gb"] - rem["max_memory_allocated_gb"],
           "remat_launches": rem["launches"],
           "loss_rel_diff": loss_rel(rem["losses"], plain["losses"]),
           "grad_rel_diff": {c: r["rel"] for c, r in grad_rel.items()},
           "grads_bit_equal": all(r["bit_equal"] for r in grad_rel.values()),
           "grad_components_not_bit_equal": [c for c, r in grad_rel.items() if not r["bit_equal"]],
           "witness_loss_rel_diff": loss_rel(plain["witness"]["losses"], plain["losses"]),
           "witness_grad_rel_diff": {c: r["rel"] for c, r in witness_rel.items()},
           "witness_bit_equal": all(r["bit_equal"] for r in witness_rel.values()),
           "phase_seconds": time.perf_counter() - t_phase}
    emit(row)
    check(all(math.isfinite(v) for v in rem["losses"].values()), "remat step: non-finite loss")
    worst = max([*row["loss_rel_diff"].values(), *row["grad_rel_diff"].values()])
    check(worst <= REMAT_TOL, f"remat step: losses or gradients {worst:.3e} relative from the step "
                              f"without remat (limit {REMAT_TOL})")
    for remat, run in runs.items():
        fwd = 2 * L if remat else L  # under remat the backward reruns each layer's forward
        want = {"selective_scan_fwd": 0, "selective_scan_fwd_ckpt": fwd, "selective_scan_bwd": L,
                "flash_attention_fwd": fwd, "flash_attention_bwd": L}
        check(run["kernel_calls_per_step"] == want,
              f"remat={remat}: calls in one step {run['kernel_calls_per_step']}, expected {want}")
    check(rem["max_memory_allocated_gb"] < plain["max_memory_allocated_gb"],
          f"remat step: peak {rem['max_memory_allocated_gb']:.2f} GB, not below "
          f"{plain['max_memory_allocated_gb']:.2f} GB without remat")
    return row


def phase_card_vs_cpu(torch, frames=128):
    """One batch at full width with 2 decoder layers, deterministic: the card
    (kernels) against the CPU (plain versions) in bf16 on the same weights
    and the same style draw; loss relative error <= 1e-2 and each top-level
    component's gradient within 5e-2 of its largest magnitude (bf16 rounds at
    other points on the two sides: the flash kernels round P and dS at their
    products' inputs, the scan kernels keep f32 states, where the plain path
    rounds elsewhere).  Then 10 steps on a fixed batch on the card must lower
    the codec loss."""
    import numpy as np

    from mamba_tts_torch.config import TTSConfig
    from mamba_tts_torch.train import state as state_lib
    from mamba_tts_torch.train import train as tr

    cfg = TTSConfig()
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, n_layers=2))
    rng = np.random.default_rng(0)
    B, Q, L, V = 2, cfg.decoder.num_quantizers, cfg.data.max_text_len, cfg.decoder.vocab_size_audio
    text_mask = np.arange(L)[None] < np.array([[60], [45]])
    target = rng.integers(2, V, (B, frames, Q)).astype(np.int32)
    target[1, 100:] = 0
    batch = {"phoneme_ids": (rng.integers(1, cfg.text_encoder.vocab_size, (B, L)) * text_mask).astype(np.int32),
             "text_mask": text_mask,
             "style_bert": rng.standard_normal((B, cfg.smsd.bert_dim)).astype(np.float32),
             "spk_embs": rng.standard_normal((B, cfg.smsd.style_dim)).astype(np.float32),
             "target_codec": target, "target_frames": np.array([frames, 100], np.int32),
             "voice_codec": rng.integers(2, V, (B, frames, Q)).astype(np.int32)}
    k = torch.tensor([0, 1])
    eps = torch.from_numpy(rng.standard_normal((B, cfg.smsd.style_dim)).astype(np.float32))
    out = {}
    for dev in ("cpu", "cuda"):
        model = _full_model(torch, cfg, device=dev)
        lo = model.compute_losses(tr.batch_to_device(batch, torch.device(dev)), deterministic=True,
                                  style_k=k.to(dev), style_eps=eps.to(dev))
        lo["loss_total"].backward()
        grads = {c: torch.cat([p.grad.float().flatten().cpu() for p in getattr(model, c).parameters()
                               if p.grad is not None])
                 for c in ("text_encoder", "dur_predictor", "smsd", "decoder")}
        out[dev] = ({n: float(v.detach()) for n, v in lo.items()}, grads)
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out["cuda"]
    loss_rel = {n: abs(l_gpu[n] - l_cpu[n]) / abs(l_cpu[n]) for n in l_cpu}
    grad_rel = {c: _errs(g_gpu[c], g_cpu[c])[1] for c in g_cpu}
    # a fixed batch on the card: 10 steps must lower the codec loss
    model = _full_model(torch, cfg)
    tx = state_lib.make_optimizer(1e-3)
    st = state_lib.create_train_state(dict(model.named_parameters()), tx)
    step = tr.make_train_step(model, tx)
    b = tr.batch_to_device(batch, torch.device("cuda"))
    codec = []
    for _ in range(10):
        st, lo = step(st, b)
        codec.append(float(lo["loss_codec"]))
    row = {"phase": "card_vs_cpu", "n_layers": 2, "frames": frames, "loss_rel_err": loss_rel,
           "grad_rel_err": grad_rel, "limits": {"loss": 1e-2, "grad": 5e-2},
           "fixed_batch_loss_codec": codec}
    emit(row)
    for n, v in loss_rel.items():
        check(v <= 1e-2, f"card vs CPU {n}: relative error {v}")
    for c, v in grad_rel.items():
        check(v <= 5e-2, f"card vs CPU gradient of {c}: relative error {v}")
    check(codec[-1] < codec[0], f"fixed batch: codec loss {codec[0]} -> {codec[-1]} did not fall")
    return row


CODEC_KEYS = ["loss_total", "loss_wave", "loss_stft", "loss_mel", "loss_vq"]
GAN_KEYS = CODEC_KEYS + ["loss_adv", "loss_fm", "loss_disc"]


def _codec_profile(torch, adversarial, B=8, seg=12800, steps=2):
    """One torch.profiler window over ``steps`` codec train steps at the CLI's
    defaults (full-width ``CodecConfig()``, B = 8, 0.8 s segments, lr 2e-4),
    after a warm-up step: device busy ms and idle share a step (against the
    profiled wall), device kernels a step and the kernels that take the time."""
    from torch.profiler import ProfilerActivity, profile

    from mamba_tts_torch.config import CodecConfig
    from mamba_tts_torch.models.discriminator import MultiSTFTDiscriminator
    from mamba_tts_torch.models.facodec import FACodec
    from mamba_tts_torch.models.layers import seed_init
    from mamba_tts_torch.train import state as state_lib
    from mamba_tts_torch.train import train_codec as tc

    model = seed_init(FACodec(CodecConfig()), 0).cuda()
    tx = state_lib.make_optimizer(2e-4)
    states = [state_lib.create_train_state(dict(model.named_parameters()), tx)]
    if adversarial:
        disc = seed_init(MultiSTFTDiscriminator(tc.discriminator_resolutions(seg)), 1).cuda()
        tx_d = state_lib.make_optimizer(2e-4)
        states.append(state_lib.create_train_state(dict(disc.named_parameters()), tx_d))
        step = tc.make_gan_codec_train_step(model, disc, tx, tx_d)
    else:
        step = tc.make_codec_train_step(model, tx)
    wav = 0.3 * torch.randn((B, seg), generator=torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")

    def run():
        out = step(*states, wav)
        states[:] = out[:-1]
        return {k: float(v) for k, v in out[-1].items()}

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        pwall = (time.perf_counter() - t0) * 1e3
    kernels, busy, count = _device(prof)
    return {"profiled_steps": steps, "profiled_wall_ms_per_step": pwall / steps,
            "device_busy_ms_per_step": busy / steps, "device_idle_share": 1 - busy / pwall,
            "device_kernels_per_step": count / steps, "top_kernels": _top(kernels, steps)}


def phase_codec_train(torch, tmp, steps=5):
    """``python -m mamba_tts_torch.train.train_codec --synthetic`` at its
    defaults (full-width ``CodecConfig()``, 28.8M parameters, B = 8, 0.8 s
    segments = 12,800 samples, lr 2e-4), ``steps`` steps, then again with
    ``--adversarial`` (three discriminator resolutions), with cuDNN's TF32
    as PyTorch leaves it for a user (on): finite losses under the JAX metric
    names, a checkpoint written; ms a step (median, the first step
    excluded), peak allocated memory, and ``_codec_profile``'s window."""
    import math
    import statistics

    from mamba_tts_torch.train import train_codec as tc

    rows = []
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for adversarial, keys in ((False, CODEC_KEYS), (True, GAN_KEYS)):
            mode = "adversarial" if adversarial else "reconstruction"
            ck = tmp / f"codec_{mode}"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = tc.main(["--synthetic", "--max_steps", str(steps), "--checkpoint_dir", str(ck)]
                          + (["--adversarial"] if adversarial else []))
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            check(all(list(h)[1:] == keys for h in out["history"]),
                  f"codec CLI ({mode}): metric names {list(out['history'][0])}")
            check(all(math.isfinite(h[k]) for h in out["history"] for k in keys),
                  f"codec CLI ({mode}): a non-finite loss")
            check((ck / str(steps) / "state.pt").is_file(), f"codec CLI ({mode}): no checkpoint")
            row = {"phase": "codec_train", "mode": mode, "B": 8, "segment": out["segment"],
                   "steps": steps, "cudnn_tf32": True,
                   "ms_per_step_median": statistics.median(out["step_ms"][1:]),
                   "step_ms": out["step_ms"], "wall_seconds": wall,
                   "max_memory_allocated_gb": peak / 1e9,
                   "losses": [{k: h[k] for k in keys} for h in out["history"]],
                   **_codec_profile(torch, adversarial)}
            emit(row)
            rows.append(row)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return rows


def phase_codec_card_vs_cpu(torch, B=2, T=3200):
    """One GAN codec step at the smoke config's codec (kernels halved, as
    the CPU tests tame the random codec), B = 2, 3,200 samples, cuDNN in full
    f32, on the card against the CPU: every loss within 1e-2 relative and
    each component's gradient within 5e-2 of its largest magnitude (the
    training gates of PERF.md §2)."""
    from mamba_tts_torch import config as config_lib
    from mamba_tts_torch.models.discriminator import MultiSTFTDiscriminator
    from mamba_tts_torch.models.facodec import ConvTranspose1dTorch, FACodec
    from mamba_tts_torch.models.layers import Conv, Dense, seed_init
    from mamba_tts_torch.train import state as state_lib
    from mamba_tts_torch.train import train_codec as tc

    class Recorder(state_lib.Optimizer):
        def __init__(self):
            super().__init__(0.0)

        def apply(self, params, grads, opt_state):
            self.grads = {n: g.detach().float().cpu() for n, g in grads.items()}
            return opt_state

    cfg = config_lib.from_json(pathlib.Path("tests/smoke_config.json").read_text()).codec
    wav = 0.3 * torch.randn((B, T), generator=torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cpu", "cuda"):
        model = seed_init(FACodec(cfg), 0)
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, (Conv, Dense, ConvTranspose1dTorch)):
                    m.weight.mul_(0.5)
        model = model.to(dev)
        disc = seed_init(MultiSTFTDiscriminator(((512, 128), (1024, 256))), 1).to(dev)
        rg, rd = Recorder(), Recorder()
        _, _, metrics = tc.make_gan_codec_train_step(model, disc, rg, rd)(
            state_lib.create_train_state(dict(model.named_parameters()), rg),
            state_lib.create_train_state(dict(disc.named_parameters()), rd), wav.to(dev))
        parts = {}
        for n, g in [*rg.grads.items(), *((f"disc.{n}", g) for n, g in rd.grads.items())]:
            parts.setdefault(n.split(".")[0], []).append(g.flatten())
        out[dev] = ({k: float(v) for k, v in metrics.items()},
                    {k: torch.cat(v) for k, v in parts.items()})
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out["cuda"]
    loss_rel = {k: abs(l_gpu[k] - v) / abs(v) for k, v in l_cpu.items()}
    grad_rel = {k: _errs(g_gpu[k], v)[1] for k, v in g_cpu.items()}
    emit({"phase": "codec_card_vs_cpu", "B": B, "samples": T, "loss_rel_err": loss_rel,
          "grad_rel_err": grad_rel, "limits": {"loss": 1e-2, "grad": 5e-2}, "losses_card": l_gpu})
    for k, v in loss_rel.items():
        check(v <= 1e-2, f"codec card vs CPU {k}: relative error {v}")
    check(len(grad_rel) == 7, f"codec card vs CPU: components {sorted(grad_rel)}")
    for k, v in grad_rel.items():
        check(v <= 5e-2, f"codec card vs CPU gradient of {k}: relative error {v}")


def phase_preprocess(torch, tmp, n_items=32):
    """Both preprocessors at full width (``TTSConfig()``: BERT-base and
    FACodec on the card, seeded) over a synthetic corpus of ``n_items`` 0.4 s
    items: ``DatasetPreprocessor`` (one item at a time) and
    ``ParallelDatasetPreprocessor`` (2 spawned G2P workers, then BERT and
    FACodec in chunks of 16, 4 writer threads).  Checks: each directory
    holds n_items x 4 tensors and the metadata, and their codec ids are
    equal; items/s of each, its models' construction included and not.
    First ``tools/wavmax`` finds the corpus's longest WAV (each item 0.4 s)."""
    import numpy as np

    from mamba_tts_torch.data.dataset import make_synthetic_dataset
    from mamba_tts_torch.data.preprocess import DatasetPreprocessor
    from mamba_tts_torch.data.preprocess_parallel import ParallelDatasetPreprocessor
    from mamba_tts_torch.tools.wavmax import longest_wav_in_tar

    csv_path, tar_path = make_synthetic_dataset(str(tmp / "corpus"), n_items=n_items)
    t0 = time.perf_counter()
    longest, seconds = longest_wav_in_tar(tar_path)
    wavmax = {"name": longest, "seconds": seconds, "ms": (time.perf_counter() - t0) * 1e3}
    check(longest is not None and longest.endswith(".wav") and abs(seconds - 0.4) < 0.01,
          f"wavmax: {wavmax}, expected a 0.4 s .wav")
    dirs = {"sequential": tmp / "prep_seq", "parallel": tmp / "prep_par"}
    t0 = time.perf_counter()
    seq = DatasetPreprocessor(str(dirs["sequential"]), [tar_path], device="cuda")
    t1 = time.perf_counter()
    n_seq = seq.preprocess(csv_path)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del seq
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    par = ParallelDatasetPreprocessor(str(dirs["parallel"]), [tar_path], cpu_workers=2,
                                      gpu_batch_size=16, io_workers=4, device="cuda")
    n_par = par.preprocess(csv_path)  # builds its models after the G2P pool
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    for kind, d in dirs.items():
        files = list((d / "tensors").glob("*.npy"))
        check(len(files) == 4 * n_items and (d / "metadata.json").is_file(),
              f"{kind} preprocessing: {len(files)} tensors")
    codec = {kind: {p.name: np.load(p) for p in (d / "tensors").glob("*_codec.npy")}
             for kind, d in dirs.items()}
    equal = sum(np.array_equal(a, codec["parallel"][name]) for name, a in codec["sequential"].items())
    row = {"phase": "preprocess", "items": n_items, "processed": [n_seq, n_par],
           "sequential": {"build_seconds": t1 - t0, "preprocess_seconds": t2 - t1,
                          "items_per_s": n_items / (t2 - t1),
                          "items_per_s_with_build": n_items / (t2 - t0)},
           "parallel": {"seconds": t4 - t3, "items_per_s_with_build": n_items / (t4 - t3),
                        "cpu_workers": 2, "gpu_batch_size": 16},
           "codec_files_equal": equal, "wavmax": wavmax}
    emit(row)
    check(n_seq == n_par == n_items, f"preprocessed {n_seq} and {n_par} of {n_items} items")
    check(equal == n_items, f"codec ids differ between the preprocessors: {equal} of {n_items} equal")
    return {"csv": csv_path, "tar": tar_path, "dir": str(dirs["sequential"])}


TRAIN_PATH_KERNELS = ("selective_scan_fwd_ckpt", "selective_scan_bwd", "flash_attention_fwd",
                      "flash_attention_bwd")  # rows 3, 4 and 6 of PERF.md §6


def phase_train_preprocessed(torch, tmp, corpus):
    """The train CLI at its defaults (full width, B = 10) from
    ``phase_preprocess``'s directory: ``--preprocessed_dir`` for 4 steps with
    a checkpoint every 2, then ``--resume`` to 6; then the online path with
    ``--loader grain --grain_workers 2`` for 4 steps.  The training kernels'
    counts are set to 0 just before each of the two and read just after:
    rows 3, 4 and 6 of the kernel table launched in each.  Finite losses,
    ms a step."""
    import math

    from mamba_tts_torch.train import train as tr

    wrappers = _wrappers()

    def run(runs):
        for w in wrappers.values():
            w.launches = 0
        outs = [tr.main(a) for a in runs]
        return outs, {k: w.launches for k, w in wrappers.items()}

    args = ["--preprocessed_dir", corpus["dir"], "--checkpoint_every", "2", "--checkpoint_dir",
            str(tmp / "ck_prep")]
    (first, second), prep = run([args + ["--max_steps", "4"], args + ["--max_steps", "6", "--resume"]])
    (grain,), loader = run([["--synthetic", "--loader", "grain", "--grain_workers", "2",
                             "--max_steps", "4", "--checkpoint_dir", str(tmp / "ck_grain")]])
    runs = (first, second, grain)
    check(all(math.isfinite(v) for r in runs for h in r["history"] for k, v in h.items()
              if k != "step"), "training from preprocessed data: a non-finite loss")
    check([(r["start_step"], r["step"]) for r in runs] == [(0, 4), (4, 6), (0, 4)],
          f"training from preprocessed data: steps {[(r['start_step'], r['step']) for r in runs]}")
    check((tmp / "ck_prep" / "6" / "state.pt").is_file(), "--preprocessed_dir: no checkpoint 6")
    row = {"phase": "train_preprocessed", "B": 10,
           "preprocessed_ms_per_step": first["ms_per_step"],
           "preprocessed_resumed_ms_per_step": second["ms_per_step"],
           "grain_loader_ms_per_step": grain["ms_per_step"],
           "preprocessed_launches": prep, "grain_loader_launches": loader,
           "loss_total": [h["loss_total"] for r in runs for h in r["history"]]}
    emit(row)
    for k in TRAIN_PATH_KERNELS:
        check(prep[k] > 0 and loader[k] > 0,
              f"{k} was not launched by training from preprocessed data ({prep[k]}) "
              f"or through the worker loader ({loader[k]})")
    return prep, loader


def phase_loader_times(torch, corpus, B=10):
    """Data seconds per batch at B = 10 (the CLI's batch) of three loaders
    over ``phase_preprocess``'s corpus, each batch ready on the card (a
    synchronise after each): ``OfflineDataset.batches`` and the device copy;
    ``dataset.batches`` and ``BatchPreparer`` (G2P, BERT-base and FACodec on
    the card); the worker loader (2 spawned workers) and ``BatchPreparer``.
    Each loader's first batch (its start-up) apart from the others."""
    import statistics

    from mamba_tts_torch.config import TTSConfig
    from mamba_tts_torch.data.dataset import VccmTTSDataset
    from mamba_tts_torch.data.grain_pipeline import make_grain_loader
    from mamba_tts_torch.data.preprocess import OfflineDataset
    from mamba_tts_torch.train import train as tr
    from mamba_tts_torch.train.pipeline import BatchPreparer

    cfg = TTSConfig()
    dev = torch.device("cuda")

    def per_batch(batches):
        times, t = [], time.perf_counter()
        for batch in batches:
            tr.batch_to_device(batch, dev)
            torch.cuda.synchronize()
            now = time.perf_counter()
            times.append(now - t)
            t = now
        return times

    preparer = BatchPreparer(cfg, device="cuda")
    dataset = VccmTTSDataset(corpus["csv"], corpus["tar"], seed=0)
    offline = OfflineDataset(corpus["dir"])
    preparer(*next(dataset.batches(B, seed=1)))  # the front-ends' first call
    times = {
        "offline": per_batch(offline.batches(B, max_text_len=cfg.data.max_text_len, seed=0)),
        "online_batch_preparer": per_batch(preparer(*b) for b in dataset.batches(B, seed=0)),
        "worker_loader_batch_preparer": per_batch(
            preparer(*b) for b in make_grain_loader(dataset, B, seed=0, worker_count=2)),
    }
    row = {"phase": "loader_times", "B": B, "items": len(dataset), "seconds_per_batch": times,
           "first_batch_seconds": {k: v[0] for k, v in times.items()},
           "later_batches_median_seconds": {k: statistics.median(v[1:]) for k, v in times.items()}}
    emit(row)
    check(all(len(v) == len(dataset) // B for v in times.values()),
          f"loader batches: {({k: len(v) for k, v in times.items()})}")
    return row


PARALLEL_NOTE = "two ranks sharing one H100 over gloo: not a scaling figure"
# phase 18b's deterministic step at the CLI's dtypes (bf16): each loss, the
# gradient norm and each component's against one rank's, relative.  Readings
# on an H100 at 700 W, two runs alike: at most 6.39e-4 (loss_dur at (2, 1))
# and 5.39e-4 (the duration predictor's gradient norm), about 3x below the
# limit.  The witness (one rank's steps on each data rank's rows, recombined)
# read at most 6.9e-8 from (2, 1).
BF16_STEP_TOL = 2e-3
WITNESS_TOL = 1e-6


def _counters():
    """Every kernel wrapper of the kernel table, by row name."""
    from mamba_tts_torch.ops import decode_megakernel as mk
    from mamba_tts_torch.ops.int8_matvec import int8_matvec

    return {**_wrappers(), "int8_matvec": int8_matvec, "decode_megakernel": mk._megakernel_call}


class _Uncounted:
    """Launches made to hold a path against its reference: the kernels'
    counts are put back on exit."""

    def __enter__(self):
        self.saved = {k: w.launches for k, w in _counters().items()}

    def __exit__(self, *exc):
        for k, w in _counters().items():
            w.launches = self.saved[k]
        return False


def _par_sp_scan(torch, rank, T=5120, D=1024, N=16):
    """Phase 18a in one rank."""
    import torch.distributed as dist

    from mamba_tts_torch.ops import pallas_scan as ps
    from mamba_tts_torch.ops.selective_scan import selective_scan
    from mamba_tts_torch.parallel.mesh import make_mesh
    from mamba_tts_torch.parallel.sp_scan import sp_selective_scan

    mesh = make_mesh((2,), ("data",), device_type="cuda")
    rows = []
    for B in (2, 8):
        u, delta, A, Bm, Cm, Dsk, _ = _scan_inputs(torch, B, T, D, N, seed=B, with_h0=False)
        u, Bm, Cm = u.float(), Bm.float(), Cm.float()
        g = torch.Generator(device="cuda").manual_seed(7)
        wy = torch.randn(u.shape, generator=g, device="cuda")
        wh = torch.randn((B, N, D), generator=g, device="cuda")

        def run(fn):
            ts = [t.detach().clone().requires_grad_(True) for t in (u, delta, A, Bm, Cm, Dsk)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y, h = fn(*ts)
            ((y.float() * wy).sum() + (h * wh).sum()).backward()
            torch.cuda.synchronize()
            return time.perf_counter() - t0, y.detach(), h.detach(), [t.grad for t in ts]

        sp_s, y_s, h_s, g_s = run(lambda *ts: sp_selective_scan(*ts, mesh))
        with _Uncounted():
            one_s, y_1, h_1, g_1 = run(lambda *ts: ps.selective_scan_pallas(*ts))
        errs = {"y": _errs(y_s, y_1), "h_T": _errs(h_s, h_1)}
        errs.update({f"d{n}": _errs(a, b) for n, a, b in zip(("u", "dt", "A", "B", "C", "D"),
                                                             g_s, g_1)})
        row = {"B": B, "T": T, "D": D, "N": N, "rel_errors": {k: e[1] for k, e in errs.items()},
               "sp_fwd_bwd_s": sp_s, "one_rank_fwd_bwd_s": one_s}
        for k in ("y", "h_T"):
            check(errs[k][1] <= 2e-4, f"sp scan B={B} {k}: relative error {errs[k][1]}")
        for k in ("du", "ddt", "dA", "dB", "dC", "dD"):
            check(errs[k][1] <= 2e-3, f"sp scan B={B} {k}: relative error {errs[k][1]}")
        if rank == 0:  # pass 1 alone: this rank's slice, the final state only
            with _Uncounted():
                Tl = T // 2
                sl = [t[:, :Tl].contiguous() for t in (u, delta, Bm, Cm)]
                args = (sl[0], sl[1], A, sl[2], sl[3], Dsk)
                row["pass1_kernels"] = kernels_per_call(
                    torch, lambda: selective_scan(*args, output=False))
                grad_args = [t.detach().clone().requires_grad_(True) for t in args]
                row["pass1_kernels_with_grad"] = kernels_per_call(
                    torch, lambda: selective_scan(*grad_args, output=False))
                for key in ("pass1_kernels", "pass1_kernels_with_grad"):
                    names = [r["kernel"] for r in row[key]]
                    check(len(row[key]) == 2 and all(r["calls"] == 1 for r in row[key])
                          and any("scan_fwd_summary" in n for n in names)
                          and any("scan_carry" in n for n in names),
                          f"sp scan pass 1 ran {row[key]}, not one summary and one carry launch")
        dist.barrier()
        rows.append(row)
        del u, delta, Bm, Cm, y_s, y_1, g_s, g_1
        torch.cuda.empty_cache()
    return rows


def _par_train(torch, rank, tmp, sp_cfg):
    """Phase 18b in one rank."""
    import math

    import numpy as np

    from mamba_tts_torch import config as config_lib
    from mamba_tts_torch.config import TTSConfig
    from mamba_tts_torch.parallel.dryrun import train_check
    from mamba_tts_torch.train import train as tr

    counters = _counters()
    runs = {}
    for tag, extra in (("2,1", []), ("1,2", []), ("1,2 sp", ["--config_json", sp_cfg]),
                       ("2,1 sp", ["--config_json", sp_cfg])):
        before = {k: w.launches for k, w in counters.items()}
        t0 = time.perf_counter()
        out = tr.main(["--synthetic", "--mesh", tag.split()[0], "--max_steps", "2",
                       "--checkpoint_dir", f"{tmp}/ck_{tag.replace(',', 'x').replace(' ', '_')}",
                       *extra])
        losses = [h["loss_total"] for h in out["history"]]
        check(out["step"] == 2 and all(math.isfinite(v) for v in losses),
              f"train CLI --mesh {tag}: {out['step']} steps, losses {losses}")
        runs[tag] = {"wall_s": time.perf_counter() - t0, "ms_per_step": out["ms_per_step"],
                     "loss_total": losses,
                     "launches": {k: w.launches - before[k] for k, w in counters.items()}}
        for k in TRAIN_PATH_KERNELS:
            check(runs[tag]["launches"][k] > 0, f"train CLI --mesh {tag}: {k} not launched")
    # one deterministic full-width step on each mesh against one rank's, on
    # a batch with uneven text and frame lengths (there a mean of per-rank
    # means is not the global batch's): with the text encoder and duration
    # predictor in f32, every loss, the gradient norm and each component's
    # gradient norm within 5e-4; and at the CLI's dtypes, within
    # BF16_STEP_TOL, beside the witness that reads the rounding of the batch
    # size alone: one rank's step on each data rank's rows (B = 2),
    # recombined over the global batch as the ranks do, held to (2, 1)
    # within WITNESS_TOL
    f32 = TTSConfig()
    for key in ("text_encoder.dtype", "duration.dtype"):
        f32 = config_lib.override(f32, key, "float32")
    batch, style = _step_batch(np, TTSConfig())

    def small(res):
        squares = {}
        for name, g in res["grads"].items():  # by component: decoder, smsd, ...
            part = name.split(".")[0]
            squares[part] = squares.get(part, 0.0) + float(np.square(g, dtype=np.float64).sum())
        return {"losses": res["losses"], "norm": res["norm"],
                "grad_norms": {k: math.sqrt(v) for k, v in squares.items()}}

    def rel(a, b):
        return abs(a - b) / abs(b) if b else abs(a - b)

    det = {}
    with _Uncounted():
        for dtype, cfg in (("f32_text_and_duration", f32), ("bf16_cli_dtypes", TTSConfig())):
            step = (config_lib.to_json(cfg), batch, None, 0, "cuda", style)
            det[dtype] = {f"{a},{b}": small(train_check(*step, mesh_shape=(a, b)))
                          for a, b in ((2, 1), (1, 2))}
            if rank == 0:
                det[dtype]["single"] = small(train_check(*step))
        if rank == 0:
            B = len(batch["text_mask"])
            halves = [small(train_check(config_lib.to_json(TTSConfig()),
                                        {k: v[r:r + B // 2] for k, v in batch.items()}, None, 0,
                                        "cuda", {k: v[r:r + B // 2] for k, v in style.items()}))
                      for r in (0, B // 2)]
            det["bf16_cli_dtypes"]["one_rank_halves"] = _recombined(TTSConfig(), batch, halves)
    if rank == 0:
        for dtype, res in det.items():
            ref = res["single"]
            for tag, got in res.items():
                if "losses" in got:
                    got["rel_err"] = {k: rel(got["losses"][k], v) for k, v in ref["losses"].items()}
                    got["rel_err"]["norm"] = rel(got["norm"], ref["norm"])
                    got["rel_err"].update({f"grad_norm_{k}": rel(got["grad_norms"][k], v)
                                           for k, v in ref["grad_norms"].items()})
        halves = det["bf16_cli_dtypes"]["one_rank_halves"]
        dp = det["bf16_cli_dtypes"]["2,1"]["losses"]
        halves["rel_err_to_2,1"] = {k: rel(halves[k], v) for k, v in dp.items()}
        halves["rel_err"] = {k: rel(halves[k], v)
                             for k, v in det["bf16_cli_dtypes"]["single"]["losses"].items()}
        emit({"phase": "parallel_deterministic_step", "B": len(batch["text_mask"]),
              "L": batch["text_mask"].shape[1], "S": batch["target_codec"].shape[1], **det})
        for dtype, tol in (("f32_text_and_duration", 5e-4), ("bf16_cli_dtypes", BF16_STEP_TOL)):
            for tag in ("2,1", "1,2"):
                for k, err in det[dtype][tag]["rel_err"].items():
                    check(err <= tol, f"{dtype} mesh {tag} step {k}: relative error {err} > {tol}")
        for k, err in halves["rel_err_to_2,1"].items():
            check(err <= WITNESS_TOL, f"bf16 mesh 2,1 step {k}: {err} from one rank's steps on "
                  f"each rank's rows, recombined (> {WITNESS_TOL}): not the batch size's rounding")
    return {"cli": runs, "deterministic_steps": det}


def _step_batch(np, cfg, B=4, L=32, S=128):
    """A deterministic step's global batch at full width and its z_style
    draw: row 1's text ends at L/2 and row 3's target at 3S/4."""
    Q, V = cfg.decoder.num_quantizers, cfg.decoder.vocab_size_audio
    rng = np.random.default_rng(0)
    text_mask = np.ones((B, L), bool)
    text_mask[1, L // 2:] = False
    target = rng.integers(2, V, (B, S, Q)).astype(np.int32)
    target[3, 3 * S // 4:] = cfg.decoder.pad_id
    frames = np.full((B,), S, np.int32)
    frames[3] = 3 * S // 4
    batch = {"phoneme_ids": (rng.integers(1, cfg.text_encoder.vocab_size, (B, L)) * text_mask
                             ).astype(np.int32),
             "text_mask": text_mask,
             "style_bert": rng.standard_normal((B, cfg.smsd.bert_dim)).astype(np.float32),
             "spk_embs": rng.standard_normal((B, cfg.smsd.style_dim)).astype(np.float32),
             "target_codec": target, "target_frames": frames,
             "voice_codec": rng.integers(2, V, (B, S, Q)).astype(np.int32)}
    style = {"k": rng.integers(0, cfg.smsd.num_mixtures, (B,)),
             "eps": rng.standard_normal((B, cfg.smsd.style_dim)).astype(np.float32)}
    return batch, style


def _recombined(cfg, batch, halves):
    """One-rank losses of consecutive row blocks -> the global batch's: each
    loss's numerator and denominator summed over the blocks, as the
    data-parallel losses sum them over the ranks."""
    rows = len(batch["text_mask"]) // len(halves)
    dens = [{"loss_codec": float((batch["target_codec"][r:r + rows] != cfg.decoder.pad_id).sum()),
             "loss_dur": float(batch["text_mask"][r:r + rows].sum()), "loss_smsd": float(rows)}
            for r in range(0, len(batch["text_mask"]), rows)]
    out = {k: sum(h["losses"][k] * d[k] for h, d in zip(halves, dens)) / sum(d[k] for d in dens)
           for k in dens[0]}
    tr = cfg.train
    out["loss_total"] = (tr.w_codec * out["loss_codec"] + tr.w_dur * out["loss_dur"]
                         + tr.w_smsd * out["loss_smsd"])
    return out


def _forced_agreement(torch, synth, rows, tokens, frames):
    """Per row, alone (B = 1), teacher-forced on the row's decoded tokens:
    the megakernel itself (``quant="megakernel"``, at the dtypes its planner
    picks for B = 1) or the forward (``quant="none"``); the share of steps
    whose argmax (specials masked) equals the token.  A free-running greedy
    decode at another batch size is no reference: one near-tied flip at
    random weights changes every later token."""
    from mamba_tts_torch.infer.synthesize import _megakernel_dtypes
    from mamba_tts_torch.ops.decode_megakernel import megakernel_greedy_decode

    model, dc = synth.model, synth.decoder.cfg
    ids, mask, style, vc = rows
    Q = dc.num_quantizers
    quant_ids = torch.arange(Q, device="cuda").repeat_interleave(frames)[None]
    pos_ids = torch.arange(frames, device="cuda").repeat(Q)[None]
    agree = []
    with torch.no_grad():
        for i in range(len(tokens)):
            th = model.encode_text(ids[i:i + 1], mask[i:i + 1])
            z = model.sample_style(style[i:i + 1])
            rh, rm = model.embed_voice(vc[i:i + 1])
            tok = torch.as_tensor(tokens[i:i + 1], device="cuda")
            inp = torch.cat([torch.full_like(tok[:, :1], dc.bos_id), tok[:, :-1]], dim=1)
            if synth.quant == "megakernel":  # forced tokens are each step's input
                wd, kvd = _megakernel_dtypes(dc, 1, rh.shape[1] + th.shape[1])
                chosen = megakernel_greedy_decode(
                    synth.decoder, synth._qparams, th, z, frames, text_mask=mask[i:i + 1],
                    ref_hidden=rh, ref_mask=rm, forced_tokens=inp[0], weight_dtype=wd,
                    kv_dtype=kvd, weight_plan=synth._weight_plans[wd]).tokens[0]
            else:
                logits = synth.decoder(inp, th, z, mask[i:i + 1], rh, rm, quant_ids=quant_ids,
                                       pos_ids=pos_ids)[0].float()
                logits[:, :dc.num_special_tokens] = -1e9
                chosen = logits.argmax(-1)
            agree.append(float((chosen == tok[0]).float().mean()))
    return agree


def _par_serving(torch, rank, tmp, voice_path, texts_path, frames=64):
    """Phase 18c in one rank."""
    import copy as copy_lib

    import numpy as np

    from mamba_tts_torch.config import TTSConfig
    from mamba_tts_torch.infer import synthesize as syn
    from mamba_tts_torch.parallel.mesh import make_mesh

    mesh = make_mesh((2,), ("data",), device_type="cuda")
    voice = _voice(1.0)
    texts = [ln.strip() for ln in open(texts_path)]
    out = {}
    for quant in ("megakernel", "none"):
        synth = syn.load_synthesizer(TTSConfig(), quant=quant, mesh=mesh)
        model = synth.model

        def sample_style(style_bert, generator=None, model=model):
            pi, mu, _ = model.smsd(style_bert)
            return mu[torch.arange(mu.shape[0]), pi.argmax(-1)]

        model.sample_style = sample_style
        ids, _, mask = synth.frontend.encode_batch(texts, pad_to=synth.cfg.data.max_text_len)
        ids, mask, vc = synth._tensors(ids, mask, synth._encode_voice([voice] * len(texts)))
        rows = (ids, mask, synth.style_encoder.embed(STYLES[:len(texts)]), vc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens = synth._decode_rows(rows, frames, 0.0, synth._generator(0))
        wall = time.perf_counter() - t0
        row = {"rows": len(texts), "frames": frames, "decode_rows_wall_s": wall}
        if rank == 0:
            with _Uncounted():
                single = copy_lib.copy(synth)
                single.mesh = None
                gen = single._generator(0)
                same_batch = [single._decode_rows(tuple(a[0:2] for a in rows), frames, 0.0, gen),
                              single._decode_rows(tuple(a[[2, 2]] for a in rows), frames, 0.0, gen)[:1]]
                check(np.array_equal(np.concatenate(same_batch), tokens),
                      f"dp serving {quant}: a rank's rows differ from one run on the same batch")
                agree = _forced_agreement(torch, synth, rows, tokens, frames)
                row["per_row_teacher_forced_agreement"] = agree
                check(min(agree) >= 0.9, f"dp serving {quant}: per-row agreement {agree}")
        out[quant] = row
        del synth, model
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    syn.main(["--texts_file", texts_path, "--voice_wav", voice_path, "--dp_serving",
              "--frames", "32", "--quant", "int8", "--output", f"{tmp}/dp.wav"])
    out["cli_wall_s"] = time.perf_counter() - t0
    if rank == 0:
        check(all(pathlib.Path(f"{tmp}/dp_{i:03d}.wav").is_file() for i in range(len(texts))),
              "--dp_serving wrote no wav per row")
    return out


def _parallel_rank(tmp, voice_path, texts_path, sp_cfg):
    """Phase 18 (a-c) in one of the two ranks that share the card."""
    import torch
    import torch.distributed as dist

    rank = dist.get_rank()
    x = torch.full((4,), float(rank + 1), device="cuda")
    dist.all_reduce(x)
    parts = [torch.empty_like(x) for _ in range(2)]
    dist.all_gather(parts, x)
    y = torch.full((4,), float(rank), device="cuda")
    dist.broadcast(y, src=1)
    check(float(x[0]) == 3.0 and all(float(p[0]) == 3.0 for p in parts) and float(y[0]) == 1.0,
          "gloo collectives on CUDA tensors gave wrong values")
    walls = {}
    counters = _counters()
    for w in counters.values():
        w.launches = 0
    t0 = time.perf_counter()
    sp = _par_sp_scan(torch, rank)
    walls["a_sp_scan_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train = _par_train(torch, rank, tmp, sp_cfg)
    walls["b_train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    serving = _par_serving(torch, rank, tmp, voice_path, texts_path)
    walls["c_serving_s"] = time.perf_counter() - t0
    launches = {k: w.launches for k, w in counters.items()}
    return {"rank": rank, "gloo_cuda_collectives": ["all_reduce", "all_gather", "broadcast"],
            "sp_scan": sp, "train": train, "serving": serving, "walls": walls,
            "launches": launches,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30}


def phase_parallel(torch, tmp, frames=64):
    """Phase 18: see the module docstring."""
    import numpy as np

    from mamba_tts_torch import config as config_lib
    from mamba_tts_torch.audio.wavio import write_wav
    from mamba_tts_torch.config import TTSConfig
    from mamba_tts_torch.infer.synthesize import load_synthesizer
    from mamba_tts_torch.parallel.dryrun import spawn

    voice_path, texts_path = str(tmp / "par_voice.wav"), str(tmp / "par_texts.txt")
    write_wav(voice_path, _voice(1.0), 16000)
    pathlib.Path(texts_path).write_text("\n".join(TEXTS[:3]) + "\n")
    sp_cfg = str(tmp / "sp_config.json")
    pathlib.Path(sp_cfg).write_text(config_lib.to_json(
        config_lib.override(TTSConfig(), "decoder.use_sp_scan", True)))
    t0 = time.perf_counter()
    ranks = spawn(2, _parallel_rank, str(tmp), voice_path, texts_path, sp_cfg, device="cuda",
                  timeout=600)
    world_s = time.perf_counter() - t0
    launches = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    emit({"phase": "parallel", "note": PARALLEL_NOTE, "card": nvidia_smi_line(),
          "world_wall_s": world_s, "launches": launches, "ranks": ranks})
    # (d) the checkpoint written under --mesh 1,2, served by one rank
    t0 = time.perf_counter()
    synth = load_synthesizer(checkpoint_dir=str(tmp / "ck_1x2"))
    wav, info = synth.synthesize(TEXT, STYLE, _voice(1.0), frames=frames)
    check(wav.shape == (frames * 200,) and bool(np.isfinite(wav).all()),
          f"serving the --mesh 1,2 checkpoint: waveform {wav.shape}")
    emit({"phase": "parallel_checkpoint_serving", "seconds": time.perf_counter() - t0,
          "frames": frames, "wall_seconds": info["wall_seconds"]})
    for k in ("selective_scan_fwd_ckpt", "selective_scan_bwd", "flash_attention_fwd",
              "flash_attention_bwd", "decode_megakernel", "int8_matvec"):
        check(launches[k] > 0, f"phase 18: {k} was not launched on the parallel paths")
    del synth
    torch.cuda.empty_cache()
    return launches


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
    da_rows = phase_decode_attention(torch)
    ga_rows = phase_grouped_attention(torch)
    mst_rows = phase_mamba_step(torch)
    m2_rows = phase_mamba2_step(torch)
    synth, _, launches = phase_slice(torch)
    phase_parity(torch, synth)
    phase_captured_vs_eager(torch, synth)
    phase_profile(torch, synth)
    del synth
    voice = _voice()
    synth_none, none_launches = phase_default_decode(torch, voice)
    synth_mk, _, mk_launches = phase_megakernel_slice(torch, voice)
    mk_worst = phase_megakernel_kernel(torch, synth_mk)
    mk_rows, mk_one = phase_megakernel_times(torch, synth_mk, voice)
    phase_megakernel_flagship(torch, synth_mk)
    flagship = mk_rows[(1, "bfloat16", "bfloat16")]
    del synth_mk
    torch.cuda.empty_cache()

    # training: each kernel against its plain version, then the main paths
    # (teacher-forced forward, the trainer CLI, flagship-length steps) with
    # the training kernels' counts set to 0 just before and read just after
    train_rows = {**phase_scan_kernels(torch), **phase_flash_kernels(torch)}
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    phase_forward_vs_decode(torch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = pathlib.Path(tmp)
        phase_train_cli(torch, tmp)
        ck_launches = phase_checkpoint_serving(torch, tmp, voice)
        released_launches = phase_released_weights(torch, tmp, voice)
        torch.cuda.empty_cache()
        flagship_batch = _flagship_batch(torch, tmp)
        phase_flagship_step(torch, flagship_batch)
        phase_style_branch(torch, synth_none, tmp)
    del synth_none
    train_launches = {k: w.launches for k, w in wrappers.items()}
    emit({"phase": "training_main_path", "launches": train_launches})
    for k, n in train_launches.items():
        check(n > 0, f"{k} was not launched on the main path")
    torch.cuda.empty_cache()
    # the flagship step under remat beside the same step without it (its own
    # counts, set to 0 just before the remat run)
    remat_launches = phase_remat_step(torch, flagship_batch)["remat_launches"]
    del flagship_batch
    torch.cuda.empty_cache()

    # codec training, then preprocessing and training from preprocessed data
    # (its own counts of the training kernels, set to 0 just before each run)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as tmp:
        tmp = pathlib.Path(tmp)
        phase_codec_train(torch, tmp)
        phase_codec_card_vs_cpu(torch)
        torch.cuda.empty_cache()
        corpus = phase_preprocess(torch, tmp)
        torch.cuda.empty_cache()
        prep_launches, loader_launches = phase_train_preprocessed(torch, tmp, corpus)
        phase_loader_times(torch, corpus)
    torch.cuda.empty_cache()
    phase_card_vs_cpu(torch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_par_") as tmp:
        par_launches = phase_parallel(torch, pathlib.Path(tmp))

    b1 = [r for r in rows if r["B"] == 1]

    def mean(key):
        return sum(r[key] for r in b1) / len(b1)

    emit({"kernels": [{
        "name": "int8_matvec", "route": "cuda", "source": "mamba_tts_torch/ops/csrc/int8_matvec.cu",
        "replaces": "mamba_tts_tpu/ops/int8_matvec.py:38", "launches": launches,
        "max_abs_err": worst, "ms": mean("kernel_ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"), "bound_by": "bytes", "library_ms": mean("library_ms"),
        "at": "mean per launch over the six decode shapes at B=1, weights cold in L2",
        "l2_hot_ms": mean("kernel_l2_hot_ms"), "bias_ms": mean("kernel_bias_ms"),
        "bias_l2_hot_ms": mean("kernel_bias_l2_hot_ms"),
        "library_l2_hot_ms": mean("library_l2_hot_ms"),
        "trained_weights_launches": ck_launches["int8_matvec"],
        "parallel_launches": par_launches["int8_matvec"],
    }, {
        "name": "decode_megakernel", "route": "cuda",
        "source": "mamba_tts_torch/ops/csrc/decode_megakernel.cu",
        "replaces": "mamba_tts_tpu/ops/decode_megakernel.py:532", "launches": mk_launches,
        "max_abs_err": max(mk_worst, mk_one["max_abs_logit_err"]), "ms": mk_one["ms"],
        "plain_ms": mk_one["plain_ms"], "bound_ms": mk_one["bound_read_once_ms"],
        "bound_by": mk_one["bound_read_once_by"], "library_ms": None,
        "at": mk_one["launch"] + "; bound_ms reads every input once a launch",
        "bound_with_plan_ms": mk_one["bound_with_plan_ms"],
        "bound_no_residency_ms": mk_one["bound_no_residency_ms"],
        "flagship_launch_ms": flagship["launch_ms"], "flagship_us_per_step": flagship["us_per_step"],
        "flagship_bound_with_plan_us_per_step": flagship["bound_with_plan_us_per_step"],
        "us_per_step": {f"B={B} {wd}/{kvd}": r["us_per_step"] for (B, wd, kvd), r in mk_rows.items()},
        "bound_with_plan_us_per_step": {f"B={B} {wd}/{kvd}": r["bound_with_plan_us_per_step"]
                                        for (B, wd, kvd), r in mk_rows.items()},
        "grid": flagship["grid"], "cluster": flagship["cluster"],
        "grid_barriers_per_step": mk_one["grid_barriers_per_step"],
        "trained_weights_launches": ck_launches["decode_megakernel"],
        "released_weights_launches": released_launches,
        "parallel_launches": par_launches["decode_megakernel"],
    }, {
        "name": "decode_attention", "route": "cuda",
        "source": "mamba_tts_torch/ops/csrc/decode_attention.cu", "replaces": None,
        "jax_counterpart": "mamba_tts_tpu/models/attention.py:99 (_naive: XLA einsums, no Pallas kernel)",
        "launches": none_launches["decode_attention"],
        "max_abs_err": max(r["max_abs_err"] for r in da_rows),
        **{k: da_rows[0][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        "at": "B=8, H=8, Tm=1,536 (the narration batch), ragged mask, K/V cold in L2",
        "ms_by_case": {r["case"]: r["ms"] for r in da_rows},
        "bound_ms_by_case": {r["case"]: r["bound_ms"] for r in da_rows},
        "grouped_ms_by_case": {r["case"]: r["ms"] for r in ga_rows},
        "grouped_bound_ms_by_case": {r["case"]: r["bound_ms"] for r in ga_rows},
    }, {
        "name": "mamba_step", "route": "cuda", "source": "mamba_tts_torch/ops/csrc/mamba_step.cu",
        "replaces": None,
        "jax_counterpart": "mamba_tts_tpu/models/mamba.py:175 (MambaBlock.step: XLA, no Pallas kernel)",
        "launches": none_launches["mamba_step"],
        "trained_weights_launches": ck_launches["mamba_step"],
        "max_rel_err": {r["case"]: r["max_rel_err"] for r in mst_rows},
        "ms": mst_rows[0]["conv_step_ms"] + mst_rows[0]["ssm_step_ms"],
        "plain_ms": mst_rows[0]["conv_step_plain_ms"] + mst_rows[0]["ssm_step_plain_ms"],
        "bound_ms": mst_rows[0]["conv_step_bound_ms"] + mst_rows[0]["ssm_step_bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "at": "conv_step + ssm_step, B=8, d_inner 1,024 (the narration batch), state cold in L2",
        **{f"{k}_by_case": {r["case"]: r[k] for r in mst_rows}
           for k in ("conv_step_ms", "ssm_step_ms", "conv_step_plain_ms", "ssm_step_plain_ms",
                     "plain_chain_ms", "conv_step_bound_ms", "ssm_step_bound_ms")},
    }, {
        "name": "mamba2_step", "route": "cuda", "source": "mamba_tts_torch/ops/csrc/mamba2_step.cu",
        "replaces": None, "jax_counterpart": None,
        "launches": {r["case"]: r["launches"] for r in m2_rows},
        "max_rel_err": {r["case"]: r["max_rel_err"] for r in m2_rows},
        "ms": m2_rows[0]["mamba2_step_ms"], "plain_ms": m2_rows[0]["mamba2_step_plain_ms"],
        "bound_ms": m2_rows[0]["mamba2_step_bound_ms"], "bound_by": "bytes", "library_ms": None,
        "at": "mamba2_step, B=16, 128 heads of 64, d_state 128 (the granite batch), state cold "
              "in L2; the decode's launches are read by the granite cell's "
              "mamba_step_launches.serve",
        **{f"{k}_by_case": {r["case"]: r[k] for r in m2_rows}
           for k in ("conv_step_ms", "mamba2_step_ms", "conv_step_plain_ms",
                     "mamba2_step_plain_ms", "conv_step_bound_ms", "mamba2_step_bound_ms")},
    }] + [{
        "name": k, "route": "cuda", "source": TRAIN_SOURCES[k][0], "replaces": TRAIN_SOURCES[k][1],
        "launches": train_launches[k], **train_rows[k],
        "preprocessed_launches": prep_launches[k], "grain_loader_launches": loader_launches[k],
        "parallel_launches": par_launches[k],
        **({"remat_launches": remat_launches[k]} if k in TRAIN_PATH_KERNELS else {}),
    } for k in TRAIN_KERNELS], "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
