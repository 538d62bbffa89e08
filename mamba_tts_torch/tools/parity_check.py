"""Greedy decode against the teacher-forced forward — counterpart of
``mamba_tts_tpu/tools/parity_check.py``.

The decode runs the decoder step by step on its own argmax stream; this
tool feeds that same stream back through the batched teacher-forced forward
and reports, over the real vocabulary:

  - the largest and the mean relative logit difference of the two paths,
  - the argmax flip rate (positions where they would pick different tokens),
  - the mean top-2 margin of the forward's logits,

for the step decode in the model's dtype, with the forward's selective scan
switched between the Hopper kernels and the plain scan (the attribution
switch; on the CPU both are the plain scan), and for the megakernel decode
in each residency rung, re-scored by the forward.

    python -m mamba_tts_torch.tools.parity_check [--checkpoint_dir D]
        [--frames 64] [--train_steps 200] [--batch 2] [--device cuda]

Without a checkpoint it first trains the model on synthetic data for
``--train_steps`` with the port's train CLI, so that the measurement reads a
trained logit landscape, not a random init.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import tempfile

import numpy as np
import torch

SCANS = ("hopper", "plain")
RUNGS = (("bfloat16", "bfloat16"), ("int8", "bfloat16"), ("int8", "int8"))


@contextlib.contextmanager
def scan_switch(scan: str):
    """``MambaBlock``'s full-sequence scan on the Hopper kernels
    (``"hopper"``: the model's own path) or on the plain scan on any device
    (``"plain"``) for the duration of the block."""
    from mamba_tts_torch.models import mamba
    from mamba_tts_torch.ops.selective_scan import selective_scan_ref

    kernel_scan = mamba.selective_scan
    if scan == "plain":
        mamba.selective_scan = lambda u, delta, A, B, C, D, h0=None: selective_scan_ref(
            u, delta, A, B, C, D, h0)
    try:
        yield
    finally:
        mamba.selective_scan = kernel_scan


@torch.no_grad()
def measure_parity(model, cfg, frames: int, seed: int = 0, batch: int = 2) -> dict:
    """Parity metrics between the greedy decodes and the forward, at
    ``batch`` rows of seeded inputs, on the model's device."""
    from mamba_tts_torch.infer.quant_decode import quantize_decoder_params
    from mamba_tts_torch.models.decoder import greedy_decode
    from mamba_tts_torch.ops.decode_megakernel import megakernel_greedy_decode

    decoder = model.decoder
    dec_cfg = decoder.cfg
    dev = decoder.head.weight.device
    Q, ns = dec_cfg.num_quantizers, dec_cfg.num_special_tokens
    B, L, S = batch, 12, 8
    rng = np.random.default_rng(seed)
    ids = torch.as_tensor(rng.integers(1, cfg.text_encoder.vocab_size, (B, L)), device=dev)
    text_mask = torch.ones((B, L), dtype=torch.bool, device=dev)
    style_bert = torch.as_tensor(rng.standard_normal((B, cfg.smsd.bert_dim)),
                                 dtype=torch.float32, device=dev)
    voice = torch.as_tensor(rng.integers(ns, dec_cfg.vocab_size_audio, (B, S, Q)), device=dev)
    text_hidden = model.encode_text(ids, text_mask)
    z_style = model.sample_style(style_bert, torch.Generator(device=dev).manual_seed(seed))
    ref_hidden, ref_mask = model.embed_voice(voice)
    quant_ids = torch.arange(Q, device=dev).repeat_interleave(frames)[None]
    pos_ids = torch.arange(frames, device=dev).repeat(Q)[None]
    cond = dict(text_mask=text_mask, ref_hidden=ref_hidden, ref_mask=ref_mask)

    def forward(scan: str, tokens: torch.Tensor) -> np.ndarray:
        """The teacher-forced rerun of a decoded stream: inputs [BOS, y_0..]
        with the grid's slot ids, the scan on the kernels or plain."""
        inp = torch.cat([torch.full((tokens.shape[0], 1), dec_cfg.bos_id, dtype=tokens.dtype,
                                    device=dev), tokens[:, :-1]], dim=1)
        with scan_switch(scan):
            logits = decoder(inp, text_hidden, z_style, text_mask, ref_hidden, ref_mask,
                             quant_ids=quant_ids, pos_ids=pos_ids)
        return logits.float().cpu().numpy()

    def stats(tokens, dec_logits, fwd_logits) -> dict:
        tokens = tokens.cpu().numpy()
        dec_logits = dec_logits.float().cpu().numpy()
        fwd_masked = fwd_logits.copy()
        fwd_masked[:, :, :ns] = -1e9  # the decode masks the specials before its argmax
        dl, fl = dec_logits[..., ns:], fwd_logits[..., ns:]
        rel = np.abs(dl - fl) / max(float(np.maximum(np.abs(dl), np.abs(fl)).max()), 1e-9)
        top = np.sort(fwd_masked, axis=-1)
        return {
            "argmax_flip_rate": float((fwd_masked.argmax(-1) != tokens).mean()),
            "logit_rel_diff_max": float(rel.max()),
            "logit_rel_diff_mean": float(rel.mean()),
            "top2_margin_mean": float((top[..., -1] - top[..., -2]).mean()),
            "positions": int(tokens.size),
        }

    res = greedy_decode(decoder, text_hidden, z_style, frames, collect_logits=True, **cond)
    results = {scan: stats(res.tokens, res.logits, forward(scan, res.tokens)) for scan in SCANS}
    qparams = quantize_decoder_params(decoder)
    for wd, kvd in RUNGS:
        mk = megakernel_greedy_decode(decoder, qparams, text_hidden, z_style, frames,
                                      collect_logits=True, weight_dtype=wd, kv_dtype=kvd, **cond)
        results[f"megakernel_{wd[:4]}w_{kvd[:4]}kv"] = stats(
            mk.tokens, mk.logits, forward("hopper", mk.tokens))
    return results


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint_dir", type=str, default=None)
    parser.add_argument("--config_json", type=str, default=None)
    parser.add_argument("--frames", type=int, default=64)
    parser.add_argument("--train_steps", type=int, default=200)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)

    from mamba_tts_torch import config as config_lib
    from mamba_tts_torch.config import TTSConfig
    from mamba_tts_torch.device import resolve_device
    from mamba_tts_torch.infer.synthesize import checkpoint_config
    from mamba_tts_torch.models.tts import MambaTTS
    from mamba_tts_torch.train import state as state_lib

    dev = resolve_device(args.device)
    cfg = (config_lib.from_json(open(args.config_json).read()) if args.config_json
           else checkpoint_config(args.checkpoint_dir) or TTSConfig())
    ckpt, tmp = args.checkpoint_dir, None
    try:
        if ckpt is None:  # train briefly on synthetic data, so that logit gaps are trained
            from mamba_tts_torch.train.train import main as train_main

            ckpt = tmp = tempfile.mkdtemp(prefix="parity_ck_")
            argv_t = ["--synthetic", "--max_steps", str(args.train_steps), "--batch_size", "4",
                      "--checkpoint_dir", ckpt, "--seed", str(args.seed),
                      "--device", args.device]
            if args.config_json:
                argv_t += ["--config_json", args.config_json]
            train_main(argv_t)
        params, restored = state_lib.restore_params(ckpt)
        if not restored:
            raise FileNotFoundError(f"no checkpoint in {ckpt}")
        model = MambaTTS(cfg)
        state_lib.copy_params(dict(model.named_parameters()), params)
        model.to(dev).eval()
        print(f"restored params from {os.path.abspath(ckpt)}")
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    out = {"greedy_parity": measure_parity(model, cfg, args.frames, args.seed, args.batch),
           "batch": args.batch}
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
