"""Serving cells of the jamba decoder (``configs/jamba2-3b-tts.json``): the
closed loop, warm-up, window and sample of ``drivers/serve.py``, with this
model's system and reference in place of the MAVE decoder's.

The system is built as ``serve.build`` builds it, after a check that the
program has the jamba decoder at all (a program without it fails here, at
once).  The comparison runs the frozen plain reference of
``reference_hybrid/`` (the jamba decoder in float32, one row at a time) on
the front-ends of ``reference/`` (text encoder, SMSD's style draw, BERT,
FACodec) and the benchmark's weights: by how much each served token's logit
lies below the reference's best along the served tokens (prefill of the
row's prefix, then its tokens), and the waveform's error.  ``decode_path``
records the decode function and precision of every request: the
configuration states ``hybrid_greedy_decode`` in bfloat16.  The control
(``readings``) is the same reference with every product's operands in
float8 e4m3, and FACodec under TF32.  Besides the serving driver's numbers
the run returns ``prefix_lengths``: each window request's rows' prefix
lengths, as the system's decode was handed them.
"""
from __future__ import annotations

import contextlib
import importlib
import json

import torch

from portbench import weights
from portbench.drivers import serve
from portbench.reference import model as ref_model
from portbench.reference.config import from_json as ref_config
from portbench.reference_hybrid.hybrid_tts import HybridConfig, HybridTTSDecoder, set_fake

Q_SPECIALS = serve.Q_SPECIALS
_SERVE_BUILD = serve.build


class DecodePaths(serve.DecodePaths):
    """``serve.DecodePaths`` and the jamba decode: each call is recorded as
    (``hybrid_greedy_decode``, the decoder's compute dtype), with the
    prefix length of each row it was handed."""

    KEYS = {**serve.DecodePaths.KEYS, "hybrid_greedy_decode": ("path", "dtype")}
    prefix_lengths: list = []

    def __init__(self):
        super().__init__()
        mod = self.mod
        self.orig["hybrid_greedy_decode"] = fn = mod.hybrid_greedy_decode
        DecodePaths.prefix_lengths = lengths = []

        def recorded(dec, text_hidden, *a, text_mask=None, ref_mask=None, **k):
            self.seen.add(("hybrid_greedy_decode", str(dec.dtype).split(".")[-1]))
            lengths.append((1 + ref_mask.sum(1) + text_mask.sum(1)).tolist())
            return fn(dec, text_hidden, *a, text_mask=text_mask, ref_mask=ref_mask, **k)

        mod.hybrid_greedy_decode = recorded


def build(conf: dict, seed: int, device):
    importlib.import_module("mamba_tts_torch.models.hybrid")  # the program has the model
    return _SERVE_BUILD(conf, seed, device)


class Front(torch.nn.Module):
    """The reference front-ends the check reads of ``serve.reference_inputs``
    (``text_encoder``, ``smsd``)."""

    def __init__(self, cfg):
        super().__init__()
        num = ref_model.Numerics()
        self.text_encoder = ref_model.TextEncoder(cfg.text_encoder, num)
        self.smsd = ref_model.SMSD(cfg.smsd)


def reference(conf: dict, host, device):
    """(reference config, front-end modules, the plain jamba decoder) on the
    benchmark's weights."""
    cfg = ref_config(json.dumps(conf["model"]))
    tts = weights.split(host, "tts")
    with torch.device(device):
        m = {"tts": Front(cfg), "bert": ref_model.BertEncoder(cfg.style_encoder),
             "codec": ref_model.FACodec(cfg.codec)}
        dec = HybridTTSDecoder(HybridConfig.from_dict(conf["model"]["decoder"],
                                                      conf["model"]["text_encoder"]["d_model"]))
    weights.load_into(m["tts"], {k: v for k, v in tts.items()
                                 if k.split(".")[0] in ("text_encoder", "smsd")})
    weights.load_into(m["bert"], weights.split(host, "bert"))
    weights.load_into(m["codec"], weights.split(host, "codec"))
    weights.load_into(dec, weights.split(tts, "decoder"))
    for v in [*m.values(), dec]:
        v.eval()
    return cfg, m, dec


def check(conf, limits, issued, voices, rows, served, wavs, host, device, control=None) -> dict:
    """``serve.check``'s numbers for the jamba decoder: the gaps of the
    served tokens below the plain reference's best along them, and the
    waveform's error; with ``control`` (any dict) also the float8
    reference's gaps and FACodec under TF32."""
    cfg, m, dec = reference(conf, host, device)
    Q = cfg.decoder.num_quantizers
    wave, tokens, gaps = 0.0, 0, serve.Gaps()
    ctl, ctl_wave, bad_token, inputs = serve.Gaps(), 0.0, False, {}
    for i, r in rows:
        req = issued[i]
        if i not in inputs:
            inputs = {i: serve.reference_inputs(cfg, m, req.texts, req.style,
                                                voices[req.voice_key], req.seed, device)}
        ids, mask, z, grid = inputs[i]
        tok = torch.as_tensor(served[i][r], device=device).long()  # (Q * F,)
        if int(tok.min()) < Q_SPECIALS or int(tok.max()) >= cfg.decoder.vocab_size_audio:
            bad_token = True
            continue
        with torch.no_grad():
            th = m["tts"].text_encoder(ids[r:r + 1], mask[r:r + 1])[0][mask[r]]
            logits = dec.logits(th, z[r], grid, tok)[:, Q_SPECIALS:]
            best = logits.max(dim=-1).values

            def below(t):
                return best - logits.gather(-1, (t - Q_SPECIALS)[:, None])[:, 0]

            gaps.add(below(tok))
            tokens += tok.numel()
            ids_q = (tok - Q_SPECIALS).reshape(Q, 1, req.frames)
            ref_wav = m["codec"].decode(ids_q)[0]
            got = torch.from_numpy(wavs[i][r]).to(device)
            wave = max(wave, float((got - ref_wav).abs().max() / ref_wav.abs().max()))
            if control is not None:
                with set_fake(dec, ref_model.fp8_e4m3):
                    low = dec.logits(th, z[r], grid, tok)[:, Q_SPECIALS:]
                ctl.add(below(low.argmax(-1) + Q_SPECIALS))
                torch.backends.cudnn.allow_tf32 = True
                low_wav = m["codec"].decode(ids_q)[0]
                torch.backends.cudnn.allow_tf32 = False
                ctl_wave = max(ctl_wave, float((low_wav - ref_wav).abs().max()
                                               / ref_wav.abs().max()))
    del m, dec
    numbers = {**gaps.numbers(), "wave_err": wave}
    out = {k: {"value": v, "limit": limits[k]} if k in limits else v
           for k, v in numbers.items()}
    out.update(tokens_compared=tokens, served_token_out_of_range=bad_token)
    if control is not None:
        out["control"] = {"control_fp8": ctl.numbers(), "control_tf32": {"wave_err": ctl_wave}}
    out["pass"] = (not bad_token and tokens > 0
                   and all(numbers[k] <= v for k, v in limits.items()))
    return out


@contextlib.contextmanager
def _as_hybrid():
    """``serve.run`` with this module's system, check and decode paths."""
    saved = serve.build, serve.check, serve.DecodePaths
    serve.build, serve.check, serve.DecodePaths = build, check, DecodePaths
    try:
        yield
    finally:
        serve.build, serve.check, serve.DecodePaths = saved


def run(conf: dict, traffic: dict, limits: dict, seed: int, seconds: float, traced: bool,
        device, fault=None, after_window=None) -> dict:
    with _as_hybrid():
        out = serve.run(conf, traffic, limits, seed, seconds, traced, device, fault=fault,
                        after_window=after_window)
    done = [r["index"] for r in out["records"]]
    out["prefix_lengths"] = dict(zip(done, DecodePaths.prefix_lengths))
    return out


def readings(conf, traffic, limits, seed, seconds, device):
    """The sound system's compared numbers, and beside them the float8
    reference's and FACodec's under TF32, on the same requests."""
    out = run(conf, traffic, limits, seed, seconds, False, device,
              after_window=lambda *a: {})
    c = out["checks"]
    program = {k: (c[k]["value"] if isinstance(c[k], dict) else c[k])
               for k in ("logit_gap", "logit_gap_mean", "argmax_miss", "wave_err")}
    return [{"reading": "program", **program, "tokens": c["tokens_compared"],
             "requests": out["attempted"], "decode_path": c["decode_path"]["value"],
             "correct": c["pass"]},
            *({"reading": k, **v} for k, v in c["control"].items())]
