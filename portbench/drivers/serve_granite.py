"""Serving cells of the granite decoder (``configs/granite-4.0-h-small-tts.json``):
the closed loop, warm-up, window and sample of ``drivers/serve.py``, with
this model's system and reference in place of the MAVE decoder's.

The system is built as ``serve.build`` builds it, after a check that the
program has the granite decoder at all (a program without it fails here,
at once), except for the decoder's weights: ``weights_granite.py`` draws
them a tensor at a time on the device, by name and seed, and the check
draws the reference's again from the seed (no host copy of 32 GB).  The
comparison runs the plain reference of ``reference_granite/`` (the granite
decoder in float32, one row at a time) on the front-ends of ``reference/``
(text encoder, SMSD's style draw, BERT, FACodec) and the benchmark's
weights: by how much each served token's logit lies below the reference's
best along the served tokens (prefill of the row's prefix, then its
tokens), and the waveform's error.  ``decode_path`` records the decode
function and precision of every request: the configuration states
``hybrid_greedy_decode`` in bfloat16.  The control (``readings``) is the
same reference with both operands of every bfloat16 product in float8
e4m3, and FACodec under TF32.  Besides ``serve.run``'s numbers the run
returns ``prefix_lengths``: each window request's rows' prefix
lengths, as the system's decode was handed them.

The warm-up (``serve.run``'s first request of each frame bucket) serves the
first bucket's request whole and, at every later bucket, decodes only
``WARM_FRAMES`` frames (the same prefill, capture and replays) and hands
FACodec those tokens repeated to the bucket's length, so the codec runs at
every shape the window will use.  Nothing in the decode depends on the
frame count but the length of its K/V cache and token buffers: its kernels
are built before the first request and its products run at B = 16 rows
whatever the bucket.  Four whole warm-up decodes of 1,600-2,560 steps
would add about 100 s of set-up and warm nothing more.
"""
from __future__ import annotations

import contextlib
import importlib
import json

import numpy as np
import torch

from portbench import weights, weights_granite
from portbench.drivers import serve, serve_hybrid
from portbench.reference import model as ref_model
from portbench.reference.config import from_json as ref_config
from portbench.reference_granite.granite_tts import GraniteConfig, GraniteTTSDecoder, set_fake

Q_SPECIALS = serve.Q_SPECIALS
FRONT = ("style_pipe", "text_encoder", "dur_predictor", "smsd")  # MambaTTS's parts but the decoder
WARM_FRAMES = 8  # the warm-up's decode at every bucket after the first: 40 steps


def build(conf: dict, seed: int, device):
    """(synthesizer, ``{"front": the other parts' weights on the host,
    "seed": seed}``): ``serve.build`` with the decoder's weights drawn by
    ``weights_granite``."""
    importlib.import_module("mamba_tts_torch.models.granite")  # the program has the model
    from mamba_tts_torch.audio.codec import FACodecTokenizer
    from mamba_tts_torch.config import from_json
    from mamba_tts_torch.infer.synthesize import Synthesizer
    from mamba_tts_torch.models.facodec import FACodec
    from mamba_tts_torch.models.style_text_encoder import BertEncoder, StyleTextEncoder
    from mamba_tts_torch.models.tts import MambaTTS
    from mamba_tts_torch.text.processor import PhonemeFrontend

    cfg = from_json(json.dumps(conf["model"]))
    with torch.device(device):
        parts = {"tts": MambaTTS(cfg), "bert": BertEncoder(cfg.style_encoder),
                 "codec": FACodec(cfg.codec)}
    shapes = {f"{k}.{n}": tuple(p.shape) for k, m in parts.items()
              for n, p in m.named_parameters() if not (k == "tts" and n.startswith("decoder."))}
    w = weights.make(shapes, seed, device)
    tts = weights.split(w, "tts")
    for k in FRONT:
        weights.load_into(getattr(parts["tts"], k), weights.split(tts, k))
    for k in ("bert", "codec"):
        weights.load_into(parts[k], weights.split(w, k))
    weights_granite.load_decoder(parts["tts"].decoder, seed, device,
                                 cfg.decoder.embedding_multiplier)
    host = {"front": {k: v.cpu() for k, v in w.items()}, "seed": seed}
    del w, tts
    synth = Synthesizer(
        cfg, parts["tts"],
        tokenizer=FACodecTokenizer(cfg.codec, module=parts["codec"], device=device),
        frontend=PhonemeFrontend(vocab_path=cfg.data.phoneme_vocab_path),
        style_encoder=StyleTextEncoder(cfg.style_encoder, module=parts["bert"], device=device),
        quant=conf["quant"], device=device)
    return synth, host


def reference(conf: dict, host, device):
    """(reference config, front-end modules, the plain granite decoder) on the
    benchmark's weights."""
    cfg = ref_config(json.dumps(conf["model"]))
    front = host["front"]
    tts = weights.split(front, "tts")
    with torch.device(device):
        m = {"tts": serve_hybrid.Front(cfg), "bert": ref_model.BertEncoder(cfg.style_encoder),
             "codec": ref_model.FACodec(cfg.codec)}
        dec = GraniteTTSDecoder(GraniteConfig.from_dict(
            conf["model"]["decoder"], conf["model"]["text_encoder"]["d_model"]))
    weights.load_into(m["tts"], {k: v for k, v in tts.items()
                                 if k.split(".")[0] in ("text_encoder", "smsd")})
    weights.load_into(m["bert"], weights.split(front, "bert"))
    weights.load_into(m["codec"], weights.split(front, "codec"))
    weights_granite.load_decoder(dec, host["seed"], device, dec.cfg.embedding_multiplier)
    for v in [*m.values(), dec]:
        v.eval()
    return cfg, m, dec


def _short_decode(decode_rows):
    """``Synthesizer._decode_rows`` that decodes ``WARM_FRAMES`` frames and
    repeats them to the frame budget asked for: (B, Q * frames) tokens."""
    def rows(arrays, frames, temperature, generator):
        tokens = decode_rows(arrays, WARM_FRAMES, temperature, generator)
        grid = tokens.reshape(len(tokens), -1, WARM_FRAMES)
        grid = np.tile(grid, (1, 1, -(-frames // WARM_FRAMES)))[..., :frames]
        return np.ascontiguousarray(grid).reshape(len(tokens), -1)
    return rows


def _warm_call(call, warm_requests: int):
    """``serve._call`` whose calls 2 to ``warm_requests`` (the warm-up's
    later buckets) decode through :func:`_short_decode`."""
    calls = [0]

    def wrapped(synth, traffic, req, voices):
        calls[0] += 1
        if not 1 < calls[0] <= warm_requests:
            return call(synth, traffic, req, voices)
        decode_rows = synth._decode_rows
        synth._decode_rows = _short_decode(decode_rows)
        try:
            return call(synth, traffic, req, voices)
        finally:
            synth._decode_rows = decode_rows
    return wrapped


@contextlib.contextmanager
def _as_granite(traffic: dict):
    """``serve.run`` with this module's system, ``serve_hybrid.check`` (its
    reference swapped for this one's), ``serve_hybrid``'s decode paths and
    the short warm-up of the module's docstring."""
    saved = serve.build, serve.check, serve.DecodePaths, serve._call, serve_hybrid.reference, \
        serve_hybrid.set_fake
    serve.build, serve.check, serve.DecodePaths = build, serve_hybrid.check, \
        serve_hybrid.DecodePaths
    serve._call = _warm_call(serve._call, len(traffic["frame_buckets"]))
    serve_hybrid.reference, serve_hybrid.set_fake = reference, set_fake
    try:
        yield
    finally:
        (serve.build, serve.check, serve.DecodePaths, serve._call, serve_hybrid.reference,
         serve_hybrid.set_fake) = saved


def run(conf: dict, traffic: dict, limits: dict, seed: int, seconds: float, traced: bool,
        device, fault=None, after_window=None) -> dict:
    with _as_granite(traffic):
        out = serve.run(conf, traffic, limits, seed, seconds, traced, device, fault=fault,
                        after_window=after_window)
    done = [r["index"] for r in out["records"]]
    out["prefix_lengths"] = dict(zip(done, serve_hybrid.DecodePaths.prefix_lengths))
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
