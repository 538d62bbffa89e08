"""Serving cells: one closed-loop client calling the system's
``Synthesizer.synthesize`` (B = 1) or ``synthesize_batch`` (B rows, one
frame bucket, one voice waveform object for every row), request after
request, for the window; then the comparison with the plain reference on
a sample of the finished requests, and a look at which decode path, in
which precision, served every request of the window.
"""
from __future__ import annotations

import gc
import itertools
import json
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import generator, trace, weights
from portbench.reference import model as ref_model
from portbench.reference import text as ref_text
from portbench.reference.config import from_json as ref_config

Q_SPECIALS = 2  # PAD, BOS
CHECK_STREAM = 0x5A17


def build(conf: dict, seed: int, device):
    """The system under test at the configuration, with the benchmark's
    weights; returns (synthesizer, the weights on the host)."""
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
              for n, p in m.named_parameters()}
    w = weights.make(shapes, seed, device)
    for k, m in parts.items():
        weights.load_into(m, weights.split(w, k))
    host = {k: v.cpu() for k, v in w.items()}
    del w
    synth = Synthesizer(
        cfg, parts["tts"],
        tokenizer=FACodecTokenizer(cfg.codec, module=parts["codec"], device=device),
        frontend=PhonemeFrontend(vocab_path=cfg.data.phoneme_vocab_path),
        style_encoder=StyleTextEncoder(cfg.style_encoder, module=parts["bert"], device=device),
        quant=conf["quant"], device=device)
    return synth, host


def _call(synth, traffic: dict, req, voices):
    """One request through the system's entry; returns waveform rows."""
    v = voices[req.voice_key]
    if traffic["entry"] == "synthesize":
        wav, _ = synth.synthesize(req.texts[0], req.style, v, frames=req.frames, seed=req.seed)
        return [wav]
    wavs, _ = synth.synthesize_batch(req.texts, [req.style] * req.rows, [v] * req.rows,
                                     frames=req.frames, seed=req.seed, variable_length=False)
    return list(wavs)


class DecodePaths:
    """Records which of the system's decode functions served each call of
    the window, with the precision it ran in: ``greedy_decode`` (the
    decoder's compute dtype), ``megakernel_greedy_decode`` (its weight and
    K/V dtypes, as the system's planner picked them) or
    ``greedy_decode_int8`` (int8 K/V or not).  The configuration's
    ``decode`` states the one path and precision of its cells."""

    KEYS = {"greedy_decode": ("path", "dtype"),
            "megakernel": ("path", "weight_dtype", "kv_dtype"),
            "greedy_decode_int8": ("path", "int8_kv")}

    def __init__(self):
        from mamba_tts_torch.infer import synthesize as mod

        self.mod, self.seen = mod, set()
        self.orig = {k: getattr(mod, k) for k in
                     ("greedy_decode", "megakernel_greedy_decode", "greedy_decode_int8")}

        def wrap(name, read):
            fn = self.orig[name]

            def recorded(*a, **k):
                self.seen.add(read(*a, **k))
                return fn(*a, **k)
            return recorded

        mod.greedy_decode = wrap(
            "greedy_decode", lambda dec, *a, **k: ("greedy_decode", str(dec.dtype).split(".")[-1]))
        mod.megakernel_greedy_decode = wrap(
            "megakernel_greedy_decode", lambda *a, **k: (
                "megakernel", k.get("weight_dtype", "bfloat16"), k.get("kv_dtype", "bfloat16")))
        mod.greedy_decode_int8 = wrap(
            "greedy_decode_int8", lambda *a, **k: ("greedy_decode_int8", bool(k.get("int8_kv"))))

    def close(self):
        for k, fn in self.orig.items():
            setattr(self.mod, k, fn)


def run(conf: dict, traffic: dict, limits: dict, seed: int, seconds: float, traced: bool,
        device, fault=None, after_window=None) -> dict:
    """``fault(synth)`` breaks the system before the window (the benchmark's
    own tests); ``after_window(synth, issued, voices, rows, served)`` runs on
    the system after it, given the requests in the order sent, the checked
    (request, row) pairs and the served tokens (the control runs)."""
    synth, host = build(conf, seed, device)
    if fault is not None:
        fault(synth)
    hop = synth.tokenizer.hop
    gen = generator.for_traffic(traffic)
    tr = gen.serve_traffic(traffic, seed)
    voices = tr.voices
    # warm-up: one request per frame bucket of the mix, from other draws
    warm = gen.serve_traffic(traffic, seed ^ 0x3C3C, count=len(traffic["frame_buckets"]))
    for req in warm.requests:
        _call(synth, traffic, req, warm.voices)
    if traced:
        trace.warm_profiler(device)
    served: Dict[int, np.ndarray] = {}
    current: Dict[str, object] = {}
    decode_rows = synth._decode_rows
    decode_tokens = synth.decode_tokens
    spans: Dict[str, float] = {}

    def capture(*a, **k):
        out = decode_rows(*a, **k)
        current["tokens"] = out
        return out

    def timed_decode(*a, **k):
        with trace.span("portbench.decode_tokens", device, spans):
            return decode_tokens(*a, **k)

    synth._decode_rows = capture
    if traced:
        synth.decode_tokens = timed_decode
    paths = DecodePaths()
    del warm
    gc.collect()
    trace.sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    records: List[dict] = []
    wavs: Dict[int, List[np.ndarray]] = {}
    failed = 0
    prof = trace.Profile(device) if traced else None
    n_prof = traffic["trace_requests"]
    t0 = time.perf_counter()
    issued = []  # the mix's requests in turn, from its start again when it runs out
    for i in itertools.count():
        req = tr.requests[i % len(tr.requests)]
        issued.append(req)
        if prof is not None and i == 0:
            prof.start()
        spans.clear()
        ts = time.perf_counter()
        try:
            with torch.profiler.record_function("portbench.request"):
                rows = _call(synth, traffic, req, voices)
            ok = all(r.shape == (req.frames * hop,) and np.isfinite(r).all() for r in rows)
        except Exception as exc:  # a failed request counts; the run goes on
            print(f"request {i} failed: {exc!r}", file=sys.stderr)
            rows, ok = [], False
        te = time.perf_counter()
        if prof is not None and i == n_prof - 1:
            prof.stop()
        failed += not ok
        if ok:
            served[i] = current.pop("tokens")
            wavs[i] = rows
        records.append({"index": i, "frames": req.frames, "rows": req.rows, "ok": ok,
                        "audio_s": req.audio_seconds if ok else 0.0, "wall_s": te - ts,
                        "decode_s": spans.get("portbench.decode_tokens")})
        if te - t0 >= seconds and (prof is None or i >= n_prof - 1):
            break
    window_s = time.perf_counter() - t0
    paths.close()
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    profile = None
    if prof is not None:
        kernels, win, pspans = prof.read()
        profile = {"kernels": kernels, "window": win, "spans": pspans,
                   "requests": records[:n_prof]}
        del prof

    synth._decode_rows = decode_rows
    synth.decode_tokens = decode_tokens
    checked = sample(records, seed, traffic)
    control = after_window(synth, issued, tr.voices, checked, served) if after_window else None
    del synth, decode_rows, decode_tokens
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    checks = check(conf, limits, issued, tr.voices, checked, served, wavs, host, device, control)
    stated = [conf["decode"][k] for k in DecodePaths.KEYS[conf["decode"]["path"]]]
    checks["decode_path"] = {"value": [list(x) for x in sorted(paths.seen)], "limit": [stated]}
    checks["pass"] = checks["pass"] and paths.seen == {tuple(stated)}
    return {"window_start": t0, "window_s": window_s, "records": records, "failed": failed,
            "attempted": len(records), "peak_bytes": peak, "profile": profile,
            "checks": checks}


def sample(records: List[dict], seed: int, traffic: dict) -> List[tuple]:
    """The (request, row) pairs to compare: the longest finished request and
    more drawn from the seed; in each, its last row and more drawn."""
    done = [r for r in records if r["ok"]]
    if not done:
        return []
    rng = np.random.Generator(np.random.PCG64([int(seed) % 2 ** 64, CHECK_STREAM]))
    longest = max(done, key=lambda r: (r["frames"], -r["index"]))
    rest = [r for r in done if r is not longest]
    n = min(traffic["check"]["requests"] - 1, len(rest))
    chosen = [longest] + [rest[int(j)] for j in rng.choice(len(rest), size=n, replace=False)]
    out = []
    for r in chosen:  # the last row, and more drawn
        k = min(r["rows"], traffic["check"]["rows"]) - 1
        more = rng.choice(r["rows"] - 1, k, replace=False) if k > 0 else []
        out += [(r["index"], int(row)) for row in sorted([r["rows"] - 1, *more])]
    return out


def reference(conf: dict, host: Dict[str, torch.Tensor], device, low: bool = False):
    """The reference's modules on the benchmark's weights; ``low`` adds
    ``tts_low``, the model with its bfloat16 layers' products in float8
    (the precision control)."""
    cfg = ref_config(json.dumps(conf["model"]))
    with torch.device(device):
        m = {"tts": ref_model.MambaTTS(cfg), "bert": ref_model.BertEncoder(cfg.style_encoder),
             "codec": ref_model.FACodec(cfg.codec)}
        if low:
            m["tts_low"] = ref_model.MambaTTS(cfg, ref_model.Numerics(fake=ref_model.fp8_e4m3))
    tts = {k: v for k, v in weights.split(host, "tts").items() if not k.startswith("style_pipe.")}
    weights.load_into(m["tts"], tts)
    if low:
        weights.load_into(m["tts_low"], tts)
    weights.load_into(m["bert"], weights.split(host, "bert"))
    weights.load_into(m["codec"], weights.split(host, "codec"))
    for v in m.values():
        v.eval()
    return cfg, m


@torch.no_grad()
def voice_grid(codec, cfg, wav: np.ndarray, device) -> torch.Tensor:
    """(S, Q) shifted codec ids of a voice prompt, PAD past its frames, cut
    to the 64-frame bucket of its length: the memory's reference part."""
    c = cfg.codec
    bucket = int(0.8 * c.sample_rate)
    n = min(len(wav), c.max_seq_len * c.hop_length)
    padded = min(-(-len(wav) // bucket) * bucket, c.max_seq_len * c.hop_length)
    x = torch.zeros((1, padded), device=device)
    x[0, :n] = torch.from_numpy(wav[:n]).to(device)
    ids = codec.encode_ids(x)[:, 0].T + Q_SPECIALS  # (T_f, Q)
    frames = -(-n // c.hop_length)
    S = min(c.max_seq_len, -(-max(8, frames) // 64) * 64)
    grid = torch.zeros((S, ids.shape[1]), dtype=torch.long, device=device)
    t = min(S, ids.shape[0], frames)
    grid[:t] = ids[:t]
    return grid


@torch.no_grad()
def reference_inputs(cfg, m, texts, style, wav, seed, device):
    """The reference's conditioning of a request: phoneme ids and mask, the
    style sample of every row, and the voice prompt's codec grid."""
    words, vocab = ref_text.load_words(), ref_text.load_phoneme_vocab()
    ids, mask = ref_text.phoneme_ids(texts, words, vocab, cfg.data.max_text_len)
    ids, mask = torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device)
    sc = cfg.style_encoder
    sid, smask = ref_text.style_token_ids([style] * len(texts), sc.vocab_size,
                                          min(sc.max_length, sc.max_position))
    style_bert = m["bert"](torch.from_numpy(sid).to(device), torch.from_numpy(smask).to(device))
    z = m["tts"].smsd.sample(style_bert, torch.Generator(device=device).manual_seed(seed))
    grid = voice_grid(m["codec"], cfg, wav, device)
    return ids, mask, z, grid


class Gaps:
    """The gaps by which tokens' logits lie below the reference's best, over
    every compared position: the widest, the mean, and the share of
    positions whose token is not the reference's first (``argmax_miss``,
    in %)."""

    def __init__(self):
        self.widest, self.total, self.missed, self.n = 0.0, 0.0, 0, 0

    def add(self, g: torch.Tensor) -> None:
        self.widest = max(self.widest, float(g.max()))
        self.total += float(g.sum())
        self.missed += int((g > 0).sum())
        self.n += g.numel()

    def numbers(self) -> dict:
        n = max(self.n, 1)
        return {"logit_gap": self.widest, "logit_gap_mean": self.total / n,
                "argmax_miss": 100.0 * self.missed / n}


def check(conf, limits, issued, voices, rows, served, wavs, host, device, control=None) -> dict:
    """The compared numbers: by how much the served tokens' logits lie below
    the reference's best (over the vocabulary less the specials; ``Gaps``),
    and the largest waveform error over the reference waveform's peak.
    Every number that ``limits`` names is held to its limit; the others are
    read beside.  With ``control`` (a dict: name -> per checked row, the
    tokens another path of the system puts first along the same inputs) the
    control's readings come beside: the gaps of the tokens the float8
    reference puts first, of each given path's, and the reference waveform
    with TF32 on."""
    cfg, m = reference(conf, host, device, low=control is not None)
    Q = cfg.decoder.num_quantizers
    wave, tokens, gaps = 0.0, 0, Gaps()
    ctl = {k: Gaps() for k in ["control_fp8", *(control or {})]}
    ctl_wave = 0.0
    bad_token = False
    inputs = {}
    for i, r in rows:
        req = issued[i]
        if i not in inputs:
            inputs = {i: reference_inputs(cfg, m, req.texts, req.style, voices[req.voice_key],
                                          req.seed, device)}
        ids, mask, z, grid = inputs[i]
        tok = torch.as_tensor(served[i][r], device=device).long()  # (Q * F,)
        if int(tok.min()) < Q_SPECIALS or int(tok.max()) >= cfg.decoder.vocab_size_audio:
            bad_token = True
            continue
        F_ = req.frames
        with torch.no_grad():
            th = m["tts"].text_encoder(ids[r:r + 1], mask[r:r + 1])
            memory, mmask = m["tts"].memory(th, mask[r:r + 1], grid[None])
            x = m["tts"].shifted(tok.reshape(1, Q, F_))
            logits = m["tts"].decoder(x, memory, mmask, z[r:r + 1])[0, :, Q_SPECIALS:]
            best = logits.max(dim=-1).values

            def below(t):
                return best - logits.gather(-1, (t - Q_SPECIALS)[:, None])[:, 0]

            gaps.add(below(tok))
            tokens += tok.numel()
            ids_q = (tok - Q_SPECIALS).reshape(Q, 1, F_)
            ref_wav = m["codec"].decode(ids_q)[0]
            got = torch.from_numpy(wavs[i][r]).to(device)
            wave = max(wave, float((got - ref_wav).abs().max() / ref_wav.abs().max()))
            if control is not None:
                for k, v in control.items():
                    ctl[k].add(below(v[(i, r)].to(device)))
                th = m["tts_low"].text_encoder(ids[r:r + 1], mask[r:r + 1])
                memory, mmask = m["tts_low"].memory(th, mask[r:r + 1], grid[None])
                low = m["tts_low"].decoder(x, memory, mmask, z[r:r + 1])[0, :, Q_SPECIALS:]
                ctl["control_fp8"].add(below(low.argmax(-1) + Q_SPECIALS))
                torch.backends.cudnn.allow_tf32 = True
                low = m["codec"].decode(ids_q)[0]
                torch.backends.cudnn.allow_tf32 = False
                ctl_wave = max(ctl_wave, float((low - ref_wav).abs().max() / ref_wav.abs().max()))
    del m
    numbers = {**gaps.numbers(), "wave_err": wave}
    out = {k: {"value": v, "limit": limits[k]} if k in limits else v
           for k, v in numbers.items()}
    out.update(tokens_compared=tokens, served_token_out_of_range=bad_token)
    if control is not None:
        out["control"] = {**{k: g.numbers() for k, g in ctl.items()},
                          "control_tf32": {"wave_err": ctl_wave}}
    out["pass"] = (not bad_token and tokens > 0
                   and all(numbers[k] <= v for k, v in limits.items()))
    return out


def int8_tokens(synth, issued, voices, rows, served):
    """Per checked (request, row): the tokens the system's int8 megakernel
    puts first along the served tokens, on the system's own conditioning:
    the system's own lower-precision path, read as a control."""
    from mamba_tts_torch.infer.quant_decode import quantize_decoder_params
    from mamba_tts_torch.ops.decode_megakernel import build_weight_plan, megakernel_greedy_decode

    dec, model, cfg = synth.decoder, synth.model, synth.cfg
    qparams = synth._qparams or quantize_decoder_params(dec)
    plan = build_weight_plan(dec.cfg, qparams, "int8")
    out = {}
    with torch.no_grad():
        for i, r in rows:
            req = issued[i]
            ids, _, mask = synth.frontend.encode_batch(req.texts, pad_to=cfg.data.max_text_len)
            ids, mask, voice = synth._tensors(ids, mask, synth._encode_voice(
                [voices[req.voice_key]] * req.rows))
            style = synth.style_encoder.embed([req.style] * req.rows)
            th = model.encode_text(ids, mask)
            z = model.sample_style(style, synth._generator(req.seed))
            rh, rm = model.embed_voice(voice[r:r + 1])
            tok = torch.as_tensor(served[i][r], device=synth.device).long()
            forced = torch.cat([tok.new_full((1,), dec.cfg.bos_id), tok[:-1]])
            res = megakernel_greedy_decode(
                dec, qparams, th[r:r + 1], z[r:r + 1], req.frames, text_mask=mask[r:r + 1],
                ref_hidden=rh, ref_mask=rm, collect_logits=True, forced_tokens=forced[None],
                weight_dtype="int8", kv_dtype="int8", weight_plan=plan)
            logits = res.logits[0].clone()
            logits[:, :dec.cfg.num_special_tokens] = -float("inf")
            out[(i, r)] = logits.argmax(-1)
    return out


def readings(conf, traffic, limits, seed, seconds, device):
    """The sound system's compared numbers, and beside them the float8
    reference's, the system's int8 megakernel path's and FACodec's under
    TF32, on the same requests."""
    out = run(conf, traffic, limits, seed, seconds, False, device,
              after_window=lambda *a: {"control_int8_weights": int8_tokens(*a)})
    c = out["checks"]
    program = {k: (c[k]["value"] if isinstance(c[k], dict) else c[k])
               for k in ("logit_gap", "logit_gap_mean", "argmax_miss", "wave_err")}
    return [{"reading": "program", **program, "tokens": c["tokens_compared"],
             "requests": out["attempted"], "decode_path": c["decode_path"]["value"],
             "correct": c["pass"]},
            *({"reading": k, **v} for k, v in c["control"].items())]
