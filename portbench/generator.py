"""The one traffic generator: reads a traffic file (``traffic/<name>.json``)
and makes the inputs of a run from ``--seed``.

Serving traffic (``"kind": "serve"``) is a list of requests.  Every seed
gives the same multiset of frame buckets: the buckets come in blocks, each
block holding every bucket of the file once, in an order drawn from the
seed or, with ``"order": "fixed"``, in the file's order (where the order
moves what is measured, as a captured graph's memory, freed only when the
next request's replaces it, moves the peak).  Sentences are drawn from ``data/words.tsv``, with a number of words
proportional to the request's audio length; style prompts from the file's
prompt list; voice prompts are seeded synthetic speakers (a harmonic source
with its own pitch, vibrato and syllable rhythm, plus breath noise).

Training traffic (``"kind": "train"``) is a pool of preprocessed batches:
phoneme ids, codec grids of the target and of the voice prompt, ``style_bert``
and ``spk_embs``, drawn from the seed as the offline-preprocessed data the
train CLI reads.

A traffic file may name a generator of its own, ``"generator": "<name>"``,
the module ``generators/<name>.py`` with the same functions; a mix that
needs one brings new code, and so carries no claim of a gain.
"""
from __future__ import annotations

import importlib
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
DATA = ROOT / "data"
SAMPLE_RATE = 16000
FRAMES_PER_SECOND = 80.0


def load_json(kind: str, name: str, root: Path = ROOT) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder ``root`` (kind:
    configs, traffic, limits)."""
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    return json.loads(path.read_text())


def for_traffic(t: dict):
    """The generator of a traffic file: this module, or the one it names."""
    name = t.get("generator")
    if name is None:
        return sys.modules[__name__]
    if not name.isidentifier():
        raise ValueError(f"generator {name!r} is not a module name")
    return importlib.import_module(f"portbench.generators.{name}")


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64([int(seed) % 2 ** 64, stream]))


def _lines(name: str) -> List[str]:
    return [ln.strip() for ln in (DATA / name).read_text().splitlines()
            if ln.strip() and not ln.startswith("#")]


def words() -> List[str]:
    return [ln.split("\t")[0] for ln in _lines("words.tsv")]


def voice(seed: int, seconds: float) -> np.ndarray:
    """A seeded synthetic speaker: 16 kHz float32 in [-1, 1]."""
    r = _rng(seed, 7)
    n = int(seconds * SAMPLE_RATE)
    t = np.arange(n) / SAMPLE_RATE
    f0 = r.uniform(85.0, 255.0) * (1 + 0.03 * np.sin(2 * np.pi * r.uniform(4, 7) * t))
    z = np.exp(1j * 2 * np.pi * np.cumsum(f0) / SAMPLE_RATE).astype(np.complex64)
    tilt, zk, src = r.uniform(0.5, 0.9), np.ones(n, np.complex64), np.zeros(n, np.float32)
    for k in range(1, 16):  # harmonic k: Im(z^k e^{i phi_k}) tilt^k
        zk = zk * z
        src += tilt ** k * (zk * np.exp(1j * r.uniform(0, 2 * np.pi))).imag
    rhythm = 0.55 + 0.45 * np.sin(2 * np.pi * r.uniform(3.0, 5.5) * t + r.uniform(0, 6.3))
    noise = r.standard_normal(n) * r.uniform(0.01, 0.04)
    wav = rhythm * src / 4.0 + noise
    return (0.6 * wav / np.abs(wav).max()).astype(np.float32)


@dataclass
class Request:
    index: int
    frames: int
    texts: List[str]
    style: str
    voice_key: int          # index into the voice pool, or the request's own voice
    seed: int               # the request's seed (the style draw)
    rows: int = 1

    @property
    def audio_seconds(self) -> float:
        return self.rows * self.frames / FRAMES_PER_SECOND


@dataclass
class ServeTraffic:
    requests: List[Request]
    voices: Dict[int, np.ndarray] = field(default_factory=dict)


def serve_traffic(t: dict, seed: int, count: Optional[int] = None) -> ServeTraffic:
    """The first ``count`` (default ``max_requests``) requests of a serving
    mix for ``seed``."""
    r = _rng(seed, 1)
    vocab, prompts = words(), _lines(t["style_prompts"])
    buckets = list(t["frame_buckets"])
    n = count or t["max_requests"]
    order: List[int] = []
    while len(order) < n:  # "order": "fixed" keeps the file's order in every block
        perm = range(len(buckets)) if t.get("order") == "fixed" else r.permutation(len(buckets))
        order += [buckets[i] for i in perm]
    pool = t["voice_pool"]
    reqs, voices = [], {}
    for i in range(n):
        frames = order[i]
        k = max(1, round(frames / FRAMES_PER_SECOND * t["words_per_second"]))
        texts = [" ".join(vocab[j] for j in r.integers(0, len(vocab), k))
                 for _ in range(t["batch"])]
        style = prompts[int(r.integers(0, len(prompts)))]
        key = int(r.integers(0, pool)) if pool else i
        reqs.append(Request(i, frames, texts, style, key, int(r.integers(0, 2 ** 31)),
                            rows=t["batch"]))
    vseed = int(_rng(seed, 2).integers(0, 2 ** 62))
    for key in sorted({q.voice_key for q in reqs}):
        voices[key] = voice(vseed + key, t["voice_seconds"])
    return ServeTraffic(reqs, voices)


def train_batches(t: dict, seed: int, cfg: dict) -> List[Dict[str, np.ndarray]]:
    """The pool of preprocessed batches: every row distinct."""
    r = _rng(seed, 3)
    B, S, Sv = t["batch"], t["frames"], t["voice_frames"]
    dec, data = cfg["decoder"], cfg["data"]
    Q, lo = dec["num_quantizers"], dec["num_special_tokens"]
    hi = dec["codebook_size"] + lo
    L = data["max_text_len"]
    n_ph = cfg["text_encoder"]["vocab_size"]
    out = []
    for _ in range(t["pool"]):
        lens = r.integers(t["text_len"][0], t["text_len"][1] + 1, B)
        ids = np.zeros((B, L), np.int64)
        for b, n in enumerate(lens):
            ids[b, :n] = r.integers(3, n_ph, n)  # past <PAD>, <BOS>, <EOS>
            ids[b, 0], ids[b, n - 1] = 1, 2
        out.append({
            "phoneme_ids": ids,
            "text_mask": ids != 0,
            "style_bert": r.standard_normal((B, cfg["smsd"]["bert_dim"])).astype(np.float32) * 0.5,
            "spk_embs": r.standard_normal((B, cfg["smsd"]["style_dim"])).astype(np.float32) * 0.5,
            "target_codec": r.integers(lo, hi, (B, S, Q)),
            "target_frames": np.full((B,), S, np.int64),
            "voice_codec": r.integers(lo, hi, (B, Sv, Q)),
        })
    return out
