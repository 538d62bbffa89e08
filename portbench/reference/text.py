"""Text inputs of the plain reference: phoneme ids of the benchmark's
sentences and the style prompts' token ids.

The traffic builds its sentences from the words of ``data/words.tsv``, each
with one pronunciation in the lexicon, lowercase and space-separated, so the
phoneme string of a sentence is the words' pronunciations joined by the
word boundary ``|`` between ``<BOS>`` and ``<EOS>``.  The style prompts are
tokenized as an uncased BERT tokenizer without a vocabulary file does in
the system: whitespace and punctuation split, each word one hashed id in
[999, vocab), ``[CLS]`` 101 first, ``[SEP]`` 102 last, ``[PAD]`` 0.
"""
from __future__ import annotations

import hashlib
import json
import unicodedata
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

DATA = Path(__file__).resolve().parent.parent / "data"


def load_words(path: Path = DATA / "words.tsv") -> Dict[str, List[str]]:
    out = {}
    for line in path.read_text().splitlines():
        if line and not line.startswith("#"):
            w, ph = line.split("\t")
            out[w] = ph.split()
    return out


def load_phoneme_vocab(path: Path = DATA / "phoneme_vocab.json") -> Dict[str, int]:
    return {p: i for i, p in enumerate(json.loads(path.read_text()))}


def phoneme_ids(sentences: Sequence[str], words: Dict[str, List[str]], vocab: Dict[str, int],
                pad_to: int) -> Tuple[np.ndarray, np.ndarray]:
    """(ids (B, pad_to) int64, mask (B, pad_to) bool True = valid)."""
    ids = np.zeros((len(sentences), pad_to), np.int64)
    mask = np.zeros((len(sentences), pad_to), bool)
    unk = vocab.get("<UNK>", vocab["<PAD>"])
    for r, s in enumerate(sentences):
        ph = ["<BOS>"]
        for j, w in enumerate(s.split(" ")):
            if j:
                ph.append("|")
            ph.extend(words[w])
        ph.append("<EOS>")
        row = [vocab.get(p, unk) for p in ph][:pad_to]
        ids[r, :len(row)] = row
        mask[r, :len(row)] = True
    return ids, mask


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _words(text: str) -> List[str]:
    text = "".join(ch for ch in unicodedata.normalize("NFD", text.lower())
                   if unicodedata.category(ch) != "Mn")
    out, cur = [], ""
    for ch in text:
        if ch.isspace() or _is_punct(ch):
            if cur:
                out.append(cur)
            cur = ""
            if _is_punct(ch):
                out.append(ch)
        else:
            cur += ch
    if cur:
        out.append(cur)
    return out


def style_token_ids(prompts: Sequence[str], vocab_size: int, max_length: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    ids = np.zeros((len(prompts), max_length), np.int64)
    mask = np.zeros((len(prompts), max_length), bool)
    for r, p in enumerate(prompts):
        row = [101]
        for w in _words(p):
            h = int.from_bytes(hashlib.md5(w.encode()).digest()[:4], "little")
            row.append(999 + h % (vocab_size - 999))
            if len(row) >= max_length - 1:
                break
        row = row[:max_length - 1] + [102]
        ids[r, :len(row)] = row
        mask[r, :len(row)] = True
    return ids, mask
