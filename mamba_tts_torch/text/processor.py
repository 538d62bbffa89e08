"""Text front-end: G2P pipeline + phoneme vocabulary + batch tokenization.

Re-implements the behavior of reference: data_utils/text_processor.py
(TxtProcessor: process/postprocess/txt_to_ph) and reference:
text_encoder.py:212-428 (TextProcessor vocab management + batch_process),
self-contained (see text/g2p.py).

Batch outputs are numpy arrays ready for jit boundaries; masks are
True = VALID (the reference emits True=pad — text_encoder.py:420-423; this
framework standardizes on True=valid).
"""
from __future__ import annotations

import json
from typing import List, Optional, Sequence, Tuple

import numpy as np

from mamba_tts_torch.text.g2p import EnG2p
from mamba_tts_torch.text.normalize import preprocess_text


def is_sil_phoneme(p: str) -> bool:
    """Silence phoneme: empty or non-alphabetic first char
    (reference: text_processor.py:21-23)."""
    return p == "" or (len(p) > 0 and not p[0].isalpha())


class TxtProcessor:
    """English text -> phoneme structure with word boundaries and BOS/EOS."""

    def __init__(self, cmudict_path: Optional[str] = None):
        self.g2p = EnG2p(cmudict_path)

    @staticmethod
    def sp_phonemes() -> List[str]:
        return ["|"]

    @staticmethod
    def preprocess_text(text: str) -> str:
        return preprocess_text(text)

    @classmethod
    def add_bdr(cls, txt_struct: List) -> List:
        out = []
        for i, ts in enumerate(txt_struct):
            out.append(ts)
            if (
                i != len(txt_struct) - 1
                and not is_sil_phoneme(txt_struct[i][0])
                and not is_sil_phoneme(txt_struct[i + 1][0])
            ):
                out.append(["|", ["|"]])
        return out

    @classmethod
    def postprocess(cls, txt_struct: List) -> List:
        while txt_struct and is_sil_phoneme(txt_struct[0][0]):
            txt_struct = txt_struct[1:]
        while txt_struct and is_sil_phoneme(txt_struct[-1][0]):
            txt_struct = txt_struct[:-1]
        txt_struct = cls.add_bdr(txt_struct)
        return [["<BOS>", ["<BOS>"]]] + txt_struct + [["<EOS>", ["<EOS>"]]]

    def process(self, txt: str) -> Tuple[List, str]:
        """Raw text -> ([[word, [phonemes]], ...], cleaned_text)."""
        txt = self.preprocess_text(txt).strip()
        phs = self.g2p(txt)
        txt_struct: List = [[w, []] for w in txt.split(" ")]
        i_word = 0
        for p in phs:
            if p == " ":
                i_word += 1
            elif i_word < len(txt_struct):
                txt_struct[i_word][1].append(p)
        txt_struct = self.postprocess(txt_struct)
        return txt_struct, txt

    def txt_to_ph(self, txt_raw: str) -> Tuple[str, str, str, List[int], str]:
        """Returns (ph, txt, word, ph2word (1-based), ph_gb_word)
        (reference: text_processor.py:206-235)."""
        txt_struct, txt = self.process(txt_raw)
        ph = [p for w in txt_struct for p in w[1]]
        ph_gb_word = ["_".join(w[1]) for w in txt_struct]
        words = [w[0] for w in txt_struct]
        ph2word = [w_id + 1 for w_id, w in enumerate(txt_struct) for _ in range(len(w[1]))]
        return " ".join(ph), txt, " ".join(words), ph2word, " ".join(ph_gb_word)


class TextProcessor:
    """Phoneme vocabulary management and tokenization
    (reference: text_encoder.py:212-428)."""

    def __init__(
        self,
        vocab_path: Optional[str] = None,
        vocab_list: Optional[Sequence[str]] = None,
        padding_token: str = "<PAD>",
        unk_token: str = "<UNK>",
    ):
        if vocab_path is not None:
            with open(vocab_path, encoding="utf-8") as f:
                self.vocab_list = json.load(f)
        elif vocab_list is not None:
            self.vocab_list = list(vocab_list)
        else:
            raise ValueError("Either vocab_path or vocab_list must be provided")
        self.phoneme_to_id = {p: i for i, p in enumerate(self.vocab_list)}
        self.id_to_phoneme = {i: p for p, i in self.phoneme_to_id.items()}
        self.vocab_size = len(self.vocab_list)
        self.padding_token = padding_token
        self.unk_token = unk_token
        self.padding_id = self.phoneme_to_id.get(padding_token, 0)
        self.unk_id = self.phoneme_to_id.get(unk_token, self.padding_id)

    def text_to_phonemes(self, text: str, g2p_processor=None) -> List[str]:
        if g2p_processor is not None:
            result = g2p_processor(text)
            if isinstance(result, dict):
                return result.get("ph", "").split()
            return result.split() if isinstance(result, str) else list(result)
        return text.split()

    def phonemes_to_ids(self, phonemes: Sequence[str]) -> List[int]:
        return [self.phoneme_to_id.get(p, self.unk_id) for p in phonemes]

    def ids_to_phonemes(self, ids: Sequence[int]) -> List[str]:
        return [self.id_to_phoneme.get(i, self.unk_token) for i in ids]

    def process_text(self, text, g2p_processor=None, max_length=None):
        phonemes = self.text_to_phonemes(text, g2p_processor)
        if max_length is not None:
            phonemes = phonemes[:max_length]
        return self.phonemes_to_ids(phonemes), phonemes

    def create_phoneme_embedding(self, embedding_dim: int, padding_idx: Optional[int] = None):
        """Build a phoneme embedding table (vocab_size, dim) with the pad row
        zeroed (reference: text_encoder.py:349-367's nn.Embedding role).
        Returns a float32 numpy array usable as a flax Embed init."""
        if padding_idx is None:
            padding_idx = self.padding_id
        rng = np.random.RandomState(0)
        table = (rng.randn(self.vocab_size, embedding_dim) / np.sqrt(embedding_dim)).astype(
            np.float32
        )
        table[padding_idx] = 0.0
        return table

    def create_positional_encoding(
        self, max_length: int, embedding_dim: int, padding_idx: Optional[int] = None
    ) -> np.ndarray:
        """Sinusoidal positional table (reference: text_encoder.py:369-384),
        with the padding row zeroed when given."""
        from mamba_tts_torch.models.text_encoder import sinusoid_position_table

        table = sinusoid_position_table(max_length, embedding_dim).copy()
        if padding_idx is None:
            padding_idx = self.padding_id
        if padding_idx is not None and 0 <= padding_idx < max_length:
            table[padding_idx] = 0.0
        return table

    def batch_process(
        self,
        texts: Sequence[str],
        g2p_processor=None,
        max_length: Optional[int] = None,
        pad_to: Optional[int] = None,
    ) -> Tuple[np.ndarray, List[int], np.ndarray]:
        """Batch tokenize with padding.

        Returns (ids (B, L) int32, lengths, mask (B, L) bool True=VALID).
        ``pad_to`` fixes the padded length (static shapes for jit); default
        pads to the batch max like the reference.
        """
        ids_list, lengths = [], []
        for text in texts:
            ids, _ = self.process_text(text, g2p_processor, max_length)
            ids_list.append(ids)
            lengths.append(len(ids))
        L = pad_to if pad_to is not None else (max(lengths) if lengths else 0)
        batch = np.full((len(texts), L), self.padding_id, np.int32)
        mask = np.zeros((len(texts), L), bool)
        for i, ids in enumerate(ids_list):
            n = min(len(ids), L)
            batch[i, :n] = ids[:n]
            mask[i, :n] = True
        return batch, lengths, mask


class PhonemeFrontend:
    """End-to-end: raw text -> phoneme ids, composing TxtProcessor (G2P) with
    TextProcessor (vocab).  This wires the real G2P path into training, which
    the reference bypasses (its train loop splits raw words and maps them to
    UNK -> pad id 0 — reference: train.py:73-81; SURVEY §7 defect 7)."""

    def __init__(
        self,
        vocab_path: Optional[str] = None,
        vocab_list: Optional[Sequence[str]] = None,
        cmudict_path: Optional[str] = None,
    ):
        self.txt = TxtProcessor(cmudict_path)
        self.vocab = TextProcessor(vocab_path=vocab_path, vocab_list=vocab_list)

    def encode(self, text: str) -> List[int]:
        ph, *_ = self.txt.txt_to_ph(text)
        return self.vocab.phonemes_to_ids(ph.split())

    def encode_batch(
        self, texts: Sequence[str], pad_to: Optional[int] = None
    ) -> Tuple[np.ndarray, List[int], np.ndarray]:
        phoneme_strs = [" ".join(self.txt.txt_to_ph(t)[0].split()) for t in texts]
        return self.vocab.batch_process(phoneme_strs, pad_to=pad_to)
