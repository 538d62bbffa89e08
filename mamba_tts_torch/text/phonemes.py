"""Phoneme vocabulary builder (reference: data_utils/phonemes.py).

Sweeps a dataset CSV's text column through the G2P front-end, unions the
phonemes, and writes ``[specials..., sorted phonemes]`` as JSON.
"""
from __future__ import annotations

import argparse
import csv
import json
from typing import Dict, List

from mamba_tts_torch.text.processor import TxtProcessor

SPECIAL_TOKENS = ["<PAD>", "<BOS>", "<EOS>", "|", "!", ",", ".", ":", ";", "?"]

# The full ARPAbet phoneme set with stress digits — the shipped 79-token
# vocabulary (reference: phoneme_vocab.json = 10 specials + 69 phonemes).
ARPABET_STRESSED = [
    v + s
    for v in ["AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY", "IH", "IY",
              "OW", "OY", "UH", "UW"]
    for s in ["0", "1", "2"]
] + ["B", "CH", "D", "DH", "F", "G", "HH", "JH", "K", "L", "M", "N", "NG",
     "P", "R", "S", "SH", "T", "TH", "V", "W", "Y", "Z", "ZH"]


def default_vocab() -> List[str]:
    return SPECIAL_TOKENS + sorted(ARPABET_STRESSED)


def build_phoneme_vocabulary(
    csv_path: str,
    output_path: str = "phoneme_vocab.json",
    text_column: str = "txt",
) -> List[str]:
    phoneme_set = set()
    processor = TxtProcessor()
    with open(csv_path, encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    print(f"Processing {len(rows)} rows...")
    errors = 0
    for row in rows:
        text = (row.get(text_column) or "").strip()
        if not text:
            continue
        try:
            ph, *_ = processor.txt_to_ph(text)
            phoneme_set.update(ph.split())
        except Exception as e:  # skip-and-count, reference semantics
            errors += 1
            print(f"Error: {e}")
    vocab = SPECIAL_TOKENS.copy()
    vocab.extend(sorted(p for p in phoneme_set if p not in SPECIAL_TOKENS))
    with open(output_path, "w", encoding="utf-8") as f:
        json.dump(vocab, f, indent=2)
    print(f"\nVocabulary size: {len(vocab)} (errors: {errors})")
    print(f"Saved to: {output_path}")
    return vocab


def load_phoneme_vocabulary(vocab_path: str) -> Dict[str, int]:
    with open(vocab_path, encoding="utf-8") as f:
        vocab_list = json.load(f)
    return {ph: idx for idx, ph in enumerate(vocab_list)}


def main():
    parser = argparse.ArgumentParser(description="Build phoneme vocabulary from dataset")
    parser.add_argument("--csv_path", type=str, required=True)
    parser.add_argument("--output_path", type=str, default="phoneme_vocab.json")
    parser.add_argument("--text_column", type=str, default="txt")
    args = parser.parse_args()
    build_phoneme_vocabulary(args.csv_path, args.output_path, args.text_column)


if __name__ == "__main__":
    main()
