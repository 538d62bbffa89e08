"""Offline dataset preprocessing (sequential) — counterpart of
``mamba_tts_tpu/data/preprocess.py``, wired to the port's front-ends (the
phoneme G2P, BERT and FACodec on ``device``, the card by default).

Re-designs reference: data_utils/preprocess.py — one-time CSV sweep that
materializes per-item arrays + ``metadata.json``, file for file the JAX
package's format (a directory written by either package trains the other):

    out_dir/tensors/{item}_phonemes.npy   int32 phoneme ids
    out_dir/tensors/{item}_style.npy      (1, bert_dim) style embedding
    out_dir/tensors/{item}_codec.npy      (1, max_seq_len, 5) shifted codec ids
    out_dir/tensors/{item}_spk_emb.npy    (1, spk_dim) speaker embedding
    out_dir/metadata.json                 per-item text/phoneme/label metadata

Failure semantics: skip-and-count per item (reference: preprocess.py:243-252).
Unlike the reference, the offline output is actually consumable by training:
:class:`OfflineDataset` loads it back (SURVEY §1 notes the reference never
wires its offline path into train.py).

CLI:
    python -m mamba_tts_torch.data.preprocess --csv_path ... --output_dir ...
        --tarball ... [--phoneme_vocab_path phoneme_vocab.json] [--debug]
        [--device cpu]
"""
from __future__ import annotations

import argparse
import csv
import json
import tarfile
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from mamba_tts_torch import config as config_lib
from mamba_tts_torch.audio.codec import FACodecTokenizer
from mamba_tts_torch.config import TTSConfig
from mamba_tts_torch.models.style_text_encoder import StyleTextEncoder
from mamba_tts_torch.text.processor import TextProcessor, TxtProcessor


def item_name_to_path(item_name: str) -> str:
    """item_name -> tar member path (dataset convention: '-' means '/')."""
    return str(Path(item_name.replace("-", "/")).with_suffix(".wav"))


def safe_item_name(item_name: str) -> str:
    return item_name.replace("/", "_").replace(" ", "_")


class DatasetPreprocessor:
    def __init__(
        self,
        output_dir: str,
        tarball_paths: List[str],
        phoneme_vocab_path: str = "phoneme_vocab.json",
        cfg: Optional[TTSConfig] = None,
        debug: bool = False,
        codec_ckpts: Optional[Tuple[str, str]] = None,
        device="cuda",
    ):
        self.cfg = cfg or TTSConfig()
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.debug = debug

        self.txt_processor = TxtProcessor()
        self.text_processor = TextProcessor(vocab_path=phoneme_vocab_path)
        self.style_encoder = StyleTextEncoder(self.cfg.style_encoder, device=device)
        enc_ckpt, dec_ckpt = codec_ckpts or (None, None)
        self.tokenizer = FACodecTokenizer(
            self.cfg.codec, device=device, torch_encoder_ckpt=enc_ckpt,
            torch_decoder_ckpt=dec_ckpt,
        )

        self.tarballs = [tarfile.open(p, "r:*") for p in tarball_paths]
        self.audio_index: Dict[str, Tuple[tarfile.TarFile, tarfile.TarInfo]] = {}
        for tar in self.tarballs:
            for m in tar.getmembers():
                if m.isfile() and m.name.endswith(".wav"):
                    self.audio_index[m.name] = (tar, m)

    # ------------------------------------------------------------ per-field

    def process_text(self, text: str) -> dict:
        ph, txt, word, ph2word, _ = self.txt_processor.txt_to_ph(text)
        phonemes = ph.split()
        return {
            "phonemes": phonemes,
            "phoneme_ids": self.text_processor.phonemes_to_ids(phonemes),
            "phoneme_str": ph,
            "cleaned_text": txt,
            "words": word.split(),
            "ph2word": ph2word,
        }

    @torch.no_grad()
    def process_style(self, style_prompt: str) -> np.ndarray:
        return self.style_encoder.embed([style_prompt]).cpu().numpy()

    def process_audio(self, wav_path: str) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        try:
            if wav_path not in self.audio_index:
                print(f"  Audio not found in tarball: {wav_path}")
                return None, None
            tar, member = self.audio_index[wav_path]
            f = tar.extractfile(member)
            if f is None:
                print(f"  Could not extract: {wav_path}")
                return None, None
            codec, spk = self.tokenizer.encode(f.read())
            return codec, spk
        except Exception as e:
            print(f"  Audio encoding error: {e}")
            return None, None

    def process_row(self, row: dict) -> Optional[dict]:
        audio_path = item_name_to_path(row["item_name"])
        text_data = self.process_text(row["txt"])
        style_emb = self.process_style(row["style_prompt"])
        codec, spk = self.process_audio(audio_path)
        if codec is None:
            return None
        return {
            "item_name": row["item_name"],
            "text": row["txt"],
            **{k: text_data[k] for k in ("phonemes", "phoneme_ids", "phoneme_str", "ph2word")},
            "style_emb": style_emb,
            "style_prompt": row["style_prompt"],
            "emotion": row.get("emotion", ""),
            "gender": row.get("gender", ""),
            "speaker": row.get("spk", ""),
            "dur_label": row.get("dur", ""),
            "pitch_label": row.get("pitch", ""),
            "energy_label": row.get("energy", ""),
            "codec_tokens": codec,
            "spk_emb": spk,
        }

    # ----------------------------------------------------------------- main

    def preprocess(self, csv_path: str, flush_every: int = 100) -> int:
        with open(csv_path, encoding="utf-8") as f:
            rows = list(csv.DictReader(f))
        print(f"Found {len(rows)} rows in CSV")
        tensors_dir = self.output_dir / "tensors"
        tensors_dir.mkdir(exist_ok=True)

        buffer: List[dict] = []
        all_metadata: List[dict] = []
        skipped = errors = total = 0
        rows_to_process = rows[:10] if self.debug else rows

        for row in rows_to_process:
            try:
                item = self.process_row(row)
                if item is None:
                    skipped += 1
                    continue
                buffer.append(item)
                total += 1
                if len(buffer) >= flush_every:
                    self._flush(buffer, tensors_dir, all_metadata)
                    buffer.clear()
            except Exception as e:
                errors += 1
                if errors <= 5:
                    print(f"Error processing {row.get('item_name', '?')}: {e}")
        if buffer:
            self._flush(buffer, tensors_dir, all_metadata)

        meta_path = self.output_dir / "metadata.json"
        with open(meta_path, "w") as f:
            json.dump(all_metadata, f, indent=2)
        print(
            f"Preprocessing complete: processed={total} skipped={skipped} "
            f"errors={errors} total_rows={len(rows_to_process)}"
        )
        return total

    @staticmethod
    def _flush(buffer: List[dict], tensors_dir: Path, all_metadata: List[dict]):
        for item in buffer:
            name = safe_item_name(item["item_name"])
            np.save(tensors_dir / f"{name}_phonemes.npy",
                    np.asarray(item["phoneme_ids"], np.int32))
            np.save(tensors_dir / f"{name}_style.npy", item["style_emb"])
            np.save(tensors_dir / f"{name}_codec.npy", item["codec_tokens"])
            np.save(tensors_dir / f"{name}_spk_emb.npy", item["spk_emb"])
            all_metadata.append(
                {
                    k: item[k]
                    for k in (
                        "item_name", "text", "phonemes", "phoneme_str", "ph2word",
                        "style_prompt", "emotion", "gender", "speaker",
                        "dur_label", "pitch_label", "energy_label",
                    )
                }
            )


class OfflineDataset:
    """Consume a preprocessed directory (the capability the reference's
    train.py never wires up)."""

    def __init__(self, preprocessed_dir: str):
        self.root = Path(preprocessed_dir)
        with open(self.root / "metadata.json") as f:
            self.metadata = json.load(f)
        self.tensors = self.root / "tensors"
        self.speaker_map: Dict[str, list] = {}
        for i, meta in enumerate(self.metadata):
            self.speaker_map.setdefault(meta.get("speaker", ""), []).append(i)

    def __len__(self) -> int:
        return len(self.metadata)

    def __getitem__(self, idx: int) -> dict:
        meta = self.metadata[idx]
        name = safe_item_name(meta["item_name"])
        return {
            **meta,
            "phoneme_ids": np.load(self.tensors / f"{name}_phonemes.npy"),
            "style_emb": np.load(self.tensors / f"{name}_style.npy"),
            "codec_tokens": np.load(self.tensors / f"{name}_codec.npy"),
            "spk_emb": np.load(self.tensors / f"{name}_spk_emb.npy"),
        }

    def batches(
        self,
        batch_size: int,
        max_text_len: int = 256,
        frame_bucket: int = 128,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
    ) -> "Iterator[dict]":
        """Jit-ready training batches straight from preprocessed tensors —
        no G2P / BERT / codec work in the training loop.  Voice prompts are
        the codec tokens of another random utterance of the same speaker
        (the online dataset's pairing rule — reference: dataset.py:85-92).
        """
        rng = np.random.RandomState(seed)
        order = np.arange(len(self))
        if shuffle:
            rng.shuffle(order)
        step = batch_size
        for start in range(0, len(order) - (step - 1 if drop_last else 0), step):
            idxs = order[start : start + step]
            if len(idxs) == 0:
                break
            items = [self[int(i)] for i in idxs]
            voices = []
            for i_local, it in enumerate(items):
                pool = [
                    j for j in self.speaker_map.get(it.get("speaker", ""), [])
                    if self.metadata[j]["item_name"] != it["item_name"]
                ]
                # no other utterance of this speaker -> use the item itself
                # (the online dataset's degenerate-case behavior)
                j = pool[rng.randint(len(pool))] if pool else int(idxs[i_local])
                voices.append(self[j])

            B = len(items)
            phon = np.zeros((B, max_text_len), np.int32)
            mask = np.zeros((B, max_text_len), bool)
            for i, it in enumerate(items):
                n = min(len(it["phoneme_ids"]), max_text_len)
                phon[i, :n] = it["phoneme_ids"][:n]
                mask[i, :n] = True

            def stack_codec(objs):
                c = np.concatenate([o["codec_tokens"] for o in objs], axis=0)
                lengths = (c != 0).any(axis=2).sum(axis=1).astype(np.int32)
                max_f = max(int(lengths.max()), frame_bucket)
                bucketed = -(-max_f // frame_bucket) * frame_bucket
                return c[:, : min(bucketed, c.shape[1])], lengths

            target_codec, target_frames = stack_codec(items)
            voice_codec, _ = stack_codec(voices)
            yield {
                "phoneme_ids": phon,
                "text_mask": mask,
                "style_bert": np.concatenate([it["style_emb"] for it in items], axis=0),
                "spk_embs": np.concatenate([it["spk_emb"] for it in items], axis=0),
                "target_codec": target_codec,
                "target_frames": target_frames,
                "voice_codec": voice_codec,
            }


def main(argv=None):
    parser = argparse.ArgumentParser(description="Offline dataset preprocessing")
    parser.add_argument("--csv_path", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--tarball", type=str, nargs="+", required=True)
    parser.add_argument("--phoneme_vocab_path", type=str, default="phoneme_vocab.json")
    parser.add_argument("--flush_every", type=int, default=100)
    parser.add_argument("--debug", action="store_true", help="process only 10 rows")
    parser.add_argument("--facodec_encoder_ckpt", type=str, default=None,
                        help="ns3_facodec_encoder.bin (pretrained weights)")
    parser.add_argument("--facodec_decoder_ckpt", type=str, default=None)
    parser.add_argument("--config_json", type=str, default=None,
                        help="a TTSConfig JSON (its codec, style_encoder and data sections)")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    ckpts = (
        (args.facodec_encoder_ckpt, args.facodec_decoder_ckpt)
        if args.facodec_encoder_ckpt else None
    )
    cfg = config_lib.from_json(open(args.config_json).read()) if args.config_json else None
    pre = DatasetPreprocessor(
        args.output_dir, args.tarball, args.phoneme_vocab_path, cfg=cfg, debug=args.debug,
        codec_ckpts=ckpts, device=args.device,
    )
    return pre.preprocess(args.csv_path, flush_every=args.flush_every)


if __name__ == "__main__":
    main()
