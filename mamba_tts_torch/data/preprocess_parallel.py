"""Offline dataset preprocessing, parallel pipeline — counterpart of
``mamba_tts_tpu/data/preprocess_parallel.py``, wired to the port's
front-ends on ``device`` (the card by default).

Re-designs reference: data_utils/preprocess_parallel.py:445-557 as the same
6-stage host pipeline (the reference's only parallelism — SURVEY §2.3):

    [1] CSV load
    [2] G2P in a ProcessPoolExecutor (per-worker TxtProcessor initializer —
        G2P is pure-Python CPU-bound); its workers are spawned, not forked,
        and the pool ends before any model is built, so no worker ever
        holds or initialises a CUDA context
    [3] tar byte extraction (main thread; tarfile handles are not picklable)
    [4] batched style-text BERT on the card
    [5] batched FACodec encode on the card
    [6] async array writes in a ThreadPoolExecutor

The output is ``data/preprocess.py``'s format, file for file.  CLI adds
``--cpu_workers --gpu_batch_size --io_workers`` over the sequential variant
(reference: preprocess_parallel.py:598-603).
"""
from __future__ import annotations

import argparse
import csv
import json
import multiprocessing
import tarfile
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mamba_tts_torch import config as config_lib
from mamba_tts_torch.audio.codec import FACodecTokenizer
from mamba_tts_torch.config import TTSConfig
from mamba_tts_torch.data.preprocess import item_name_to_path, safe_item_name
from mamba_tts_torch.models.style_text_encoder import StyleTextEncoder
from mamba_tts_torch.text.processor import TextProcessor

_WORKER_TXT = None


def _init_text_worker():
    """Per-worker initializer: build the G2P processor once per process
    (reference: preprocess_parallel.py:44-47)."""
    global _WORKER_TXT
    from mamba_tts_torch.text.processor import TxtProcessor

    _WORKER_TXT = TxtProcessor()


def _g2p_one(text: str):
    ph, txt, word, ph2word, _ = _WORKER_TXT.txt_to_ph(text)
    return ph, txt, ph2word


def process_text_parallel(texts: List[str], cpu_workers: int) -> List[Tuple[str, str, list]]:
    """Stage [2]: parallel G2P (reference: preprocess_parallel.py:85-125)."""
    if cpu_workers <= 1:
        _init_text_worker()
        return [_g2p_one(t) for t in texts]
    with ProcessPoolExecutor(max_workers=cpu_workers, initializer=_init_text_worker,
                             mp_context=multiprocessing.get_context("spawn")) as ex:
        return list(ex.map(_g2p_one, texts, chunksize=16))


class BatchedStyleProcessor:
    """Stage [4]: batched BERT embedding (reference: preprocess_parallel.py:132-174)."""

    def __init__(self, cfg: TTSConfig, batch_size: int = 16, device="cuda"):
        self.encoder = StyleTextEncoder(cfg.style_encoder, device=device)
        self.batch_size = batch_size

    @torch.no_grad()
    def embed_batch(self, prompts: List[str]) -> np.ndarray:
        outs = []
        for i in range(0, len(prompts), self.batch_size):
            outs.append(self.encoder.embed(prompts[i : i + self.batch_size]).cpu().numpy())
        return np.concatenate(outs, axis=0) if outs else np.zeros((0, 768), np.float32)


class BatchedAudioEncoder:
    """Stage [5]: batched FACodec encode (reference: preprocess_parallel.py:177-288)."""

    def __init__(self, cfg: TTSConfig, batch_size: int = 16, codec_ckpts=None, device="cuda"):
        enc_ckpt, dec_ckpt = codec_ckpts or (None, None)
        self.tokenizer = FACodecTokenizer(
            cfg.codec, device=device, torch_encoder_ckpt=enc_ckpt, torch_decoder_ckpt=dec_ckpt
        )
        self.batch_size = batch_size

    def encode_batch(
        self, audio_bytes: List[Optional[bytes]]
    ) -> List[Tuple[Optional[np.ndarray], Optional[np.ndarray]]]:
        results: List[Tuple[Optional[np.ndarray], Optional[np.ndarray]]] = []
        pending: List[bytes] = []
        pending_idx: List[int] = []
        results = [(None, None)] * len(audio_bytes)
        for i, b in enumerate(audio_bytes):
            if b is not None:
                pending.append(b)
                pending_idx.append(i)
        for start in range(0, len(pending), self.batch_size):
            chunk = pending[start : start + self.batch_size]
            idxs = pending_idx[start : start + self.batch_size]
            try:
                codec, spk = self.tokenizer.encode(chunk)
                for j, idx in enumerate(idxs):
                    results[idx] = (codec[j : j + 1], spk[j : j + 1])
            except Exception as e:  # skip-and-count the whole failed chunk
                print(f"  batch encode error: {e}")
        return results


class AsyncTensorWriter:
    """Stage [6]: async .npy writes (reference: preprocess_parallel.py:295-340)."""

    def __init__(self, tensors_dir: Path, io_workers: int = 4):
        self.dir = tensors_dir
        self.pool = ThreadPoolExecutor(max_workers=io_workers)
        self.futures = []

    def submit(self, name: str, arrays: Dict[str, np.ndarray]):
        def write():
            for suffix, arr in arrays.items():
                np.save(self.dir / f"{name}_{suffix}.npy", arr)

        self.futures.append(self.pool.submit(write))

    def wait(self):
        for f in self.futures:
            f.result()
        self.pool.shutdown()


class ParallelDatasetPreprocessor:
    def __init__(
        self,
        output_dir: str,
        tarball_paths: List[str],
        phoneme_vocab_path: str = "phoneme_vocab.json",
        cfg: Optional[TTSConfig] = None,
        cpu_workers: int = 4,
        gpu_batch_size: int = 16,
        io_workers: int = 4,
        debug: bool = False,
        codec_ckpts=None,
        device="cuda",
    ):
        self.cfg = cfg or TTSConfig()
        self.codec_ckpts = codec_ckpts
        self.device = device
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.cpu_workers = cpu_workers
        self.gpu_batch_size = gpu_batch_size
        self.io_workers = io_workers
        self.debug = debug
        self.text_processor = TextProcessor(vocab_path=phoneme_vocab_path)
        self.tarballs = [tarfile.open(p, "r:*") for p in tarball_paths]
        self.audio_index = {}
        for tar in self.tarballs:
            for m in tar.getmembers():
                if m.isfile() and m.name.endswith(".wav"):
                    self.audio_index[m.name] = (tar, m)

    def preprocess(self, csv_path: str) -> int:
        # [1] CSV
        with open(csv_path, encoding="utf-8") as f:
            rows = list(csv.DictReader(f))
        if self.debug:
            rows = rows[:10]
        print(f"[1/6] loaded {len(rows)} rows")

        # [2] parallel G2P
        g2p_out = process_text_parallel([r["txt"] for r in rows], self.cpu_workers)
        print(f"[2/6] G2P done ({self.cpu_workers} workers)")

        # [3] tar extraction
        audio_bytes: List[Optional[bytes]] = []
        for r in rows:
            entry = self.audio_index.get(item_name_to_path(r["item_name"]))
            if entry is None:
                audio_bytes.append(None)
            else:
                tar, member = entry
                f = tar.extractfile(member)
                audio_bytes.append(f.read() if f else None)
        print(f"[3/6] extracted {sum(b is not None for b in audio_bytes)} wavs")

        # [4] batched style embeddings
        style = BatchedStyleProcessor(self.cfg, self.gpu_batch_size, self.device)
        style_embs = style.embed_batch([r["style_prompt"] for r in rows])
        print(f"[4/6] style embeddings {style_embs.shape}")

        # [5] batched codec encode
        audio = BatchedAudioEncoder(self.cfg, self.gpu_batch_size, self.codec_ckpts, self.device)
        codec_out = audio.encode_batch(audio_bytes)
        print("[5/6] codec encode done")

        # [6] async writes
        tensors_dir = self.output_dir / "tensors"
        tensors_dir.mkdir(exist_ok=True)
        writer = AsyncTensorWriter(tensors_dir, self.io_workers)
        metadata = []
        processed = skipped = 0
        for i, (row, (ph, txt, ph2word), (codec, spk)) in enumerate(
            zip(rows, g2p_out, codec_out)
        ):
            if codec is None:
                skipped += 1
                continue
            phonemes = ph.split()
            name = safe_item_name(row["item_name"])
            writer.submit(
                name,
                {
                    "phonemes": np.asarray(
                        self.text_processor.phonemes_to_ids(phonemes), np.int32
                    ),
                    "style": style_embs[i : i + 1],
                    "codec": codec,
                    "spk_emb": spk,
                },
            )
            metadata.append(
                {
                    "item_name": row["item_name"],
                    "text": row["txt"],
                    "phonemes": phonemes,
                    "phoneme_str": ph,
                    "ph2word": ph2word,
                    "style_prompt": row["style_prompt"],
                    "emotion": row.get("emotion", ""),
                    "gender": row.get("gender", ""),
                    "speaker": row.get("spk", ""),
                    "dur_label": row.get("dur", ""),
                    "pitch_label": row.get("pitch", ""),
                    "energy_label": row.get("energy", ""),
                }
            )
            processed += 1
        writer.wait()
        with open(self.output_dir / "metadata.json", "w") as f:
            json.dump(metadata, f, indent=2)
        print(f"[6/6] wrote {processed} items (skipped {skipped})")
        return processed


def main(argv=None):
    parser = argparse.ArgumentParser(description="Parallel offline preprocessing")
    parser.add_argument("--csv_path", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--tarball", type=str, nargs="+", required=True)
    parser.add_argument("--phoneme_vocab_path", type=str, default="phoneme_vocab.json")
    parser.add_argument("--cpu_workers", type=int, default=4)
    parser.add_argument("--gpu_batch_size", type=int, default=16)
    parser.add_argument("--io_workers", type=int, default=4)
    parser.add_argument("--debug", action="store_true")
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
    pre = ParallelDatasetPreprocessor(
        args.output_dir, args.tarball, args.phoneme_vocab_path, cfg=cfg,
        cpu_workers=args.cpu_workers, gpu_batch_size=args.gpu_batch_size,
        io_workers=args.io_workers, debug=args.debug, codec_ckpts=ckpts, device=args.device,
    )
    return pre.preprocess(args.csv_path)


if __name__ == "__main__":
    main()
