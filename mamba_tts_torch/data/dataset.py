"""VccmDataset / TextrolSpeech dataset wrapper (host-side) — the PyTorch
port's own copy of ``mamba_tts_tpu/data/dataset.py`` (framework-free; only
its imports point into this package).

Re-designs reference: dataset.py:16-109 — CSV of
(item_name, dur, pitch, energy, gender, emotion, spk, txt, style_prompt)
plus a tar(.gz) of WAVs; each example pairs the target utterance with a
*different random utterance of the same speaker* as the voice prompt.

Fixes vs reference (SURVEY §7 defect 7 area), and one of the port's own:
- ``__len__`` is the CSV row count, not the tar member count
  (reference: dataset.py:82-83 returns the tar count — a latent mismatch).
- the batch iterator zero-pads waveforms to the batch max instead of
  assuming equal lengths (reference collate_fn stacks unchecked —
  dataset.py:100-109).
- rows whose audio is missing from the tar are skipped-and-counted at init
  (the data pipeline's skip-and-count failure semantics, SURVEY §5).
- each process reads the archive through its own handle (a loader worker,
  forked or spawned, opens it again), where the JAX package's copy opens
  it once in ``__init__``.

Returns numpy arrays; all device work happens downstream.
"""
from __future__ import annotations

import csv
import io
import os
import tarfile
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from mamba_tts_torch.audio.wavio import read_wav_mono


class VccmTTSDataset:
    def __init__(
        self,
        csv_path: str = "VccmDataset/controlspeech_train.csv",
        audio_root: str = "TextrolSpeech_data.tar.gz",
        sample_rate: int = 16000,
        seed: int = 0,
        use_native: bool = True,
    ):
        self.csv_path = csv_path
        self.audio_root = audio_root
        self.sample_rate = sample_rate
        self._rng = np.random.RandomState(seed)

        # Prefer the C++ runtime (native/libttsdata.so: indexed tar + WAV
        # decode + resample, multi-threaded); fall back to tarfile + scipy.
        self.use_native = use_native
        self._open()
        if self._native is not None:
            self.members = {n: n for n in self._native.names()}
        else:
            self.members = {
                m.name: m
                for m in self.tar.getmembers()
                if m.isfile() and m.name.endswith(".wav")
            }
        with open(csv_path, encoding="utf-8") as f:
            rows = list(csv.DictReader(f))

        self.rows: List[dict] = []
        self.skipped = 0
        for row in rows:
            if self._member_name(row["item_name"]) in self.members:
                self.rows.append(row)
            else:
                self.skipped += 1

        self.speaker_map: Dict[str, List[str]] = {}
        for row in self.rows:
            self.speaker_map.setdefault(row["spk"], []).append(row["item_name"])

    @staticmethod
    def _member_name(item_name: str) -> str:
        return str(Path(item_name.replace("-", "/")).with_suffix(".wav"))

    def _open(self) -> None:
        """Open the archive for this process.  A file handle shared with a
        forked loader worker would share its offset too, so a process that
        did not open it (a worker, or an unpickled copy) opens its own."""
        self._pid = os.getpid()
        self._native = self.tar = None
        if self.use_native:
            from mamba_tts_torch.data import native

            if native.available():
                try:
                    self._native = native.NativeTarReader(self.audio_root)
                except Exception:
                    self._native = None
        if self._native is None:
            self.tar = tarfile.open(self.audio_root, "r:*")

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_native"] = state["tar"] = state["_pid"] = None
        return state

    def _wav(self, item_name: str) -> np.ndarray:
        name = self._member_name(item_name)
        if self._pid != os.getpid():
            self._open()
        if self._native is not None:
            return self._native.read_wav(name, target_sr=self.sample_rate)
        data = self.tar.extractfile(self.members[name]).read()
        wav, _ = read_wav_mono(data, target_sr=self.sample_rate)
        return wav

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int) -> Tuple[dict, np.ndarray]:
        row = self.rows[idx]
        item_name = row["item_name"]
        candidates = [n for n in self.speaker_map[row["spk"]] if n != item_name]
        voice_name = candidates[self._rng.randint(len(candidates))] if candidates else item_name
        return (
            {
                "voice_waveform": self._wav(voice_name),
                "text_prompt": row["txt"],
                "style_prompt": row["style_prompt"],
            },
            self._wav(item_name),
        )

    def batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        seed: Optional[int] = None,
        drop_last: bool = True,
    ) -> Iterator[Tuple[dict, np.ndarray]]:
        """Yields ({'voice_waveform': (B, T), 'text_prompt': [...],
        'style_prompt': [...]}, target_waveform (B, T')) with zero-padded
        waveforms."""
        order = np.arange(len(self))
        if shuffle:
            np.random.RandomState(self._rng.randint(2**31) if seed is None else seed).shuffle(order)
        for start in range(0, len(order) - (batch_size - 1 if drop_last else 0), batch_size):
            idxs = order[start : start + batch_size]
            if len(idxs) == 0:
                break
            items = [self[int(i)] for i in idxs]
            voices = [it[0]["voice_waveform"] for it in items]
            targets = [it[1] for it in items]
            yield (
                {
                    "voice_waveform": _pad_stack(voices),
                    "text_prompt": [it[0]["text_prompt"] for it in items],
                    "style_prompt": [it[0]["style_prompt"] for it in items],
                },
                _pad_stack(targets),
            )


def _pad_stack(waves: List[np.ndarray]) -> np.ndarray:
    max_len = max(w.shape[0] for w in waves)
    out = np.zeros((len(waves), max_len), np.float32)
    for i, w in enumerate(waves):
        out[i, : w.shape[0]] = w
    return out


def make_synthetic_dataset(
    tmpdir: str,
    n_items: int = 8,
    n_speakers: int = 2,
    sample_rate: int = 16000,
    seconds: float = 0.4,
) -> Tuple[str, str]:
    """Build a tiny synthetic CSV + tar.gz dataset (for tests and CPU smoke
    runs; the reference has no hardware-independent data fixture)."""
    import random

    from mamba_tts_torch.audio.wavio import write_wav

    tmpdir = Path(tmpdir)
    tmpdir.mkdir(parents=True, exist_ok=True)
    wav_dir = tmpdir / "wavs"
    wav_dir.mkdir(exist_ok=True)
    rng = random.Random(0)
    texts = [
        "hello world", "the quick brown fox", "speak to me now",
        "this is a test", "good day to you", "one two three four",
        "keep it simple", "make it fast",
    ]
    styles = [
        "speak in a fast and energetic voice",
        "use a slow and calm speaking style",
    ]
    rows = []
    tar_path = str(tmpdir / "data.tar.gz")
    with tarfile.open(tar_path, "w:gz") as tar:
        for i in range(n_items):
            spk = f"spk{i % n_speakers}"
            item = f"{spk}-utt{i}"
            t = np.arange(int(sample_rate * seconds)) / sample_rate
            freq = 200 + 50 * i
            wav = (0.3 * np.sin(2 * np.pi * freq * t)).astype(np.float32)
            path = wav_dir / f"utt{i}.wav"
            write_wav(str(path), wav, sample_rate)
            tar.add(str(path), arcname=f"{spk}/utt{i}.wav")
            rows.append(
                dict(
                    item_name=item, dur="normal", pitch="normal", energy="normal",
                    gender="M", emotion="neutral", spk=spk,
                    txt=rng.choice(texts), style_prompt=rng.choice(styles),
                )
            )
    csv_path = str(tmpdir / "train.csv")
    with open(csv_path, "w", newline="", encoding="utf-8") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
    return csv_path, tar_path
