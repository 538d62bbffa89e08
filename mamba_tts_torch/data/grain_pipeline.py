"""Worker-backed input pipeline (the alternative to ``dataset.batches``) —
counterpart of ``mamba_tts_tpu/data/grain_pipeline.py``, on
``torch.utils.data.DataLoader`` in place of grain (which this package does
not use): a seeded shuffle, worker processes that read and decode the WAVs,
and the JAX package's padded batch collation (:func:`_collate`).

grain's shuffle order is grain's own and is not reproduced: here each epoch
is a ``torch.randperm`` drawn from one ``torch.Generator`` seeded with
``seed`` (:func:`epoch_orders`).  As grain's ``IndexSampler(num_epochs=...)``
with ``Batch(drop_remainder=True)`` does, one sampler runs over all epochs
and batches are cut across the epoch boundary, so only the stream's last
partial batch is dropped (none without an end); the ``DataLoader`` and its
workers are built once per call.  Workers are spawned, not forked, so that
none inherits a CUDA context or a thread of the training process; each reads
the archive through its own handle (``VccmTTSDataset`` opens one per
process).
"""
from __future__ import annotations

import itertools
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.data import DataLoader

from mamba_tts_torch.data.dataset import VccmTTSDataset, _pad_stack


class _Source(torch.utils.data.Dataset):
    """Random-access items of the dataset as dicts."""

    def __init__(self, dataset: VccmTTSDataset):
        self._ds = dataset

    def __len__(self) -> int:
        return len(self._ds)

    def __getitem__(self, idx):
        inputs, target = self._ds[int(idx)]
        return {
            "voice_waveform": inputs["voice_waveform"],
            "text_prompt": inputs["text_prompt"],
            "style_prompt": inputs["style_prompt"],
            "target_waveform": target,
        }


def _collate(items) -> Tuple[dict, np.ndarray]:
    return (
        {
            "voice_waveform": _pad_stack([it["voice_waveform"] for it in items]),
            "text_prompt": [it["text_prompt"] for it in items],
            "style_prompt": [it["style_prompt"] for it in items],
        },
        _pad_stack([it["target_waveform"] for it in items]),
    )


def epoch_orders(n: int, seed: int = 0, shuffle: bool = True) -> Iterator[List[int]]:
    """The item order of each epoch: permutations drawn in turn from one
    generator seeded with ``seed`` (or ``range(n)`` without shuffling)."""
    g = torch.Generator().manual_seed(seed)
    while True:
        yield torch.randperm(n, generator=g).tolist() if shuffle else list(range(n))


class _EpochStream(torch.utils.data.Sampler):
    """The item indices of ``num_epochs`` epochs (``None``: no end), one
    epoch's order after the other."""

    def __init__(self, n: int, seed: int, shuffle: bool, num_epochs: Optional[int]):
        self.n, self.seed, self.shuffle, self.num_epochs = n, seed, shuffle, num_epochs

    def __iter__(self):
        orders = epoch_orders(self.n, self.seed, self.shuffle)
        epochs = itertools.count() if self.num_epochs is None else range(self.num_epochs)
        for _ in epochs:
            yield from next(orders)


def make_grain_loader(
    dataset: VccmTTSDataset,
    batch_size: int,
    seed: int = 0,
    shuffle: bool = True,
    num_epochs: Optional[int] = 1,
    worker_count: int = 0,
) -> Iterator[Tuple[dict, np.ndarray]]:
    """Collated batches ``({'voice_waveform', 'text_prompt',
    'style_prompt'}, target (B, T))`` over ``num_epochs`` passes (``None``:
    no end), batched across the epoch boundaries; the stream's last
    incomplete batch is dropped.  ``worker_count > 0`` moves tar extraction
    and WAV decoding into that many worker processes (0: in this process),
    spawned once for the whole stream."""
    source = _Source(dataset)
    yield from DataLoader(
        source, batch_size=batch_size,
        sampler=_EpochStream(len(source), seed, shuffle, num_epochs), drop_last=True,
        collate_fn=_collate, num_workers=worker_count,
        multiprocessing_context="spawn" if worker_count > 0 else None,
    )
