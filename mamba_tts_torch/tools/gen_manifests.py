"""Generate the pinned checkpoint key-inventory manifests: the counterpart
of ``mamba_tts_tpu/tools/gen_manifests.py``.

Writes name -> shape JSON fixtures under tests/data/ for:

- ``bert_base_uncased_manifest.json``: the released HF ``bert-base-uncased``
  inventory in BOTH namings: the raw ``pytorch_model.bin`` (``bert.``
  prefix, historical ``LayerNorm.gamma/beta``, ``cls.*`` pretraining heads)
  and ``BertModel.from_pretrained().state_dict()`` (stripped, renamed,
  ``pooler``).  BERT-base is fully regular, so the inventory is authored
  here from the architecture (12 layers, hidden 768, intermediate 3072,
  vocab 30522, positions 512, types 2).  reference: smsd.py:39-45.
- ``facodec_consumed_manifest.json``: every ``ns3_facodec_encoder.bin`` /
  ``ns3_facodec_decoder.bin`` key that ``convert_torch_facodec`` consumes, at
  the released scale (``CodecConfig()``: ngf 32, up_ratios 2/4/5/5, latent
  256, codebooks 2**10 x 8, 4-layer timbre transformer d=256), from the
  upstream-graph replicas of ``tools/facodec_replicas.py``.  Extra release
  keys (gradient-reversal heads, f0/phone predictors) are ignored by the
  converter by design and are not inventoried.
  reference: data_utils/audio_encoder.py:143-173.

Run: ``python -m mamba_tts_torch.tools.gen_manifests [OUT_DIR]`` (tests/data
by default).  The converters' tests read the fixtures: every manifest key
must be consumed with the recorded shape, so a mapping drift fails before a
user's first real-checkpoint load.  Both packages write the same bytes.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import torch

from mamba_tts_torch.config import CodecConfig
from mamba_tts_torch.tools import facodec_replicas

H, FF, V, P, T, L = 768, 3072, 30522, 512, 2, 12


def bert_manifest() -> dict:
    raw = {
        "bert.embeddings.word_embeddings.weight": [V, H],
        "bert.embeddings.position_embeddings.weight": [P, H],
        "bert.embeddings.token_type_embeddings.weight": [T, H],
        "bert.embeddings.LayerNorm.gamma": [H],
        "bert.embeddings.LayerNorm.beta": [H],
        "bert.pooler.dense.weight": [H, H],
        "bert.pooler.dense.bias": [H],
        "cls.predictions.bias": [V],
        "cls.predictions.transform.dense.weight": [H, H],
        "cls.predictions.transform.dense.bias": [H],
        "cls.predictions.transform.LayerNorm.gamma": [H],
        "cls.predictions.transform.LayerNorm.beta": [H],
        "cls.predictions.decoder.weight": [V, H],
        "cls.seq_relationship.weight": [2, H],
        "cls.seq_relationship.bias": [2],
    }
    for i in range(L):
        e = f"bert.encoder.layer.{i}"
        for name in ("attention.self.query", "attention.self.key",
                     "attention.self.value", "attention.output.dense"):
            raw[f"{e}.{name}.weight"] = [H, H]
            raw[f"{e}.{name}.bias"] = [H]
        raw[f"{e}.attention.output.LayerNorm.gamma"] = [H]
        raw[f"{e}.attention.output.LayerNorm.beta"] = [H]
        raw[f"{e}.intermediate.dense.weight"] = [FF, H]
        raw[f"{e}.intermediate.dense.bias"] = [FF]
        raw[f"{e}.output.dense.weight"] = [H, FF]
        raw[f"{e}.output.dense.bias"] = [H]
        raw[f"{e}.output.LayerNorm.gamma"] = [H]
        raw[f"{e}.output.LayerNorm.beta"] = [H]

    # BertModel.state_dict() naming: stripped prefix, gamma/beta -> weight/
    # bias, no cls.* heads (what transformers hands the reference).
    statedict = {}
    for k, v in raw.items():
        if k.startswith("cls."):
            continue
        k = k[len("bert."):]
        k = k.replace("LayerNorm.gamma", "LayerNorm.weight")
        k = k.replace("LayerNorm.beta", "LayerNorm.bias")
        statedict[k] = v
    return {"raw_bin": raw, "bertmodel_statedict": statedict}


def facodec_manifest() -> dict:
    """Released-scale key inventory from the upstream-graph replicas, built
    on the meta device: only the shapes are read."""
    cfg = CodecConfig()  # released scale is the default config
    with torch.device("meta"):
        enc = facodec_replicas.TEncoder(cfg)
        dec = facodec_replicas.TDecoder(cfg)
    return {
        "encoder": {k: list(v.shape) for k, v in enc.state_dict().items()},
        "decoder": {k: list(v.shape) for k, v in dec.state_dict().items()},
    }


def main(out_dir: Optional[str] = None) -> str:
    """Write both manifests into ``out_dir`` (the repository's tests/data by
    default) with ``json.dump(indent=1, sort_keys=True)``; returns the
    directory."""
    if out_dir is None:
        out_dir = os.path.join(os.path.dirname(__file__), "..", "..", "tests", "data")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "bert_base_uncased_manifest.json"), "w") as f:
        json.dump(bert_manifest(), f, indent=1, sort_keys=True)
    with open(os.path.join(out_dir, "facodec_consumed_manifest.json"), "w") as f:
        json.dump(facodec_manifest(), f, indent=1, sort_keys=True)
    print("wrote manifests to", os.path.abspath(out_dir))
    return out_dir


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir", nargs="?", default=None, help="default: tests/data")
    main(ap.parse_args().out_dir)
