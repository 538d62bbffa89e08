"""Weight bridge: JAX-package parameter trees -> the port's modules.

Takes the Flax ``params`` trees of ``mamba_tts_tpu`` as nested dicts of
**numpy arrays** (convert with ``jax.tree.map(np.asarray, params)`` on the
JAX side) and imports neither jax nor flax.  The port's modules carry the
Flax tree's names (``layer_0``, ``mamba``, ``LayerNorm_0``, ...), so each
leaf's module is found by its path and converted by the module's type:

- Dense ``kernel (in, out)``               -> ``Linear.weight (out, in)``
- Conv ``kernel (k, in, out)``             -> ``Conv1d.weight (out, in, k)``
- 2-D Conv ``kernel (kh, kw, in, out)``    -> ``Conv2d.weight (out, in, kh, kw)``
- ConvTranspose1dTorch ``kernel (k, in, out)``, stored flipped along k
                                           -> ``ConvTranspose1d.weight (in, out, k)``
- Embed ``embedding``                      -> ``Embedding.weight``
- LayerNorm ``scale`` / ``bias``           -> ``weight`` / ``bias``
- raw parameters (Mamba ``conv_w``, ``conv_b``, ``A_log``, ``D``; Snake
  ``alpha``; VQ ``codebook``; ``noise_scale``) -> copied as they are.

Every key must be consumed and every port parameter set; anything else
raises.  :func:`tree_from_npz` reads a tree saved as one ``.npz`` of
``/``-joined keys, the way in for the JAX package's orbax checkpoints
(README).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from mamba_tts_torch.config import CodecConfig, StyleEncoderConfig, TTSConfig
from mamba_tts_torch.models.discriminator import MultiSTFTDiscriminator
from mamba_tts_torch.models.facodec import ConvTranspose1dTorch, FACodec
from mamba_tts_torch.models.layers import Conv, Conv2d, Dense, Embed, LayerNorm
from mamba_tts_torch.models.style_text_encoder import BertEncoder
from mamba_tts_torch.models.tts import MambaTTS


def _target(mod: nn.Module, leaf: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    """(parameter attribute, value in the port's layout) for one Flax leaf."""
    if isinstance(mod, ConvTranspose1dTorch) and leaf == "kernel":
        return "weight", np.ascontiguousarray(value[::-1].transpose(1, 2, 0))
    if isinstance(mod, Conv) and leaf == "kernel":
        return "weight", np.ascontiguousarray(value.transpose(2, 1, 0))
    if isinstance(mod, Conv2d) and leaf == "kernel":
        return "weight", np.ascontiguousarray(value.transpose(3, 2, 0, 1))
    if isinstance(mod, Dense) and leaf == "kernel":
        return "weight", np.ascontiguousarray(value.T)
    if isinstance(mod, Embed) and leaf == "embedding":
        return "weight", value
    if isinstance(mod, LayerNorm) and leaf == "scale":
        return "weight", value
    return leaf, value


def load_params(module: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Copy a Flax ``params`` tree (numpy leaves) into ``module`` in place.

    Raises ``KeyError`` for a key with no port parameter, ``ValueError`` for
    a shape mismatch or for port parameters the tree leaves unset."""
    own = dict(module.named_parameters())
    assigned = set()

    def walk(node: Mapping[str, Any], path: Tuple[str, ...]):
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, path + (key,))
                continue
            where = "/".join(path + (key,))
            try:
                mod = module.get_submodule(".".join(path))
            except AttributeError:
                raise KeyError(f"bridge: no port module for key {where}") from None
            attr, arr = _target(mod, key, np.asarray(val, np.float32))
            name = ".".join(path + (attr,))
            if name not in own:
                raise KeyError(f"bridge: no port parameter for key {where} (looked for {name})")
            if tuple(own[name].shape) != arr.shape:
                raise ValueError(f"bridge: shape mismatch at {where}: port "
                                 f"{tuple(own[name].shape)} vs tree {arr.shape}")
            with torch.no_grad():
                own[name].copy_(torch.from_numpy(np.array(arr, np.float32)))
            assigned.add(name)

    walk(params, ())
    missing = sorted(set(own) - assigned)
    if missing:
        raise ValueError(f"bridge: port parameters left unset: {missing[:20]}"
                         + (f" ... {len(missing) - 20} more" if len(missing) > 20 else ""))
    return module


def mamba_tts_from_params(cfg: TTSConfig, params: Mapping[str, Any]) -> MambaTTS:
    """The JAX ``MambaTTS`` params tree -> a port :class:`MambaTTS` (CPU)."""
    return load_params(MambaTTS(cfg), params)


def facodec_from_params(cfg: CodecConfig, params: Mapping[str, Any]) -> FACodec:
    """The JAX ``FACodec`` params tree -> a port :class:`FACodec` (CPU)."""
    return load_params(FACodec(cfg), params)


def discriminator_from_params(resolutions, params: Mapping[str, Any],
                              channels: int = 32) -> MultiSTFTDiscriminator:
    """The JAX ``MultiSTFTDiscriminator`` params tree -> a port
    :class:`MultiSTFTDiscriminator` at the same resolutions (CPU)."""
    return load_params(MultiSTFTDiscriminator(resolutions, channels), params)


def bert_from_params(cfg: StyleEncoderConfig, params: Mapping[str, Any]) -> BertEncoder:
    """The JAX ``BertEncoder`` params tree -> a port :class:`BertEncoder` (CPU)."""
    return load_params(BertEncoder(cfg), params)


def tree_from_npz(path) -> Dict[str, Any]:
    """A params tree saved as ``np.savez(path, **{"a/b/kernel": leaf, ...})``
    -> the nested dict of numpy arrays that :func:`load_params` takes."""
    tree: Dict[str, Any] = {}
    with np.load(path) as flat:
        for key in flat.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = flat[key]
    return tree
