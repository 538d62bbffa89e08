"""The granite block as the codec-token decoder (``DecoderConfig.block ==
"granite"``): IBM's granite-4.0-h layers (Hugging Face
``modeling_granitemoehybrid``) over the jamba decoder's prefix, cache and
decode (``models/hybrid.py``).  The JAX package has no counterpart.

Per layer, of the kind ``layer_types`` gives, with r the
``residual_multiplier``::

    x += r · Mamba2(RMSNorm(x))   or   x += r · SelfAttention(RMSNorm(x))
    x += r · (MoE(RMSNorm(x)) + SharedMLP(RMSNorm(x)))

The Mamba-2 mixer is ``models/mamba2.py``'s; the attention is causal,
grouped-query, with no positional encoding and scores scaled by
``attention_multiplier``; the mixture of experts ``models/moe.py``'s, this
device's held experts of a router over all of them, with the shared MLP.
The layers' input is multiplied by ``embedding_multiplier``, the tied
head's logits divided by ``logits_scaling``; every RMSNorm takes
``norm_eps``.

:class:`GraniteDecoder` is :class:`~mamba_tts_torch.models.hybrid.HybridDecoder`
with these layers: the same ``[style || voice || text]`` prefix packed per
row, teacher-forced ``forward`` (off the card when a gradient is recorded),
``prefill`` (each Mamba-2 layer's conv window and f32 state and each
attention layer's K/V at each row's length; the spans ``prefill.mamba2``,
``prefill.attention`` and ``prefill.moe``, device-timed, one a layer) and
``step_with_cache``, served by ``hybrid_greedy_decode``'s captured decode:
a Mamba-2 layer's step is ``conv_step`` and the ``mamba2_step`` kernel,
two launches; an attention layer's the grouped ``decode_attention`` kernel;
the MoE's the batched product over the held experts (:meth:`MoE.step`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from mamba_tts_torch.config import DecoderConfig
from mamba_tts_torch.models.attention import SelfAttention
from mamba_tts_torch.models.hybrid import HybridDecoder
from mamba_tts_torch.models.layers import RMSNorm, parse_dtype
from mamba_tts_torch.models.mamba2 import Mamba2Mixer
from mamba_tts_torch.models.moe import MoE
from mamba_tts_torch.utils.profiling import annotate


class GraniteLayer(nn.Module):
    """One granite layer: a Mamba-2 or a self-attention mixer, then the MoE
    with its shared MLP, each added to the residual times
    ``residual_multiplier``."""

    def __init__(self, cfg: DecoderConfig, kind: str):
        super().__init__()
        dt = parse_dtype(cfg.dtype)
        self.kind, self.r = kind, cfg.residual_multiplier
        self.norm_mixer = RMSNorm(cfg.d_model, cfg.norm_eps, dt)
        if kind == "mamba":
            self.mamba = Mamba2Mixer(cfg.mamba2, cfg.d_model, cfg.norm_eps, dt)
        else:
            self.attn = SelfAttention(cfg.d_model, cfg.n_heads, cfg.kv_heads, dtype=dt,
                                      scale=cfg.attention_multiplier or None)
        self.norm_mlp = RMSNorm(cfg.d_model, cfg.norm_eps, dt)
        self.moe = MoE(cfg.d_model, cfg.moe, dt)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None):
        """x (B, T, d) -> (x, the mixer's state: a ``Mamba2State`` or (K,
        V)); each part a device-timed span (``prefill.mamba2`` or
        ``prefill.attention``, then ``prefill.moe``)."""
        if self.kind == "mamba":
            with annotate("prefill.mamba2", device_time=True):
                h, state = self.mamba(self.norm_mixer(x), lengths)
        else:
            with annotate("prefill.attention", device_time=True):
                h, k, v = self.attn(self.norm_mixer(x))
                state = (k, v)
        x = x + h * self.r
        with annotate("prefill.moe", device_time=True):
            return x + self.moe(self.norm_mlp(x)) * self.r, state

    def step(self, x: torch.Tensor, state, cache, rows, pos):
        """One token, as ``HybridLayer.step``: a Mamba-2 layer writes its new
        window and state over ``state``'s and returns it, an attention layer
        writes into ``cache`` = (K, V, mask) and returns None."""
        h = self.norm_mixer(x)
        if self.kind == "mamba":
            h, state = self.mamba.step(h, state, inplace=True)
        else:
            h, state = self.attn.step(h, *cache, rows, pos), None
        x = x + h * self.r
        return x + self.moe.step(self.norm_mlp(x)) * self.r, state


class GraniteDecoder(HybridDecoder):
    """The granite decoder; see the module's docstring.  ``d_text``: the
    width of the text encoder's output.  Matrices are held in the compute
    dtype (the router's in f32); embeddings, norms, A_log, D and dt_bias
    stay f32."""

    def make_layer(self, cfg: DecoderConfig, kind: str) -> nn.Module:
        return GraniteLayer(cfg, kind)
