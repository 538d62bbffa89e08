"""Top-level MambaTTS model — counterpart of ``mamba_tts_tpu/models/tts.py``.

Holds the trainable components under the JAX tree's top-level names
(``text_encoder``, ``dur_predictor``, ``smsd``, ``style_pipe``, ``decoder``),
so a checkpoint holds the JAX package's whole tree.  The NAR style branch
(``style_pipe``, :meth:`MambaTTS.nar_frames`) is not used when serving, and
no loss consumes it: ``compute_losses(use_nar_branch=True)`` computes it
and ignores it, as the JAX package does, and its gradients are zero.

Training graph (:meth:`MambaTTS.compute_losses`):

    L = w_codec * CE(logits, codec tokens, ignore PAD)  [shifted teacher
        forcing: inputs = [BOS, y[:-1]], targets = y]
      + w_dur   * MSE(log durations)                    [heuristic targets
        from the true frame counts]
      + w_smsd  * GMM-NLL(spk_embs | style prompt)

Parallelism: ``MambaTTS(cfg, sp_mesh=..., mesh=...)``.  ``mesh`` shards the
decoder and the style branch over its "model" axis (``shardings``: each
parameter's split, from ``parallel/mesh.py``'s rules) and splits the batch rows
over its "data" axis: then every loss that normalises over the batch sums
its numerator and its denominator over "data" before dividing, so a
data-parallel step is the global batch's step.  ``sp_mesh`` time-shards
the decoder's scans (``cfg.decoder.use_sp_scan``).

``cfg.decoder.block == "jamba"`` puts the jamba decoder of
``models/hybrid.py`` in the decoder's place (one device, no mesh): the same
losses, its conditioning a prefix instead of cross-attention and FiLM;
``"granite"`` the granite decoder of ``models/granite.py``, likewise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn

from mamba_tts_torch.config import TTSConfig
from mamba_tts_torch.models.decoder import MambaTTSDecoder
from mamba_tts_torch.models.granite import GraniteDecoder
from mamba_tts_torch.models.hybrid import HybridDecoder
from mamba_tts_torch.models.smsd import SMSD, sample_mixture
from mamba_tts_torch.models.style import StyleConditioningPipeline
from mamba_tts_torch.models.text_encoder import DurationPredictor, TextEncoder, duration_loss
from mamba_tts_torch.parallel.comm import global_mean
from mamba_tts_torch.parallel.mesh import axis_group, axis_size, param_shardings
from mamba_tts_torch.utils.profiling import annotate


def heuristic_durations(text_mask: torch.Tensor, target_frames: torch.Tensor) -> torch.Tensor:
    """Divide each sample's codec frames evenly across its phonemes.
    text_mask (B, L) True = valid; target_frames (B,) true frame counts."""
    lengths = torch.clamp(text_mask.sum(dim=1), min=1)
    per_ph = torch.clamp(target_frames.to(lengths.dtype) // lengths, min=1)
    return per_ph[:, None] * text_mask.to(per_ph.dtype)


def codec_ce_loss(logits: torch.Tensor, targets: torch.Tensor, pad_id: int = 0,
                  group=None) -> torch.Tensor:
    """Cross-entropy over flattened codec tokens, ignoring PAD; over the
    global batch of the data-parallel ``group``."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    valid = (targets != pad_id).to(torch.float32)
    return global_mean((nll * valid).sum(), valid.sum(), group)


class MambaTTS(nn.Module):
    def __init__(self, cfg: TTSConfig, sp_mesh=None, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.dp_group = axis_group(mesh, "data")
        # registered first, so that ``seed_init`` (last module first) draws it
        # last and every other component keeps the draws it had without it
        self.style_pipe = StyleConditioningPipeline(cfg.style, mesh)
        self.text_encoder = TextEncoder(cfg.text_encoder)
        self.dur_predictor = DurationPredictor(cfg.duration)
        self.smsd = SMSD(cfg.smsd)
        if cfg.decoder.hybrid:
            if mesh is not None or sp_mesh is not None:
                raise ValueError(f"the {cfg.decoder.block} decoder runs on one device (no mesh)")
            block = GraniteDecoder if cfg.decoder.block == "granite" else HybridDecoder
            self.decoder = block(cfg.decoder, cfg.text_encoder.d_model)
        else:
            self.decoder = MambaTTSDecoder(cfg.decoder.with_mamba_dims(), sp_mesh, mesh)
        self.shardings = None  # name -> Split on "model" (or None), with tensor parallelism
        if axis_size(mesh, "model") > 1:
            with torch.device("meta"):  # the full model's shapes, no storage
                full = MambaTTS(dataclasses.replace(
                    cfg, decoder=dataclasses.replace(cfg.decoder, use_sp_scan=False)))
            self.shardings = param_shardings(dict(full.named_parameters()), mesh)

    # ------------------------------------------------------------- training

    def compute_losses(self, batch: Dict[str, torch.Tensor], deterministic: bool = False,
                       generator: Optional[torch.Generator] = None,
                       style_k: Optional[torch.Tensor] = None,
                       style_eps: Optional[torch.Tensor] = None,
                       use_nar_branch: bool = False,
                       shard_generator: Optional[torch.Generator] = None
                       ) -> Dict[str, torch.Tensor]:
        """batch keys: phoneme_ids (B, L) | text_mask (B, L) bool | style_bert
        (B, bert_dim) | spk_embs (B, style_dim) | target_codec (B, S, Q)
        shifted ids | target_frames (B,) | voice_codec (B, S, Q).

        Dropout, ``NoiseNet`` and the ``sample_mixture`` draw of ``z_style``
        take ``generator``; ``style_k`` / ``style_eps`` hand the draw in.
        ``use_nar_branch`` also runs the NAR style branch on the predicted
        durations, after everything else (so that its dropout draws move no
        other), and consumes nothing of it.  ``shard_generator`` draws the
        dropout of activations sharded over the "model" axis (one stream per
        model rank; ``generator`` when None)."""
        c = self.cfg
        dec_cfg = c.decoder
        tr = c.train
        phoneme_ids, text_mask = batch["phoneme_ids"], batch["text_mask"]
        B = phoneme_ids.shape[0]

        with annotate("train.text_encoder"):
            text_hidden = self.text_encoder(phoneme_ids, text_mask, deterministic, generator)

        # SMSD: NLL against the speaker embeddings, and a sampled style that
        # carries no gradient.
        with annotate("train.smsd"):
            loss_smsd = self.smsd.loss(batch["style_bert"], batch["spk_embs"], deterministic,
                                       generator, group=self.dp_group)
            with torch.no_grad():
                pi, mu, sigma = self.smsd(batch["style_bert"])
                z_style = sample_mixture(pi, mu, sigma, c.smsd.variance_mode, c.smsd.fixed_std,
                                         generator=generator, k=style_k, eps=style_eps)

        with annotate("train.duration"):
            log_dur = self.dur_predictor(text_hidden, text_mask, deterministic, generator)
            dur_target = heuristic_durations(text_mask, batch["target_frames"])
            loss_dur = duration_loss(log_dur, dur_target, text_mask, group=self.dp_group)

        with annotate("train.decoder"):
            # voice prompt -> reference conditioning
            ref_hidden, ref_mask = self.embed_voice(batch["voice_codec"])

            # shifted teacher forcing over the flattened codec grid
            target_3d = batch["target_codec"].transpose(1, 2)  # (B, Q, S)
            Q, S = target_3d.shape[1], target_3d.shape[2]
            targets = target_3d.reshape(B, Q * S).long()
            inputs = torch.cat([torch.full((B, 1), dec_cfg.bos_id, dtype=targets.dtype,
                                           device=targets.device), targets[:, :-1]], dim=1)
            dev = targets.device
            quant_ids = torch.arange(Q, device=dev).repeat_interleave(S)[None]
            pos_ids = torch.arange(S, device=dev).repeat(Q)[None]
            logits = self.decoder(inputs, text_hidden, z_style, text_mask, ref_hidden, ref_mask,
                                  quant_ids=quant_ids, pos_ids=pos_ids)
            loss_codec = codec_ce_loss(logits, targets, pad_id=dec_cfg.pad_id,
                                       group=self.dp_group)

        if use_nar_branch:
            self.style_pipe(text_hidden, z_style, torch.exp(log_dur).detach(), text_mask,
                            max_frame_len=dec_cfg.max_len // dec_cfg.num_quantizers,
                            deterministic=deterministic, generator=generator,
                            shard_generator=shard_generator)

        loss_total = tr.w_codec * loss_codec + tr.w_dur * loss_dur + tr.w_smsd * loss_smsd
        return {"loss_total": loss_total, "loss_codec": loss_codec, "loss_dur": loss_dur,
                "loss_smsd": loss_smsd}

    # ------------------------------------------------------------ inference

    def encode_text(self, phoneme_ids, text_mask=None):
        return self.text_encoder(phoneme_ids, text_mask)

    def predict_durations(self, text_hidden, text_mask=None):
        return self.dur_predictor(text_hidden, text_mask)

    def sample_style(self, style_bert, generator: Optional[torch.Generator] = None):
        return self.smsd.sample(style_bert, generator)

    def embed_voice(self, voice_codec: torch.Tensor):
        """(B, S, Q) shifted codec ids -> (ref_hidden (B, Q*S, d), ref_mask)."""
        voice_3d = voice_codec.transpose(1, 2)
        ref_hidden = self.decoder.embed_codec_tokens(voice_3d.long())
        ref_mask = voice_3d.reshape(voice_codec.shape[0], -1) != self.cfg.decoder.pad_id
        return ref_hidden, ref_mask

    def nar_frames(self, text_hidden, z_style, durations, text_mask=None, max_frame_len=1024):
        """The NAR style branch: (styled_frames, output_lengths, style_K, style_V)."""
        return self.style_pipe(text_hidden, z_style, durations, text_mask, max_frame_len)
