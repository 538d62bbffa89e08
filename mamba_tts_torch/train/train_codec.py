"""Codec (FACodec) training — counterpart of
``mamba_tts_tpu/train/train_codec.py``: reconstruction and VQ losses, plus
an adversarial term with ``--adversarial``:

    L_G = w_wave * L1(wave) + w_stft * multi-resolution STFT
        + w_mel * mel L1 + w_vq * sum of the VQ codebook + commitment losses
        [+ w_adv * hinge G + w_fm * feature matching   with --adversarial]

against the multi-resolution complex-STFT discriminator
(``models/discriminator.py``).  The GAN step updates the generator first,
against the discriminator's parameters as they were, then trains the
discriminator on the same forward's reconstruction, detached.  Flags are the
JAX CLI's plus ``--device`` (``cuda`` by default, ``cpu`` for the plain
path); the optimizer and checkpoints are the port's own (``train/state.py``):

    python -m mamba_tts_torch.train.train_codec --synthetic --max_steps 5
    python -m mamba_tts_torch.train.train_codec --synthetic --adversarial
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from mamba_tts_torch.audio.mel import mel_l1_loss, multi_resolution_stft_loss
from mamba_tts_torch.config import CodecConfig
from mamba_tts_torch.device import resolve_device
from mamba_tts_torch.models.discriminator import (MultiSTFTDiscriminator, discriminator_loss,
                                                  feature_matching_loss,
                                                  generator_adversarial_loss)
from mamba_tts_torch.models.facodec import FACodec
from mamba_tts_torch.models.layers import seed_init
from mamba_tts_torch.train import state as state_lib

CODEC_RESOLUTIONS = ((512, 128), (1024, 256))  # the STFT loss's, not the discriminator's


def _reconstruction(model: FACodec, wav: torch.Tensor, w_wave: float = 1.0, w_stft: float = 1.0,
                    w_mel: float = 1.0, w_vq: float = 1.0, resolutions=CODEC_RESOLUTIONS):
    """(recon, weighted sum of the generator's reconstruction and VQ losses,
    the losses by name)."""
    vq = []
    recon, _, _ = model(wav, vq)
    loss_vq = sum(vq) if vq else torch.zeros((), device=wav.device)
    loss_wave = (recon - wav).abs().mean()
    loss_stft = multi_resolution_stft_loss(recon, wav, resolutions)
    loss_mel = mel_l1_loss(recon, wav)
    total = w_wave * loss_wave + w_stft * loss_stft + w_mel * loss_mel + w_vq * loss_vq
    return recon, total, {"loss_wave": loss_wave, "loss_stft": loss_stft, "loss_mel": loss_mel,
                          "loss_vq": loss_vq}


def codec_loss_fn(model: FACodec, wav: torch.Tensor, **loss_kw):
    """(total, {loss_total, loss_wave, loss_stft, loss_mel, loss_vq}) of the
    codec on ``wav`` (B, T); the VQ losses of all quantizers are summed."""
    _, total, metrics = _reconstruction(model, wav, **loss_kw)
    return total, {"loss_total": total, **metrics}


def _grads(loss: torch.Tensor, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """d loss / d params for these parameters only (zeros where the graph does
    not reach one); nothing is accumulated in any ``.grad``."""
    names = list(params)
    gs = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
    return {n: g if g is not None else torch.zeros_like(params[n]) for n, g in zip(names, gs)}


def make_codec_train_step(model: FACodec, tx: state_lib.Optimizer, **loss_kw):
    """(state, wav) -> (state advanced one step, losses as 0-dim tensors)."""

    def step(st: state_lib.TrainState, wav: torch.Tensor):
        total, metrics = codec_loss_fn(model, wav, **loss_kw)
        opt_state = tx.apply(st.params, _grads(total, st.params), st.opt_state)
        return (st.replace(step=st.step + 1, opt_state=opt_state),
                {k: v.detach() for k, v in metrics.items()})

    return step


def make_gan_codec_train_step(model: FACodec, disc: MultiSTFTDiscriminator,
                              tx_g: state_lib.Optimizer, tx_d: state_lib.Optimizer,
                              w_adv: float = 1.0, w_fm: float = 2.0, **loss_kw):
    """(generator state, discriminator state, wav) -> (both advanced one step,
    losses).  The generator adds hinge G and feature matching to the
    reconstruction losses, with gradients taken over its own parameters
    only; the discriminator then trains on (real, the detached recon)."""

    def step(g_st: state_lib.TrainState, d_st: state_lib.TrainState, wav: torch.Tensor):
        recon, total, metrics = _reconstruction(model, wav, **loss_kw)
        fake_outs = disc(recon)
        with torch.no_grad():  # feature matching holds the real features constant
            real_outs = disc(wav)
        loss_adv = generator_adversarial_loss(fake_outs)
        loss_fm = feature_matching_loss(real_outs, fake_outs)
        total = total + w_adv * loss_adv + w_fm * loss_fm
        g_opt = tx_g.apply(g_st.params, _grads(total, g_st.params), g_st.opt_state)

        fake = recon.detach()
        loss_disc = discriminator_loss(disc(wav), disc(fake))
        d_opt = tx_d.apply(d_st.params, _grads(loss_disc, d_st.params), d_st.opt_state)
        metrics = {"loss_total": total, **metrics, "loss_adv": loss_adv, "loss_fm": loss_fm,
                   "loss_disc": loss_disc}
        return (g_st.replace(step=g_st.step + 1, opt_state=g_opt),
                d_st.replace(step=d_st.step + 1, opt_state=d_opt),
                {k: v.detach() for k, v in metrics.items()})

    return step


def make_segment_sampler(dataset, batch_size: int, seg: int, seed: int
                         ) -> Callable[[], np.ndarray]:
    """Batches of random ``seg``-sample windows of random dataset items (a
    shorter item is zero-padded), drawn from ``np.random.RandomState(seed)``
    exactly as the JAX CLI draws them."""
    rng = np.random.RandomState(seed)

    def sample_batch() -> np.ndarray:
        wavs = np.zeros((batch_size, seg), np.float32)
        for i in range(batch_size):
            _, target = dataset[rng.randint(len(dataset))]
            if target.shape[0] >= seg:
                start = rng.randint(target.shape[0] - seg + 1)
                wavs[i] = target[start:start + seg]
            else:
                wavs[i, :target.shape[0]] = target
        return wavs

    return sample_batch


def discriminator_resolutions(seg: int):
    """The discriminator's resolutions, capped to the segment length."""
    res = tuple((n, n // 4) for n in (512, 1024, 2048) if n <= seg)
    return res or ((min(seg, 256), max(seg // 4, 1)),)


def main(argv: Optional[list] = None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--lr", type=float, default=2e-4)
    parser.add_argument("--max_steps", type=int, default=10)
    parser.add_argument("--segment_seconds", type=float, default=0.8)
    parser.add_argument("--csv_path", type=str, default=None)
    parser.add_argument("--audio_root", type=str, default=None)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--checkpoint_dir", type=str, default="codec_checkpoints")
    parser.add_argument("--checkpoint_every", type=int, default=200)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--adversarial", action="store_true",
                        help="add the multi-resolution STFT discriminator "
                             "(hinge GAN + feature matching)")
    parser.add_argument("--disc_lr", type=float, default=None,
                        help="discriminator lr (default: same as --lr)")
    parser.add_argument("--w_adv", type=float, default=1.0)
    parser.add_argument("--w_fm", type=float, default=2.0)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="cuda (cuDNN convolutions, cuFFT) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from mamba_tts_torch.data.dataset import VccmTTSDataset, make_synthetic_dataset

    cfg = CodecConfig()
    seg = int(args.segment_seconds * cfg.sample_rate)
    seg -= seg % cfg.hop_length
    tmp = None
    try:
        if args.synthetic:
            tmp = tempfile.mkdtemp(prefix="mtts_codec_")
            csv_path, audio_root = make_synthetic_dataset(
                tmp, n_items=max(8, args.batch_size * 2), seconds=args.segment_seconds)
        else:
            csv_path, audio_root = args.csv_path, args.audio_root
            if not (csv_path and audio_root):
                parser.error("--csv_path and --audio_root, or --synthetic")
        dataset = VccmTTSDataset(csv_path, audio_root, cfg.sample_rate, seed=args.seed)
        print(f"dataset: {len(dataset)} items")
        sample_batch = make_segment_sampler(dataset, args.batch_size, seg, args.seed)
        # the JAX CLI initialises the codec (and the discriminator) on a batch
        # each: drawing them too keeps the training batches equal to its own
        for _ in range(2 if args.adversarial else 1):
            sample_batch()

        model = seed_init(FACodec(cfg), args.seed).to(device)
        params = dict(model.named_parameters())
        print(f"codec: {sum(p.numel() for p in params.values()) / 1e6:.1f}M params, "
              f"segment {seg} samples")
        tx = state_lib.make_optimizer(args.lr)
        st = state_lib.create_train_state(params, tx)
        if args.adversarial:
            disc = seed_init(MultiSTFTDiscriminator(discriminator_resolutions(seg)),
                             args.seed + 1).to(device)
            d_params = dict(disc.named_parameters())
            print(f"discriminator: {sum(p.numel() for p in d_params.values()) / 1e6:.2f}M "
                  f"params at {disc.resolutions}")
            tx_d = state_lib.make_optimizer(args.disc_lr or args.lr)
            d_st = state_lib.create_train_state(d_params, tx_d)
            gan_step = make_gan_codec_train_step(model, disc, tx, tx_d, w_adv=args.w_adv,
                                                 w_fm=args.w_fm)
        else:
            step_fn = make_codec_train_step(model, tx)

        history, step_ms = [], []
        for step in range(args.max_steps):
            t0 = time.perf_counter()
            wav = torch.from_numpy(sample_batch()).to(device)
            if args.adversarial:
                st, d_st, metrics = gan_step(st, d_st, wav)
            else:
                st, metrics = step_fn(st, wav)
            metrics = {k: float(v) for k, v in metrics.items()}  # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
            history.append({"step": step, **metrics})
            print(f"step {step} | " + " ".join(f"{k.replace('loss_', '')}={v:.4f}"
                                                for k, v in metrics.items())
                  + f" | {step_ms[-1]:.0f} ms")
            if (step + 1) % args.checkpoint_every == 0:
                state_lib.save_checkpoint(args.checkpoint_dir, st)
        path = state_lib.save_checkpoint(args.checkpoint_dir, st)
        print(f"saved codec checkpoint at step {st.step}")
        return {"step": st.step, "history": history, "step_ms": step_ms,
                "checkpoint": str(path), "segment": seg}
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
