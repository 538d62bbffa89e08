"""Training entry point — counterpart of ``mamba_tts_tpu/train/train.py``.

Public flags mirror the JAX CLI (``--batch_size --lr --max_steps --w_codec
--w_dur --w_smsd``, checkpointing and ``--resume``, ``--synthetic`` smoke
data, metrics, tracing), plus ``--device`` (``cuda`` by default, ``cpu`` for
the plain path) in place of the JAX package's device selection:

    python -m mamba_tts_torch.train.train --synthetic --max_steps 4
    python -m mamba_tts_torch.train.train --synthetic --device cpu \\
        --config_json tests/smoke_config.json --max_steps 2

Data comes from the raw CSV and tar through the front-ends
(``train/pipeline.py`` ``BatchPreparer``: G2P, BERT and FACodec in every
step), read by ``dataset.batches`` or, with ``--loader grain``, by the
worker-backed loader (``data/grain_pipeline.py``, ``--grain_workers``); or,
with ``--preprocessed_dir``, from a directory that ``data/preprocess.py`` or
``data/preprocess_parallel.py`` of either package wrote (``OfflineDataset``),
with no front-end work in the loop:

    python -m mamba_tts_torch.train.train --preprocessed_dir prep --max_steps 4

On the card every decoder layer's selective scan and long-query
cross-attention run through the Hopper kernels (``ops/pallas_scan.py``,
``ops/flash_attention.py``), forward and backward.

``--mesh d,m`` trains data-parallel over d ranks and tensor-parallel over m
(``parallel/mesh.py``), one process a rank, under ``torchrun`` or
``parallel/dryrun.py`` ``spawn``:

    torchrun --nproc_per_node 4 -m mamba_tts_torch.train.train --synthetic --mesh 2,2

Every rank reads the same global batch and keeps its rows; the gradients
are summed over "data" and each loss is the global batch's, so a step equals
the unsharded step up to summation order; dropout and noise draw from
(seed, step, data rank), and activations sharded over "model" from
(seed, step, data rank, model rank): the same distributions as the unsharded
step, not the same numbers.  With ``decoder.use_sp_scan`` in the config the
scans shard their time axis over the "data" axis as well.
"""
from __future__ import annotations

import argparse
import dataclasses
import shutil
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from mamba_tts_torch import config as config_lib
from mamba_tts_torch.config import TTSConfig
from mamba_tts_torch.device import resolve_device
from mamba_tts_torch.models.layers import seed_init
from mamba_tts_torch.models.tts import MambaTTS
from mamba_tts_torch.parallel import comm
from mamba_tts_torch.parallel.distributed import rank_mesh
from mamba_tts_torch.parallel.mesh import (
    axis_group,
    axis_rank,
    axis_size,
    shard_batch,
    shard_params,
)
from mamba_tts_torch.train import state as state_lib
from mamba_tts_torch.utils.profiling import annotate

_SEED_MIX = 0x9E3779B97F4A7C15  # odd 64-bit constant: (seed, step) -> generator seed
_STREAM_MIX = 0xC2B2AE3D27D4EB4F  # another: one stream per rank


def build_model(cfg: TTSConfig, sp_mesh=None, mesh=None) -> MambaTTS:
    return MambaTTS(cfg, sp_mesh=sp_mesh, mesh=mesh)


def init_params(model: MambaTTS, seed: int = 0, params: Optional[Mapping[str, Any]] = None,
                mesh=None) -> Dict[str, torch.Tensor]:
    """Seeded random init of ``model`` in place, or the JAX package's params
    tree (numpy leaves) through the weight bridge.  For a model built on
    ``mesh`` the full model is initialised and this rank's shards are copied
    in, so every mesh shape starts from the same weights.  Returns the
    model's parameters by name."""
    full = model
    if mesh is not None:
        cfg = model.cfg
        full = MambaTTS(dataclasses.replace(
            cfg, decoder=dataclasses.replace(cfg.decoder, use_sp_scan=False)))
    if params is None:
        seed_init(full, seed)
    else:
        from mamba_tts_torch.bridge import load_params

        load_params(full, params)
    if mesh is not None:
        state_lib.copy_params(dict(model.named_parameters()),
                              shard_params(dict(full.named_parameters()), mesh))
    return dict(model.named_parameters())


def step_generator(seed: int, step: int, device: torch.device, stream: int = 0
                   ) -> torch.Generator:
    """The generator of one train step (dropout, NoiseNet, the z_style draw):
    a function of ``--seed`` and the step, as the JAX loop folds the step
    into its key, so a resumed run draws what an uninterrupted one would;
    ``stream`` > 0 gives another rank its own draws."""
    return torch.Generator(device=device).manual_seed(
        (seed * _SEED_MIX + step + stream * _STREAM_MIX) % 2 ** 63)


def step_generators(seed: int, step: int, device: torch.device, mesh=None):
    """(generator, shard generator) of a train step on ``mesh``: the first
    draws everything replicated over "model" (dropout, NoiseNet, z_style),
    one stream per data rank; the second the dropout of activations sharded
    over "model", one stream per (data rank, model rank); None without
    tensor parallelism."""
    data_rank = axis_rank(mesh, "data")
    gen = step_generator(seed, step, device, data_rank)
    if axis_size(mesh, "model") == 1:
        return gen, None
    stream = (1 + axis_rank(mesh, "model")) * 2 ** 20 + data_rank
    return gen, step_generator(seed, step, device, stream)


def sync_gradients(grads: Dict[str, torch.Tensor], group) -> None:
    """Sum the gradients over the data-parallel ``group`` in place (one
    all-reduce over all of them)."""
    if comm.group_size(group) == 1:
        return
    with annotate("train.grad_sync"):
        ts = list(grads.values())
        flat = comm.all_reduce_(torch.cat([t.reshape(-1) for t in ts]), group)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def batch_to_device(batch: Mapping[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``: ids as int64, masks as bool,
    features as f32."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        if t.dtype.is_floating_point:
            t = t.to(torch.float32)
        elif t.dtype != torch.bool:
            t = t.long()
        out[k] = t.to(device)
    return out


def make_train_step(model: MambaTTS, tx: state_lib.Optimizer, seed: int = 0,
                    use_nar_branch: bool = False, mesh=None):
    """(state, batch, out=None, **kw) -> (state advanced one step, losses as
    0-dim tensors).  The step's gradients of every parameter feed ``tx`` (a
    parameter the graph does not reach, ``style_pipe`` always, gets a zero
    gradient).  ``use_nar_branch`` runs the NAR style branch in the step, as
    the JAX package's flag does; no loss consumes it.  On ``mesh`` the batch
    is this rank's rows and the gradients are summed over "data" before the
    update.  ``kw`` go to ``compute_losses`` (``deterministic``,
    ``style_k``, ``style_eps``).  A dict ``out`` receives the step's
    gradients after the data-parallel sum (``grads``, this rank's shards)
    and their global norm before clipping (``norm``).  Traced, a step is the
    span ``train.step`` over ``train.forward``, ``train.backward`` and
    ``train.optimizer`` (the gradient dict, the data-parallel sum
    ``train.grad_sync`` on a mesh, the norm, the clip and Adam), each timed
    on the device too."""
    dp_group = axis_group(mesh, "data")

    @annotate("train.step")
    def train_step(st: state_lib.TrainState, batch: Dict[str, torch.Tensor],
                   out: Optional[Dict[str, Any]] = None, **kw):
        device = next(iter(st.params.values())).device
        for p in st.params.values():
            p.grad = None
        gen, shard_gen = step_generators(seed, st.step, device, mesh)
        kw = {"deterministic": False, "generator": gen, "shard_generator": shard_gen,
              "use_nar_branch": use_nar_branch, **kw}
        with annotate("train.forward", device_time=True):
            losses = model.compute_losses(batch, **kw)
        with annotate("train.backward", device_time=True):
            losses["loss_total"].backward()
        with annotate("train.optimizer", device_time=True):
            grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                     for n, p in st.params.items()}
            sync_gradients(grads, dp_group)
            norm = tx.global_norm(list(grads), list(grads.values()))
            opt_state = tx.apply(st.params, grads, st.opt_state, norm=norm)
        for p in st.params.values():
            p.grad = None
        if out is not None:
            out.update(grads=grads, norm=norm)
        return (st.replace(step=st.step + 1, opt_state=opt_state),
                {k: v.detach() for k, v in losses.items()})

    return train_step


def main(argv: Optional[list] = None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch_size", type=int, default=10)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--max_steps", type=int, default=10, help="short run for sanity check")
    parser.add_argument("--w_codec", type=float, default=1.0)
    parser.add_argument("--w_dur", type=float, default=0.1)
    parser.add_argument("--w_smsd", type=float, default=0.5)
    parser.add_argument("--csv_path", type=str, default="VccmDataset/controlspeech_train.csv")
    parser.add_argument("--audio_root", type=str, default="TextrolSpeech_data.tar.gz")
    parser.add_argument("--checkpoint_dir", type=str, default="checkpoints")
    parser.add_argument("--checkpoint_every", type=int, default=100)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--synthetic", action="store_true",
                        help="run on a generated synthetic dataset (smoke test)")
    parser.add_argument("--preprocessed_dir", type=str, default=None,
                        help="train from an offline-preprocessed directory "
                             "(data/preprocess.py output): no G2P/BERT/codec work in the loop")
    parser.add_argument("--config_json", type=str, default=None)
    parser.add_argument("--bert_vocab", type=str, default=None,
                        help="path to a real BERT vocab.txt for the style-text encoder; "
                             "without it the WordPiece tokenizer uses a hash vocabulary (warns)")
    parser.add_argument("--mesh", type=str, default=None,
                        help="mesh shape as 'data,model', e.g. '4,2' (one process a rank)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--loader", choices=["batches", "grain"], default="batches",
                        help="online-path input pipeline: plain dataset.batches or the "
                             "worker-backed loader (data/grain_pipeline.py)")
    parser.add_argument("--grain_workers", type=int, default=0,
                        help="loader worker processes (0 = in-process)")
    parser.add_argument("--log_file", type=str, default=None,
                        help="append per-step JSON metric lines to this file")
    parser.add_argument("--tensorboard_dir", type=str, default=None)
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of steps 2-4 here")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="cuda (the Hopper kernels) or cpu (the plain PyTorch path)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    mesh = (rank_mesh(tuple(int(x) for x in args.mesh.split(",")), ("data", "model"), device)
            if args.mesh else None)
    main_rank = mesh is None or mesh.get_rank() == 0

    cfg = config_lib.from_json(open(args.config_json).read()) if args.config_json else TTSConfig()
    for key in ("batch_size", "lr", "max_steps", "w_codec", "w_dur", "w_smsd"):
        cfg = config_lib.override(cfg, f"train.{key}", getattr(args, key))
    if args.bert_vocab:
        cfg = config_lib.override(cfg, "style_encoder.bert_vocab", args.bert_vocab)

    from mamba_tts_torch.utils.metrics import MetricsLogger
    from mamba_tts_torch.utils.profiling import StepTimer, trace

    tmp = None
    try:
        # data: the online path (raw CSV + tar, front-ends in the loop) or
        # the offline-preprocessed one (ready tensors)
        if args.preprocessed_dir:
            from mamba_tts_torch.data.preprocess import OfflineDataset

            offline = OfflineDataset(args.preprocessed_dir)
            if main_rank:
                print(f"offline dataset: {len(offline)} items from {args.preprocessed_dir}")

            def batch_iter(epoch_seed):
                return offline.batches(cfg.train.batch_size, max_text_len=cfg.data.max_text_len,
                                       seed=epoch_seed)
        else:
            from mamba_tts_torch.data.dataset import VccmTTSDataset, make_synthetic_dataset
            from mamba_tts_torch.train.pipeline import BatchPreparer

            if args.synthetic:
                tmp = tempfile.mkdtemp(prefix="mtts_synth_")
                csv_path, audio_root = make_synthetic_dataset(
                    tmp, n_items=max(8, args.batch_size * 2))
            else:
                csv_path, audio_root = args.csv_path, args.audio_root
            dataset = VccmTTSDataset(csv_path, audio_root, cfg.data.sample_rate, seed=args.seed)
            if main_rank:
                print(f"dataset: {len(dataset)} items ({dataset.skipped} skipped)")
            preparer = BatchPreparer(cfg, device=device)
            if args.loader == "grain":
                from mamba_tts_torch.data.grain_pipeline import make_grain_loader

                def raw_batches(epoch_seed):
                    return make_grain_loader(dataset, cfg.train.batch_size, seed=epoch_seed,
                                             worker_count=args.grain_workers)
            else:
                def raw_batches(epoch_seed):
                    return dataset.batches(cfg.train.batch_size, seed=epoch_seed)

            def batch_iter(epoch_seed):
                for inputs, target_wav in raw_batches(epoch_seed):
                    yield preparer(inputs, target_wav)

        model = build_model(cfg, sp_mesh=mesh if cfg.decoder.use_sp_scan else None, mesh=mesh)
        init_params(model, args.seed, mesh=mesh)
        model.to(device)
        params = dict(model.named_parameters())
        if main_rank:
            print(f"model: {sum(p.numel() for p in params.values()) / 1e6:.1f}M params"
                  + (f" (this rank's shards; mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))})"
                     if mesh is not None else ""))
        tx = state_lib.make_optimizer(cfg.train.lr, cfg.train.grad_clip_norm, mesh=mesh,
                                      shardings=model.shardings)
        train_state = state_lib.create_train_state(params, tx)
        # the config beside the checkpoints, so that inference can configure itself
        if main_rank:
            Path(args.checkpoint_dir).mkdir(parents=True, exist_ok=True)
            (Path(args.checkpoint_dir) / "config.json").write_text(config_lib.to_json(cfg))
        if args.resume:
            train_state, restored = state_lib.restore_checkpoint(args.checkpoint_dir, train_state,
                                                                 mesh=mesh)
            if main_rank:
                print("resume: " + (f"restored step {train_state.step}" if restored
                                    else "no checkpoint found"))

        train_step = make_train_step(model, tx, seed=args.seed, mesh=mesh)
        logger = MetricsLogger(log_file=args.log_file if main_rank else None,
                               tensorboard_dir=args.tensorboard_dir if main_rank else None)
        timer = StepTimer(skip_first=1)
        step = start_step = train_state.step
        history = []
        t_start = time.perf_counter()
        profile_ctx = None
        while step < cfg.train.max_steps:
            epoch_start = step
            for batch in batch_iter(step):
                if step >= cfg.train.max_steps:
                    break
                if args.profile_dir and main_rank and step - start_step == 2 and profile_ctx is None:
                    profile_ctx = trace(args.profile_dir)
                    profile_ctx.__enter__()
                batch = batch_to_device(batch, device)
                if mesh is not None:
                    batch = shard_batch(batch, mesh)
                with timer:
                    train_state, losses = train_step(train_state, batch)
                    losses = {k: float(v) for k, v in losses.items()}  # waits for the step
                history.append({"step": step, **losses})
                if step % cfg.train.log_every == 0 and main_rank:
                    logger.log(step, losses, tokens=int(batch["target_codec"].numel())
                               * axis_size(mesh, "data"))
                if profile_ctx is not None and step - start_step >= 4:
                    profile_ctx.__exit__(None, None, None)
                    profile_ctx = None
                    print(f"profiler trace written to {args.profile_dir}")
                step += 1
                if step % args.checkpoint_every == 0:
                    state_lib.save_checkpoint(args.checkpoint_dir, train_state, mesh=mesh,
                                              shardings=model.shardings)
                    if main_rank:
                        print(f"checkpoint saved at step {step}")
            if step == epoch_start:
                raise ValueError(f"an epoch gave no batch of {cfg.train.batch_size}: "
                                 "the dataset holds fewer items than the batch size")
        if profile_ctx is not None:
            profile_ctx.__exit__(None, None, None)
        if cfg.train.max_steps > 0 and step % args.checkpoint_every != 0:
            state_lib.save_checkpoint(args.checkpoint_dir, train_state, mesh=mesh,
                                              shardings=model.shardings)
            if main_rank:
                print(f"checkpoint saved at step {step}")
        logger.close()
        if main_rank:
                print(f"done: {step} steps in {time.perf_counter() - t_start:.1f}s "
                  f"(steady-state {timer.mean * 1e3:.0f} ms/step)")
        return {"start_step": start_step, "step": step, "history": history,
                "ms_per_step": timer.mean * 1e3}
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
