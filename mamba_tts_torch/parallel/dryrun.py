"""Multi-rank dry runs on one machine — counterpart of ``__graft_entry__.py``'s
``dryrun_multichip``.

:func:`spawn` starts ``world`` ranks with ``torch.multiprocessing`` (spawned,
not forked), joins them to a gloo process group through a ``file://``
init method in a fresh temporary directory (so that concurrent worlds, such
as test workers, never race for a port), gives each one intra-op thread,
runs ``fn(*args)`` in every rank and returns the ranks' results in rank
order.  A rank that raises fails the call with that rank's exit code and
traceback.  With ``device="cuda"`` every rank takes the card of its rank
modulo the cards present: two ranks share one card over gloo, since NCCL
refuses two ranks on one device.

:func:`dryrun_multichip` runs one full ``MambaTTS`` train step (text
encoder, duration predictor, SMSD, style pipeline and decoder; all three
losses) on a ("data", "model") mesh; :func:`train_check` runs the train
CLI's step (``train.make_train_step``) once, for the tests and
``chip_smoke.py`` to hold against the single-rank step and JAX's.
"""
from __future__ import annotations

import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def _rank_main(rank: int, world: int, tmp: str, device: str, backend: str, fn: Callable,
               args: tuple) -> None:
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{tmp}/init", rank=rank,
                            world_size=world)
    try:
        torch.save(fn(*args), os.path.join(tmp, f"result_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(world: int, fn: Callable, *args, device: str = "cpu", backend: str = "gloo",
          timeout: float = 900.0) -> List[Any]:
    """``fn(*args)`` in each of ``world`` spawned ranks of one process group;
    the ranks' return values (saved with ``torch.save``) in rank order.
    ``fn`` must be importable by name (a module-level function)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="mtts_world_") as tmp:
        ctx = mp.start_processes(_rank_main, args=(world, tmp, device, backend, fn, args),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1.0):  # raises with the rank's traceback
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.terminate()
                raise TimeoutError(f"spawned world of {world} ranks ran past {timeout} s")
        return [torch.load(os.path.join(tmp, f"result_{r}.pt"), map_location="cpu",
                           weights_only=False) for r in range(world)]


def _mesh(mesh_shape: Optional[Sequence[int]], device: torch.device):
    from mamba_tts_torch.parallel.mesh import make_mesh

    if mesh_shape is None:
        return None
    axes = ("data", "model")[:len(mesh_shape)]
    return make_mesh(tuple(mesh_shape), axes, device_type=device.type)


def _numpy(tree):
    return {k: v.detach().float().cpu().numpy() for k, v in tree.items()}


def train_check(cfg_json: str, batch: Dict[str, np.ndarray], params: Optional[dict] = None,
                seed: int = 0, device: str = "cpu", style: Optional[dict] = None,
                use_nar_branch: bool = True, mesh_shape: Optional[Sequence[int]] = None
                ) -> Dict[str, Any]:
    """One step of the train CLI's ``make_train_step`` on the global
    ``batch`` (numpy), this rank's rows on ``mesh_shape`` (None: one rank,
    no process group needed).
    ``params``: the JAX package's params tree (numpy leaves) through the
    bridge, else the seeded init.  With ``style`` ({"k", "eps"} numpy over
    the global batch) the step is deterministic (no dropout, the z_style
    draw handed in); else it draws from the step's generators.  Returns the
    losses, the global gradient norm before clipping, the full (gathered)
    gradients after the data-parallel sum and the full parameters after
    the update, all on the host, and ``replicated``: this rank's copy of
    every replicated parameter after the update."""
    from mamba_tts_torch import config as config_lib
    from mamba_tts_torch.models.tts import MambaTTS
    from mamba_tts_torch.parallel.mesh import gather_params, shard_batch
    from mamba_tts_torch.train import state as state_lib
    from mamba_tts_torch.train.train import batch_to_device, init_params, make_train_step

    dev = torch.device(device)
    cfg = config_lib.from_json(cfg_json)
    mesh = _mesh(mesh_shape, dev)
    model = MambaTTS(cfg, sp_mesh=mesh if cfg.decoder.use_sp_scan else None, mesh=mesh)
    init_params(model, seed, params, mesh)
    model.to(dev)
    named = dict(model.named_parameters())
    tx = state_lib.make_optimizer(cfg.train.lr, cfg.train.grad_clip_norm, mesh=mesh,
                                  shardings=model.shardings)
    tb = batch_to_device(batch, dev)
    kw: Dict[str, Any] = {}
    if style is not None:
        tb = {**tb, "style_k": torch.as_tensor(style["k"], device=dev),
              "style_eps": torch.as_tensor(style["eps"], device=dev)}
    if mesh is not None:
        tb = shard_batch(tb, mesh)
    if style is not None:
        kw = {"deterministic": True, "style_k": tb.pop("style_k"),
              "style_eps": tb.pop("style_eps")}
    # the train CLI's own step
    step = make_train_step(model, tx, seed=seed, use_nar_branch=use_nar_branch, mesh=mesh)
    out: Dict[str, Any] = {}
    _, losses = step(state_lib.create_train_state(named, tx), tb, out=out, **kw)
    shardings = model.shardings or dict.fromkeys(named)
    full_grads = out["grads"] if mesh is None else gather_params(out["grads"], mesh, shardings)
    full_params = named if mesh is None else gather_params(named, mesh, shardings)
    return {"losses": {k: float(v) for k, v in losses.items()}, "norm": float(out["norm"]),
            "grads": _numpy(full_grads), "params": _numpy(full_params),
            "replicated": _numpy({n: p for n, p in named.items() if shardings[n] is None})}


def _dryrun_rank(mesh_shape, device: str) -> Dict[str, float]:
    from mamba_tts_torch import config as config_lib

    cfg = _tiny_config()
    n_data = mesh_shape[0]
    B, L, S = max(2 * n_data, 2), 6, 8
    Q, V = cfg.decoder.num_quantizers, cfg.decoder.vocab_size_audio
    rng = np.random.default_rng(0)
    batch = {
        "phoneme_ids": rng.integers(1, cfg.text_encoder.vocab_size, (B, L)).astype(np.int32),
        "text_mask": np.ones((B, L), bool),
        "style_bert": rng.standard_normal((B, cfg.smsd.bert_dim)).astype(np.float32),
        "spk_embs": rng.standard_normal((B, cfg.smsd.style_dim)).astype(np.float32),
        "target_codec": rng.integers(2, V, (B, S, Q)).astype(np.int32),
        "target_frames": np.full((B,), S, np.int32),
        "voice_codec": rng.integers(2, V, (B, S, Q)).astype(np.int32),
    }
    return train_check(config_lib.to_json(cfg), batch, device=device,
                       mesh_shape=mesh_shape)["losses"]


def _tiny_config():
    """One layer a stack at the widths of the JAX dry run: every component
    and loss in the step, every sharding rule matched."""
    from mamba_tts_torch import config as cl

    return cl.TTSConfig(
        decoder=cl.DecoderConfig(
            d_model=64, n_layers=1, n_heads=4, d_ff=128, d_style=32, max_len=256,
            num_quantizers=5, mamba=cl.MambaConfig(d_model=64, d_state=4), dtype="bfloat16"),
        text_encoder=cl.TextEncoderConfig(vocab_size=79, d_model=64, n_layers=1, n_heads=2,
                                          d_k=16, d_v=16, d_inner=128, dtype="bfloat16"),
        duration=cl.DurationPredictorConfig(d_model=64, filter_size=32, dtype="bfloat16"),
        smsd=cl.SMSDConfig(bert_dim=64, style_dim=32, num_mixtures=3, hidden_dim=48),
        style=cl.StylePipelineConfig(d_style=32, d_model=64, num_heads=4, dtype="bfloat16"),
    )


def dryrun_multichip(world: int = 4, mesh_shape: Optional[Sequence[int]] = None,
                     device: str = "cpu") -> List[Dict[str, float]]:
    """One full ``MambaTTS`` train step over ``world`` spawned ranks on a
    ("data", "model") mesh (default: 2 model ranks when ``world`` is even),
    at one layer a stack; every rank's losses, which must be finite and
    equal across ranks (each is the global batch's)."""
    if mesh_shape is None:
        n_model = 2 if world % 2 == 0 and world > 1 else 1
        mesh_shape = (world // n_model, n_model)
    losses = spawn(world, _dryrun_rank, tuple(mesh_shape), device, device=device)
    for rank_losses in losses:
        if not all(np.isfinite(v) for v in rank_losses.values()):
            raise RuntimeError(f"dryrun_multichip: non-finite losses {rank_losses}")
        if rank_losses != losses[0]:
            raise RuntimeError(f"dryrun_multichip: ranks disagree: {losses}")
    return losses
