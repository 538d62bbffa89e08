"""Train state, optimizer and checkpoints — counterpart of
``mamba_tts_tpu/train/state.py``.

- :class:`Optimizer` (:func:`make_optimizer`): global-norm gradient clipping
  then Adam, with optax's formulas (``optax.chain(clip_by_global_norm,
  adam)``): a gradient whose global norm exceeds ``max_norm`` becomes
  ``(g / norm) * max_norm`` (no epsilon); Adam's moments are bias-corrected
  by ``1 - b^count`` and the update is ``-lr * mu_hat / (sqrt(nu_hat) + eps)``.
  The JAX package clips the global norm across all modules; so does this.
  On a mesh (``make_optimizer(..., mesh=...)``) the norm sums the squares
  of the "model" shards over that axis and counts replicated parameters
  once, after the data-parallel gradient sum: optax's norm over the whole
  tree.  Adam stays elementwise on each rank's shards.
- :class:`TrainState`: step, params (name -> tensor, the model's own
  parameters, updated in place) and the optimizer state.
- :func:`save_checkpoint` / :func:`restore_checkpoint` / :func:`restore_params`:
  the port's own ``torch.save`` of ``{step, params, opt_state}`` in a
  step-numbered directory under ``checkpoint_dir``; :func:`copy_params`
  loads saved params into a model's, keys and shapes checked.  On a mesh
  the save gathers full tensors and rank 0 writes the file a single device
  writes; the restore cuts it to any mesh's shards.  The JAX
  package's orbax checkpoints come in through the weight bridge (README).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from mamba_tts_torch.parallel import comm
from mamba_tts_torch.parallel.mesh import axis_group, gather_params, shard_params

CHECKPOINT_FILE = "state.pt"


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


class Optimizer:
    """``optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(lr))``.

    State: ``{"count": int, "mu": {name: tensor}, "nu": {name: tensor}}``."""

    def __init__(self, lr: float, max_norm: float = 1.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, mesh=None, shardings: Optional[Dict[str, Any]] = None):
        self.lr, self.max_norm, self.b1, self.b2, self.eps = lr, max_norm, b1, b2, eps
        self.tp_group = axis_group(mesh, "model")
        if self.tp_group is not None and shardings is None:
            raise ValueError("a tensor-parallel optimizer needs the model's shardings")
        self.shardings = shardings

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        zeros = {n: torch.zeros_like(p, memory_format=torch.preserve_format)
                 for n, p in params.items()}
        return {"count": 0, "mu": zeros, "nu": {n: torch.zeros_like(p) for n, p in zeros.items()}}

    @torch.no_grad()
    def global_norm(self, names, g) -> torch.Tensor:
        """The gradients' global norm: on a mesh the "model" shards' squares
        are summed over that axis, replicated parameters counted once."""
        norms = torch.stack(torch._foreach_norm(g))
        if self.tp_group is None:
            return torch.linalg.vector_norm(norms)
        sharded = torch.tensor([self.shardings[n] is not None for n in names],
                               device=norms.device)
        sq = (norms * norms).where(sharded, 0.0).sum()
        return torch.sqrt(comm.all_reduce_(sq, self.tp_group)
                          + (norms * norms).where(~sharded, 0.0).sum())

    @torch.no_grad()
    def apply(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
              opt_state: Dict[str, Any], norm: Optional[torch.Tensor] = None
              ) -> Dict[str, Any]:
        """One step in place on ``params`` and the state's moments; returns
        the new state.  ``norm``: the gradients' :meth:`global_norm`, when
        the caller has taken it already."""
        names = list(grads)
        g = [grads[n] for n in names]
        if norm is None:
            norm = self.global_norm(names, g)
        clipped = torch._foreach_mul(torch._foreach_div(g, norm), self.max_norm)
        keep = norm < self.max_norm
        g = [torch.where(keep, a, b) for a, b in zip(g, clipped)]
        count = opt_state["count"] + 1
        mu = [opt_state["mu"][n] for n in names]
        nu = [opt_state["nu"][n] for n in names]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - self.b2))
        mu_hat = torch._foreach_div(mu, 1.0 - self.b1 ** count)
        nu_hat = torch._foreach_div(nu, 1.0 - self.b2 ** count)
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps)
        updates = torch._foreach_mul(torch._foreach_div(mu_hat, denom), -self.lr)
        torch._foreach_add_([params[n] for n in names], updates)
        return {**opt_state, "count": count}


def make_optimizer(lr: float, grad_clip_norm: float = 1.0, mesh=None, shardings=None
                   ) -> Optimizer:
    """``shardings``: the model's (``MambaTTS.shardings``) on a mesh with a
    "model" axis."""
    return Optimizer(lr, grad_clip_norm, mesh=mesh, shardings=shardings)


def create_train_state(params: Dict[str, torch.Tensor], tx: Optimizer) -> TrainState:
    return TrainState(step=0, params=params, opt_state=tx.init(params))


def _latest_step(checkpoint_dir: Path) -> Optional[int]:
    steps = [int(p.name) for p in checkpoint_dir.iterdir()
             if p.name.isdigit() and (p / CHECKPOINT_FILE).is_file()]
    return max(steps) if steps else None


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().cpu() if torch.is_tensor(tree) else tree


def save_checkpoint(checkpoint_dir: str, state: TrainState, mesh=None, shardings=None) -> Path:
    """Write ``<checkpoint_dir>/<step>/state.pt`` (through a temporary file,
    so a cut run leaves no half-written checkpoint).  On ``mesh`` every rank
    calls this: the shards (the model's ``shardings``) are gathered to full
    tensors and rank 0 writes them; the call returns once the file is there."""
    path = Path(checkpoint_dir) / str(state.step)
    params, opt_state = state.params, state.opt_state
    if mesh is not None:
        params = gather_params(params, mesh, shardings)
        opt_state = {**opt_state, **{k: gather_params(opt_state[k], mesh, shardings)
                                     for k in ("mu", "nu")}}
    if mesh is None or dist.get_rank() == 0:
        path.mkdir(parents=True, exist_ok=True)
        tmp = path / (CHECKPOINT_FILE + ".tmp")
        torch.save({"step": state.step, "params": _cpu(params), "opt_state": _cpu(opt_state)},
                   tmp)
        tmp.replace(path / CHECKPOINT_FILE)
    if mesh is not None:
        dist.barrier()
    return path


def _load(checkpoint_dir: str, step: Optional[int]):
    path = Path(checkpoint_dir)
    if not path.is_dir():
        return None
    target = step if step is not None else _latest_step(path)
    if target is None or not (path / str(target) / CHECKPOINT_FILE).is_file():
        return None
    return torch.load(path / str(target) / CHECKPOINT_FILE, map_location="cpu", weights_only=True)


def restore_params(checkpoint_dir: str, step: Optional[int] = None
                   ) -> Tuple[Optional[Dict[str, torch.Tensor]], bool]:
    """Only the params of the latest (or given) checkpoint, on the CPU."""
    saved = _load(checkpoint_dir, step)
    return (None, False) if saved is None else (saved["params"], True)


def copy_params(own: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor]) -> None:
    """Copy ``params`` (name -> tensor, as a checkpoint holds them) into the
    tensors of ``own`` (a model's ``named_parameters()``) in place.  Raises
    ``KeyError`` naming the keys the model lacks and those the checkpoint
    lacks, and ``ValueError`` naming each shape that differs."""
    unknown, missing = sorted(set(params) - set(own)), sorted(set(own) - set(params))
    if unknown or missing:
        raise KeyError(f"checkpoint keys the model lacks: {unknown[:20]}; "
                       f"model parameters the checkpoint lacks: {missing[:20]}")
    bad = [f"{n}: model {tuple(p.shape)} vs checkpoint {tuple(params[n].shape)}"
           for n, p in own.items() if p.shape != params[n].shape]
    if bad:
        raise ValueError("checkpoint shapes differ from the model's: " + "; ".join(bad[:20]))
    with torch.no_grad():
        for n, p in own.items():
            p.copy_(params[n])


def restore_checkpoint(checkpoint_dir: str, state: TrainState, step: Optional[int] = None,
                       mesh=None) -> Tuple[TrainState, bool]:
    """Copy the latest (or given) checkpoint into ``state``'s tensors in
    place, cut to this rank's shards on ``mesh`` (any mesh shape); returns
    (state, restored?)."""
    saved = _load(checkpoint_dir, step)
    if saved is None:
        return state, False
    copy_params(state.params, shard_params(saved["params"], mesh))
    with torch.no_grad():
        for key in ("mu", "nu"):
            moments = shard_params(saved["opt_state"][key], mesh)
            for n, t in state.opt_state[key].items():
                t.copy_(moments[n])
    opt_state = {**state.opt_state, "count": int(saved["opt_state"]["count"])}
    return state.replace(step=int(saved["step"]), opt_state=opt_state), True
