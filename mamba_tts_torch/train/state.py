"""Train state, optimizer and checkpoints — counterpart of
``mamba_tts_tpu/train/state.py``.

- :class:`Optimizer` (:func:`make_optimizer`): global-norm gradient clipping
  then Adam, with optax's formulas (``optax.chain(clip_by_global_norm,
  adam)``): a gradient whose global norm exceeds ``max_norm`` becomes
  ``(g / norm) * max_norm`` (no epsilon); Adam's moments are bias-corrected
  by ``1 - b^count`` and the update is ``-lr * mu_hat / (sqrt(nu_hat) + eps)``.
  The JAX package clips the global norm across all modules; so does this.
- :class:`TrainState`: step, params (name -> tensor, the model's own
  parameters, updated in place) and the optimizer state.
- :func:`save_checkpoint` / :func:`restore_checkpoint` / :func:`restore_params`:
  the port's own ``torch.save`` of ``{step, params, opt_state}`` in a
  step-numbered directory under ``checkpoint_dir``; :func:`copy_params`
  loads saved params into a model's, keys and shapes checked.  The JAX
  package's orbax checkpoints come in through the weight bridge (README).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

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
                 eps: float = 1e-8):
        self.lr, self.max_norm, self.b1, self.b2, self.eps = lr, max_norm, b1, b2, eps

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        zeros = {n: torch.zeros_like(p, memory_format=torch.preserve_format)
                 for n, p in params.items()}
        return {"count": 0, "mu": zeros, "nu": {n: torch.zeros_like(p) for n, p in zeros.items()}}

    @torch.no_grad()
    def apply(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
              opt_state: Dict[str, Any]) -> Dict[str, Any]:
        """One step in place on ``params`` and the state's moments; returns
        the new state."""
        names = list(grads)
        g = [grads[n] for n in names]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
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


def make_optimizer(lr: float, grad_clip_norm: float = 1.0) -> Optimizer:
    return Optimizer(lr, grad_clip_norm)


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


def save_checkpoint(checkpoint_dir: str, state: TrainState) -> Path:
    """Write ``<checkpoint_dir>/<step>/state.pt`` (through a temporary file,
    so a cut run leaves no half-written checkpoint)."""
    path = Path(checkpoint_dir) / str(state.step)
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / (CHECKPOINT_FILE + ".tmp")
    torch.save({"step": state.step, "params": _cpu(state.params),
                "opt_state": _cpu(state.opt_state)}, tmp)
    tmp.replace(path / CHECKPOINT_FILE)
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


def restore_checkpoint(checkpoint_dir: str, state: TrainState, step: Optional[int] = None
                       ) -> Tuple[TrainState, bool]:
    """Copy the latest (or given) checkpoint into ``state``'s tensors in
    place; returns (state, restored?)."""
    saved = _load(checkpoint_dir, step)
    if saved is None:
        return state, False
    copy_params(state.params, saved["params"])
    with torch.no_grad():
        for key in ("mu", "nu"):
            for n, t in state.opt_state[key].items():
                t.copy_(saved["opt_state"][key][n])
    opt_state = {**state.opt_state, "count": int(saved["opt_state"]["count"])}
    return state.replace(step=int(saved["step"]), opt_state=opt_state), True
