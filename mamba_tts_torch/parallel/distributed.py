"""Process-group start-up — counterpart of ``mamba_tts_tpu/parallel/distributed.py``.

The JAX package calls ``jax.distributed.initialize``; here each process joins
a ``torch.distributed`` process group, from explicit arguments or from the
environment ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``).  Nothing on a machine announces a cluster, so without
either this is a no-op, as is a second call.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> dict:
    """Join the process group when running multi-process; no-op otherwise.

    ``coordinator_address`` is an init method (``tcp://host:port`` or
    ``file://path``; a bare ``host:port`` means tcp).  ``backend`` defaults
    to NCCL when a CUDA card is present, else gloo.  Returns JAX's four keys:
    process_index, process_count, local_devices, global_devices (one device
    a process)."""
    explicit = coordinator_address is not None
    env_driven = all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))
    if (explicit or env_driven) and not dist.is_initialized():
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        if explicit:
            if num_processes is None or process_id is None:
                raise ValueError("an explicit coordinator_address needs num_processes and "
                                 "process_id")
            url = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
            dist.init_process_group(backend, init_method=url, world_size=num_processes,
                                    rank=process_id)
        else:
            dist.init_process_group(backend, init_method="env://")
    if dist.is_initialized():
        index, count = dist.get_rank(), dist.get_world_size()
    else:
        index, count = 0, 1
    return {"process_index": index, "process_count": count, "local_devices": 1,
            "global_devices": count}


def rank_mesh(shape: Optional[Tuple[int, ...]], axes: Tuple[str, ...], device: torch.device):
    """The mesh of a CLI run one process a rank: joins the process group
    (``torchrun``'s environment, or the one ``parallel/dryrun.py`` started),
    takes this rank's card (its local rank modulo the cards present) and
    builds ``make_mesh(shape, axes)``.  A lone process raises."""
    from mamba_tts_torch.parallel.mesh import make_mesh

    initialize_multihost()
    if not dist.is_initialized():
        raise ValueError("a mesh needs one process a rank: run under torchrun "
                         "(--nproc_per_node N) or mamba_tts_torch.parallel.dryrun.spawn")
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return make_mesh(shape, axes, device_type=device.type)
