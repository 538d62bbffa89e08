"""Device selection shared by every entry point of the port.

Entry points run on the CUDA card unless the caller asks for the CPU.  There
is no quiet fallback: asking for the card on a machine without one raises.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """``"cuda"`` (the default) or ``"cpu"`` -> a ``torch.device``.

    Raises ``RuntimeError`` when the card is asked for and none is present.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def on_card(t: torch.Tensor) -> bool:
    """True when ``t`` lies on the CUDA card: the dispatch test of every op
    that has a hand-written kernel (or a queued one) beside its plain
    version.  Tests replace it with a stub to reach the card branch on a
    CUDA-less machine."""
    return t.device.type == "cuda"
