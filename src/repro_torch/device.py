"""Where the port's entry points put their tensors.

Every entry point that creates tensors takes ``device=``.  The default is
the CUDA card: the port is written for it, and a run that silently landed
on the CPU would measure the wrong machine.  The CPU is used only when the
caller asks for it (``device="cpu"``), as the tests do.
"""
from __future__ import annotations

import functools

import torch

__all__ = ["resolve_device", "sm_count"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a :class:`torch.device`, ``"cuda"`` when None.

    Raises when a CUDA device is asked for (or defaulted to) and none is
    present: nothing carries on on the CPU unless the caller asked for it.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


@functools.cache
def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count
