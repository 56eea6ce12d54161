"""Device resolution for the port's entry points.

Every entry point takes a `device` argument and runs on CUDA unless the
caller asks for the CPU.  There is no fallback: asking for CUDA on a host
without a usable card raises, it never moves the work to the CPU.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """`None`/"cuda" -> the current CUDA device (raises without one);
    "cpu" -> the CPU.  Any other torch device string is taken as given
    and must be a CUDA or CPU device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain CPU path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev

