"""Device binding shared by the port's device engines."""
from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The torch device a device engine runs on.  A CUDA device must
    exist: the port never quietly runs on the CPU unless asked to."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA device is "
                f"available (pass device='cpu' to run the plain versions "
                f"on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: "
                         f"'cuda' or 'cpu'")
    return dev


def stream_context(device: torch.device,
                   stream: Optional["torch.cuda.Stream"]):
    """Enter ``device`` and ``stream`` (CUDA), or nothing (CPU)."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.cuda.device(device))
    if stream is not None:
        stack.enter_context(torch.cuda.stream(stream))
    return stack
