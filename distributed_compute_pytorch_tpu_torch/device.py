"""Device resolution for the port's entry points.

The rule: an entry point runs on CUDA unless its caller asks for the CPU.
When CUDA is absent and the caller did not ask for the CPU, it raises —
nothing carries on quietly on the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None``/``"cuda"``/``"cuda:N"`` -> a CUDA device (``RuntimeError``
    when no CUDA device is available); ``"cpu"`` -> the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or "
                         f"'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device is required but torch.cuda.is_available() is "
            "False; pass device='cpu' (CLI: --device cpu) to run on the "
            "CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
