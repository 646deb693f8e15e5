"""Device resolution shared by every entry point of the port.

Entry points run on the card unless the caller asks for the CPU: a missing
CUDA device is an error, never a quiet fall-back to the CPU."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


def make_generator(seed: int, device) -> torch.Generator:
    """A generator that draws on ``device`` (CUDA draws need a CUDA
    generator), seeded with ``seed``."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return gen
