"""Where the package's entry points run: on the CUDA card unless the
caller names another device. Nothing falls back to the CPU silently."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a `torch.device`; None means the current CUDA card, and
    raises where there is none (pass device="cpu" to run on the CPU). A
    CUDA device comes back with its index (a bare "cuda" is the current
    card), so that a rank's card is never a bare "cuda"."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: dealii_adapter_tpu_torch runs on "
            "the CUDA card by default; pass device='cpu' to run on the CPU"
        )
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
