"""Where the package's entry points run: on the CUDA card unless the
caller names another device. Nothing falls back to the CPU silently."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a `torch.device`; None means the CUDA card, and raises
    where there is none (pass device="cpu" to run on the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: dealii_adapter_tpu_torch runs on "
            "the CUDA card by default; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")
