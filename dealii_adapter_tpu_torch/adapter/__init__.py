"""Coupling adapter layer — the preCICE seam of the port.

Counterpart of `dealii_adapter_tpu/adapter/`: `adapter.py` (interface
registration, gather/scatter between the device fields and the coupling
library's interleaved host buffers, implicit-coupling checkpoints of cloned
tensors) and `participant.py` (a copy: the 14-method participant surface,
the scriptable `FakeParticipant`, the closed-loop
`SurrogateFluidParticipant` and the import-gated `PreciceParticipant`).
"""

from .adapter import Adapter
from .participant import (
    FakeParticipant,
    PreciceParticipant,
    SurrogateFluidParticipant,
    make_participant,
)

__all__ = [
    "Adapter",
    "FakeParticipant",
    "PreciceParticipant",
    "SurrogateFluidParticipant",
    "make_participant",
]
