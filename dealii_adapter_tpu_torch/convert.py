"""Carry parameters and state between the JAX package and this one.

A model here has no learned weights: its parameters are the configuration
plus numpy-built element matrices and masks, and its state is the Newmark
triple. These helpers let tests drive both packages from the same inputs;
they use only numpy and `dataclasses`, never jax.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .config import AllParameters
from .models.nonlinear_elasticity import NonlinearState


def params_from_jax(p) -> AllParameters:
    """The port's `AllParameters` from the JAX package's (field-identical)
    dataclass."""
    return AllParameters(**dataclasses.asdict(p))


def state_from_numpy(
    displacement, velocity, acceleration, device="cpu", dtype=torch.float64
) -> NonlinearState:
    """A `NonlinearState` from three (n_nodes, dim) arrays (numpy or
    anything `np.asarray` takes, e.g. JAX arrays)."""
    return NonlinearState(
        *(
            torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype,
                            device=device)
            for x in (displacement, velocity, acceleration)
        )
    )


def state_to_numpy(state: NonlinearState) -> Tuple[np.ndarray, ...]:
    """(displacement, velocity, acceleration) as float64 numpy arrays."""
    return tuple(
        x.detach().to("cpu", torch.float64).numpy()
        for x in (state.displacement, state.velocity, state.acceleration)
    )


def element_matrix_from_jax(E) -> np.ndarray:
    """A float64 numpy copy of an element matrix held as a JAX array."""
    return np.array(np.asarray(E), dtype=np.float64)
