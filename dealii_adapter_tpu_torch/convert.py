"""Carry parameters and state between the JAX package and this one.

A model here has no learned weights: its parameters are the configuration
plus numpy-built element matrices and masks, and its state is the Newmark
triple (nonlinear model) or the theta-scheme triple (linear model). These
helpers let tests drive both packages from the same inputs; they use only
numpy and `dataclasses`, never jax.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .config import AllParameters
from .device import resolve_device
from .models.linear_elasticity import LinearState
from .models.nonlinear_elasticity import NonlinearState


def params_from_jax(p) -> AllParameters:
    """The port's `AllParameters` from the JAX package's (field-identical)
    dataclass, for either model (the derived `lmbda` and `data_consistent`
    are recomputed from the same inputs)."""
    return AllParameters(**dataclasses.asdict(p))


def _tensors(arrays, device, dtype):
    device = resolve_device(device)
    return tuple(
        torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype, device=device)
        for x in arrays
    )


def _arrays(fields) -> Tuple[np.ndarray, ...]:
    return tuple(x.detach().to("cpu", torch.float64).numpy() for x in fields)


def state_from_numpy(
    displacement, velocity, acceleration, device=None, dtype=torch.float64
) -> NonlinearState:
    """A `NonlinearState` from three (n_nodes, dim) arrays (numpy or
    anything `np.asarray` takes, e.g. JAX arrays), on `device` (default:
    the CUDA card)."""
    return NonlinearState(*_tensors((displacement, velocity, acceleration),
                                    device, dtype))


def state_to_numpy(state: NonlinearState) -> Tuple[np.ndarray, ...]:
    """(displacement, velocity, acceleration) as float64 numpy arrays."""
    return _arrays((state.displacement, state.velocity, state.acceleration))


def linear_state_from_numpy(
    displacement, velocity, old_load, device=None, dtype=torch.float64
) -> LinearState:
    """A `LinearState` from three (n_nodes, dim) arrays, on `device`
    (default: the CUDA card)."""
    return LinearState(*_tensors((displacement, velocity, old_load), device, dtype))


def linear_state_to_numpy(state: LinearState) -> Tuple[np.ndarray, ...]:
    """(displacement, velocity, old_load) as float64 numpy arrays."""
    return _arrays((state.displacement, state.velocity, state.old_load))


def element_matrix_from_jax(E) -> np.ndarray:
    """A float64 numpy copy of an element matrix held as a JAX array."""
    return np.array(np.asarray(E), dtype=np.float64)
