"""The PyTorch package on the two Neo-Hookean golden tip trajectories of
`tests/golden_trajectories.json` (recorded by the JAX package,
tests/test_golden_trajectory.py), with that test's configurations, loads
and tolerances (rtol 1e-7): `nonlinear_pf_q4` (2D PF, Q4, dense Direct
Newton solves, 1,898 DoF, traction 2000) and `nonlinear_pf_q2` (2D PF,
Q2, the f64 Jacobi CG on the f64 jvp tangent, 518 DoF, traction 5000;
`slow`: 20 steps of ~450 jvp CG iterations each). A file of its own, so
that xdist's `--dist loadfile` places it on a free worker."""

import json
import os

import numpy as np
import pytest
import torch

from dealii_adapter_tpu_torch.config import AllParameters
from dealii_adapter_tpu_torch.models.nonlinear_elasticity import (
    NonlinearElasticity,
)

torch.set_num_threads(2)

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden_trajectories.json")
N_STEPS = 20
# tests/test_golden_trajectory.py's Neo-Hookean configuration
NONLINEAR = dict(
    model="neo-Hookean", type_lin="CG", scenario="PF", dim=2, poly_degree=2,
    delta_t=0.01, mu=0.5e6, nu=0.4, rho=1000.0, tol_lin=1e-6, tol_u=1e-6,
    tol_f=1e-9, max_iterations_NR=12, max_iterations_lin=10.0,
)


def _tip_trajectory(model, magnitude):
    """x-displacement of the node nearest the flap tip's centre after each
    of N_STEPS steps under a constant interface traction (the JAX test's
    `_tip_trajectory`)."""
    nodes = model.space.mesh.nodes
    target = np.zeros(model.space.dim)
    target[1] = nodes[:, 1].max()
    tip = int(np.argmin(((nodes - target) ** 2).sum(axis=1)))
    stress = np.zeros((model.space.n_nodes, model.space.dim))
    stress[model.space.boundary_nodes[model.interface_id], 0] = magnitude
    stress = torch.as_tensor(stress, dtype=model.dtype)
    state = model.initial_state()
    traj = []
    for _ in range(N_STEPS):
        state, info = model.step(state, stress)
        assert info.converged
        traj.append(float(state.displacement[tip, 0]))
    return traj


def _check(key, traj):
    with open(GOLDEN_PATH) as fh:
        golden = json.load(fh)[key]
    assert len(golden) == N_STEPS and abs(traj[-1]) > 1e-4
    np.testing.assert_allclose(traj, golden, rtol=1e-7)


def test_nonlinear_pf_q4_matches_golden():
    """Q4 with dense Direct solves at traction 2000, 20 steps."""
    model = NonlinearElasticity(AllParameters(**dict(
        NONLINEAR, poly_degree=4, type_lin="Direct")), device="cpu")
    assert model.space.n_dofs == 1898
    _check("nonlinear_pf_q4", _tip_trajectory(model, 2000.0))


@pytest.mark.slow
def test_nonlinear_pf_q2_matches_golden():
    """Q2 with the f64 Jacobi CG on the f64 jvp tangent at traction 5000,
    all 20 steps (tests/test_torch_nonlinear.py checks the production
    configuration on the first 5 in Tier-1; `chip_smoke.py`'s `golden_nl`
    phase runs all 20 on the card)."""
    model = NonlinearElasticity(AllParameters(**NONLINEAR), device="cpu")
    assert model.space.n_dofs == 518
    _check("nonlinear_pf_q2", _tip_trajectory(model, 5000.0))
