"""The system under test, built through the port's public constructors
from a configuration file: `AllParameters(**params)`, the flap's mesh from
`mesh.generator.make_scenario_grid` at the configuration's scale, and the
model class its `model` names."""

from __future__ import annotations

import numpy as np


def build(config: dict, device, scale: int | None = None):
    from dealii_adapter_tpu_torch.config import AllParameters
    from dealii_adapter_tpu_torch.mesh.generator import make_scenario_grid

    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in config["params"].items()}
    params = AllParameters(**kw)
    mesh, tags = make_scenario_grid(params.scenario, params.dim,
                                    params.poly_degree,
                                    scale=scale or int(config["scale"]),
                                    solver=params.model)
    if params.model == "neo-Hookean":
        from dealii_adapter_tpu_torch.models.nonlinear_elasticity import (
            NonlinearElasticity as Model,
        )
    else:
        from dealii_adapter_tpu_torch.models.linear_elasticity import (
            LinearElastodynamics as Model,
        )
    return Model(params, mesh=mesh, tags=tags, device=device)


class Flap:
    """The benchmark's own view of the flap's nodes (`reference/fem.py`'s
    lattice on the host): the interface nodes, ascending, and the tip node
    (top, centred in x and z) whose displacement a user's loop reads."""

    def __init__(self, config: dict, scale: int | None = None):
        from ..reference import fem

        lat = fem.flap_lattice(scale or int(config["scale"]),
                               int(config["params"]["poly_degree"]), "cpu")
        self.interface_nodes = fem.FlapBoundary(lat).interface_nodes
        nx, ny, nz = lat.shape
        self.tip = int(lat.node_ids(ix=nx // 2, iy=ny - 1, iz=nz // 2)[0])
        self.n_dofs = 3 * lat.n_nodes
