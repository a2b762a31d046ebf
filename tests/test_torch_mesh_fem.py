"""The PyTorch package's copies of the numpy host modules (mesh, FE
tabulation, DoF space, config) give results identical to the JAX
package's."""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from dealii_adapter_tpu.config import parse_prm as jax_parse_prm
from dealii_adapter_tpu.fem.dofspace import DofSpace as JaxDofSpace
from dealii_adapter_tpu.fem.tabulation import tabulate as jax_tabulate
from dealii_adapter_tpu.mesh.generator import make_scenario_grid as jax_grid
from dealii_adapter_tpu_torch.config import parse_prm
from dealii_adapter_tpu_torch.convert import params_from_jax
from dealii_adapter_tpu_torch.fem.dofspace import DofSpace
from dealii_adapter_tpu_torch.fem.tabulation import tabulate
from dealii_adapter_tpu_torch.mesh.generator import make_scenario_grid

torch.set_num_threads(1)

EXAMPLES = sorted(
    glob.glob(os.path.join(os.path.dirname(__file__), "..", "examples", "*.prm"))
)


def _assert_same(a, b, path="root"):
    """Exact structural equality of numpy/dataclass/dict/sequence trees."""
    if dataclasses.is_dataclass(a):
        _assert_same(dataclasses.asdict(a), dataclasses.asdict(b), path)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize(
    "scenario,dim,degree,solver",
    [
        ("PF", 2, 2, "neo-Hookean"),
        ("PF", 3, 2, "neo-Hookean"),
        ("FSI3", 3, 1, "linear"),
        ("PF", 3, 4, "linear"),
    ],
)
def test_mesh_and_dofspace_identical(scenario, dim, degree, solver):
    jm, jtags = jax_grid(scenario, dim, degree, solver=solver)
    tm, ttags = make_scenario_grid(scenario, dim, degree, solver=solver)
    _assert_same(jtags, ttags, "tags")
    for f in ("dim", "degree", "reps", "p0", "p1", "axis_coords", "nodes",
              "cells", "cell_h", "boundary_faces"):
        _assert_same(getattr(jm, f), getattr(tm, f), f)

    js = JaxDofSpace.create(jm, n_q_1d=degree + 2)
    ts = DofSpace.create(tm, n_q_1d=degree + 2)
    _assert_same(js.tab, ts.tab, "tab")
    _assert_same(js.cells, ts.cells, "cells")
    _assert_same(js.boundary_nodes, ts.boundary_nodes, "boundary_nodes")
    assert js.plan_sentinel == ts.plan_sentinel
    # the order of a node's entries within its plan row is not specified
    np.testing.assert_array_equal(np.sort(js.plan, 1), np.sort(ts.plan, 1))
    clamped, oop = jtags["clamped"], jtags.get("out_of_plane")
    np.testing.assert_array_equal(
        js.dirichlet_mask(clamped, oop), ts.dirichlet_mask(clamped, oop)
    )
    jf, jn = js.interface_faces(jtags["interface"])
    tf, tn = ts.interface_faces(ttags["interface"])
    np.testing.assert_array_equal(jf, tf)
    np.testing.assert_array_equal(jn, tn)


@pytest.mark.parametrize("dim,degree,nq", [(2, 1, 2), (2, 3, 5), (3, 2, 4)])
def test_tabulation_identical(dim, degree, nq):
    _assert_same(jax_tabulate(dim, degree, nq), tabulate(dim, degree, nq))


@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_parse_prm_identical(path):
    jp = jax_parse_prm(path)
    tp = parse_prm(path)
    _assert_same(dataclasses.asdict(jp), dataclasses.asdict(tp))
    _assert_same(dataclasses.asdict(params_from_jax(jp)), dataclasses.asdict(tp))
