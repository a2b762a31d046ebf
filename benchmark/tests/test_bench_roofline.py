"""The copied roofline arithmetic against the port's recorded bounds, and
the yardstick's multigrid levels against the program's hierarchy."""

import pytest

from benchmark.harness import roofline


def test_tangent_matvec_bound_q4():
    # K1 at Q4: 3,456 cells x 375^2 x 4 B once (PERF.md's kernel table)
    ms = roofline.bound_s(*roofline.tangent_matvec_work(3456, 375)) * 1e3
    assert round(ms, 4) == 0.5834


def test_q1_level_bound_main3d():
    # K3 on main3d's FEM-SEM level, bf16 vectors (PERF.md's kernel table)
    ms = roofline.bound_s(*roofline.stencil_work((19, 325, 55), 2)) * 1e3
    assert round(ms, 4) == 0.0025


@pytest.mark.parametrize("degree,scale", [(3, 1), (4, 1), (2, 2)])
def test_hierarchy_matches_the_program(degree, scale):
    import torch

    from dealii_adapter_tpu_torch.config import AllParameters
    from dealii_adapter_tpu_torch.mesh.generator import make_scenario_grid
    from dealii_adapter_tpu_torch.models.linear_elasticity import (
        LinearElastodynamics,
    )

    p = AllParameters(model="linear", scenario="PF", dim=3, poly_degree=degree,
                      preconditioner="MG", precond_dtype="float32",
                      solve_dtype="float32", delta_t=0.005)
    mesh, tags = make_scenario_grid("PF", 3, degree, scale=scale, solver="linear")
    m = LinearElastodynamics(p, mesh=mesh, tags=tags, device=torch.device("cpu"))
    shapes = [tuple(lv.grid_shape) for lv in m.preconditioner.levels]
    smoothed, coarse = roofline.q1_hierarchy(
        (3 * scale, 18 * scale, scale), degree, (0.1, 1.0, 0.3), p.mg_coarse_size)
    assert shapes[1:] == smoothed + [coarse]


def test_the_configurations_work():
    """The work functions at the cells' configurations: K1's bound at the
    Neo-Hookean Q4 cell, and one V-cycle's Q1 levels of each cell above the
    finest level's share alone and under a millisecond."""
    from benchmark.harness.cell import ROOT, load_json

    nh = load_json(f"{ROOT}/benchmark/configs/nh_q4_flap3d.json")
    lin = load_json(f"{ROOT}/benchmark/configs/linear_q3_flap3d.json")
    assert roofline.flap_cells(nh) == 3456
    assert round(roofline.tangent_matvec_s(nh) * 1e3, 4) == 0.5834
    assert roofline.tangent_write_s(nh) == pytest.approx(3456 * 375 ** 2 * 4
                                                         / roofline.HBM_BYTES_PER_S)
    for cfg in (nh, lin):
        p = cfg["params"]
        levels, _ = roofline.q1_hierarchy(
            (3 * cfg["scale"], 18 * cfg["scale"], cfg["scale"]), p["poly_degree"],
            (0.1, 1.0, 0.3), p["mg_coarse_size"])
        finest = (2 * p["mg_smooth_degree"] + 2) * roofline.bound_s(
            *roofline.stencil_work(levels[0], roofline.IO_BYTES[p["precond_dtype"]]))
        assert finest < roofline.vcycle_levels_s(cfg) < 1e-3
