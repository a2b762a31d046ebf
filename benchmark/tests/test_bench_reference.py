"""The plain reference against the program on the CPU at a small scale:
the same lattice, interface and constraints (the output's format), a
sound step judged within its limits, the program's float32 path (the
check's control) and planted faults judged outside them."""

import numpy as np
import pytest
import torch

from benchmark.harness import cell as C
from benchmark.harness import check, program

CPU = torch.device("cpu")
CONFIGS = {c["name"]: C.load_json(C.os.path.join(C.ROOT, c["file"]))
           for c in C.load_json(C.os.path.join(C.ROOT, "BENCHMARK.json"))["configs"]}
LIMITS = {"nh_q4_flap3d": C.load_json(
    C.os.path.join(C.BENCH_DIR, "limits", "nh_q4_flap3d.march.json")),
    "linear_q3_flap3d": C.load_json(
    C.os.path.join(C.BENCH_DIR, "limits", "linear_q3_flap3d.march.json"))}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    cfg = CONFIGS[request.param]
    model = program.build(cfg, CPU, scale=1)
    ref = check.make_reference(cfg, CPU, scale=1)
    values = np.zeros((len(ref.bc.interface_nodes), 3))
    values[:, 0] = 1000.0
    field = ref.bc.nodal_field(ref.lat, values).to(model.dtype)
    s0 = model.initial_state()
    s1, _ = model.step(s0, field)
    rec = {"in": s0._asdict(), "out": s1._asdict(), "load": values,
           "load_prev": None}
    return request.param, cfg, model, ref, rec


def test_same_lattice_interface_and_constraints(pair):
    _, _, model, ref, _ = pair
    assert np.array_equal(ref.lat.coords(), model.mesh.nodes)
    assert np.array_equal(ref.bc.interface_nodes,
                          model.space.boundary_nodes[model.interface_id])
    assert torch.equal(ref.bc.mask, model.mask.double())


def test_a_sound_step_is_within_the_limits(pair):
    name, _, _, ref, rec = pair
    got = ref.judge(rec)
    assert all(got[k] <= lim for k, lim in LIMITS[name].items()), got


def _altered(rec, fn):
    out = {k: v.clone() for k, v in rec["out"].items()}
    fn(out, rec["in"])
    return dict(rec, out=out)


def _unchanged(out, inp):
    for k in out:
        out[k].copy_(inp[k])


def _half_left_out(out, inp):
    n = out["displacement"].shape[0] // 2
    for k in out:
        out[k][n:] = inp[k][n:]


def _one_answer_altered(out, inp):
    u = out["displacement"]
    i = int(u[:, 0].abs().argmax())
    u[i, 0] *= 1.001


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out,
                                   _one_answer_altered],
                         ids=["unchanged", "half_left_out", "one_altered"])
def test_a_planted_fault_is_outside_the_limits(pair, fault):
    name, _, _, ref, rec = pair
    got = ref.judge(_altered(rec, fault))
    assert any(got[k] > lim for k, lim in LIMITS[name].items()), got


def test_the_float32_control_is_outside_the_limits(pair):
    name, cfg, _, ref, rec = pair
    cfg32 = dict(cfg, params=dict(cfg["params"], dtype="float32"))
    model = program.build(cfg32, CPU, scale=1)
    field = ref.bc.nodal_field(ref.lat, rec["load"]).to(model.dtype)
    s0 = model.initial_state()
    s1, _ = model.step(s0, field)
    got = ref.judge(dict(rec, **{"in": s0._asdict(), "out": s1._asdict()}))
    assert any(got[k] > lim for k, lim in LIMITS[name].items()), got
