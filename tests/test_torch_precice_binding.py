"""The port's pyprecice binding (`dealii_adapter_tpu_torch/adapter/
participant.py:PreciceParticipant`) against a mock `precice` module that
exposes the official pyprecice-v3 snake_case surface, installed with
monkeypatch, so no pyprecice is needed: a full implicit coupled run of the
port's linear model driven through the binding (the reference's
initialize order, 3 windows x 2 implicit iterations, the checkpoint verbs
of the rollback), the 14 delegate names, and every camelCase verb's
arguments forwarded to its snake_case method. The mocks are copies of
those of tests/test_pyprecice_binding.py and
tests/test_participant_binding.py, which hold the JAX package's binding
the same way."""

import sys
import types

import numpy as np
import pytest
import torch

from dealii_adapter_tpu_torch.adapter import Adapter
from dealii_adapter_tpu_torch.adapter.participant import (
    FakeParticipant,
    Participant,
    PreciceParticipant,
    make_participant,
)
from dealii_adapter_tpu_torch.config import AllParameters
from dealii_adapter_tpu_torch.models.linear_elasticity import (
    LinearElastodynamics,
)
from dealii_adapter_tpu_torch.runner import coupled_run

torch.set_num_threads(1)


class _MockNativeParticipant:
    """pyprecice-v3-shaped native object: official snake_case names only,
    each recording the call and delegating to FakeParticipant's proven
    window/checkpoint logic."""

    def __init__(self, participant_name, config_file, rank, size):
        assert isinstance(participant_name, str) and participant_name
        assert isinstance(config_file, str) and config_file
        assert (rank, size) == (0, 1)
        self._fake = FakeParticipant(
            dim=2, window_dt=0.01, end_time=0.03, implicit_iterations=2,
            read_fn=lambda t, xy: np.stack(
                [1000.0 * (1 + t) * np.ones(len(xy)), np.zeros(len(xy))],
                axis=1,
            ),
        )
        self.calls = []

    def _rec(self, name, *shapes):
        self.calls.append(name)

    def get_mesh_dimensions(self, mesh_name):
        self._rec("get_mesh_dimensions")
        assert isinstance(mesh_name, str)
        return self._fake.getMeshDimensions(mesh_name)

    def set_mesh_vertices(self, mesh_name, coords):
        self._rec("set_mesh_vertices")
        coords = np.asarray(coords)
        assert coords.ndim == 2 and coords.shape[1] == 2
        assert coords.dtype.kind == "f"
        return self._fake.setMeshVertices(mesh_name, coords)

    def requires_initial_data(self):
        self._rec("requires_initial_data")
        return self._fake.requiresInitialData()

    def initialize(self):
        self._rec("initialize")
        return self._fake.initialize()

    def read_data(self, mesh_name, data_name, ids, relative_dt):
        self._rec("read_data")
        assert relative_dt >= 0.0
        return self._fake.readData(mesh_name, data_name, ids, relative_dt)

    def write_data(self, mesh_name, data_name, ids, values):
        self._rec("write_data")
        values = np.asarray(values)
        assert values.ndim == 2 and values.shape[1] == 2
        return self._fake.writeData(mesh_name, data_name, ids, values)

    def advance(self, dt):
        self._rec("advance")
        assert dt > 0.0
        return self._fake.advance(dt)

    def is_coupling_ongoing(self):
        self._rec("is_coupling_ongoing")
        return self._fake.isCouplingOngoing()

    def get_max_time_step_size(self):
        self._rec("get_max_time_step_size")
        return self._fake.getMaxTimeStepSize()

    def is_time_window_complete(self):
        self._rec("is_time_window_complete")
        return self._fake.isTimeWindowComplete()

    def requires_writing_checkpoint(self):
        self._rec("requires_writing_checkpoint")
        return self._fake.requiresWritingCheckpoint()

    def requires_reading_checkpoint(self):
        self._rec("requires_reading_checkpoint")
        return self._fake.requiresReadingCheckpoint()

    def finalize(self):
        self._rec("finalize")
        return self._fake.finalize()


class _RecordingParticipant:
    """Stands in for precice.Participant; records (method, args) calls."""

    def __init__(self, name, config, rank, size):
        self.calls = [("__init__", (name, config, rank, size))]

    def _rec(self, method, *args):
        self.calls.append((method, args))

    def get_mesh_dimensions(self, mesh_name):
        self._rec("get_mesh_dimensions", mesh_name)
        return 3

    def set_mesh_vertices(self, mesh_name, coords):
        self._rec("set_mesh_vertices", mesh_name, coords)
        return np.arange(len(coords), dtype=np.int32)

    def requires_initial_data(self):
        self._rec("requires_initial_data")
        return False

    def initialize(self):
        self._rec("initialize")

    def read_data(self, mesh_name, data_name, ids, relative_dt):
        self._rec("read_data", mesh_name, data_name, ids, relative_dt)
        return np.zeros((len(ids), 3))

    def write_data(self, mesh_name, data_name, ids, values):
        self._rec("write_data", mesh_name, data_name, ids, values)

    def advance(self, dt):
        self._rec("advance", dt)

    def is_coupling_ongoing(self):
        self._rec("is_coupling_ongoing")
        return True

    def get_max_time_step_size(self):
        self._rec("get_max_time_step_size")
        return 0.25

    def is_time_window_complete(self):
        self._rec("is_time_window_complete")
        return True

    def requires_writing_checkpoint(self):
        self._rec("requires_writing_checkpoint")
        return True

    def requires_reading_checkpoint(self):
        self._rec("requires_reading_checkpoint")
        return False

    def finalize(self):
        self._rec("finalize")


@pytest.fixture()
def mock_precice(monkeypatch):
    mod = types.ModuleType("precice")
    created = []

    def Participant(name, config, rank, size):
        p = _MockNativeParticipant(name, config, rank, size)
        created.append(p)
        return p

    mod.Participant = Participant
    monkeypatch.setitem(sys.modules, "precice", mod)
    return created


@pytest.fixture
def stub_precice(monkeypatch):
    mod = types.ModuleType("precice")
    mod.Participant = _RecordingParticipant
    monkeypatch.setitem(sys.modules, "precice", mod)
    return mod


def test_binding_drives_full_implicit_coupled_run(mock_precice):
    params = AllParameters(
        model="linear", type_lin="CG", scenario="PF", delta_t=0.01,
        end_time=0.03, poly_degree=1, mu=0.5e6, nu=0.4, rho=1000.0,
        theta=0.5, participant_name="Solid",
        config_file="precice-config.xml",
    )
    model = LinearElastodynamics(params, device="cpu")
    binding = PreciceParticipant(
        params.participant_name, params.config_file, 0, 1
    )
    native = mock_precice[0]
    adapter = Adapter(
        params, model.interface_id, model.space, participant=binding,
        dtype=model.dtype, device=model.device,
    )
    state = coupled_run(model, adapter)

    calls = native.calls
    # reference initialize order (`adapter.h:229-342`)
    assert calls.index("get_mesh_dimensions") < calls.index(
        "set_mesh_vertices"
    )
    assert calls.index("set_mesh_vertices") < calls.index(
        "requires_initial_data"
    )
    assert calls.index("requires_initial_data") < calls.index("initialize")
    # the coupled loop ran: 3 windows x 2 implicit iterations
    assert calls.count("advance") == 6
    assert calls.count("read_data") == 6
    assert calls.count("write_data") == 6
    # rollback protocol executed through the binding (one re-read per
    # repeated window; `adapter.h:447-489`)
    assert calls.count("requires_writing_checkpoint") >= 3
    assert calls.count("requires_reading_checkpoint") >= 3
    assert native._fake.finalized
    assert calls[-1] == "finalize"
    # physics moved (the surrogate read field pushed the flap)
    assert float(state.displacement.abs().max()) > 0.0


def test_binding_delegate_names_exist_on_pyprecice_v3(mock_precice):
    """The constructor and the 13 verbs: every snake_case attribute the
    binding delegates to exists on the pyprecice-v3 surface (encoded by
    the mock)."""
    p = PreciceParticipant("Solid", "precice-config.xml", 0, 1)
    assert mock_precice and p._p is mock_precice[0]
    for camel, snake in [
        ("getMeshDimensions", "get_mesh_dimensions"),
        ("setMeshVertices", "set_mesh_vertices"),
        ("requiresInitialData", "requires_initial_data"),
        ("initialize", "initialize"),
        ("readData", "read_data"),
        ("writeData", "write_data"),
        ("advance", "advance"),
        ("isCouplingOngoing", "is_coupling_ongoing"),
        ("getMaxTimeStepSize", "get_max_time_step_size"),
        ("isTimeWindowComplete", "is_time_window_complete"),
        ("requiresWritingCheckpoint", "requires_writing_checkpoint"),
        ("requiresReadingCheckpoint", "requires_reading_checkpoint"),
        ("finalize", "finalize"),
    ]:
        assert hasattr(p, camel)
        assert callable(getattr(p._p, snake)), snake


def test_all_14_methods_map_to_snake_case_with_args(stub_precice):
    p = PreciceParticipant("Solid", "cfg.xml")
    inner = p._p

    coords = np.array([[0.0, 1.0, 2.0], [3.0, 4.0, 5.0]])
    ids = np.array([0, 1], dtype=np.int32)
    values = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])

    assert p.getMeshDimensions("Solid-Mesh") == 3
    out_ids = p.setMeshVertices("Solid-Mesh", coords)
    np.testing.assert_array_equal(out_ids, [0, 1])
    assert p.requiresInitialData() is False
    p.initialize()
    data = p.readData("Solid-Mesh", "Stress", ids, 0.01)
    assert data.shape == (2, 3)
    p.writeData("Solid-Mesh", "Displacement", ids, values)
    p.advance(0.01)
    assert p.isCouplingOngoing() is True
    assert p.getMaxTimeStepSize() == 0.25
    assert p.isTimeWindowComplete() is True
    assert p.requiresWritingCheckpoint() is True
    assert p.requiresReadingCheckpoint() is False
    p.finalize()

    methods = [c[0] for c in inner.calls[1:]]
    assert methods == [
        "get_mesh_dimensions",
        "set_mesh_vertices",
        "requires_initial_data",
        "initialize",
        "read_data",
        "write_data",
        "advance",
        "is_coupling_ongoing",
        "get_max_time_step_size",
        "is_time_window_complete",
        "requires_writing_checkpoint",
        "requires_reading_checkpoint",
        "finalize",
    ]
    by_name = dict((c[0], c[1]) for c in inner.calls[1:])
    assert by_name["get_mesh_dimensions"] == ("Solid-Mesh",)
    assert by_name["set_mesh_vertices"][0] == "Solid-Mesh"
    np.testing.assert_array_equal(by_name["set_mesh_vertices"][1], coords)
    rd = by_name["read_data"]
    assert rd[0] == "Solid-Mesh" and rd[1] == "Stress" and rd[3] == 0.01
    np.testing.assert_array_equal(rd[2], ids)
    wd = by_name["write_data"]
    assert wd[0] == "Solid-Mesh" and wd[1] == "Displacement"
    np.testing.assert_array_equal(wd[2], ids)
    np.testing.assert_array_equal(wd[3], values)
    assert by_name["advance"] == (0.01,)


def test_constructor_forwards_name_config_rank_size(stub_precice):
    p = PreciceParticipant("Solid", "precice-config.xml", rank=2, size=4)
    assert p._p.calls[0] == ("__init__", ("Solid", "precice-config.xml", 2, 4))


def test_binding_satisfies_participant_protocol(stub_precice):
    assert isinstance(PreciceParticipant("Solid", "cfg.xml"), Participant)


def test_make_participant_constructs_real_binding(stub_precice):
    class P:
        participant_name = "Solid"
        config_file = "precice-config.xml"

    p = make_participant(P())
    assert isinstance(p, PreciceParticipant)
    assert p._p.calls[0] == ("__init__", ("Solid", "precice-config.xml", 0, 1))
