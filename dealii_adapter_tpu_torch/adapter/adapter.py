"""The coupling Adapter: interface registration, data gather/scatter, and
implicit-coupling checkpointing around a host-side participant.

Counterpart of `dealii_adapter_tpu/adapter/adapter.py` (the reference's
`Adapter::Adapter<dim, VectorType, ParameterClass>`,
`include/adapter/adapter.h:26-209`):

* interface discovery (`initialize`, `adapter.h:229-342`): the DofSpace
  knows the interface node set and coordinates, so registration is one
  array lookup;
* gather/scatter (`format_deal_to_precice` / `format_precice_to_deal`,
  `adapter.h:389-443`): `_gather` reads the interface rows of a (n_nodes,
  dim) field back to the host, `_scatter` builds the zero-padded nodal
  field on the model's device in the model's dtype;
* checkpointing (`save_current_state_if_required` /
  `reload_old_state_if_required`, `adapter.h:447-489`): torch tensors are
  mutable, so a checkpoint holds CLONES of the state's tensors (the JAX
  package holds a reference, which its immutable arrays make a copy), and
  a reload hands out fresh clones, so the saved state survives any
  in-place change and any number of rollbacks; reload rewinds the `Time`
  handler via `set_absolute_time` (`time_handler.h:63-70`).

The participant (libprecice or the in-process fake) lives on the host;
device tensors cross the boundary only in `read_data`/`advance`, once per
coupling step, never inside CG/Newton.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..config import AllParameters
from ..device import resolve_device
from ..fem.dofspace import DofSpace
from ..time_handler import Time
from .participant import Participant, make_participant


def _clone_state(state):
    """A copy of a state tuple (a NamedTuple of tensors) whose tensors
    share no storage with the original's."""
    return type(state)(*(t.clone() for t in state))


class Adapter:
    def __init__(
        self,
        params: AllParameters,
        interface_id: int,
        space: DofSpace,
        participant: Optional[Participant] = None,
        dtype=None,
        device=None,
    ):
        """`dtype` and `device` are the model's: the fields `read_data`
        returns are built there (default dtype float64; default device the
        CUDA card, as for the models)."""
        self.params = params
        self.space = space
        self.interface_id = interface_id
        self.mesh_name = params.mesh_name
        self.read_data_name = params.read_data_name
        self.write_data_name = params.write_data_name
        self.precice = make_participant(params, fake=participant)
        self.dtype = torch.float64 if dtype is None else dtype
        self.device = resolve_device(device)

        self.iface_nodes = space.boundary_nodes[interface_id]
        self.n_interface_nodes = len(self.iface_nodes)
        self._iface_index = torch.as_tensor(self.iface_nodes, device=self.device)
        self.vertex_ids: Optional[np.ndarray] = None

        # implicit-coupling checkpoint (cloned state + time)
        self._saved: Optional[Tuple[Any, float]] = None

    # ------------------------------------------------------------------

    def initialize(self, write_field) -> None:
        """Register interface vertices and run the participant handshake
        (`adapter.h:229-342`). `write_field` is the (n_nodes, dim) field to
        publish if the partner requires initial data."""
        pdim = self.precice.getMeshDimensions(self.mesh_name)
        if pdim != self.space.dim:
            raise ValueError(
                f"The dimension of the solver ({self.space.dim}) and the "
                f"configured coupling mesh ({pdim}) do not match "
                "(adapter.h:235-240)"
            )
        coords = self.space.boundary_node_coords(self.interface_id)
        self.vertex_ids = self.precice.setMeshVertices(self.mesh_name, coords)
        if self.precice.requiresInitialData():
            self.precice.writeData(
                self.mesh_name,
                self.write_data_name,
                self.vertex_ids,
                self._gather(write_field),
            )
        self.precice.initialize()

    # -- data movement ---------------------------------------------------

    def _gather(self, field: torch.Tensor) -> np.ndarray:
        """(n_nodes, dim) field -> (n_iface, dim) float64 host buffer, in
        vertex registration order (`format_deal_to_precice`,
        `adapter.h:389-417`); only the interface rows leave the device."""
        rows = field[self._iface_index.to(field.device)]
        return rows.detach().to("cpu", torch.float64).numpy()

    def _scatter(self, values: np.ndarray) -> torch.Tensor:
        """(n_iface, dim) host buffer -> (n_nodes, dim) field on the model's
        device in its dtype, zero off the interface
        (`format_precice_to_deal`, `adapter.h:421-443`)."""
        out = np.zeros((self.space.n_nodes, self.space.dim))
        out[self.iface_nodes] = np.asarray(values).reshape(-1, self.space.dim)
        return torch.as_tensor(out, dtype=self.dtype, device=self.device)

    def read_data(self, relative_dt: float) -> torch.Tensor:
        """Sample the partner's field `relative_dt` into the current window
        and return it as a nodal field on the model's device
        (`adapter.h:346-361`)."""
        vals = self.precice.readData(
            self.mesh_name, self.read_data_name, self.vertex_ids, relative_dt
        )
        return self._scatter(vals)

    def advance(self, write_field, dt: float) -> None:
        """Publish `write_field` on the interface and advance the coupling
        window (`adapter.h:365-385`) — the inter-solver synchronization
        point."""
        self.precice.writeData(
            self.mesh_name,
            self.write_data_name,
            self.vertex_ids,
            self._gather(write_field),
        )
        self.precice.advance(dt)

    # -- implicit-coupling checkpointing ---------------------------------

    def save_current_state_if_required(self, state, time: Time) -> bool:
        """Checkpoint clones of the state's tensors and the current time
        (`adapter.h:447-464`)."""
        if self.precice.requiresWritingCheckpoint():
            self._saved = (_clone_state(state), time.current())
            return True
        return False

    def reload_old_state_if_required(self, state, time: Time):
        """Returns the state to continue from (fresh clones of the
        checkpoint on rollback); rewinds `time` on rollback
        (`adapter.h:468-489`, `time_handler.h:63-70`)."""
        if self.precice.requiresReadingCheckpoint():
            assert self._saved is not None, "rollback without checkpoint"
            saved_state, saved_time = self._saved
            time.set_absolute_time(saved_time)
            return _clone_state(saved_state)
        return state

    # -- passthrough steering -------------------------------------------

    def is_coupling_ongoing(self) -> bool:
        return self.precice.isCouplingOngoing()

    def is_time_window_complete(self) -> bool:
        return self.precice.isTimeWindowComplete()

    def get_max_time_step_size(self) -> float:
        return self.precice.getMaxTimeStepSize()

    def finalize(self) -> None:
        self.precice.finalize()

