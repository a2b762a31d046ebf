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

Several ranks (`device_mesh`, the model's `RankGroup`): the JAX package
couples through one process, and so here rank 0 alone holds the
participant; the other ranks hold none. `_gather` brings the interface
rows of the distributed field to rank 0 (each rank adds the interface
rows it owns into an (n_iface, dim) buffer, one SUM all-reduce; under the
cell partition's replicated vectors rank 0 reads its own), `read_data`
sends rank 0's (n_iface, dim) buffer to every rank, which keeps its own
rows of the scattered field, and rank 0 decides every steering answer and
sends it, one small collective each, so that every rank takes the same
branch. Checkpoints are each rank's clones of its own rows. With
`device_mesh` None nothing of this runs.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..config import AllParameters
from ..device import resolve_device
from ..fem.dofspace import DofSpace
from ..parallel.spmd import lattice_layout
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
        device_mesh=None,
    ):
        """`dtype` and `device` are the model's: the fields `read_data`
        returns are built there (default dtype float64; default device the
        CUDA card, as for the models). `device_mesh` is the model's rank
        group (None on one device); on a rank other than 0 `participant`
        is ignored and no participant is made."""
        self.params = params
        self.space = space
        self.interface_id = interface_id
        self.mesh_name = params.mesh_name
        self.read_data_name = params.read_data_name
        self.write_data_name = params.write_data_name
        self.mesh = device_mesh
        self.rank = 0 if device_mesh is None else device_mesh.rank
        self.precice = (make_participant(params, fake=participant)
                        if self.rank == 0 else None)
        self.dtype = torch.float64 if dtype is None else dtype
        self.device = resolve_device(device)

        self.iface_nodes = space.boundary_nodes[interface_id]
        self.n_interface_nodes = len(self.iface_nodes)
        self._iface_index = torch.as_tensor(self.iface_nodes, device=self.device)
        self.vertex_ids: Optional[np.ndarray] = None
        # the lattice partition's rows: this rank's slab layout, and the
        # interface nodes it owns (their slots in the interface order and
        # their rows in this rank's block)
        self._layout = lattice_layout(params, space, device_mesh)
        if self._layout is not None:
            lay = self._layout
            idx = np.unravel_index(self.iface_nodes, lay.grid_shape)
            own = (idx[lay.axis] >= lay.lo) & (idx[lay.axis] < lay.hi)
            loc = list(idx)
            loc[lay.axis] = idx[lay.axis] - lay.lo
            rows = np.ravel_multi_index(tuple(a[own] for a in loc),
                                        lay.owned_shape)
            self._own_slots = torch.as_tensor(np.nonzero(own)[0],
                                              device=self.device)
            self._own_rows = torch.as_tensor(rows, device=self.device)

        # implicit-coupling checkpoint (cloned state + time)
        self._saved: Optional[Tuple[Any, float]] = None

    # ------------------------------------------------------------------

    def initialize(self, write_field) -> None:
        """Register interface vertices and run the participant handshake
        (`adapter.h:229-342`). `write_field` is the (n_nodes, dim) field
        (this rank's rows on several ranks) to publish if the partner
        requires initial data."""
        pdim = initial = 0
        if self.precice is not None:
            pdim = self.precice.getMeshDimensions(self.mesh_name)
            if pdim == self.space.dim:
                coords = self.space.boundary_node_coords(self.interface_id)
                self.vertex_ids = self.precice.setMeshVertices(
                    self.mesh_name, coords)
                initial = self.precice.requiresInitialData()
        pdim, initial = self._decide(pdim, initial)
        if pdim != self.space.dim:
            raise ValueError(
                f"The dimension of the solver ({self.space.dim}) and the "
                f"configured coupling mesh ({int(pdim)}) do not match "
                "(adapter.h:235-240)"
            )
        if initial:
            values = self._gather(write_field)
            if self.precice is not None:
                self.precice.writeData(
                    self.mesh_name,
                    self.write_data_name,
                    self.vertex_ids,
                    values,
                )
        if self.precice is not None:
            self.precice.initialize()

    # -- several ranks -----------------------------------------------------

    def _decide(self, *answers):
        """Rank 0's answers (numbers), the same on every rank: one SUM
        all-reduce of a small f64 buffer that only rank 0 fills (one
        nonzero term an entry, so the sum is exact). On one device the
        answers as they are."""
        if self.mesh is None:
            return answers if len(answers) > 1 else answers[0]
        buf = torch.zeros(len(answers), dtype=torch.float64, device=self.device)
        if self.rank == 0:
            buf.copy_(torch.tensor([float(a) for a in answers],
                                   dtype=torch.float64))
        out = self.mesh.all_reduce(buf).tolist()
        return tuple(out) if len(out) > 1 else out[0]

    # -- data movement ---------------------------------------------------

    def _gather(self, field: torch.Tensor) -> Optional[np.ndarray]:
        """(n_nodes, dim) field -> (n_iface, dim) float64 host buffer, in
        vertex registration order (`format_deal_to_precice`,
        `adapter.h:389-417`); only the interface rows leave the device. On
        the lattice partition `field` is this rank's rows: each rank adds
        the interface rows it owns into the buffer (one all-reduce), and
        the buffer is returned on rank 0, None elsewhere."""
        if self._layout is None:
            if self.rank != 0:
                return None
            rows = field[self._iface_index.to(field.device)]
            return rows.detach().to("cpu", torch.float64).numpy()
        buf = torch.zeros((self.n_interface_nodes, self.space.dim),
                          dtype=torch.float64, device=field.device)
        buf[self._own_slots] = field.detach()[self._own_rows].to(torch.float64)
        buf = self.mesh.all_reduce(buf)
        return buf.cpu().numpy() if self.rank == 0 else None

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
        (`adapter.h:346-361`); on several ranks rank 0 reads, every rank
        receives the (n_iface, dim) buffer (one all-reduce) and returns
        its rows of the field."""
        vals = None
        if self.precice is not None:
            vals = self.precice.readData(
                self.mesh_name, self.read_data_name, self.vertex_ids,
                relative_dt)
        if self.mesh is None:
            return self._scatter(vals)
        buf = torch.zeros((self.n_interface_nodes, self.space.dim),
                          dtype=torch.float64, device=self.device)
        if vals is not None:
            buf.copy_(torch.as_tensor(
                np.asarray(vals, dtype=np.float64).reshape(buf.shape)))
        field = self._scatter(self.mesh.all_reduce(buf).cpu().numpy())
        return field if self._layout is None else self._layout.local(field)

    def advance(self, write_field, dt: float) -> None:
        """Publish `write_field` on the interface and advance the coupling
        window (`adapter.h:365-385`) — the inter-solver synchronization
        point."""
        values = self._gather(write_field)
        if self.precice is not None:
            self.precice.writeData(
                self.mesh_name,
                self.write_data_name,
                self.vertex_ids,
                values,
            )
            self.precice.advance(dt)

    # -- implicit-coupling checkpointing ---------------------------------

    def save_current_state_if_required(self, state, time: Time) -> bool:
        """Checkpoint clones of the state's tensors and the current time
        (`adapter.h:447-464`)."""
        if self._decide(self.rank == 0
                        and self.precice.requiresWritingCheckpoint()):
            self._saved = (_clone_state(state), time.current())
            return True
        return False

    def reload_old_state_if_required(self, state, time: Time):
        """Returns the state to continue from (fresh clones of the
        checkpoint on rollback); rewinds `time` on rollback
        (`adapter.h:468-489`, `time_handler.h:63-70`)."""
        if self._decide(self.rank == 0
                        and self.precice.requiresReadingCheckpoint()):
            assert self._saved is not None, "rollback without checkpoint"
            saved_state, saved_time = self._saved
            time.set_absolute_time(saved_time)
            return _clone_state(saved_state)
        return state

    # -- passthrough steering -------------------------------------------

    def is_coupling_ongoing(self) -> bool:
        return bool(self._decide(self.rank == 0
                                 and self.precice.isCouplingOngoing()))

    def is_time_window_complete(self) -> bool:
        return bool(self._decide(self.rank == 0
                                 and self.precice.isTimeWindowComplete()))

    def get_max_time_step_size(self) -> float:
        return self._decide(self.precice.getMaxTimeStepSize()
                            if self.rank == 0 else 0.0)

    def finalize(self) -> None:
        if self.precice is not None:
            self.precice.finalize()

