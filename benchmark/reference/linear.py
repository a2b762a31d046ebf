"""Plain reference of the linear elastodynamic solid under the one-step
theta scheme (the upstream `linear_elasticity` model): the residual of one
step's linear system at a given solution, and the displacement update.

    (M + theta^2 dt^2 K) V1 = dt theta F1 + dt (1 - theta) F0
                              + (M - theta (1 - theta) dt^2 K) V0 - dt K D0
    D1 = D0 + dt theta V1 + dt (1 - theta) V0

on the free DoFs, V1 = 0 on the constrained ones. K is the small-strain
stiffness, sigma = lambda tr(eps) I + 2 mu eps, lambda = 2 mu nu / (1 - 2
nu); M the consistent mass; F the interface traction interpolated from its
nodal values and integrated over the faces. Quadrature: degree + 1 Gauss
points per axis (exact for these integrands).
"""

from __future__ import annotations

import torch

from . import fem


class LinearTheta:
    def __init__(self, config: dict, device, scale: int | None = None):
        self.p = int(config["poly_degree"])
        self.lat = fem.flap_lattice(scale or int(config["scale"]), self.p,
                                    device)
        self.bc = fem.FlapBoundary(self.lat)
        if any(float(b) != 0.0 for b in config.get("body_force", (0, 0, 0))):
            raise ValueError("the reference has no body force")
        mu, nu = float(config["mu"]), float(config["nu"])
        self.mu, self.lmbda = mu, 2.0 * mu * nu / (1.0 - 2.0 * nu)
        self.rho = float(config["rho"])
        self.dt = float(config["delta_t"])
        self.theta = float(config["theta"])
        n_q = self.p + 1
        self.cell = fem.cell_basis(self.lat, n_q)
        self.faces = [(fem.face_cells(self.lat, a, s),
                       fem.face_basis(self.lat, a, s, n_q))
                      for a, s in self.bc.faces]

    def stiffness(self, u: torch.Tensor) -> torch.Tensor:
        _, G, w = self.cell
        eye = torch.eye(3, dtype=u.dtype, device=u.device)

        def fn(ue):
            H = fem.gradients(G, ue)
            tr = H.diagonal(dim1=-2, dim2=-1).sum(-1)
            sigma = (self.lmbda * tr)[..., None, None] * eye \
                + self.mu * (H + H.transpose(-1, -2))
            return fem.test_contraction(G, w, sigma)

        return self.lat.cell_loop(fn, u)

    def mass(self, v: torch.Tensor) -> torch.Tensor:
        return fem.mass_apply(self.lat, self.cell, self.rho, v)

    def load(self, values) -> torch.Tensor:
        """The interface load vector of traction values in the interface
        order (None: no load)."""
        out = self.lat.vector()
        if values is None:
            return out
        traction = self.bc.nodal_field(self.lat, values)
        for conn, (N, _, w) in self.faces:
            tq = torch.einsum("qn,cnk->cqk", N, traction[conn])
            fe = torch.einsum("qn,q,cqk->cnk", N, w, tq)
            out.index_add_(0, conn.reshape(-1), fe.reshape(-1, 3))
        return out

    def judge(self, rec: dict) -> dict:
        """The numbers of one step: `rec` holds the program's state before
        (`in`) and after (`out`) the step, `load` the step's interface
        traction values and `load_prev` those of the step that made the
        state before (None from rest)."""
        s0, s1 = rec["in"], rec["out"]
        D0, V0 = (s0[k].double() for k in ("displacement", "velocity"))
        D1, V1, F1p = (s1[k].double() for k in ("displacement", "velocity",
                                                  "old_load"))
        dt, th = self.dt, self.theta
        mask = self.bc.mask
        F1, F0 = self.load(rec["load"]), self.load(rec.get("load_prev"))
        rhs = (dt * th * F1 + dt * (1.0 - th) * F0 + self.mass(V0)
               - (th * (1.0 - th) * dt * dt) * self.stiffness(V0)
               - dt * self.stiffness(D0))
        Vm = mask * V1
        r = mask * (rhs - self.mass(Vm) - (th * dt) ** 2 * self.stiffness(Vm)) \
            - (1.0 - mask) * V1
        D1r = D0 + dt * th * V1 + dt * (1.0 - th) * V0
        tiny = 1e-300
        gap = max(((D1 - D1r).norm() / D1r.norm().clamp_min(tiny)).item(),
                  ((F1p - F1).norm() / F1.norm().clamp_min(tiny)).item())
        return {"residual_abs": r.norm().item(), "update_gap": gap}
