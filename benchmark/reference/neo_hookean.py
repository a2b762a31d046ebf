"""Plain reference of the compressible Neo-Hookean solid under Newmark
time stepping (the upstream `nonlinear_elasticity` model): the residual of
one step's discrete equations at a given end state, and the Newmark
updates of velocity and acceleration.

    R(u1) = F_ext(u1) - F_int(u1) - M a1          on the free DoFs
    a1 = (u1 - u0 - dt v0) / (beta dt^2) - (1 / (2 beta) - 1) a0
    v1 = v0 + dt ((1 - gamma) a0 + gamma a1)

F_int[n] = int tau F^-T : grad_X N_n dV with the Kirchhoff stress
tau = (kappa / 2)(J^2 - 1) I + dev(mu J^(-2/3) F F^T),
kappa = 2 mu (1 + nu) / (3 (1 - 2 nu)). F_ext is the interface traction,
interpolated from its nodal values, scaled by Nanson's ratio
|J F^-T N| of the deformed to the reference area and integrated over the
reference faces. Quadrature: degree + 2 Gauss points per axis, on cells
and faces (upstream's QGauss(degree + 2)).
"""

from __future__ import annotations

import torch

from . import fem


class NeoHookeanNewmark:
    def __init__(self, config: dict, device, scale: int | None = None):
        self.p = int(config["poly_degree"])
        self.lat = fem.flap_lattice(scale or int(config["scale"]), self.p,
                                    device)
        self.bc = fem.FlapBoundary(self.lat)
        if any(float(b) != 0.0 for b in config.get("body_force", (0, 0, 0))):
            raise ValueError("the reference has no body force")
        mu, nu = float(config["mu"]), float(config["nu"])
        self.mu = mu
        self.kappa = 2.0 * mu * (1.0 + nu) / (3.0 * (1.0 - 2.0 * nu))
        self.rho = float(config["rho"])
        self.dt = float(config["delta_t"])
        self.beta = float(config["beta"])
        self.gamma = float(config["gamma"])
        n_q = self.p + 2
        self.cell = fem.cell_basis(self.lat, n_q)
        self.faces = [(fem.face_cells(self.lat, a, s),
                       fem.face_basis(self.lat, a, s, n_q), a)
                      for a, s in self.bc.faces]

    def internal_force(self, u: torch.Tensor) -> torch.Tensor:
        _, G, w = self.cell
        eye = torch.eye(3, dtype=u.dtype, device=u.device)

        def fn(ue):
            F = fem.gradients(G, ue) + eye
            J = torch.linalg.det(F)
            b_bar = J[..., None, None] ** (-2.0 / 3.0) * (F @ F.transpose(-1, -2))
            tr = b_bar.diagonal(dim1=-2, dim2=-1).sum(-1)
            tau = (0.5 * self.kappa * (J * J - 1.0))[..., None, None] * eye \
                + self.mu * (b_bar - (tr / 3.0)[..., None, None] * eye)
            P = tau @ torch.linalg.inv(F).transpose(-1, -2)
            return fem.test_contraction(G, w, P)

        return self.lat.cell_loop(fn, u)

    def external_force(self, u: torch.Tensor, traction: torch.Tensor) -> torch.Tensor:
        out = torch.zeros_like(u)
        eye = torch.eye(3, dtype=u.dtype, device=u.device)
        for conn, (N, G, w), axis in self.faces:
            ue, te = u[conn], traction[conn]
            F = fem.gradients(G, ue) + eye
            J = torch.linalg.det(F)
            normal = torch.zeros(3, dtype=u.dtype, device=u.device)
            normal[axis] = 1.0
            n_star = J[..., None] * (torch.linalg.inv(F).transpose(-1, -2)
                                     @ normal)
            ratio = n_star.norm(dim=-1)  # (c, q)
            tq = torch.einsum("qn,cnk->cqk", N, te)
            fe = torch.einsum("qn,q,cq,cqk->cnk", N, w, ratio, tq)
            out.index_add_(0, conn.reshape(-1), fe.reshape(-1, 3))
        return out

    def acceleration(self, u0, v0, a0, u1):
        dt, beta = self.dt, self.beta
        return ((u1 - u0 - dt * v0) / (beta * dt * dt)
                - (0.5 / beta - 1.0) * a0)

    def judge(self, rec: dict) -> dict:
        """The numbers of one step: `rec` holds the program's state before
        (`in`) and after (`out`) the step, each a dict of (n_nodes, 3)
        tensors, and `load`, the interface traction's values in the
        interface order."""
        s0, s1 = rec["in"], rec["out"]
        u0, v0, a0 = (s0[k].double() for k in ("displacement", "velocity",
                                                 "acceleration"))
        u1, v1, a1p = (s1[k].double() for k in ("displacement", "velocity",
                                                  "acceleration"))
        mask = self.bc.mask
        traction = self.bc.nodal_field(self.lat, rec["load"])
        a1 = self.acceleration(u0, v0, a0, u1)
        v1r = v0 + self.dt * ((1.0 - self.gamma) * a0 + self.gamma * a1)
        fext = mask * self.external_force(u1, traction)
        R = fext - mask * (self.internal_force(u1)
                           + fem.mass_apply(self.lat, self.cell, self.rho, a1))
        tiny = 1e-300
        gap = max(
            ((v1 - v1r).norm() / v1r.norm().clamp_min(tiny)).item(),
            ((a1p - a1).norm() / a1.norm().clamp_min(tiny)).item(),
            (((1.0 - mask) * u1).norm() / u1.norm().clamp_min(tiny)).item())
        return {"residual_rel": (R.norm() / fext.norm().clamp_min(tiny)).item(),
                "newmark_gap": gap}
