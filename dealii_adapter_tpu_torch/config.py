"""Runtime configuration.

A copy of `dealii_adapter_tpu/config.py`, kept field-for-field identical
so that `convert.params_from_jax` can carry a parameter set across with
`dataclasses.asdict`. The PyTorch package carries its own copy because
importing anything from `dealii_adapter_tpu` imports jax. `use_pallas`
is read by nothing in this package; `tangent_matvec_kernel` and
`tangent_block_symmetric` select the CUDA tangent matvec kernel
(`models/nonlinear_elasticity.py:tangent_kernel_id`).

Mirrors the five parameter structs of the reference
(`include/adapter/parameters.h:17-111`) as Python dataclasses, plus a parser
for deal.II `ParameterHandler` ``.prm`` text files so that reference
configurations (e.g. the reference's `parameters.prm`) run unchanged.

Derived quantities follow `include/adapter/parameters.cc:177-205`:
  * lambda = 2 mu nu / (1 - 2 nu)
  * data_consistent is classified from the read-data name prefix
    ("Stress" -> consistent, "Force" -> conservative).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Tuple


@dataclasses.dataclass
class TimeParameters:
    """Simulation time properties (`parameters.h:17-27`)."""

    end_time: float = 1.0
    delta_t: float = 0.1
    output_interval: int = 1
    output_folder: str = ""


@dataclasses.dataclass
class SystemParameters:
    """Material properties and body forces (`parameters.h:32-42`)."""

    nu: float = 0.3
    mu: float = 1538462.0
    lmbda: float = -1.0  # derived; 'lambda' is a Python keyword
    rho: float = 1000.0
    body_force: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    @property
    def kappa(self) -> float:
        """Bulk modulus used by the Neo-Hookean material
        (`compressible_neo_hook_material.h:20`)."""
        return (2.0 * self.mu * (1.0 + self.nu)) / (3.0 * (1.0 - 2.0 * self.nu))


@dataclasses.dataclass
class SolverParameters:
    """Linear/nonlinear solver knobs (`parameters.h:48-60`)."""

    model: str = "linear"  # "linear" | "neo-Hookean"
    type_lin: str = "Direct"  # "CG" | "Direct"
    tol_lin: float = 1e-6  # relative CG tol (nonlinear model only)
    max_iterations_lin: float = 1.0  # CG cap = n_dofs * this
    max_iterations_NR: int = 10
    tol_f: float = 1e-9
    tol_u: float = 1e-6


@dataclasses.dataclass
class DiscretizationParameters:
    """FE degree and time-integrator coefficients (`parameters.h:68-79`)."""

    poly_degree: int = 3
    theta: float = 0.5  # linear model: one-step theta scheme
    beta: float = 0.25  # nonlinear model: Newmark-beta
    gamma: float = 0.5


@dataclasses.dataclass
class CouplingParameters:
    """preCICE adapter configuration (`parameters.h:87-100`)."""

    scenario: str = "FSI3"  # "FSI3" | "PF"
    config_file: str = "precice-config.xml"
    participant_name: str = "dealiisolver"
    mesh_name: str = "dealii-mesh"
    read_data_name: str = "Stress"
    write_data_name: str = "Displacement"
    flap_location: float = 0.0
    data_consistent: bool = True


@dataclasses.dataclass
class AllParameters(
    SolverParameters,
    DiscretizationParameters,
    SystemParameters,
    TimeParameters,
    CouplingParameters,
):
    """Aggregate of every runtime knob, mirroring the multiple-inheritance
    `Parameters::AllParameters` (`parameters.h:103-111`).

    Extra TPU-native knobs (not in the reference) live at the end.
    """

    # --- TPU-native extensions -------------------------------------------
    dim: int = 2  # the reference fixes this at compile time (-DDIM)
    dtype: str = "float64"  # "float64" | "float32"
    use_pallas: bool = False  # Pallas element kernels on TPU
    n_devices: int = 1  # device-mesh size for sharded element batches
    # matrix-free preconditioner for CG (the reference's SSOR is inherently
    # sequential; Chebyshev-accelerated Jacobi is the TPU-native equivalent)
    preconditioner: str = "Jacobi"  # "Jacobi" | "Chebyshev" | "MG" | "None"
    cheb_degree: int = 4
    cheb_eig_ratio: float = 30.0
    mg_smooth_degree: int = 2  # Chebyshev smoothing steps per MG level visit
    # Chebyshev degree for the FINEST level only (0 = mg_smooth_degree);
    # with the same-resolution FEM-SEM Q1 level below it, the fine smoother
    # can often run weaker — and it is the costliest level to smooth
    mg_fine_smooth_degree: int = 0
    mg_coarse_size: int = 4000  # dense-solve threshold (DoFs) for the MG base
    # Q1 level-operator backend: "auto" (on TPU: AUTOTUNE — measure every
    # candidate at the actual level shape at setup time and keep the
    # fastest; off-TPU: pallas if use_pallas else stencil) | "stencil"
    # (assembled 27-point stencil, shifted-FMA interior pass,
    # ops/stencil.py) | "stencil_conv"
    # (interior pass as one XLA 3D convolution) | "stencil_banded"
    # (interior pass as 9 banded MXU matmuls) | "stencil_flat" (lane-
    # flattened (Z, Y, X*dim) VPU pass) | "stencil_flatx" (transposed
    # (Z, X*dim, Y) lane layout) | "pallas" (slab-fused
    # per-cell kernel) | "xla" (per-cell extract -> MXU matmul ->
    # overlap-add)
    mg_level_backend: str = "auto"
    # True (default): FEM-SEM first coarse level (Q1 on the same node
    # lattice). Measured on the 3D flap tangent: 188 CG its/step vs 322 for
    # combined p+h coarsening — the cheaper cycles do not pay for the lost
    # contraction. False: p+h coarsening (Q1 at half resolution).
    mg_fem_sem: bool = True
    # skip fine-level smoothing and precondition purely through the
    # same-resolution Q1 (FEM-SEM) hierarchy — removes every Q_p operator
    # apply from the V-cycle
    mg_skip_fine_smoothing: bool = False
    # dtype of the MG preconditioner hierarchy ("" = follow the linear-solve
    # dtype); "float32" gives the mixed-precision f32-V-cycle-in-f64-CG scheme
    precond_dtype: str = ""
    # dtype of the inner Krylov solves ("" = same as `dtype`). "float32"
    # runs the CG — operator action, preconditioner, vectors — in f32 while
    # residuals, norms and state stay f64: inexact Newton for the nonlinear
    # model, iterative refinement (defect correction) for the linear model's
    # absolute 1e-10 contract. The idiomatic choice on TPU generations
    # without native f64 (v5e emulates f64 at a large slowdown).
    solve_dtype: str = ""
    # Newton-Krylov forcing term: "fixed" mirrors the reference (every CG
    # solve to tol_lin * ||R||, `nonlinear_elasticity.cc:1171-1172`); "ew"
    # uses Eisenstat-Walker choice-2 adaptive tolerances (loose early
    # solves, tight only near convergence) — same tol_u/tol_f convergence
    # contract, substantially fewer total CG iterations
    newton_forcing: str = "fixed"  # "fixed" | "ew"
    ew_eta0: float = 0.1  # first-iteration forcing term for "ew"
    # start Newton from the constant-acceleration Newmark predictor
    # delta0 = dt v_n + dt^2/2 a_n instead of the reference's delta0 = 0 —
    # same convergence contract, fewer iterations for smooth dynamics
    newton_predictor: bool = False
    # element gather/scatter formulation: "structured" = gather-free strided
    # patches + overlap-add (single-device), "gather" = transpose-gather
    # plans (required for sharding), "auto" = structured unless sharded
    element_backend: str = "auto"
    # Newton tangent operator inside CG: "assembled" materializes per-cell
    # element tangent matrices once per Newton iteration (the reference's
    # assemble-once structure, `nonlinear_elasticity.cc:1044-1087`, as one
    # bandwidth-bound batched FMA sweep per CG matvec); "jvp" re-linearizes
    # the internal force per solve and pays a kinematics+constitutive
    # pushforward per CG iteration; "auto" = assembled when the structured
    # backend + mixed-precision CG path is active and the tangent fits
    # `assembled_tangent_max_gb`, else jvp. Both are the same frozen
    # linearization — identical Newton/CG behavior.
    tangent_backend: str = "auto"  # "auto" | "assembled" | "jvp"
    assembled_tangent_max_gb: float = 6.0
    # Newton residual precision schedule: "mixed" evaluates the residual
    # in f32 for iterations whose accuracy target sits far above the
    # measured f32 noise floor (floor calibrated at iteration 0 by
    # evaluating both precisions once), f64 otherwise. The convergence
    # contract (dual rel/abs rule, `nonlinear_elasticity.cc:459-463`) is
    # always decided on iterations at f64 accuracy: an f32 residual's
    # additive noise floor cannot falsely read below 1e-9 relative, and
    # the schedule switches to f64 within 30x of the floor. "f64" forces
    # every evaluation to full precision.
    newton_residual: str = "mixed"  # "mixed" | "f64"
    # how early the mixed schedule hands back to f64: iterations whose
    # relative residual sits within this factor of the measured f32 noise
    # floor evaluate in f64. Larger = fewer wasted near-floor f32
    # iterations (the CPU-measured +2 Newton its of the schedule), smaller
    # = fewer f64 evaluations; the optimum depends on the hardware's
    # f64/f32 cost ratio (~13x on v5e).
    newton_residual_f64_window: float = 30.0
    # MG fine-level smoothing operator: True smooths the CURRENT Newton
    # iteration's assembled tangent (the exact CG operator, already
    # materialized — one batched FMA sweep per apply) on the V-cycle's
    # fine level; False (default) keeps the constant small-strain proxy
    # the hierarchy was built from. Only takes effect with
    # preconditioner=MG, the assembled tangent backend, and fine smoothing
    # enabled. CAUTION: the fine Chebyshev keeps the proxy's lam_max
    # (x1.1); at LARGE strains the tangent's spectrum outgrows it and the
    # smoother can diverge (measured at min det F ~ 0.5) — opt in only
    # for moderate-deformation runs. Iteration-neutral at bench strains
    # (measured); the win is the cheaper fine matvec on TPU.
    mg_fine_tangent: bool = False
    # sum-factorized f64 residual/mass contractions on 3D structured
    # meshes (ops/sumfact.py): per-axis 1D stages instead of dense
    # (q, npc) tabulation matmuls — ~13x fewer emulated-f64 multiplies,
    # same physics to roundoff. Default OFF: measured 2x SLOWER per step
    # on v5e at 1M DoF (1.64 vs 0.82 s/step) — the many small-leading-dim
    # stage einsums lose to one large MXU-shaped (q, npc) matmul despite
    # the flop advantage. Kept as an opt-in for TPU generations with
    # native f64 (flop-bound there) and as the Q3+ scaling path.
    use_sumfact: bool = False
    # "highest": true-f32 assembly matmuls; "default": single-bf16-pass MXU
    # (the assembled K stays exactly symmetric either way — see
    # ops/assembled_tangent.py)
    tangent_assembly_precision: str = "highest"
    # store only the upper component blocks (d <= e) of the per-cell
    # tangent and apply symmetrically: 2/3 the assembly MXU matmuls, 2/3
    # the HBM traffic per CG matvec, exact K = K^T by construction
    # (ops/assembled_tangent.py `assemble_cell_tangents_sym`)
    tangent_block_symmetric: bool = False
    # Pallas matvec kernel for the materialized tangent: "auto" probes the
    # hardware-proven packed kernel first (one contiguous buffer, pack
    # concatenation once per Newton it); "blocks" prefers the pack-free
    # block-ref kernel (no pack pass, no duplicate packed buffer) and
    # falls back to packed; "packed" / "xla" force those paths. "blocks"
    # becomes the auto-default once a hardware run validates its
    # Mosaic compile + timing (blocked 2026-08-19: the remote compile
    # helper 500s on every fresh Pallas compile).
    tangent_matvec_kernel: str = "auto"
    # Modified-Newton tangent reuse (assembled backend only): assemble the
    # materialized per-cell tangent for the first `tangent_reuse_after`
    # Newton iterations of each step and FREEZE it afterwards. The
    # reference re-assembles every iteration
    # (`nonlinear_elasticity.cc:1044-1087`); freezing trades the largest
    # per-step cost block (assembly: 43 ms x ~5 its at 1M DoF, round-4
    # profile) for Newton iterations that converge linearly instead of
    # quadratically once frozen. The convergence CONTRACT is untouched —
    # residuals stay exact, only the linear-solve operator lags the
    # iterate. Non-acceleration safeguard: exact-Newton residual ratios
    # shrink (super)linearly iteration over iteration, while a stale
    # frozen tangent produces a CONSTANT contraction rate — so an
    # iteration whose predecessor solved with a frozen tangent and whose
    # realized ratio fails to drop below half the previous iteration's
    # ratio re-assembles at the current iterate before solving. Frozen
    # iterations already contracting faster than `tangent_refresh_ratio`
    # per iteration (default 50x/it) are left frozen regardless: they
    # finish in a couple of iterations and a refresh would cost more
    # than it saves. (A fixed-threshold safeguard was measured to stall:
    # frozen-rate ~0.3-0.45 sat under the 0.5 cut and burned the entire
    # iteration budget on the 2D drive.)
    newton_tangent_reuse: bool = False
    tangent_reuse_after: int = 1
    tangent_refresh_ratio: float = 0.02
    # NOTE: a bf16 STORAGE dtype for the materialized tangent was built
    # and measured in round 4 and REMOVED: entry-wise rounding of K is
    # amplified by kappa(K) and stalls/diverges Newton (2D drive: no
    # convergence in 12 its; 3D scale-1: test failure). The op-level
    # machinery (assemble_*'s out_dtype) remains for study; the solver
    # always stores the tangent in solve_dtype.

    def __post_init__(self):
        self.finalize()

    def finalize(self) -> "AllParameters":
        """Derive dependent quantities (`parameters.cc:189-200`)."""
        self.lmbda = 2.0 * self.mu * self.nu / (1.0 - 2.0 * self.nu)
        if self.read_data_name.startswith("Stress"):
            self.data_consistent = True
        elif self.read_data_name.startswith("Force"):
            self.data_consistent = False
        else:
            raise ValueError(
                "Unknown read data type. Please use 'Force' or 'Stress' in "
                "the read data naming."
            )
        if self.model not in ("linear", "neo-Hookean"):
            raise ValueError(f"Unknown model '{self.model}'")
        if self.type_lin not in ("CG", "Direct"):
            raise ValueError(f"Unknown linear solver type '{self.type_lin}'")
        if not (-1.0 < self.nu < 0.5):
            raise ValueError(f"Poisson's ratio out of range: {self.nu}")
        if self.tangent_matvec_kernel not in (
            "auto", "blocks", "packed", "packedt", "xla"
        ):
            raise ValueError(
                "tangent_matvec_kernel must be 'auto', 'blocks', 'packed', "
                f"'packedt' or 'xla', got {self.tangent_matvec_kernel!r}"
            )
        if self.tangent_assembly_precision not in (
            "highest", "high", "default", "bf16emu"
        ):
            raise ValueError(
                "tangent_assembly_precision must be 'highest', 'high', "
                "'default' or 'bf16emu' (test-only CPU emulation of "
                f"'default'), got {self.tangent_assembly_precision!r}"
            )
        return self


# ---------------------------------------------------------------------------
# .prm parsing
# ---------------------------------------------------------------------------

# Map of (subsection, key) -> attribute name on AllParameters. Key names are
# those declared in `parameters.cc:5-174`; we additionally accept the
# "Linear solver"/"Nonlinear solver" subsections that appear in
# `source/nonlinear_elasticity/nonlinear_elasticity.prm`.
_PRM_KEYMAP: Dict[Tuple[str, str], str] = {
    ("time", "end time"): "end_time",
    ("time", "time step size"): "delta_t",
    ("time", "output interval"): "output_interval",
    ("time", "output folder"): "output_folder",
    ("system properties", "shear modulus"): "mu",
    ("system properties", "poisson's ratio"): "nu",
    ("system properties", "rho"): "rho",
    ("system properties", "body forces"): "body_force",
    ("solver", "model"): "model",
    ("solver", "solver type"): "type_lin",
    ("solver", "residual"): "tol_lin",
    ("solver", "max iteration multiplier"): "max_iterations_lin",
    ("solver", "max iterations newton-raphson"): "max_iterations_NR",
    ("solver", "tolerance force"): "tol_f",
    ("solver", "tolerance displacement"): "tol_u",
    ("linear solver", "solver type"): "type_lin",
    ("linear solver", "residual"): "tol_lin",
    ("linear solver", "max iteration multiplier"): "max_iterations_lin",
    ("nonlinear solver", "max iterations newton-raphson"): "max_iterations_NR",
    ("nonlinear solver", "tolerance force"): "tol_f",
    ("nonlinear solver", "tolerance displacement"): "tol_u",
    ("discretization", "polynomial degree"): "poly_degree",
    ("discretization", "theta"): "theta",
    ("discretization", "beta"): "beta",
    ("discretization", "gamma"): "gamma",
    ("precice configuration", "scenario"): "scenario",
    ("precice configuration", "precice config-file"): "config_file",
    ("precice configuration", "participant name"): "participant_name",
    ("precice configuration", "mesh name"): "mesh_name",
    ("precice configuration", "read data name"): "read_data_name",
    ("precice configuration", "write data name"): "write_data_name",
    ("precice configuration", "flap location"): "flap_location",
    # TPU-native extension knobs (no reference equivalent)
    ("tpu", "dim"): "dim",
    ("tpu", "dtype"): "dtype",
    ("tpu", "devices"): "n_devices",
    ("tpu", "preconditioner"): "preconditioner",
    ("tpu", "chebyshev degree"): "cheb_degree",
    ("tpu", "element backend"): "element_backend",
    ("tpu", "solve dtype"): "solve_dtype",
    ("tpu", "preconditioner dtype"): "precond_dtype",
    ("tpu", "tangent backend"): "tangent_backend",
    ("tpu", "newton tangent reuse"): "newton_tangent_reuse",
    ("tpu", "tangent reuse after"): "tangent_reuse_after",
    ("tpu", "tangent refresh ratio"): "tangent_refresh_ratio",
}

_FIELD_TYPES = {f.name: f.type for f in dataclasses.fields(AllParameters)}


def _coerce(attr: str, raw: str):
    if attr == "body_force":
        vals = [float(v) for v in re.split(r"[,\s]+", raw.strip()) if v]
        while len(vals) < 3:
            vals.append(0.0)
        return tuple(vals[:3])
    current = getattr(AllParameters, attr, None)
    ftype = _FIELD_TYPES.get(attr, "str")
    if "int" in str(ftype) and attr != "max_iterations_lin":
        return int(float(raw))
    if "float" in str(ftype):
        return float(raw)
    if isinstance(current, bool):
        return raw.strip().lower() in ("true", "1", "yes")
    return raw.strip()


_KNOWN_SECTIONS = {s for s, _ in _PRM_KEYMAP}


class PrmParseError(ValueError):
    """A ``.prm`` entry violates the declared parameter schema."""


def parse_prm(path_or_text: str, strict: bool = False, **overrides) -> AllParameters:
    """Parse a deal.II ``.prm`` parameter file into :class:`AllParameters`.

    Accepts either a filesystem path or the raw text. With ``strict=True``
    (the CLI default), undeclared subsections and undeclared keys raise
    :class:`PrmParseError` with the line number — matching deal.II's
    ``ParameterHandler``, which rejects entries that were never declared
    (`parameters.cc:5-174`), so a typo like ``set Residul`` cannot silently
    run with the default tolerance. With ``strict=False`` unknown entries
    are ignored (useful for forward-compatible programmatic use).
    ``overrides`` are applied last (e.g. ``dim=3``).
    """
    text = path_or_text
    if "\n" not in path_or_text:
        try:
            with open(path_or_text, "r") as fh:
                text = fh.read()
        except (OSError, ValueError):
            pass  # treat as raw text

    params = AllParameters()
    section = ""
    for lineno, line in enumerate(text.splitlines(), start=1):
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        low = line.lower()
        if low.startswith("subsection"):
            section = line[len("subsection"):].strip().lower()
            if strict and section not in _KNOWN_SECTIONS:
                raise PrmParseError(
                    f"line {lineno}: undeclared subsection '{section}' "
                    f"(known: {sorted(_KNOWN_SECTIONS)})"
                )
        elif low == "end":
            section = ""
        elif low.startswith("set "):
            key, _, value = line[4:].partition("=")
            attr = _PRM_KEYMAP.get((section, key.strip().lower()))
            if attr is not None:
                setattr(params, attr, _coerce(attr, value.strip()))
            elif strict:
                known_keys = sorted(
                    k for (s, k) in _PRM_KEYMAP if s == section
                )
                raise PrmParseError(
                    f"line {lineno}: undeclared entry '{key.strip()}' in "
                    f"subsection '{section}' (known keys: {known_keys})"
                )
        elif strict:
            raise PrmParseError(f"line {lineno}: unparseable line '{line}'")
    for k, v in overrides.items():
        if not hasattr(params, k):
            raise AttributeError(f"Unknown parameter override '{k}'")
        setattr(params, k, v)
    return params.finalize()
