#!/usr/bin/env python
"""Reference value of `chip_smoke.py`'s cli_nl check, from the JAX package.

    JAX_PLATFORMS=cpu python tools/jax_reference_nl_default.py

Runs the JAX package's coupled loop, as its CLI runs it with
`--standalone --traction 2000 0`, on the reference's own Neo-Hookean
configuration (`examples/nonlinear_elasticity.prm`: FSI3 flap, Q4,
1,898 DoF, f64 CG with Jacobi on the jvp tangent) cut to 3 steps by
`chip_smoke.py:nl_default_prm`, and prints every window's Newton and CG
counts and the final ||u||^2 that `chip_smoke.py` (`NL_DEFAULT_REF`)
holds the port's CLI run against. Host times printed here are CPU times
of the JAX package, not device metrics.
"""

import os
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

import dealii_adapter_tpu as dat  # noqa: E402  (x64)
from dealii_adapter_tpu.adapter import Adapter, FakeParticipant  # noqa: E402
from dealii_adapter_tpu.models.nonlinear_elasticity import (  # noqa: E402
    NonlinearElasticity,
)
from dealii_adapter_tpu.runner import coupled_run  # noqa: E402
from chip_smoke import (  # noqa: E402  (stdlib-only module)
    NL_DEFAULT_PRM,
    NL_DEFAULT_TRACTION,
    nl_default_prm,
)


def main():
    with tempfile.TemporaryDirectory() as tmp:
        prm = os.path.join(tmp, "case.prm")
        text = (ROOT / NL_DEFAULT_PRM).read_text()
        pathlib.Path(prm).write_text(nl_default_prm(text, os.path.join(tmp, "out")))
        params = dat.parse_prm(prm)
    t0 = time.perf_counter()
    model = NonlinearElasticity(params)
    mag = np.asarray([float(x) for x in NL_DEFAULT_TRACTION])
    participant = FakeParticipant(
        dim=params.dim, window_dt=params.delta_t, end_time=params.end_time,
        read_fn=lambda t, coords: np.tile(mag, (len(coords), 1)),
    )
    adapter = Adapter(params, model.interface_id, model.space,
                      participant=participant, dtype=model.dtype)

    def output_cb(state, t, info):
        print(f"t={t.current():.4g}: newton {int(info.iterations)} cg "
              f"{int(info.cg_iterations)} converged {bool(info.converged)}",
              flush=True)

    state = coupled_run(model, adapter, output_cb=output_cb)
    u = np.asarray(state.displacement)
    print(f"{model.space.n_dofs} DoF, {time.perf_counter() - t0:.1f} s (CPU); "
          f"final ||u||^2 {float((u * u).sum())!r}")


if __name__ == "__main__":
    main()
