"""The traffic's general generator and the two loops that drive the
program.

A traffic mix is a data file (`traffic/<mix>.json`); `draw` turns it and
the seed into the run's load, the same set of sizes for every seed. A mix
whose load or loop these cannot express brings `traffic/<mix>.py` with
its own `draw(traffic, seed)` and `Driver` (`cell.Cell.draw`,
`cell.Cell.driver`); the mixes here use:

* `march` (`"driver": "march"`): the solid's time loop under a prescribed
  interface traction, uniform in x and constant in time (`traction_pa`,
  its sign drawn from the seed); `model.step` back to back from rest and
  from rest again every `restart_every` steps, each step ending in the
  read-back of the flap tip's displacement that a user's monitoring loop
  makes;
* `coupled` (`"driver": "coupled"`): `runner.coupled_run` against the
  surrogate fluid (`participant.py`), window = the mix's `window_s` (by
  default the configuration's dt), fluid law sigma = sigma0(t) - k u with
  sigma0 = sign x `traction_pa` x sin(2 pi f t) in x (f = `frequency_hz`)
  and k = `kappa` x `traction_pa` / (the largest interface x-displacement
  of one step from rest under `traction_pa`); from rest again after
  `episode_periods` periods of the sine (never, without the key).

Both restart so that every window repeats the same stretch of the
trajectory, however fast the program runs through it.

Both record every step's counters, time it (host clock, and CUDA events
around it on the card), clone the states of the steps the seed samples for
the check (and of the last one), and profile the stretch the mix's
`trace` entry names when the run traces.
"""

from __future__ import annotations

import math
import random
import sys
import time

import numpy as np
import torch


def draw(traffic: dict, seed: int) -> dict:
    """The run's load from the mix and the seed: the seed picks the
    traction's sign. The flap is symmetric in x, so both signs ask the same
    work of the program, and every seed the same amount."""
    rng = random.Random(int(seed))
    return {"sign": rng.choice((-1.0, 1.0))}


class Sampler:
    """Which steps (or coupling windows) the check reads: index 0 (the
    start from rest), each later one with the mix's `sample_probability`
    up to `max_samples`, drawn from the seed, and the last one."""

    def __init__(self, traffic: dict, seed: int):
        self.rng = random.Random(f"{int(seed)}:samples")
        self.p = float(traffic["sample_probability"])
        self.left = int(traffic["max_samples"])

    def take(self, index: int) -> bool:
        pick = index == 0 or self.rng.random() < self.p
        if pick and self.left > 0:
            self.left -= 1
            return True
        return False


def clone_state(state) -> dict:
    return {k: v.detach().clone() for k, v in state._asdict().items()}


def step_counts(info) -> dict:
    """The counters of one step: Newton (Neo-Hookean) or CG (linear)."""
    if hasattr(info, "cg_iterations"):
        return dict(newton_its=int(info.iterations), cg_its=int(info.cg_iterations),
                    tangent_asm=int(info.tangent_assemblies),
                    ok=bool(info.converged))
    return dict(cg_its=int(info.iterations), newton_its=0, tangent_asm=0,
                residual=float(info.residual))


class Profiled:
    """A stretch under torch.profiler, the card's activity only."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.wall_s = None
        self.events = None
        self.active = False

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.active = True
        torch.cuda.synchronize(self.device)
        self._t0 = time.perf_counter()

    def stop(self):
        torch.cuda.synchronize(self.device)
        self.wall_s = time.perf_counter() - self._t0
        self.prof.stop()
        self.active = False

    def read(self):
        """The stretch's device events (read once the window has closed:
        it takes seconds)."""
        from . import trace

        if self.events is None and self.prof is not None:
            self.events = trace.record(self.prof)
        return self.events


class Timer:
    """Host clock around each step, and CUDA events on the card."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def begin(self):
        ev = None
        if self.cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        return ev, time.perf_counter()

    def end(self, mark):
        ev, t0 = mark
        t = time.perf_counter() - t0
        if ev is not None:
            ev[1].record()
        return ev, t


def event_ms(ev):
    if ev is None:
        return None
    ev[1].synchronize()
    return ev[0].elapsed_time(ev[1])


def interface_field(model, bc_nodes: np.ndarray, values: np.ndarray) -> torch.Tensor:
    """The (n_nodes, 3) f64 nodal traction the program reads: `values` on
    the interface nodes (the benchmark's own list, ascending), 0 elsewhere."""
    out = torch.zeros((model.space.n_nodes, 3), dtype=torch.float64,
                      device=model.device)
    out[torch.as_tensor(bc_nodes, device=model.device)] = torch.as_tensor(
        values, dtype=torch.float64, device=model.device)
    return out.to(model.dtype)


class MarchRun:
    """`model.step` back to back for `seconds` from rest under a constant
    traction, after `warmup_steps` steps from rest in set-up; with the mix's
    `restart_every` N, from rest again every N steps, so that every window
    repeats the same stretch of the trajectory whatever its speed."""

    def __init__(self, model, flap, traffic, load, seed, trace):
        self.model, self.flap, self.traffic = model, flap, traffic
        n_if = len(flap.interface_nodes)
        self.load_values = np.zeros((n_if, 3))
        self.load_values[:, 0] = traffic["traction_pa"] * load["sign"]
        self.stress = interface_field(model, flap.interface_nodes,
                                      self.load_values)
        self.sampler = Sampler(traffic, seed)
        self.trace = trace  # the card's trace; none on the CPU
        self.cuda = model.device.type == "cuda"
        self.tip = int(flap.tip)

    def warm_up(self):
        st = self.model.initial_state()
        for _ in range(int(self.traffic["warmup_steps"])):
            st, _ = self.model.step(st, self.stress)
            st.displacement[self.tip].tolist()

    def window(self, seconds: float) -> dict:
        model = self.model
        timer = Timer(model.device)
        tr = self.traffic.get("trace", {})
        prof = Profiled(model.device) if self.trace and self.cuda else None
        steps, samples, marks = [], [], []
        cycle = int(self.traffic.get("restart_every", 0))
        last = None
        t_start = time.perf_counter()
        deadline = t_start + seconds
        i = 0
        while True:
            if i == 0 or (cycle and i % cycle == 0):  # from rest
                st = model.initial_state()
                prev = clone_state(st)
                from_rest = True
            if prof is not None and i == tr["skip"]:
                prof.start()
            syncs = model.host_syncs
            mark = timer.begin()
            st, info = model.step(st, self.stress)
            st.displacement[self.tip].tolist()  # the user's read-back
            ev, host_s = timer.end(mark)
            rec = dict(step_counts(info), host_s=host_s,
                       readbacks=model.host_syncs - syncs,
                       traced=prof is not None and prof.active)
            steps.append(rec)
            marks.append(ev)
            if prof is not None and prof.active and i + 1 == tr["skip"] + tr["steps"]:
                prof.stop()
            out = clone_state(st)
            pair = {"in": prev, "out": out, "load": self.load_values,
                    "load_prev": None if from_rest else self.load_values}
            from_rest = False
            if self.sampler.take(i):
                samples.append(pair)
            last = pair
            prev = out
            i += 1
            if time.perf_counter() >= deadline:
                break
        window_s = time.perf_counter() - t_start
        if prof is not None and prof.active:
            prof.stop()
        for rec, ev in zip(steps, marks):
            rec["event_ms"] = event_ms(ev)
        if last is not None and (not samples or samples[-1] is not last):
            samples.append(last)
        return dict(steps=steps, window_s=window_s, samples=samples,
                    profile=prof, attempted=len(steps),
                    failed=sum(1 for s in steps if not _step_ok(s)))


# the linear step's CG contract: absolute residual, hard-coded upstream
# (`linear_elasticity.cc:542-543`)
LINEAR_RESIDUAL_MAX = 1e-10


def _step_ok(rec) -> bool:
    """A converged Newton step, or a linear step whose reported residual
    meets the contract."""
    if "ok" in rec:
        return rec["ok"]
    return rec["residual"] <= LINEAR_RESIDUAL_MAX


class _StepRecorder:
    """The model as `coupled_run` sees it, with each `step` timed, counted
    and, in a sampled window, its states cloned."""

    def __init__(self, model, owner):
        self._model = model
        self._owner = owner

    def __getattr__(self, name):
        return getattr(self._model, name)

    def step(self, state, data):
        return self._owner.step(state, data)


class CoupledRun:
    """`runner.coupled_run` against the surrogate fluid for `seconds`."""

    def __init__(self, model, flap, traffic, load, seed, trace):
        self.model, self.flap, self.traffic, self.load = model, flap, traffic, load
        self.seed, self.trace = seed, trace
        self.k = None
        self.window_dt = float(traffic.get("window_s", model.params.delta_t))

    def episode_windows(self):
        """Coupling windows from rest to rest: `episode_periods` periods of
        the load's sine, or None (one episode) without the key."""
        periods = self.traffic.get("episode_periods")
        if periods is None:
            return None
        return max(1, round(periods / (self.traffic["frequency_hz"]
                                       * self.window_dt)))

    def _fluid(self, deadline=None, max_windows=None, on_window=None):
        from .participant import TimedSurrogateFluid

        amp = self.traffic["traction_pa"] * self.load["sign"]
        f = self.traffic["frequency_hz"]
        k = self.k

        def stress_fn(t, coords, u):
            sig = -k * u
            sig[:, 0] += amp * math.sin(2.0 * math.pi * f * t)
            return sig

        tr = self.traffic
        return TimedSurrogateFluid(
            dim=3, window_dt=self.window_dt, stress_fn=stress_fn,
            eps=tr["relative_convergence"], max_iterations=tr["max_iterations"],
            initial_relaxation=tr["initial_relaxation"], deadline=deadline,
            max_windows=max_windows, on_window=on_window)

    def _adapter(self, fluid):
        from dealii_adapter_tpu_torch.adapter.adapter import Adapter

        m = self.model
        return Adapter(m.params, m.interface_id, m.space, participant=fluid,
                       dtype=m.dtype, device=m.device)

    def warm_up(self):
        from dealii_adapter_tpu_torch.runner import (
            NewtonDivergedError,
            coupled_run,
        )

        m = self.model
        n_if = len(self.flap.interface_nodes)
        vals = np.zeros((n_if, 3))
        vals[:, 0] = self.traffic["traction_pa"]
        st, _ = m.step(m.initial_state(),
                       interface_field(m, self.flap.interface_nodes, vals))
        ux = st.displacement[torch.as_tensor(self.flap.interface_nodes,
                                             device=m.device), 0]
        self.k = (self.traffic["kappa"] * self.traffic["traction_pa"]
                  / ux.abs().max().item())
        fluid = self._fluid(max_windows=int(self.traffic["warmup_windows"]))
        try:
            coupled_run(m, self._adapter(fluid))
        except NewtonDivergedError as e:  # the window's check judges it
            print(f"bench: warm-up coupling ended: {e}", file=sys.stderr)

    def step(self, state, data):
        m = self.model
        w = self.episode_start + self.fluid.window
        tr = self.traffic.get("trace", {})
        if (self.prof is not None and not self.prof.active
                and self.prof.wall_s is None and w == tr["skip_windows"]):
            self.prof.start()
        syncs = m.host_syncs
        mark = self.timer.begin()
        out, info = m.step(state, data)
        ev, host_s = self.timer.end(mark)
        rec = dict(step_counts(info), host_s=host_s, window=w,
                   readbacks=m.host_syncs - syncs,
                   traced=self.prof is not None and self.prof.active)
        self.steps.append(rec)
        self.marks.append(ev)
        # every window's last call is kept until the window completes
        self.pending[w] = {"in": clone_state(state), "out": clone_state(out),
                           "load": self.fluid.last_read.copy()}
        return out, info

    def on_window(self, w, last_read, written):
        w += self.episode_start
        # the profiler's stop takes seconds: it ends the traced window,
        # which `coupling_host_ms.fsi` leaves out, and not the next one
        if (self.prof is not None and self.prof.active
                and w + 1 == self.traffic["trace"]["skip_windows"]
                + self.traffic["trace"]["windows"]):
            self.prof.stop()
        self.window_ends.append(time.perf_counter())
        self.accepted_reads.append(last_read.copy())
        rec = self.pending.pop(w, None)
        self.pending.clear()
        if rec is not None:
            rec["written"] = written
            rec["load_prev"] = (self.accepted_reads[w - 1]
                                if w > self.episode_start else None)
            if w in self.sampled_windows:
                self.samples.append(rec)
            self.last = rec

    def window(self, seconds: float) -> dict:
        from dealii_adapter_tpu_torch.runner import (
            NewtonDivergedError,
            coupled_run,
        )

        m = self.model
        self.timer = Timer(m.device)
        self.prof = Profiled(m.device) if self.trace and m.device.type == "cuda" else None
        self.steps, self.marks, self.samples = [], [], []
        self.pending, self.accepted_reads, self.last = {}, [], None
        sampler = Sampler(self.traffic, self.seed)
        self.sampled_windows = {w for w in range(10000) if sampler.take(w)}
        t_start = time.perf_counter()
        self.window_ends = [t_start]
        self.episode_start = 0  # the window index an episode starts at
        self.counts, self.capped = [], 0
        diverged = 0
        try:
            while time.perf_counter() < t_start + seconds:
                self.fluid = self._fluid(
                    deadline=t_start + seconds,
                    max_windows=self.episode_windows(),
                    on_window=self.on_window)
                coupled_run(_StepRecorder(m, self), self._adapter(self.fluid))
                self.counts += self.fluid.iterations_per_window
                self.capped += self.fluid.capped
                self.episode_start = len(self.counts)
        except NewtonDivergedError as e:
            # the program ends the coupling; the step it ended on is judged
            # (it wrote nothing to the fluid)
            print(f"bench: coupled run ended: {e}", file=sys.stderr)
            diverged = 1
            self.counts += self.fluid.iterations_per_window
            self.capped += self.fluid.capped
            w = max(self.pending, default=None)
            if w is not None:
                rec = self.pending[w]
                rec["load_prev"] = (self.accepted_reads[w - 1]
                                    if w > self.episode_start else None)
                self.samples.append(rec)
                self.last = rec
        if m.device.type == "cuda":
            torch.cuda.synchronize(m.device)
        window_s = time.perf_counter() - t_start
        if self.prof is not None and self.prof.active:
            self.prof.stop()
        for rec, ev in zip(self.steps, self.marks):
            rec["event_ms"] = event_ms(ev)
        samples = self.samples
        if self.last is not None and (not samples or samples[-1] is not self.last):
            samples.append(self.last)
        windows = self.counts
        step_s, traced = {}, set()
        for rec in self.steps:
            step_s[rec["window"]] = step_s.get(rec["window"], 0.0) + rec["host_s"]
            if rec["traced"]:
                traced.add(rec["window"])
        ends = self.window_ends
        return dict(steps=self.steps, window_s=window_s, samples=samples,
                    profile=self.prof, attempted=len(windows),
                    failed=self.capped + diverged + sum(
                        1 for s in self.steps if not _step_ok(s)),
                    iterations_per_window=list(windows),
                    window_wall_s=[b - a for a, b in zip(ends, ends[1:])],
                    step_s_per_window=[step_s.get(w, 0.0) for w in range(len(windows))],
                    traced_windows=sorted(traced))


DRIVERS = {"march": MarchRun, "coupled": CoupledRun}
