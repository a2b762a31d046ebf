"""A pytest plugin that records, for every test case, when it started and
ended and, under `JAX_LOG_COMPILES=1`, the seconds the JAX package spent
tracing, lowering and compiling with XLA during it: where the Tier-1
clock goes (PERF.md §8).

    PYTHONPATH=tools CASE_TIMES_DIR=out JAX_LOG_COMPILES=1 \\
        python -m pytest tests/ -p pytest_case_times [the Tier-1 flags]

Each process (the xdist controller and every worker) appends lines to
`$CASE_TIMES_DIR/<pid>.txt` as the run goes, so a run cut by its clock
still leaves its timeline: `S <time> <case>` and `E <time> <case>` at a
case's start and end, and at the process's end one line `J <json>` with
{case: {"XLA compilation": s, "jaxpr to MLIR module conversion": s,
"tracing + transforming": s}} from JAX's compile log (a fixture's
compilations count to the first case that uses it). It imports neither
jax nor torch.
"""

import json
import logging
import os
import re
import time

_PATTERN = re.compile(
    r"Finished (XLA compilation|jaxpr to MLIR module conversion|"
    r"tracing \+ transforming) .* in ([0-9.]+) sec")
_state = {"case": None, "out": None, "jax": {}}


def _out():
    if _state["out"] is None:
        path = os.path.join(os.environ.get("CASE_TIMES_DIR", "."),
                            f"{os.getpid()}.txt")
        _state["out"] = open(path, "a", buffering=1)
    return _state["out"]


class _CompileLog(logging.Handler):
    def emit(self, record):
        m = _PATTERN.match(record.getMessage())
        if m and _state["case"]:
            case = _state["jax"].setdefault(_state["case"], {})
            case[m.group(1)] = case.get(m.group(1), 0.0) + float(m.group(2))


def pytest_configure(config):
    logger = logging.getLogger("jax")
    logger.addHandler(_CompileLog())
    logger.setLevel(logging.WARNING)


def pytest_runtest_logstart(nodeid, location):
    _state["case"] = nodeid
    _out().write(f"S {time.time():.3f} {nodeid}\n")


def pytest_runtest_logfinish(nodeid, location):
    _out().write(f"E {time.time():.3f} {nodeid}\n")


def pytest_unconfigure(config):
    if _state["jax"]:
        _out().write("J " + json.dumps(_state["jax"]) + "\n")
    if _state["out"] is not None:
        _state["out"].close()
