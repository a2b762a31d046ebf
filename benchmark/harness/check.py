"""The comparison that decides `correct`: the plain reference
(`reference/`, named by the configuration's `reference` key) judges the
states the timed path produced in the steps (or coupling windows) the seed
sampled, each number's worst reading over the samples is held against the
cell's limit (`limits/<cell>.json`), and in a coupled cell the
displacement the adapter wrote to the fluid is held against the solid's
state on the interface (the same numbers: an exact copy)."""

from __future__ import annotations

import importlib
import math

import torch


def make_reference(config: dict, device, scale=None):
    module, cls = config["reference"].split(".")
    mod = importlib.import_module("benchmark.reference." + module)
    cfg = dict(config["params"], scale=scale or config["scale"])
    return getattr(mod, cls)(cfg, device, scale=scale)


def written_gap(ref, rec) -> float:
    """max |written - u| / max |u| over the interface nodes (0 for an exact
    copy)."""
    idx = torch.as_tensor(ref.bc.interface_nodes, device=ref.lat.device)
    u = rec["out"]["displacement"].double()[idx]
    w = torch.as_tensor(rec["written"], dtype=torch.float64, device=u.device)
    return ((w - u).abs().max() / u.abs().max().clamp_min(1e-300)).item()


def judge(config: dict, samples: list, limits: dict, device, scale=None):
    """(correct, {number: {"value", "limit"}}): each number's largest
    reading over the samples against its limit."""
    ref = make_reference(config, device, scale)
    worst = {}
    for rec in samples:
        rec = dict(rec, **{side: {k: v.to(device) for k, v in rec[side].items()}
                           for side in ("in", "out")})
        got = ref.judge(rec)
        if "written" in rec:
            got["written_gap"] = written_gap(ref, rec)
        for k, v in got.items():
            cur = worst.get(k, -math.inf)
            if cur == cur and not cur >= v:  # the largest; a NaN sticks
                worst[k] = v
    # a number no sample gave, or a NaN, is None (JSON has no NaN)
    out = {}
    for k, lim in limits.items():
        v = worst.get(k)
        out[k] = {"value": v if v is not None and v == v else None, "limit": lim}
    correct = bool(samples) and all(
        v["value"] is not None and v["value"] <= v["limit"]
        for v in out.values())
    return correct, out
