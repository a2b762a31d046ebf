"""The lattice partition on two (and four) cards over NCCL, one rank a
card.

Run on a machine with two or more NVIDIA GPUs:
`python -m pytest --noconftest -m cuda tests/test_torch_cards.py`. It
skips, saying why, where fewer cards are visible than a case needs (this module
imports neither jax nor the JAX package; the spawned ranks import it by
name).

Each rank checks that its card is the current device (the kernels launch
on the current device's stream), runs K3 and K5 on its slab of a small
lattice against their plain versions, and the halo fill and interface sum
as NCCL send/recv against the slot all-reduce on the same input (bit for
bit), eager and replayed from a CUDA graph.
"""

import numpy as np
import pytest
import torch

from dealii_adapter_tpu_torch.ops.q1_structured import Q1StructuredOperator
from dealii_adapter_tpu_torch.ops.q2_structured import Q2StructuredOperator
from dealii_adapter_tpu_torch.parallel import spawn
from dealii_adapter_tpu_torch.parallel.lattice import SlabLayout, SlabOperator
from dealii_adapter_tpu_torch.solvers.graphs import capture

# a Q2 lattice of 4 x 3 x 2 cells split along its slowest axis (2 cells a
# rank on 2 ranks, 1 on 4), and the same nodes as a Q1 lattice
LATTICE = (9, 7, 5)


def _element_matrix(n, seed):
    E = np.random.default_rng(seed).standard_normal((n, n))
    return E + E.T


def _rel(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def _exchanges(lay, v, y):
    """The halo fill of `v` and the interface sum of `y` in the rule's
    form (p2p on NCCL), then as the slot all-reduce."""
    out = []
    for slots in (False, True):
        lay.mesh.slot_exchange = slots
        out += [lay.fill(v), lay.interface_sum(y)]
    lay.mesh.slot_exchange = False
    return out


def _two_card_rank(mesh):
    dev = mesh.device
    out = dict(rank=mesh.rank, backend=mesh.backend, device=str(dev),
               current=torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(7 + mesh.rank)
    errors = {}
    for name, cls, p, E in (("K3", Q1StructuredOperator, 1, _element_matrix(24, 1)),
                            ("K5", Q2StructuredOperator, 2, _element_matrix(81, 2))):
        lay = SlabLayout(LATTICE, p, 0, mesh)
        kernel = cls(E, lay.slab_shape, torch.float32, dev)
        before = cls.launches
        x = torch.randn(kernel._u_shape, generator=g, device=dev)
        errors[f"{name} slab"] = _rel(kernel(x), kernel.plain(x))
        # the distributed operator, gathered, against one lattice's plain
        # operator on the gathered input
        u = torch.randn((int(np.prod(LATTICE)), 3), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
        y = lay.gather(SlabOperator(kernel, lay)(lay.local(u)))
        whole = cls(E, LATTICE, torch.float32, dev)
        errors[f"{name} lattice"] = _rel(y, whole.plain(u))
        out[f"{name} launches"] = cls.launches - before
        out[f"{name} tensor device"] = y.device.index
    out["errors"] = errors

    lay = SlabLayout(LATTICE, 2, 0, mesh)
    v = torch.randn((lay.n_owned, 3), generator=g, device=dev)
    y = torch.randn(lay.slab_shape + (3,), generator=g, device=dev)
    out["form"] = mesh.exchange_form(v)
    eager = _exchanges(lay, v, y)
    out["p2p equals all_reduce"] = (torch.equal(eager[0], eager[2])
                                    and torch.equal(eager[1], eager[3]))
    # captured: the p2p exchanges replayed equal the eager calls, also on
    # new data in the captured input buffers
    v_in, y_in = v.clone(), y.clone()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # the warm-up before a capture
        lay.fill(v_in), lay.interface_sum(y_in)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with capture(graph):
        filled, summed = lay.fill(v_in), lay.interface_sum(y_in)
    replays = []
    for k in range(2):
        if k:
            v_in.copy_(torch.randn(v.shape, generator=g, device=dev))
            y_in.copy_(torch.randn(y.shape, generator=g, device=dev))
        graph.replay()
        torch.cuda.synchronize(dev)
        ref = _exchanges(lay, v_in, y_in)
        replays.append(torch.equal(filled, ref[0]) and torch.equal(summed, ref[1])
                       and torch.equal(ref[0], ref[2]) and torch.equal(ref[1], ref[3]))
    out["replay equals eager"] = replays
    out["calls"] = dict(mesh.calls)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
def test_two_cards_slab_kernels_and_p2p_exchange(world):
    """`world` ranks over NCCL, each on its own card (the current device,
    the tensors' device): K3 and K5 on the rank's slab within f32 roundoff
    of their plain versions (1e-5 relative L2), and the distributed
    operators gathered against one lattice's; the p2p halo fill and
    interface sum bit for bit the slot all-reduce's, and a replayed
    capture of them bit for bit the eager call, also on new data. Four
    ranks give the middle ranks both neighbours."""
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < world:
        pytest.skip(f"needs {world} CUDA cards, {visible} visible (one rank a "
                    "card over NCCL)")
    ranks = spawn(_two_card_rank, world, "cuda", backend="nccl", timeout_s=300)
    for r in ranks:
        assert r["backend"] == "nccl" and r["form"] == "p2p"
        assert r["device"] == f"cuda:{r['rank']}" and r["current"] == r["rank"]
        assert r["K3 tensor device"] == r["K5 tensor device"] == r["rank"]
        assert r["K3 launches"] >= 2 and r["K5 launches"] >= 2
        assert all(e <= 1e-5 for e in r["errors"].values()), r["errors"]
        assert r["p2p equals all_reduce"]
        assert r["replay equals eager"] == [True, True]
        assert r["calls"]["p2p"] > 0
