"""The graphed octave loop (``nfs_tpu_torch/styler/octave.py``
``_OctaveGraphs``) on the CPU, for the tests of the grid and particle
stylers' CUDA graphs: a recording stand-in for ``torch.cuda.graph`` whose
replay calls the captured step. A test module takes the fixture by
importing it (``from torch_graph_stand_in import stand_in_graphs``); this
module imports no JAX, so those modules also run with ``--noconftest``.
"""

import weakref

import numpy as np
import pytest
import torch

from nfs_tpu_torch.styler import grid as G
from nfs_tpu_torch.styler import octave as O
from nfs_tpu_torch.styler import particle as P


class StandInGraph:
    """torch.cuda.CUDAGraph's stand-in: replay calls what was captured;
    ``capturing`` is the graph being captured, if any."""
    capturing = None

    def __init__(self):
        self.step = None

    def replay(self):
        self.step()


class _StandInCapture:
    def __init__(self, graph, pool=None):
        self.graph = graph

    def __enter__(self):
        StandInGraph.capturing = self.graph

    def __exit__(self, *exc):
        StandInGraph.capturing = None


def _cuda_bias_corrected(x, bc):
    """The bias correction as CUDA computes it: a tensor over a Python
    float is the product with the float's float32 reciprocal."""
    if isinstance(bc, float):
        bc = torch.tensor([np.float32(1) / np.float32(bc)])
    return x * bc


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """Capture records the step, replay calls it, and the grid and
    particle stylers' GPU check passes. Gives the stand-in graph class,
    whose ``capturing`` is set while a step is captured."""
    step = O._OctaveGraph.step

    def recorded(self, loss_fn, optimizer):
        if StandInGraph.capturing is None:
            return step(self, loss_fn, optimizer)
        # the graph holds its owner weakly, as a CUDA graph holds no
        # Python object: a dropped styler's graphs go with it
        owner = weakref.ref(self)
        StandInGraph.capturing.step = (
            lambda: step(owner(), loss_fn, optimizer))

    monkeypatch.setattr(O._OctaveGraph, "step", recorded)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", _StandInCapture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(O, "_bias_corrected", _cuda_bias_corrected)

    def on_cpu(real):
        def graphed(self, *args):
            device = self.device
            self.device = torch.device("cuda")
            try:
                return real(self, *args)
            finally:
                self.device = device
        return graphed

    for cls in (G.GridStyler, P.ParticleStyler):
        monkeypatch.setattr(cls, "_graphed", on_cpu(cls._graphed))
    return StandInGraph
