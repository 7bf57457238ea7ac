"""An eager stand-in for ``erl_gaussian_process_tpu_torch/models/
pose_graph.capture`` on the CPU, shared by the tests of the port's CUDA-
graph modules: a capture runs its warm-up, and its graph's replay runs the
captured function again and copies the results into the outputs of its
first run, so the outputs are static buffers that each replay overwrites,
as a CUDA graph's are. Import the ``eager_graphs`` fixture into a test
module to use it, or call :func:`install` in a process of its own (a rank
of a spawned world)."""

import pytest
import torch.utils._pytree as pytree

import erl_gaussian_process_tpu_torch.models.pose_graph as pg


class StaticGraph:
    """Stand-in for a captured graph on the CPU (see the module
    docstring)."""

    def __init__(self, key, run, inputs):
        self.key, self.graph, self.inputs = key, run, inputs
        self.outputs, self.replays = None, 0

    def replay(self):
        out = self.graph()
        if self.outputs is None:
            self.outputs = out
        else:
            for dst, src in zip(pytree.tree_leaves(self.outputs),
                                pytree.tree_leaves(out)):
                if dst is not None:
                    dst.copy_(src)
        self.replays += 1

    def release(self):
        self.graph, self.inputs, self.outputs = None, (), ()


def install(set_attr=setattr) -> list:
    """Make captures on the CPU :class:`StaticGraph` (after the warm-up
    run, as on the card), by ``set_attr(pose_graph, "capture", ...)``;
    returns the list of captures made."""
    made = []

    def capture(key, device, warm, run, inputs, generators=()):
        warm()
        made.append(StaticGraph(key, run, inputs))
        return made[-1]

    set_attr(pg, "capture", capture)
    return made


@pytest.fixture
def eager_graphs(monkeypatch):
    """:func:`install` for one test; returns the list of captures made."""
    return install(monkeypatch.setattr)
