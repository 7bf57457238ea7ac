"""CUDA graphs of the exact GPs' steps: the port's counterpart of the JAX
package's one-dispatch jits of the exact and noisy-input GPs
(``erl_gaussian_process_tpu/models/vanilla_gp.py``: ``vanilla_fit``,
``rr_fit``, ``vanilla_ktest``, ``vanilla_mean``, ``vanilla_variance``,
``vanilla_l_inv``, ``vanilla_variance_fast``;
``models/noisy_input_gp.py``: ``nigp_fit``, ``nigp_fit_nograd``,
``nigp_rr_fit``, ``nigp_rr_fit_nograd``, ``nigp_ktest``, ``nigp_mean``,
``nigp_gradient``, ``nigp_variance_cov``, ``nigp_l_inv``,
``nigp_variance_cov_fast``).

On a CUDA device ``VanillaGaussianProcess`` and
``NoisyInputGaussianProcess`` run each of these steps as one replay of a
graph captured with ``models/pose_graph.capture``, kept in the model's
:class:`ExactGraphs`:

- **Fits.** A graph per fit variant and per what it bakes: the shapes and
  dtypes of the train set, the kernel and its scale (the chol-gram kernels
  take the family and the scale as host constants). Before each replay
  the train set goes into the graph's static inputs without blocking; a
  reduced-rank basis's constants are copied in whenever the basis holds
  other tensors than the ones copied last (``set_coord_origin``). The
  host jitter retry (``gp_core.host_jitter_retry``) stays outside the
  graph: each rung writes the raised noise into the static inputs,
  replays, and reads alpha's finiteness. **The model's state is the
  graph's buffers** (x and the masks its static inputs; L, alpha and Dinv
  its outputs): the next fit of the same key overwrites them in place.
- **Queries.** For each state, a group of graphs per query key (the
  queries' shape, the gradients asked for, the kernel, its scale, reduced
  rank or not) over one static cross gram: the test graph computes ktest
  and the mean (and the gradient) from the queries; the variance graph
  whitens that ktest by the state's factor (``gp_core.whiten``, its
  64-row ``dinv`` substitution at float32) and reduces it; the repeated-
  query path's graph multiplies it by L^-1, which one more graph a state
  computes. A mean-only test replays no variance graph.
- **A live result keeps its inputs** (:class:`Held`). A TestResult reads
  its group's buffers (ktest, the mean, the gradient) until another test
  of its group would overwrite them; that test first gives it copies of
  them: a result kept across another test of its shape costs one copy of
  its ktest (128 MiB at the exact-GP cell, n = 8192 and 4096 queries at
  float32), which it copies back into the buffer for its variance. A
  result read after its model's state changed (a retrain, a load) runs the
  eager functions on its own ktest and the model's current state, which
  is what the eager chain computes from them; so does a result whose
  group was dropped.

**Memory.** Each graph's private pool keeps its outputs and the peak of
its temporaries. Measured on an H100 at float32: the exact GP's fit at n =
8192 278 MiB, its test graph of 4096 queries 130 MiB (ktest), its
variance graph 390 MiB; the noisy-input GP's fit at 7680^2 248 MiB (1606
MiB for a scale mixture, whose joint gram is built outside the
factorization), its test of 1024 queries with gradients 552 MiB; at
float64 the golden's fit at 7500^2 484 MiB and its test of 10 000 queries
with gradients 10 506 MiB (the (7500, 30 000) ktest and the gradient
blocks' temporaries, which the eager test holds as long while it runs).
Hence :data:`MAX_STATES` states a model and :data:`MAX_QUERIES` query
groups a state (a serving model tests one batch shape and its
remainder): ~2 GiB a state at most at the exact-GP cell, and 10.3 GiB a
query shape of the golden's size.

Capture errors raise with their cause; nothing falls back to the eager
chain. The CPU models build none of this.
"""

from __future__ import annotations

import weakref
from typing import Callable, Optional

import torch

from erl_gaussian_process_tpu_torch.models import pose_graph
from erl_gaussian_process_tpu_torch.models.pose_graph import (
    CapturedGraph,
    GraphTable,
    empty_like,
    feed,
    same,
)

MAX_STATES = 2   # states kept a model: each a fit graph, its L^-1, queries
MAX_QUERIES = 2  # query groups kept a state


def _spec(a) -> tuple:
    """What a graph bakes of an input: its shape and dtype."""
    return tuple(a.shape), str(a.dtype)


class Held:
    """One TestResult's outputs of its test replay: ``outputs`` (ktest, the
    mean[, the gradient]) are its group's static buffers until another
    replay of the group's test graph would overwrite them, then copies of
    them; ``group`` is that group and ``state`` the state it was tested
    on."""

    __slots__ = ("outputs", "group", "state", "__weakref__")

    def __init__(self, outputs: tuple, group: "_QueryGraphs", state):
        self.outputs, self.group, self.state = outputs, group, state

    @property
    def ktest(self) -> torch.Tensor:
        return self.outputs[0]


class _QueryGraphs:
    """The graphs of one query key on one state: ``test`` (the queries ->
    ktest, the mean[, the gradient]) and, captured at their first use, the
    variance graphs by name (ktest [and L^-1] -> the variance)."""

    def __init__(self, key, test: CapturedGraph):
        self.key, self.test = key, test
        self.graphs: dict = {}
        self.consts: tuple = ()
        self.kept = True
        self._holder: Optional[weakref.ref] = None

    @property
    def ktest(self) -> torch.Tensor:
        return self.test.outputs[0]

    def hold(self, held: Held) -> None:
        self._holder = weakref.ref(held)

    def free(self) -> None:
        """Give the live result whose ktest is the buffer copies of what it
        holds of the buffers: a replay is about to overwrite them."""
        held = None if self._holder is None else self._holder()
        if held is not None and held.ktest is self.ktest:
            held.outputs = tuple(t.clone() for t in held.outputs)
        self._holder = None

    def release(self) -> None:
        self.free()
        for g in (self.test, *self.graphs.values()):
            g.release()
        self.graphs = {}
        self.kept = False


class _StateGraphs:
    """One state's graphs: ``fit`` (None for a state made elsewhere, such
    as a loaded one), whose buffers ``state`` is, the L^-1 graph and the
    query groups."""

    def __init__(self, key, fit: Optional[CapturedGraph], state=None):
        self.key, self.fit, self.state = key, fit, state
        self.consts: tuple = ()
        self.l_inv: Optional[CapturedGraph] = None
        self.queries = GraphTable(None, MAX_QUERIES)

    def release(self) -> None:
        self.queries.drop()
        for g in (self.fit, self.l_inv):
            if g is not None:
                g.release()
        self.state = None


class ExactGraphs:
    """One exact GP's graphs (see the module docstring). ``captures`` lists
    every graph captured, the dropped ones released: key, warm-up and
    capture ms, pool bytes, launches a replay, replays."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.captures: list = []
        self._states = GraphTable(None, MAX_STATES)
        self._other: Optional[_StateGraphs] = None

    def _capture(self, key, body: Callable, args: tuple, inputs: tuple
                 ) -> CapturedGraph:
        """``body(*args)`` captured (after one eager run of it), recorded in
        ``captures``; ``inputs`` are the graph's static inputs."""
        def run():
            return body(*args)

        g = pose_graph.capture(key, self.device, run, run, inputs)
        self.captures.append(g)
        return g

    def _inputs(self, arrays: tuple) -> tuple:
        inputs = tuple(empty_like(a, self.device) for a in arrays)
        for dst, a in zip(inputs, arrays):
            feed(dst, a)
        return inputs

    def clear(self) -> None:
        """Release every graph (a loaded state replaces the model's)."""
        self._states.drop()
        if self._other is not None:
            self._other.release()
            self._other = None

    # -- fits ----------------------------------------------------------------
    def fit(self, static: tuple, body: Callable, feeds: tuple,
            consts: tuple = ()):
        """One fit through the graph of ``static`` (the variant, the kernel
        and its scale) and the inputs' shapes, captured at its first use:
        ``feeds`` (host arrays) are copied into its static inputs before
        every replay, ``consts`` (device tensors) when they are other
        tensors than the ones copied last; ``body(*feeds, *consts)`` on
        those inputs is what the graph runs. Returns the state: a new
        NamedTuple of the graph's buffers."""
        key = ("fit", *static, *map(_spec, (*feeds, *consts)))
        sg = self._states.get(key)
        if sg is None:
            inputs = self._inputs((*feeds, *consts))
            sg = self._states.keep(_StateGraphs(
                key, self._capture(key, body, inputs, inputs)))
        else:
            for dst, a in zip(sg.fit.inputs, feeds):
                feed(dst, a)
            if not same(sg.consts, consts):
                for dst, a in zip(sg.fit.inputs[len(feeds):], consts):
                    feed(dst, a)
        sg.consts = consts
        sg.fit.replay()
        sg.state = type(sg.fit.outputs)(*sg.fit.outputs)
        return sg.state

    def _state_graphs(self, state) -> _StateGraphs:
        """The graphs of ``state``: its fit graph's, else those of the last
        state made elsewhere, begun anew for another one."""
        for sg in self._states.values():
            if sg.state is state:
                return self._states.get(sg.key)
        if self._other is None or self._other.state is not state:
            if self._other is not None:
                self._other.release()
            self._other = _StateGraphs(("state",), None, state)
        return self._other

    def l_inv(self, state, body: Callable) -> torch.Tensor:
        """``body(state)`` (L^-1) through the state's graph; its output, which
        the replay after the next fit of this state overwrites."""
        sg = self._state_graphs(state)
        if sg.l_inv is None:
            st = sg.state
            sg.l_inv = self._capture(("l_inv", *sg.key), body, (st,), ())
        sg.l_inv.replay()
        return sg.l_inv.outputs

    # -- queries -------------------------------------------------------------
    def test(self, state, static: tuple, body: Callable, xq,
             consts: tuple = ()) -> Held:
        """A test through the test graph of ``state`` and the query key
        (``static`` and the queries' shape), captured at its first use:
        ``xq`` (a host array) and ``consts`` (device tensors, copied when
        they are other tensors than the ones copied last) go into its static
        inputs, and ``body(state, xq, *consts)`` -> (ktest, mean[, gradient])
        is what it runs. Returns the result's :class:`Held`."""
        sg = self._state_graphs(state)
        key = ("test", *static, _spec(xq), *map(_spec, consts))
        q = sg.queries.get(key)
        if q is None:
            inputs = self._inputs((xq, *consts))
            q = sg.queries.keep(_QueryGraphs(key, self._capture(
                key, body, (sg.state, *inputs), inputs)))
        else:
            q.free()
            feed(q.test.inputs[0], xq)
            if not same(q.consts, consts):
                for dst, a in zip(q.test.inputs[1:], consts):
                    feed(dst, a)
        q.consts = consts
        q.test.replay()
        held = Held(q.test.outputs, q, sg.state)
        q.hold(held)
        return held

    @staticmethod
    def serves(held: Optional[Held], state) -> bool:
        """Whether the graphs serve a result: its model's state is the one
        it was tested on and its group is kept."""
        return held is not None and held.state is state and held.group.kept

    def variance(self, held: Held, name: str, body: Callable,
                 l_inv: Optional[torch.Tensor] = None):
        """The variance graph ``name`` of a result's group on its ktest (which
        is copied back into the group's buffer when another result's is
        there): ``body(state, ktest)``, or ``body(l_inv, ktest)`` when
        ``l_inv`` (the state's L^-1 graph output) is given. Returns its
        outputs, which its next replay overwrites."""
        q = held.group
        if held.ktest is not q.ktest:
            q.free()
            q.ktest.copy_(held.ktest)
            held.outputs = (q.ktest, *held.outputs[1:])
            q.hold(held)
        g = q.graphs.get(name)
        if g is None:
            first = held.state if l_inv is None else l_inv
            g = q.graphs[name] = self._capture(
                (name, *q.key[1:]), body, (first, q.ktest), (q.ktest,))
        g.replay()
        return g.outputs
