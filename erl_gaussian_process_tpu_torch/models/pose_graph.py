"""CUDA graphs of the occupancy map's steps over static buffers: the port's
counterpart of ``jax.jit`` with ``donate_argnames`` on the map's step
functions (``erl_gaussian_process_tpu/models/spgp_occupancy_map.py``).

On a CUDA device, ``SpGpOccupancyMap`` (``models/spgp_occupancy_map.py``)
runs each chunk of c poses — sampling, labels, the cap and compaction, the
FITC update (``csrc/fitc.cu``) and the Kahan add, :func:`pose_chunk_body`
— and each prepared predict (the gram of ``csrc/gram.cuh`` and its
products, ``predict_prepared_step``) as one replay of a captured graph:

- **The state is static.** Q_M, alpha, their Kahan terms, the pseudo
  points and factors the steps read, and the map's box live in tensors of
  :class:`PoseGraphs` that every graph reads and writes in place, so a
  replay reads the previous replay's result: what donation does in JAX.
  The map's ``sp_gp.state`` is those tensors, so a state a caller held from
  before an update holds the new values after it (JAX's donation leaves
  it invalid). :meth:`PoseGraphs.bind` copies a state that was put in
  their place (a loaded checkpoint) into them.
- **Inputs are copied in.** Before each replay the poses' sensor positions,
  end points and masks (or the queries) go into the graph's static input
  buffers: host-to-device copies that do not block, from pageable memory,
  which CUDA stages before the call returns.
- **Randomness.** Pose i of a chunk draws from generator i, registered
  with the graph (``CUDAGraph.register_generator_state``) and seeded with
  ``step_seed`` on the host before each replay; a replay reads the seed
  and offset the generator holds at that moment, so each pose draws what
  the eager map draws for it.
- **A cache per shape.** A graph is captured per (rays, c, the step's
  settings, scale, datasets kept or not) and per (queries, gradient,
  kernel, scale), the way a jit traces once per static shape; at most
  :data:`MAX_GRAPHS` of each kind are kept, the least recently used
  dropped first. Each capture is preceded by one eager run of the same
  body on scratch copies of the state (a side stream; its kernel launches
  are counted), so that nothing is built or loaded for the first time
  inside the capture.
- **Launch counts.** Under capture the kernel wrappers count into
  ``captured`` (``ops/_library.note_launch``); each replay adds the launches
  its graph captured to the wrappers' ``launches``: the counts are the
  kernels the replays ran.
- **Spans and counters** (``utils.timing``). A capture is the span
  ``egp.graph.capture`` and adds its warm-up's and capture's ms to
  ``graph.capture_ms``; a replay is ``egp.graph.replay``; the copies of a
  step's inputs and seeds before it are ``egp.graph.feed``.
- **On a mesh** (``parallel/mesh.py``) whose collectives run on the card
  (NCCL, ``parallel.mesh.runs_graphs``), each rank replays the same graphs: a chunk
  samples its c poses replicated, from the same seeds on every rank, then
  runs the rank's shard of the FITC update, the ``all_reduce`` pair and
  the Kahan add (JAX's ``sharded_update_many``); a predict without a
  gradient runs the rank's block of queries and the gather into a static
  output (JAX's ``sharded_spgp_predict``); a predict with a gradient runs
  the one-card graph, as the eager map does. The capture's warm-up runs the
  same collectives first, so the communicator exists before the capture.
  The graph keys are the same on every rank and the tables drop graphs the
  same way, so the ranks capture, replay and release in lockstep: a rank
  whose peer does not replay waits inside its graph for ever, and only the
  caller's own bound (a world's join) ends it.

Capture errors raise with their cause; nothing falls back to the eager
chain. The CPU map and a map on a mesh that stages its collectives through
the host (gloo) run eagerly and build none of this.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import gc
import time
from typing import Callable, Optional

import numpy as np
import torch

from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
    SpGpState,
    spgp_update,
)
from erl_gaussian_process_tpu_torch.parallel.mesh import (
    sharded_spgp_predict,
    sharded_spgp_update,
)
from erl_gaussian_process_tpu_torch.utils.timing import count, span

MAX_GRAPHS = 4  # graphs kept of each kind (update, predict)


def pose_chunk_body(state: SpGpState, sensor_positions, points, point_masks,
                    aabb_min, aabb_max, scale, *, kernel, diagonal_qm,
                    zero_threshold: float = 0.0, generators=None, u=None,
                    collect_datasets: bool = False, mesh=None, **sample_kw):
    """The captured body of one chunk of c poses: each pose sampled by
    ``sample_pose`` (pose i from ``generators[i]``, or from the fractions
    ``u[i]`` when ``u`` (c, n, free_slots) is given), the c datasets
    concatenated into one ``spgp_update`` whose new Q_M, alpha and Kahan
    terms are written into ``state``'s own tensors; with ``mesh``, into
    ``sharded_spgp_update`` (the samples sharded over the ranks, the
    increments summed by the ``all_reduce`` pair). Plain tensor code: run
    eagerly it is the same chain as ``update_batch_steps`` (``mesh=``) on
    one chunk.

    sensor_positions (c, d); points (c, n, d); point_masks (c, n). Returns
    (n_used (c,), the dataset (pts, y, mask) the update consumed when
    ``collect_datasets`` (c == 1), else None)."""
    from erl_gaussian_process_tpu_torch.models.spgp_occupancy_map import (
        sample_pose,
    )

    c = sensor_positions.shape[0]
    chunk = [sample_pose(sensor_positions[i], points[i], point_masks[i],
                         aabb_min, aabb_max,
                         generator=None if generators is None
                         else generators[i],
                         u=None if u is None else u[i], **sample_kw)
             for i in range(c)]
    pts, y, var, mask = (chunk[0] if c == 1 else
                         tuple(torch.cat(t) for t in zip(*chunk)))
    update = spgp_update if mesh is None else functools.partial(
        sharded_spgp_update, mesh)
    update(state, pts, y, var, mask, scale, kernel=kernel,
           diagonal_qm=diagonal_qm, zero_threshold=zero_threshold, out=state,
           block=chunk[0][0].shape[0])
    n_used = torch.stack([torch.sum(m) for *_, m in chunk])
    return n_used, ((pts, y, mask) if collect_datasets else None)


def _counted_wrappers():
    from erl_gaussian_process_tpu_torch.ops import WRAPPERS

    return [w for w in WRAPPERS.values() if hasattr(w, "captured")]


@dataclasses.dataclass
class CapturedGraph:
    """One captured graph: its static inputs and outputs, the kernel
    launches of one replay (by wrapper), and what its capture cost: the
    eager warm-up's and the capture's wall ms, and the bytes the graph's
    private memory pool reserved."""

    key: tuple
    graph: "torch.cuda.CUDAGraph"
    inputs: tuple
    outputs: tuple
    launches: dict
    warmup_ms: float
    capture_ms: float
    pool_bytes: int
    replays: int = 0

    def replay(self) -> None:
        with span("egp.graph.replay"):
            self.graph.replay()
        self.replays += 1
        for wrapper, k in self.launches.items():
            wrapper.launches += k

    def release(self) -> None:
        """Drop the graph and its buffers (its pool is freed with them);
        the record of its capture stays."""
        self.graph, self.inputs, self.outputs = None, (), ()


def capture(key, device, warm: Callable, run: Callable, inputs: tuple,
            generators=()) -> CapturedGraph:
    """``warm()`` once eagerly, then ``run()`` captured as a CUDA graph, both
    on a side stream; ``run``'s return value is the graph's static output.
    The generators ``run`` draws from are registered with the graph.

    Python's cyclic garbage collector is held off during the capture: a
    graph that a collected reference cycle held would be destroyed inside
    the capture, and freeing a graph is an operation a capturing stream
    does not permit (it invalidates the capture).

    Adds the warm-up's and the capture's ms to ``graph.capture_ms``
    (``utils.timing.count``)."""
    with span("egp.graph.capture"):
        wrappers = _counted_wrappers()
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            t0 = time.perf_counter()
            warm()
            torch.cuda.synchronize(device)
            t1 = time.perf_counter()
            reserved = torch.cuda.memory_reserved(device)
            before = [w.captured for w in wrappers]
            graph = torch.cuda.CUDAGraph()
            for gen in generators:
                graph.register_generator_state(gen)
            collecting = gc.isenabled()
            gc.disable()
            try:
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = run()
                finally:
                    graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
            t2 = time.perf_counter()
        torch.cuda.current_stream(device).wait_stream(stream)
        launches = {w: w.captured - n for w, n in zip(wrappers, before)
                    if w.captured > n}
        g = CapturedGraph(
            key=key, graph=graph, inputs=inputs, outputs=out,
            launches=launches, warmup_ms=1e3 * (t1 - t0),
            capture_ms=1e3 * (t2 - t1),
            pool_bytes=torch.cuda.memory_reserved(device) - reserved)
    count("graph.capture_ms", g.warmup_ms + g.capture_ms)
    return g


class GraphTable:
    """Captured graphs by key, the way a jit caches one executable per
    static shape: at most ``size`` kept, the least recently used released
    first. Every graph kept is appended to ``captures`` (a list that the
    tables of one model share: the record of what was captured, released
    graphs included), unless ``captures`` is None (a table of groups of
    graphs, whose graphs their owner records)."""

    def __init__(self, captures: Optional[list], size: int = MAX_GRAPHS):
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self.captures = captures
        self.size = size

    def get(self, key) -> Optional[CapturedGraph]:
        g = self._graphs.get(key)
        if g is not None:
            self._graphs.move_to_end(key)
        return g

    def keep(self, g: CapturedGraph) -> CapturedGraph:
        self._graphs[g.key] = g
        if self.captures is not None:
            self.captures.append(g)
        while len(self._graphs) > self.size:
            self._graphs.popitem(last=False)[1].release()
        return g

    def drop(self, keep: Callable = lambda g: False) -> None:
        """Release every graph for which ``keep(g)`` is false."""
        for key in [k for k, g in self._graphs.items() if not keep(g)]:
            self._graphs.pop(key).release()

    def __iter__(self):
        return iter(self._graphs)

    def __len__(self) -> int:
        return len(self._graphs)

    def values(self):
        return self._graphs.values()


def feed(dst: torch.Tensor, a) -> None:
    """Copy a host array (pageable: CUDA stages it before the call returns)
    or a tensor into the static tensor ``dst`` without waiting."""
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a))
    dst.copy_(a, non_blocking=True)


def empty_like(a, device) -> torch.Tensor:
    """A static tensor on ``device`` of the shape and dtype of ``a`` (a host
    array or a tensor)."""
    if isinstance(a, torch.Tensor):
        return torch.empty(a.shape, dtype=a.dtype, device=device)
    return torch.empty(a.shape, device=device,
                       dtype=torch.from_numpy(np.empty(0, a.dtype)).dtype)


def same(a: tuple, b: tuple) -> bool:
    """Whether two tuples hold the same objects."""
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))


def _fresh(t: torch.Tensor) -> torch.Tensor:
    return t.clone(memory_format=torch.contiguous_format)


class PoseGraphs:
    """One map's graphs and the static buffers they share (see the module
    docstring). ``captures`` lists every graph captured, the dropped ones
    released: key, warm-up and capture ms, pool bytes, launches a replay,
    replays. ``mesh``: the map's mesh (an NCCL ``parallel.mesh.Mesh``)
    or None."""

    def __init__(self, device, mesh=None):
        self.device = torch.device(device)
        self.mesh = mesh
        self.state: Optional[SpGpState] = None
        self.box: Optional[tuple] = None
        self._generators: list = []
        self.captures: list = []
        self._updates = GraphTable(self.captures)
        self._predicts = GraphTable(self.captures)
        self._prepared = None     # (the prepare it holds, L_qm, alpha)

    def bind(self, state: SpGpState, aabb_min, aabb_max) -> tuple:
        """Make the static buffers hold ``state`` and the box: nothing when
        they are the buffers already, copies when they are other tensors of
        the same shapes, new buffers (every graph dropped) otherwise.
        Returns (static state, aabb_min, aabb_max)."""
        new = (*state, aabb_min, aabb_max)
        if self.state is not None:
            old = (*self.state, *self.box)
            if all(a is b for a, b in zip(new, old)):
                return self.state, *self.box
            if all(a.shape == b.shape and a.dtype == b.dtype
                   for a, b in zip(new, old)):
                for a, b in zip(old, new):
                    if a is not b:
                        a.copy_(b)
                return self.state, *self.box
        fresh = [_fresh(t) for t in new]
        self.state, self.box = SpGpState(*fresh[:-2]), tuple(fresh[-2:])
        self._updates.drop()
        self._predicts.drop()
        self._prepared = None
        return self.state, *self.box

    def _capture_update(self, key, c, n, scale, collect_datasets, kw):
        d = self.state.pseudo.shape[1]
        dt, dev = self.state.pseudo.dtype, self.device
        while len(self._generators) < c:
            self._generators.append(torch.Generator(device=dev))
        gens = self._generators[:c]
        inputs = (torch.zeros((c, d), dtype=dt, device=dev),
                  torch.zeros((c, n, d), dtype=dt, device=dev),
                  torch.zeros((c, n), dtype=torch.bool, device=dev))

        def body(st):
            return pose_chunk_body(st, *inputs, *self.box, scale,
                                   generators=gens,
                                   collect_datasets=collect_datasets,
                                   mesh=self.mesh, **kw)

        return self._updates.keep(capture(
            key, dev, lambda: body(SpGpState(*map(_fresh, self.state))),
            lambda: body(self.state), inputs, gens))

    def update_chunk(self, sensor_positions, points, point_masks, seeds,
                     scale, *, collect_datasets: bool = False, **kw):
        """One chunk of c poses through its graph (captured at the first
        chunk of its shape): host arrays sensor_positions (c, d), points
        (c, n, d) (masked rows zeroed), point_masks (c, n) bool; ``seeds``
        the c poses' generator seeds; ``kw`` the step's settings
        (``SpGpOccupancyMap._step_kw``). The state buffers hold the result.
        Returns the graph's static (n_used (c,), dataset or None), which
        the next replay overwrites."""
        c, n = point_masks.shape
        key = ("update", n, c, bool(collect_datasets), float(scale),
               tuple(sorted(kw.items())))
        g = self._updates.get(key) or self._capture_update(
            key, c, n, float(scale), bool(collect_datasets), kw)
        with span("egp.graph.feed"):
            for dst, a in zip(g.inputs,
                              (sensor_positions, points, point_masks)):
                feed(dst, a)
            for gen, s in zip(self._generators, seeds):
                gen.manual_seed(s)
        g.replay()
        return g.outputs

    def predict(self, prepared, xq, scale, *, kernel, with_grad: bool,
                zero_threshold: float = 0.0):
        """``predict_prepared_step`` through its graph: ``prepared`` the
        map's cached (L_qm, alpha_solved), copied into the static pair
        whenever it is another object than the last one; xq (q, d) host
        array. On a mesh, a predict without the gradient is
        ``sharded_spgp_predict`` (the queries sharded, the means
        gathered). Returns new tensors (mean (q, 1), grad (q, d, 1) |
        None)."""
        from erl_gaussian_process_tpu_torch.models.spgp_occupancy_map import (
            predict_prepared_step,
        )

        # the pair's shapes are the state's, fixed until bind() starts over
        if self._prepared is None:
            self._prepared = (prepared, *map(_fresh, prepared))
        elif self._prepared[0] is not prepared:
            for a, b in zip(self._prepared[1:], prepared):
                a.copy_(b)
            self._prepared = (prepared, *self._prepared[1:])
        q = xq.shape[0]
        key = ("predict", q, bool(with_grad), kernel, float(scale),
               float(zero_threshold))
        g = self._predicts.get(key)
        if g is None:
            inputs = (torch.zeros((q, self.state.pseudo.shape[1]),
                                  dtype=self.state.pseudo.dtype,
                                  device=self.device),)

            def run():
                if self.mesh is not None and not with_grad:
                    return sharded_spgp_predict(
                        self.mesh, self.state, *self._prepared[1:],
                        inputs[0], scale, kernel=kernel, with_var=False,
                        zero_threshold=zero_threshold)
                return predict_prepared_step(
                    self.state, *self._prepared[1:], inputs[0], scale,
                    kernel=kernel, with_grad=with_grad,
                    zero_threshold=zero_threshold)

            g = self._predicts.keep(capture(key, self.device, run, run,
                                            inputs))
        feed(g.inputs[0], xq)
        g.replay()
        mean, grad = g.outputs
        return mean.clone(), None if grad is None else grad.clone()
