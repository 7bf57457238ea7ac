"""CUDA graphs of the sensor GPs' steps: the port's counterpart of the JAX
package's one-dispatch jits of the 3D range-sensor GP and the 2D lidar GP
(``erl_gaussian_process_tpu/models/range_sensor_gp_3d.py``
``_scan_train_fused`` and ``_scan_train_fused_rr``, the same two in
``models/lidar_gp_2d.py``) and of their routed predict
(``models/batch_gp.py`` ``_predict_segmented`` and
``_predict_segmented_rr``).

On a CUDA device, without ``mesh=`` or on a mesh whose collectives run on
the card (NCCL, ``parallel/mesh.runs_graphs``),
``RangeSensorGaussianProcess3D`` and ``LidarGaussianProcess2D`` run each
scan train (the gather and the bank fit on the device) and each routed
test, from the sensor-frame coordinates on, as one replay of a graph
captured with
``models/pose_graph.capture``:

- **Trains.** A graph per shape and per the settings a graph bakes (the
  kernel, its scale, the mapping, the integer settings), keyed by the
  model; the float settings (valid range, sensor variance, discontinuity
  threshold and variance) are a static input filled before every replay,
  so a setting changed between two trains reaches the next one. The range
  images are copied into a static input; the 2D lidar GP's partition table
  too, whenever the model built a new one (with ``partition_on_hit_rays``
  it may change shape from scan to scan: a graph per shape, as JAX traces
  per shape). The graph's outputs are the bank a train returns: the next
  replay of that graph overwrites them.
- **Not the offline replay.** ``train_scan_batch`` (JAX's
  ``_scan_train_batch_fused``) runs eagerly: a trajectory is replayed
  once, so its graph would cost a capture on top of an eager run each
  time; on the card a cached graph of the 64-scan replay only tied the
  eager chain (its outputs must be copied out) and pinned a pool as large
  as they are.
- **The reduced-rank fit** captures the well-posed chain
  (``batch_gp.bank_fit_rr_parts``); after the replay the host reads the
  one flag the eager fit reads, and only a bank with a failed member runs
  the jitter ladder, eagerly (``ladder_runs`` counts those trains).
- **On a mesh.** A train's body is ``parallel/mesh.sharded_bank_fit``: the
  rank's block of members through the bank fit and the three gathers
  (JAX's ``sharded_bank_fit``), all in the rank's graph; the capture's
  warm-up runs the gathers first. Every rank captures and replays the same
  trains in the same order (the keys are the same on every rank). The
  routed predicts read the replicated bank and hold no collective.
- **The routed test** (:meth:`SensorGraphs.routed_test`: either sensor
  GP's ``test`` and ``compute_occ``). The host computes the queries'
  sensor-frame coordinates (numpy, in the model's dtype, as the CPU model
  routes: the 3D GP's frame coordinates, the 2D GP's angles); the rest is
  one replay: the partition search (the 3D GP's frame bounds too), the
  bank's trained mask, the grouping into fixed-shape rows
  (``batch_gp.group_chunks``), the batched predict and the gather back
  (``batch_gp.bank_predict_chunked``). The queries are padded to a
  multiple of ``batch_gp.ROUTE_PAD``, so a graph per (bank, padded count,
  dtype, table shapes, kernel, scale, reduced rank, frame settings): a
  trajectory's tests of one query count share one. The 2D GP's partition
  bounds are a static input, copied whenever the model holds a new table
  (with ``partition_on_hit_rays`` it changes from scan to scan). The
  coordinates go in with one copy from a pinned buffer, and the mean,
  variance and valid flag come back with one copy into another; each call
  that answers a query counts ``bank.routed_graphed``.
- **The bank a routed graph reads** is a train graph's outputs when the
  model's bank is those (no copy), else a static copy of the model's
  bank, copied again whenever the model holds another bank
  (``use_scan_bank``, a loaded checkpoint, a bank the jitter ladder
  replaced).

Each capture runs its body once eagerly first (``capture``'s warm-up);
capture errors raise with their cause, and no failure falls back to the
eager chain. The CPU model and a model on a mesh that stages its
collectives through the host (gloo) build none of this.
"""

from __future__ import annotations

import collections
import logging
import weakref
from typing import Callable

import numpy as np
import torch

from erl_gaussian_process_tpu_torch.models import pose_graph
from erl_gaussian_process_tpu_torch.models.batch_gp import (
    ROUTE_PAD,
    BankState,
    RRFitParts,
    _sync,
    bank_fit_rr_finish,
)
from erl_gaussian_process_tpu_torch.models.pose_graph import (
    GraphTable,
    empty_like,
    feed,
    same,
)
from erl_gaussian_process_tpu_torch.utils.timing import count, span

_LOG = logging.getLogger("erl_gaussian_process_tpu_torch")

MAX_GRAPHS = 8  # graphs kept of each kind (trains, routed tests)


def _bank_of(outputs) -> BankState:
    return outputs.bank if isinstance(outputs, RRFitParts) else outputs


class SensorGraphs:
    """One sensor GP's graphs (see the module docstring). ``captures``
    lists every graph captured, the dropped ones released: key, warm-up
    and capture ms, pool bytes, launches a replay, replays."""

    def __init__(self, device, size: int = MAX_GRAPHS):
        self.device = torch.device(device)
        self.captures: list = []
        self._fits = GraphTable(self.captures, size)
        self._routed = GraphTable(self.captures, size)
        self._tables: dict = {}       # graph key -> the tables last copied
        # static copies of banks that are no train graph's outputs:
        # token -> (bank, the bank last copied into it)
        self._banks: collections.OrderedDict = collections.OrderedDict()
        self.size = size
        self.ladder_runs = 0

    # -- trains ------------------------------------------------------------
    def fit(self, key, body: Callable, feeds: tuple, tables: tuple = ()):
        """One scan train through the graph of ``key`` (captured at its
        first use): ``feeds`` (host arrays) are copied into the graph's
        static inputs before every replay, ``tables`` (host arrays) only
        when they are other objects than the last ones copied;
        ``body(*feeds, *tables)`` on those inputs is what the graph runs.
        Returns the bank: the graph's outputs, or for a reduced-rank fit
        (``body`` returning ``batch_gp.RRFitParts``) its bank after
        ``batch_gp.bank_fit_rr_finish``."""
        g = self._fits.get(key)
        if g is None:
            inputs = self._static((*feeds, *tables))

            def run():
                return body(*inputs)

            g = self._fits.keep(pose_graph.capture(key, self.device, run, run,
                                                   inputs))
            self._prune()
        else:
            with span("egp.graph.feed"):
                for dst, a in zip(g.inputs, feeds):
                    feed(dst, a)
                self._feed_tables(g, len(feeds), tables)
        self._tables[key] = tables
        g.replay()
        if not isinstance(g.outputs, RRFitParts):
            return g.outputs
        bank, laddered = bank_fit_rr_finish(g.outputs)
        if laddered:
            self.ladder_runs += 1
            _LOG.info("reduced-rank bank fit: a member's Cholesky failed; "
                      "ran the jitter ladder after the replay (%d so far)",
                      self.ladder_runs)
        return bank

    def _static(self, arrays: tuple) -> tuple:
        """Static tensors on the device holding copies of ``arrays`` (host
        arrays): a new graph's inputs."""
        inputs = tuple(empty_like(a, self.device) for a in arrays)
        for dst, a in zip(inputs, arrays):
            feed(dst, a)
        return inputs

    def _feed_tables(self, g, at: int, tables: tuple) -> None:
        """``tables`` (host arrays) into ``g``'s static inputs from ``at``
        on, unless they are the objects last copied into them."""
        if not same(self._tables.get(g.key, ()), tables):
            for dst, a in zip(g.inputs[at:], tables):
                feed(dst, a)

    def _prune(self) -> None:
        """A train graph's outputs go with it when the table drops it: so
        do the routed tests that read them."""
        kept = set(self._fits)
        self._routed.drop(lambda r: r.key[0][0] != "fit"
                          or r.key[0][1] in kept)
        kept.update(self._routed)
        self._tables = {k: v for k, v in self._tables.items() if k in kept}

    # -- routed predicts ---------------------------------------------------
    def _token(self, state: BankState):
        """(token, the train graph whose outputs ``state`` is, or None):
        the part of a routed key that names the bank."""
        for g in self._fits.values():
            if g.outputs is not None and same(tuple(state),
                                               tuple(_bank_of(g.outputs))):
                return ("fit", g.key), g
        return ("bank", tuple(None if t is None else
                              (tuple(t.shape), t.dtype) for t in state)), None

    def _bank(self, token, fit, state: BankState) -> BankState:
        """The static bank a routed graph of ``token`` reads for
        ``state``: the train graph's outputs, or a static copy of
        ``state``, copied again when it holds another bank."""
        if fit is not None:
            return _bank_of(fit.outputs)
        # the bank last copied in, held by weak references: a caller's
        # bank is not kept alive by its copy
        source = tuple(None if t is None else weakref.ref(t) for t in state)
        held = self._banks.get(token)
        if held is None:
            held = (BankState(*(None if t is None else
                                t.clone(memory_format=torch.contiguous_format)
                                for t in state)), source)
            self._banks[token] = held
            while len(self._banks) > self.size:
                old, _ = self._banks.popitem(last=False)
                self._routed.drop(lambda r, old=old: r.key[0] != old)
        else:
            self._banks.move_to_end(token)
            if not same(tuple(None if r is None else r() for r in held[1]),
                         tuple(state)):
                for dst, src in zip(held[0], state):
                    if dst is not None:
                        dst.copy_(src)
                held = (held[0], source)
                self._banks[token] = held
        return held[0]

    def routed_test(self, state: BankState, coords: np.ndarray,
                    body: Callable, settings: tuple,
                    tables: tuple = ()) -> tuple:
        """The routed test of ``state``'s bank as one replay: coords (m, d)
        the queries' sensor-frame coordinates on the host, NaN where the
        frame maps none; ``tables`` host arrays (the 2D GP's partition
        bounds), copied into static inputs only when they are other objects
        than the last ones copied, their shapes part of the graph's key (a
        table need not match the bank's member count: one rebuilt after
        the train does not); ``body(bank, q, *tables)`` the graph's
        function of the static bank, the padded coordinates (mp, d) and
        the tables on the device, returning
        ``batch_gp.bank_predict_chunked``'s (q_dim + 2, mp); ``settings``
        what it bakes. Returns numpy (mean (m, q_dim), var (m,), valid
        (m,) bool), new arrays.

        The phases are ``bank_predict_assigned``'s spans, as their names
        say: ``egp.bank.group`` the graph's lookup, ``egp.bank.h2d`` the
        coordinates into the pinned buffer and the copy in (a capture at
        a graph's first use), ``egp.bank.predict`` the replay,
        ``egp.bank.readback`` the copy out and the wait for the card,
        ``egp.bank.scatter`` the outputs cut to m."""
        with span("egp.bank.group"):
            m = coords.shape[0]
            mp = max(1, -(-m // ROUTE_PAD)) * ROUTE_PAD
            token, fit = self._token(state)
            key = (token, "chunked", mp, coords.dtype.str,
                   tuple(t.shape for t in tables), *settings)
            g = self._routed.get(key)
        with span("egp.bank.h2d"):
            if g is None:
                bank = self._bank(token, fit, state)
                pin = self.device.type == "cuda"
                dtype = bank.alpha.dtype
                host_in = torch.empty((mp, coords.shape[1]), dtype=dtype,
                                      pin_memory=pin)
                host_out = torch.empty((bank.alpha.shape[2] + 2, mp),
                                       dtype=dtype, pin_memory=pin)
                q = torch.empty(host_in.shape, dtype=dtype,
                                device=self.device)
                _stage(host_in, q, coords)
                static = self._static(tables)

                def run():
                    return body(bank, q, *static)

                g = self._routed.keep(pose_graph.capture(
                    key, self.device, run, run,
                    (q, host_in, host_out, *static)))
            else:
                self._bank(token, fit, state)
                with span("egp.graph.feed"):
                    _stage(g.inputs[1], g.inputs[0], coords)
                    self._feed_tables(g, 3, tables)
            self._tables[key] = tables
        with span("egp.bank.predict"):
            g.replay()
        host_out = g.inputs[2]
        with span("egp.bank.readback"):
            host_out.copy_(g.outputs, non_blocking=True)
            _sync(self.device)
        with span("egp.bank.scatter"):
            out = host_out.numpy()[:, :m]
            qd = out.shape[0] - 2
            mean, var = out[:qd].T.copy(), out[qd].copy()
            valid = out[qd + 1] > 0
        if valid.any():
            count("bank.routed_graphed")
        return mean, var, valid


def _stage(host: torch.Tensor, dst: torch.Tensor, coords: np.ndarray):
    """coords into the head of the (pinned) host buffer, NaN past it (a
    padded query routes nowhere), and the buffer into ``dst`` without
    blocking: the caller reads the results back, which waits for the
    copy, before the next call writes the buffer again."""
    h = host.numpy()
    m = coords.shape[0]
    h[:m] = coords
    h[m:] = np.nan
    dst.copy_(host, non_blocking=True)
