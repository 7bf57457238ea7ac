"""One run of one cell: set-up, the measured window, the traced slice, the
per-layer readers and the check against the plain reference.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in files of its own, found by the names ``BENCHMARK.json``
gives: the configuration ``configs/<name>.json`` names its adapter
``adapters/<adapter>.py`` (the program's model behind the calls the loop
makes, and the comparison) whose reference is ``reference/<adapter>.py``;
the traffic is ``traffic/<name>.json``, read by :func:`run_loop`; a
per-layer metric is ``metrics/<name>.py`` with ``read(ctx)``; the limits
of a cell's check are ``limits/<cell>.json``.

A traffic file holds:

- ``session``: ``"pass"`` starts a new session of the model inside the
  window at every pass over the configuration's updates (a map per
  trajectory); ``"run"`` builds one model in set-up for the whole run.
- ``query_every``: a blocking query after every that many updates, 0 for
  none; its latency runs from the call to the answer on the host.
- ``query``: what one query asks for, read by the adapter (points,
  gradient, inset).
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import os
import statistics
import sys
import time
import traceback

import torch

from portbench import trace as tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
CACHE = os.path.join(HERE, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "erl_gaussian_process_tpu")
TRACE_SECONDS = 1.0   # the traced slice after the window, in --trace 1 runs


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the harness must not
    load (compared whole: the program's package name begins with the JAX
    package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(workload: str, root: str = ROOT) -> dict:
    """The cell's entries of ``BENCHMARK.json`` with the files they name."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return {"cell": cell, "config": _json(os.path.join(root, conf["file"])),
            "traffic": _json(os.path.join(HERE, "traffic",
                                          cell["traffic"] + ".json")),
            "limits": _json(os.path.join(HERE, "limits", workload + ".json")),
            "end_to_end": e2e, "per_layer": layer}


class Ctx:
    """What a per-layer reader gets: the cell's adapter object, the
    window's record, the traced slice (``trace``, ``traced``) and
    :meth:`warn` for what a reader finds wrong with its source."""

    def __init__(self, cell, window: dict):
        self.cell, self.window = cell, window
        self.trace, self.traced = None, None
        self.warnings = []

    def warn(self, msg: str) -> None:
        self.warnings.append(msg)
        print(f"portbench warning: {msg}", file=sys.stderr, flush=True)


@contextlib.contextmanager
def _no_span(name):
    del name
    yield


def run_loop(cell, traffic: dict, k: int, seconds: float, spans=False):
    """The closed loop from update ``k`` until ``seconds`` have passed,
    then until the device is done. Returns (next k, updates, query
    latencies in seconds, wall seconds)."""
    span = torch.profiler.record_function if spans else _no_span
    n = cell.n
    per_pass = traffic["session"] == "pass"
    every = int(traffic.get("query_every", 0))
    lat, updates = [], 0
    t0 = time.perf_counter()
    while True:
        if per_pass and k % n == 0:
            with span("portbench.session"):
                cell.start_session(k // n)
        with span("portbench.update"):
            cell.update(k)
        k += 1
        updates += 1
        if every and k % every == 0:
            tq = time.perf_counter()
            with span("portbench.query"):
                cell.query(k - 1)
            lat.append(time.perf_counter() - tq)
        if time.perf_counter() - t0 >= seconds:
            break
    cell.sync()
    return k, updates, lat, time.perf_counter() - t0


def end_to_end(setup_s: float, window: dict) -> dict:
    out = {"setup_s": setup_s,
           "updates_hz": window["updates"] / window["seconds"]}
    lat = window["latencies"]
    if lat:
        out["query_p50_ms"] = 1e3 * statistics.median(lat)
        out["query_p95_ms"] = 1e3 * (statistics.quantiles(lat, n=20)[18]
                                     if len(lat) > 1 else lat[0])
    return out


def launch_counts() -> dict:
    from erl_gaussian_process_tpu_torch.ops import launch_counts as counts
    return counts()


def traced_slice(cell, traffic: dict, k: int, ctx: Ctx) -> None:
    """TRACE_SECONDS more of the loop under ``torch.profiler``, the cell
    recording what it did; fills ``ctx.trace`` and ``ctx.traced``."""
    from torch.profiler import ProfilerActivity, profile

    cell.recording, cell.query_log = [], []
    before = launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(tracing.WINDOW_SPAN):
            _, updates, lat, seconds = run_loop(cell, traffic, k,
                                                TRACE_SECONDS, spans=True)
    after = launch_counts()
    ctx.trace = tracing.Trace.from_profiler(prof)
    ctx.traced = {"updates": updates, "queries": len(lat), "latencies": lat,
                  "seconds": seconds,
                  "launches": {w: after[w] - before[w] for w in after}}


def warm_host_allocator() -> None:
    """Bring glibc's malloc to the state a long-running process is in.
    It serves blocks above its mmap threshold (128 KiB at start) from fresh
    mappings, which fault in page by page on every use, and raises the
    threshold (and the heap's trim threshold with it) when such a block is
    freed. Freeing one 16 MiB block puts every later block under 16 MiB on
    the heap, whose pages stay mapped: the routed test's per-query arrays
    no longer fault (on an H100 machine its median query went from ~16 to
    ~10 ms)."""
    import numpy as np

    block = np.ones(16 * 2**20 // 8)
    del block


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             t0: float, cache_dir: str = CACHE, control: bool = False) -> dict:
    """One run. Returns the result line's fields plus ``checks`` (each
    number compared with its limit) and, with ``control``, the control's
    numbers (``control_numbers``) and the adapter's diagnostics
    (``diagnostics``, where it has them)."""
    cfg, traffic = spec["config"], spec["traffic"]
    adapter = importlib.import_module(f"portbench.adapters.{cfg['adapter']}")
    readers = {m["name"]: load_file_module(
        os.path.join(HERE, "metrics", m["name"] + ".py"),
        "portbench_metric_" + m["name"].replace(".", "_"))
        for m in spec["per_layer"]}
    device = torch.device(device)
    warm_host_allocator()
    if device.type == "cuda":
        from erl_gaussian_process_tpu_torch.ops._build import load_library
        load_library()
    cell = adapter.Cell(cfg, traffic, seed, device, ROOT, cache_dir)
    if traffic["session"] == "run":
        cell.start_session(0)
    cell.warm()
    setup_s = time.perf_counter() - t0
    window = {"updates": 0, "seconds": 0.0, "latencies": []}
    ctx = Ctx(cell, window)
    for r in readers.values():
        if hasattr(r, "install"):
            r.install(ctx)
    failed = 0
    try:
        k, window["updates"], window["latencies"], window["seconds"] = \
            run_loop(cell, traffic, 0, seconds)
        if trace:
            traced_slice(cell, traffic, k, ctx)
    except Exception:   # a failed call ends the run, reported below
        traceback.print_exc()
        failed = 1
    attempted = window["updates"] + len(window["latencies"]) + failed
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    metrics = {}
    if not failed:
        if trace:
            units = {m["name"]: m["unit"] for m in spec["per_layer"]}
            for name, r in readers.items():
                v = r.read(ctx)
                if v is not None:
                    metrics[name] = {"value": v, "unit": units[name]}
        else:
            e2e = end_to_end(setup_s, window)
            metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                       for m in spec["end_to_end"] if m["name"] in e2e}
    for r in readers.values():
        if hasattr(r, "uninstall"):
            r.uninstall(ctx)
    out = {"attempted": attempted, "failed": failed, "metrics": metrics,
           "memory_peak_bytes": int(peak), "warnings": ctx.warnings}
    if trace and ctx.trace is not None:
        out["busy_s"], out["window_s"] = ctx.trace.busy_s, ctx.trace.window_s
        out["breakdown"] = {"device_ops": ctx.trace.device_ops(),
                            "idle_gaps": ctx.trace.idle_gaps()}
    checks, correct = {}, False
    if not failed:
        got = cell.collect()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        nums = cell.check(got)
        limits = spec["limits"]
        checks = {name: {"value": v, "limit": limits.get(name)}
                  for name, v in nums.items()}
        correct = all(c["limit"] is not None and math.isfinite(c["value"])
                      and c["value"] <= c["limit"] for c in checks.values())
        if control:
            out["control_numbers"] = cell.check(got, control=True)
            if hasattr(cell, "diagnose"):
                out["diagnostics"] = cell.diagnose(got)
    out["correct"], out["checks"] = correct, checks
    return out
