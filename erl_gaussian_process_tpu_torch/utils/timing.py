"""Phase timers (counterpart of ``erl_gaussian_process_tpu/utils/timing.py``:
the reference's ERL_BLOCK_TIMER scopes and ``ReportTime`` helper), and the
program's spans and counters.

PyTorch launches CUDA work asynchronously, so every timer here waits for
the card before it reads a clock: :class:`BlockTimer` synchronizes the
current CUDA device when one is in use, and :func:`report_time` times each
call with CUDA events once CUDA is in use.

:func:`span` and :func:`count` wait for nothing. A span is a host range
on the profiler's clock, the one the card's kernels and copies are traced
on, opened only while a profiler records (``torch.profiler.profile``,
:class:`trace` with a ``log_dir``, ``torch.autograd.profiler.emit_nvtx``);
otherwise it is one shared no-op context, so a closed span costs a flag
test. An open span is torch's ``_RecordFunctionFast`` (a
``RecordFunction`` without ``torch.profiler.record_function``'s
dispatcher calls, several times cheaper under a profiler). A span's
parent is the span open around it on the same thread. Counters are plain
numbers in one dict, always on.

The JAX module's ``warn_if_x64_disabled`` has no counterpart: torch has no
x64 switch, a float64 tensor is float64.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Callable

import torch
from torch.autograd import profiler as _profiler

logger = logging.getLogger("erl_gaussian_process_tpu_torch")

_NO_SPAN = contextlib.nullcontext()
_RANGE = torch._C._profiler._RecordFunctionFast
_COUNTERS: dict = {}


def span(name: str):
    """``with span("egp.layer.phase"): ...``: the block as a host range
    named ``name`` in the trace of a profiler that is recording, else
    nothing (see the module docstring)."""
    if _profiler._is_profiler_enabled:
        return _RANGE(name)
    return _NO_SPAN


def count(name: str, n=1) -> None:
    """Add ``n`` (an int, or a float such as milliseconds) to the counter
    ``name``."""
    _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def counters() -> dict:
    """A copy of every counter: name -> the sum counted since the process
    started or :func:`reset_counters`."""
    return dict(_COUNTERS)


def reset_counters() -> None:
    _COUNTERS.clear()


def _leaves(tree):
    """The tensors (and arrays) of a nested tuple/list/dict/NamedTuple."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def block_until_ready(tree):
    """Wait for the CUDA work that produced ``tree``'s tensors (a
    ``torch.cuda.synchronize`` of each device they lie on); return
    ``tree``."""
    devices = {x.device for x in _leaves(tree)
               if isinstance(x, torch.Tensor) and x.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return tree


class BlockTimer:
    """``with BlockTimer("msg") as t: ...``: wall time of the block in
    ``t.elapsed`` (seconds), logged at INFO. On entry and exit it
    synchronizes the current CUDA device when CUDA is initialized, so the
    block's queued kernels count toward it."""

    def __init__(self, msg: str, log=True):
        self.msg = msg
        self.log = log
        self.elapsed = 0.0

    @staticmethod
    def _sync():
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def __enter__(self):
        self._sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.elapsed = time.perf_counter() - self.t0
        if self.log:
            logger.info("%s: %.3f ms", self.msg, self.elapsed * 1e3)
        return False


class trace:
    """Profiler scope: a :class:`BlockTimer`, and with ``log_dir`` a
    ``torch.profiler`` trace of the block (CPU, plus CUDA when available)
    written as a Chrome trace to ``log_dir/trace.json`` (``chrome://tracing``
    or Perfetto open it). The program's spans (:func:`span`, ``egp.*``)
    appear in it as host ranges, beside the operators and kernels they
    enclose."""

    def __init__(self, log_dir: str | None = None, msg: str = "trace"):
        self.log_dir = log_dir
        self.timer = BlockTimer(msg)
        self._prof = None
        self.path = None

    def __enter__(self):
        if self.log_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        self.timer.__enter__()
        return self

    def __exit__(self, *exc):
        out = self.timer.__exit__(*exc)
        if self._prof is not None:
            import os

            self._prof.__exit__(*exc)
            os.makedirs(self.log_dir, exist_ok=True)
            self.path = os.path.join(self.log_dir, "trace.json")
            self._prof.export_chrome_trace(self.path)
        return out


def memory_usage(state) -> int:
    """Total bytes of all tensors and arrays in a model state (a nested
    NamedTuple, tuple, list or dict), as the JAX module counts its
    pytree's leaves."""
    total = 0
    for x in _leaves(state):
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        else:
            total += getattr(x, "nbytes", 0)
    return total


def report_time(name: str, repeats: int, fn: Callable, *args, warmup: int = 1,
                **kwargs):
    """Run ``fn`` ``warmup`` times, then ``repeats`` timed times; returns
    (mean_s, min_s). Once CUDA is in use each call is timed with CUDA
    events recorded around it on the current stream (the time from the
    first to the last of its queued work), else with the host clock."""
    for _ in range(warmup):
        block_until_ready(fn(*args, **kwargs))
    events = torch.cuda.is_available() and torch.cuda.is_initialized()
    times = []
    for _ in range(repeats):
        if events:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            block_until_ready(out)
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3)
        else:
            t0 = time.perf_counter()
            block_until_ready(fn(*args, **kwargs))
            times.append(time.perf_counter() - t0)
    mean_s = sum(times) / len(times)
    logger.info("%s: mean %.3f ms, min %.3f ms over %d runs",
                name, mean_s * 1e3, min(times) * 1e3, repeats)
    return mean_s, min(times)
