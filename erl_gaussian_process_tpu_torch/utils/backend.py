"""Deadline-bounded CUDA initialization (counterpart of
``erl_gaussian_process_tpu/utils/backend.py``).

A machine whose card is missing, wedged or held by a dead process can make
the first CUDA call of a process fail slowly or never return. Entry points
that need the card (``chip_smoke.py``, a benchmark) probe through here
first, so that "no usable card" is a fast, classifiable error instead of a
hang or a long traceback. There is no CPU fallback: the port's entry points
run on the card unless the caller asks for the CPU.

The probe initializes CUDA, launches one tiny op on ``cuda:0`` and waits
for it, in a daemon thread under a deadline. A thread that times out stays
parked inside the CUDA driver, where it can hold the driver's lock, so
every later CUDA call of the same process may block on it: a caller that
goes on in the same process after a failed probe probes with
:func:`probe_backend_subprocess` instead, and a caller of
:func:`probe_backend` exits when it fails (``os._exit`` skips the parked
thread).
"""

from __future__ import annotations

import threading
from typing import Tuple

PLATFORM = "gpu"


def _probe() -> None:
    """Initialize CUDA, add on ``cuda:0`` and wait; raises on failure."""
    import torch

    torch.cuda.init()
    if torch.cuda.device_count() < 1:
        raise RuntimeError("no CUDA device")
    x = torch.ones(8, device="cuda:0")
    if float((x + x).sum()) != 16.0:
        raise RuntimeError("cuda:0 added 8 ones wrong")
    torch.cuda.synchronize(0)


# a child interpreter runs _probe from this file alone: it imports torch,
# not the package
_CHILD = """
import importlib.util
spec = importlib.util.spec_from_file_location("backend", {path!r})
module = importlib.util.module_from_spec(spec)
spec.loader.exec_module(module)
module._probe()
"""


def _timeout_reason(timeout_s: float) -> str:
    return f"CUDA init exceeded {timeout_s:g}s (card wedged or held?)"


def probe_backend(timeout_s: float = 55.0) -> Tuple[bool, str]:
    """Initialize CUDA and run one op on ``cuda:0`` under a deadline.

    Returns ``(True, "gpu")`` on success, ``(False, reason)`` without a
    card, on a CUDA error or on timeout."""
    out = {}

    def probe():
        try:
            _probe()
            out["ok"] = True
        except Exception as e:  # no card, driver or runtime error
            out["err"] = f"{type(e).__name__}: {e}"

    t = threading.Thread(target=probe, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        return False, _timeout_reason(timeout_s)
    if "err" in out:
        return False, out["err"]
    return True, PLATFORM


def probe_backend_subprocess(timeout_s: float = 55.0) -> Tuple[bool, str]:
    """Like :func:`probe_backend`, but in a child ``python -c`` that
    imports only torch, so that a probe that hangs leaves nothing parked
    in this process: for callers that go on in the same process whatever
    the answer."""
    import subprocess
    import sys

    child = [sys.executable, "-c", _CHILD.format(path=__file__)]
    try:
        r = subprocess.run(child, capture_output=True, timeout=timeout_s,
                           text=True)
    except subprocess.TimeoutExpired:
        return False, _timeout_reason(timeout_s)
    if r.returncode != 0:
        tail = (r.stderr or "").strip().splitlines()
        return False, tail[-1] if tail else f"probe exited rc={r.returncode}"
    return True, PLATFORM


def require_backend(timeout_s: float = 55.0) -> str:
    """Probe the card; raise ``RuntimeError`` (fast) instead of hanging
    when it is unusable. Returns the platform name, ``"gpu"``."""
    ok, info = probe_backend(timeout_s)
    if not ok:
        raise RuntimeError(
            f"CUDA unavailable — failing fast instead of hanging: {info}")
    return info
