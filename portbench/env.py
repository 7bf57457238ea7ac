"""The process environment of a benchmark run, set before numpy or torch
is imported (``run.py`` and ``readings.py`` call :func:`setup` first).

- Build and kernel caches at fixed paths inside the checkout, so that
  only a checkout's first run builds.
- One host thread for the math libraries: the program's host work is one
  thread's, and idle pool threads that spin on a shared host spread the
  host-bound cells' runs.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "portbench", ".cache")


def setup() -> None:
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
