"""The port's deadline-bounded CUDA probe (``utils/backend.py``, the
counterpart of the JAX package's ``utils/backend.py``) where there is no
card: every probe answers ``(False, reason)`` fast, ``require_backend``
raises, and a CUDA init that never returns costs the thread probe its
deadline, not a hang. The card's case is in ``tests/test_torch_cuda.py``."""

import ast
import threading
import time

import pytest
import torch

from erl_gaussian_process_tpu_torch.utils import backend


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card answers the probe: tests/test_torch_cuda.py "
                    "holds that case")


def test_probe_without_a_card_fails_fast(no_card):
    t0 = time.perf_counter()
    ok, reason = backend.probe_backend(5.0)
    assert time.perf_counter() - t0 < 5.0
    assert ok is False and reason


def test_require_backend_raises(no_card):
    with pytest.raises(RuntimeError, match="CUDA unavailable"):
        backend.require_backend(5.0)


def test_probe_of_a_hung_init_returns_at_its_deadline(monkeypatch):
    release = threading.Event()
    monkeypatch.setattr(torch.cuda, "init", lambda: release.wait(30.0))
    try:
        t0 = time.perf_counter()
        ok, reason = backend.probe_backend(0.5)
        took = time.perf_counter() - t0
    finally:
        release.set()    # let the parked thread end
    assert ok is False and "exceeded" in reason, reason
    assert 0.5 <= took < 1.5, took


def test_probe_in_a_child_without_a_card(no_card):
    ok, reason = backend.probe_backend_subprocess(30.0)
    assert ok is False and reason


def test_probe_module_imports_only_torch():
    """The child interpreter runs the module from its file alone: besides
    the standard library it imports torch and nothing else."""
    with open(backend.__file__) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert names == {"__future__", "threading", "typing", "subprocess",
                     "sys", "torch"}, names
