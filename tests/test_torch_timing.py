"""The PyTorch port's timers (``erl_gaussian_process_tpu_torch/utils/
timing.py``) on the CPU: ``BlockTimer`` and ``report_time`` measure and
log, ``trace`` writes a Chrome trace file, and ``memory_usage`` equals the
JAX package's ``memory_usage`` for the same SPGP state."""

import json
import logging
import os
import time

import jax.numpy as jnp
import numpy as np
import torch

from erl_gaussian_process_tpu.models.sparse_pseudo_input_gp import (
    spgp_init as jax_spgp_init,
)
from erl_gaussian_process_tpu.utils.timing import (
    memory_usage as jax_memory_usage,
)
from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
    spgp_init,
)
from erl_gaussian_process_tpu_torch.utils.timing import (
    BlockTimer,
    memory_usage,
    report_time,
    trace,
)


def test_block_timer_measures_and_logs(caplog):
    with caplog.at_level(logging.INFO, logger="erl_gaussian_process_tpu_torch"):
        with BlockTimer("sleep") as t:
            time.sleep(0.02)
    assert 0.015 < t.elapsed < 2.0
    assert any("sleep:" in r.getMessage() for r in caplog.records)
    with BlockTimer("quiet", log=False) as t2:
        pass
    assert t2.elapsed >= 0.0


def test_report_time_on_cpu(caplog):
    calls = []

    def fn(a, b=1.0):
        calls.append(1)
        time.sleep(0.005)
        return torch.ones(3) * a * b

    with caplog.at_level(logging.INFO, logger="erl_gaussian_process_tpu_torch"):
        mean_s, min_s = report_time("fn", 3, fn, 2.0, b=3.0, warmup=2)
    assert len(calls) == 5
    assert 0.004 < min_s <= mean_s < 2.0
    assert any("fn: mean" in r.getMessage() for r in caplog.records)


def test_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "tr")
    with trace(d, msg="matmul") as tr:
        a = torch.randn(64, 64)
        (a @ a).sum()
    assert tr.path == os.path.join(d, "trace.json")
    with open(tr.path) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") or "mm" in e.get("name", "")
               for e in events)
    assert tr.timer.elapsed > 0
    with trace(None) as plain:       # no directory: the timer alone
        pass
    assert plain.path is None and plain.timer.elapsed >= 0


def test_memory_usage_equals_jax():
    for dt in (np.float32, np.float64):
        c = np.linspace(-1, 1, 6).astype(dt)
        p = np.stack(np.meshgrid(c, c, indexing="ij"), -1).reshape(-1, 2)
        js = jax_spgp_init(jnp.asarray(p), dt(0.5), kernel="rbf")
        ts = spgp_init(torch.as_tensor(p), 0.5, kernel="rbf")
        assert memory_usage(ts) == jax_memory_usage(js) > 0
    assert memory_usage({"a": [torch.zeros(3, dtype=torch.float64), None],
                         "b": np.zeros(2, np.float32)}) == 24 + 8
