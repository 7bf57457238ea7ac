"""A run of each cell, at a CPU test's size, with the timed path broken
underneath: the check has to come out not correct for each fault the cell
can have (a step that leaves its state unchanged, half the batch left out,
an answer altered where it is produced), and correct unbroken. The look
for a card is skipped: the harness runs on the CPU here. The cells run on
one card, so none has an exchange between cards to leave out."""

import time

import pytest
import torch

from erl_gaussian_process_tpu_torch.models import range_sensor_gp_3d as rsgp
from erl_gaussian_process_tpu_torch.models import spgp_occupancy_map as som
from portbench import harness


def _run(tiny, workload):
    spec, cache = tiny(workload)
    return harness.run_cell(spec, 4_000_000_123, 0.3, False, "cpu",
                            time.perf_counter(), cache_dir=cache)


def _map_unchanged(mp):
    mp.setattr(som, "spgp_update", lambda state, *a, **k: state)


def _map_half_batch(mp):
    real = som.spgp_update

    def half(state, x, y, var, mask, *a, **k):
        mask = mask.clone()
        mask[::2] = False
        return real(state, x, y, var, mask, *a, **k)
    mp.setattr(som, "spgp_update", half)


def _map_sample_dropped(mp):
    real = som.sample_pose

    def drop(*a, **k):
        pts, y, var, mask = real(*a, **k)
        mask = mask.clone()
        mask[int(torch.nonzero(mask)[0])] = False
        return pts, y, var, mask
    mp.setattr(som, "sample_pose", drop)


def _bank_unchanged(mp):
    """Each train leaves the bank it found: the one of the scan before."""
    real = rsgp.RangeSensorGaussianProcess3D._fit_scans
    before = {}

    def stale(self, *a, **k):
        fresh = real(self, *a, **k)
        out = before.get("bank", fresh)
        before["bank"] = fresh
        return out
    mp.setattr(rsgp.RangeSensorGaussianProcess3D, "_fit_scans", stale)


def _bank_half_batch(mp):
    real = rsgp.bank_fit_core

    def half(x, y, var, mask, *a, **k):
        mask = mask.clone()
        mask[::2] = False
        return real(x, y, var, mask, *a, **k)
    mp.setattr(rsgp, "bank_fit_core", half)


def _bank_alpha_altered(mp):
    real = rsgp.bank_fit_core

    def altered(*a, **k):
        bank = real(*a, **k)
        j = int(torch.nonzero(bank.trained)[0])
        alpha = bank.alpha.clone()
        alpha[j] *= 1.1
        return bank._replace(alpha=alpha)
    mp.setattr(rsgp, "bank_fit_core", altered)


def _range_altered(mp):
    real = rsgp.RangeSensorGP3DTestResult.get_mean

    def altered(self, *a, **k):
        r, ok = real(self, *a, **k)
        r = r.copy()
        r[ok.argmax()] *= 1.1
        return r, ok
    mp.setattr(rsgp.RangeSensorGP3DTestResult, "get_mean", altered)


FAULTS = {
    "hotel0.stream": [_map_unchanged, _map_half_batch, _map_sample_dropped],
    "lidar3d.train": [_bank_unchanged, _bank_half_batch, _bank_alpha_altered],
    "lidar3d.query": [_bank_unchanged, _bank_half_batch, _bank_alpha_altered,
                      _range_altered],
}
CASES = [(w, f) for w, fs in FAULTS.items() for f in fs]


@pytest.mark.parametrize("workload", sorted(FAULTS))
def test_unbroken_run_is_correct(tiny, workload):
    out = _run(tiny, workload)
    assert out["failed"] == 0 and out["correct"], out["checks"]


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{w}-{f.__name__[1:]}" for w, f in CASES])
def test_broken_run_is_not_correct(tiny, monkeypatch, workload, fault):
    fault(monkeypatch)
    out = _run(tiny, workload)
    assert out["failed"] == 0 and not out["correct"], out["checks"]
