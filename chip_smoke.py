#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each a hard failure (non-zero exit, no result line) when it fails:

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
2. the build: nvcc compiles ``erl_gaussian_process_tpu_torch/csrc`` into one
   library (first use, into ``erl_gaussian_process_tpu_torch/_build/``);
3. every kernel against its plain PyTorch version on the card, at the main
   path's shapes, with kernel and plain times (CUDA events, median of 20);
4. the slice: the 983-pose replica-hotel-0 replay at full width (1089
   pseudo points padded to 1152, 384 rays, 2048-sample budget, float32)
   through ``SpGpOccupancyMap`` on the card — once pose by pose through
   ``update``, once through ``update_batch(collect_datasets=True)`` — then
   ``predict`` with the map-quality gates (surface > 0.9 occupied,
   trajectory > 0.95 free);
5. the launch counts of that run: one FITC launch per pose update and at
   least one gram launch;
6. the drift check: the collected datasets replayed through the port's
   plain float64 path, posterior drift on the fixed query grid <= 0.2.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits non-zero before doing anything.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

DRIFT_GATE_MAX = 0.2
REPS = 20
# gram: max abs error; FITC: relative to max |result|, at the variance
# given (float32 at 0.1: the 1/(lambda + var) amplification of float32
# rounding at the main path's 1e-4 makes a pointwise check meaningless)
GRAM_TOL = {torch.float32: 1e-6, torch.float64: 1e-12}
FITC_TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
FITC_VAR = {torch.float64: 1e-4, torch.float32: 0.1}
MIXTURE = ("matern32", 1.5, (1.0, 2.0, 0.5))


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=REPS) -> float:
    """Median milliseconds of ``fn()`` on the card, each rep between two
    CUDA events, after three warm-up calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def check_kernels(dev, setting, pseudo, lo, hi, sensors, pts, masks):
    """Phase 3: each kernel against its plain version at the main path's
    shapes. Returns {name: {max_abs_err, ms, plain_ms}}."""
    from erl_gaussian_process_tpu_torch.kernels import register_scale_mixture
    from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
        pad_pseudo_points,
        spgp_init,
    )
    from erl_gaussian_process_tpu_torch.models.spgp_occupancy_map import (
        sample_pose,
        step_seed,
    )
    from erl_gaussian_process_tpu_torch.ops import (
        cross_gram_cuda,
        cross_gram_plain,
        fitc_update_cuda,
        fitc_update_plain,
    )

    scale = float(setting.sp_gp.kernel.scale)
    m_valid = pseudo.shape[1]
    p_pad = pad_pseudo_points(np.ascontiguousarray(pseudo.T))   # (1152, 3)
    rng = np.random.default_rng(0)
    xq = rng.uniform(lo, hi, (2048, 3))
    mix = register_scale_mixture(*MIXTURE)
    out = {}

    # gram: predict's k(P, x*) at (1152, 2048, d=3)
    gram_err32 = 0.0
    for dt in (torch.float32, torch.float64):
        P = torch.as_tensor(p_pad, device=dev, dtype=dt)
        X = torch.as_tensor(xq, device=dev, dtype=dt)
        for name in ("rbf", "ou", "matern32", mix):
            k = cross_gram_cuda(name, P, X, scale)
            torch.cuda.synchronize()
            ref = cross_gram_plain(name, P, X, scale)
            err = float((k - ref).abs().max())
            tol = GRAM_TOL[dt]
            log(f"gram {name:28s} {str(dt):14s} shape {tuple(k.shape)} "
                f"max_abs_err {err:.3e} (tol {tol:g})")
            check(err <= tol, f"gram {name} {dt} error {err} > {tol}")
            check(bool((k[m_valid:] == 0).all()),
                  f"gram {name} {dt}: far-point rows not exactly 0")
            if dt == torch.float32:
                gram_err32 = max(gram_err32, err)
    P32 = torch.as_tensor(p_pad, device=dev, dtype=torch.float32)
    X32 = torch.as_tensor(xq, device=dev, dtype=torch.float32)
    out["gram"] = {
        "max_abs_err": gram_err32,
        "ms": cuda_ms(lambda: cross_gram_cuda("matern32", P32, X32, scale)),
        "plain_ms": cuda_ms(
            lambda: cross_gram_plain("matern32", P32, X32, scale)),
    }

    # FITC at M=1152, N=2048: pose 0's sampled dataset
    s = setting
    fitc_err32 = 0.0
    fitc_args = {}
    for dt in (torch.float64, torch.float32):
        st = spgp_init(torch.as_tensor(p_pad, device=dev, dtype=dt), scale,
                       kernel="matern32")
        g = torch.Generator(device=dev)
        g.manual_seed(step_seed(0, 1))
        x, y, _, mask = sample_pose(
            torch.as_tensor(sensors[0], device=dev, dtype=dt),
            torch.as_tensor(pts[0], device=dev, dtype=dt),
            torch.as_tensor(masks[0], device=dev),
            torch.as_tensor(lo, device=dev, dtype=dt),
            torch.as_tensor(hi, device=dev, dtype=dt),
            free_slots=12, max_samples=int(s.sp_gp.max_num_samples),
            min_distance=s.min_distance, max_distance=s.max_distance,
            free_sampling_margin=s.free_sampling_margin,
            free_points_per_meter=s.free_points_per_meter,
            logodd_occupied=s.logodd_occupied, logodd_free=s.logodd_free,
            logodd_variance=s.logodd_variance, generator=g)
        for var_val in sorted({FITC_VAR[dt], s.logodd_variance}):
            var = torch.full((x.shape[0],), var_val, device=dev, dtype=dt)
            args = ("matern32", st.pseudo, st.L_inv, x, y, var, mask, scale)
            dq, da = fitc_update_cuda(*args)
            torch.cuda.synchronize()
            dq_ref, da_ref = fitc_update_plain(*args)
            rel_q = float((dq - dq_ref).abs().max() / dq_ref.abs().max())
            rel_a = float((da - da_ref).abs().max() / da_ref.abs().max())
            gated = var_val == FITC_VAR[dt]
            tol = FITC_TOL[dt]
            log(f"fitc M={dq.shape[0]} N={x.shape[0]} active "
                f"{int(mask.sum())} {str(dt):14s} var {var_val:g}: "
                f"rel_err dQ {rel_q:.3e} dalpha {rel_a:.3e} "
                f"max_abs_err dQ {float((dq - dq_ref).abs().max()):.3e}"
                + (f" (tol {tol:g})" if gated else " (reported)"))
            check(bool(torch.equal(dq, dq.T)), f"fitc {dt}: dQ not symmetric")
            check(bool((dq[m_valid:] == 0).all() and (da[m_valid:] == 0).all()),
                  f"fitc {dt}: far-point rows not exactly 0")
            if gated:
                check(rel_q <= tol and rel_a <= tol,
                      f"fitc {dt} var {var_val}: rel err {rel_q}, {rel_a} > "
                      f"{tol}")
            if dt == torch.float32 and gated:
                fitc_err32 = float((dq - dq_ref).abs().max())
            if dt == torch.float32 and var_val == s.logodd_variance:
                fitc_args = args
    out["fitc"] = {
        "max_abs_err": fitc_err32,
        "ms": cuda_ms(lambda: fitc_update_cuda(*fitc_args)),
        "plain_ms": cuda_ms(lambda: fitc_update_plain(*fitc_args)),
    }
    return out


def run_slice(dev, card, setting, pseudo, lo, hi, sensors, pts, masks, hits,
              traj):
    """Phases 4-6. Returns (launch counts, timings, drift results)."""
    from erl_gaussian_process_tpu_torch.geometry import Aabb
    from erl_gaussian_process_tpu_torch.models import SpGpOccupancyMap
    from erl_gaussian_process_tpu_torch.ops import (
        launch_counts,
        reset_launch_counts,
    )
    from erl_gaussian_process_tpu_torch.utils.drift import (
        drift_metric,
        replay_f64,
        sign_agreement,
    )
    from erl_gaussian_process_tpu_torch.workloads import (
        FREE_SLOTS_PER_RAY,
        hotel0_query_grid,
    )

    box = Aabb.from_min_max(lo, hi)

    def new_map():
        return SpGpOccupancyMap(setting, pseudo, box, seed=0,
                                dtype=torch.float32,
                                free_slots_per_ray=FREE_SLOTS_PER_RAY,
                                device=dev)

    b = len(sensors)
    # warm-up (library handles, allocator): not part of the counted run
    warm = new_map()
    for i in range(2):
        warm.update(sensors[i], pts[i], masks[i])
    warm.predict(traj[:8])
    torch.cuda.synchronize()

    reset_launch_counts()
    seq = new_map()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(b):
        seq.update(sensors[i], pts[i], masks[i])
    torch.cuda.synchronize()
    t_seq = time.perf_counter() - t0

    bat = new_map()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_used, (dx, dy, dm) = bat.update_batch(sensors, pts, masks,
                                            collect_datasets=True)
    torch.cuda.synchronize()
    t_bat = time.perf_counter() - t0
    check(bool(torch.equal(seq.state.qm, bat.state.qm)
               and torch.equal(seq.state.alpha, bat.state.alpha)),
          "update_batch state differs from the pose-by-pose state")

    rng = np.random.default_rng(0)
    sel = hits[rng.choice(len(hits), min(2000, len(hits)), replace=False)]
    fracs = {}
    t_predict = {}
    for tag, omap in (("update", seq), ("update_batch", bat)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lo_surf, _ = omap.predict(sel.astype(np.float32))
        torch.cuda.synchronize()
        t_predict[tag] = time.perf_counter() - t0
        lo_traj, _ = omap.predict(traj)
        surf = float((lo_surf > 0).float().mean())
        free = float((lo_traj < 0).float().mean())
        fracs[tag] = (surf, free)
        log(f"quality [{tag}]: surface occupied {surf:.4f} (gate > 0.9), "
            f"trajectory free {free:.4f} (gate > 0.95)")
        check(surf > 0.9 and free > 0.95,
              f"hotel-0 quality gate [{tag}]: surf {surf} free {free}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bat.predict(sel.astype(np.float32))
    torch.cuda.synchronize()
    t_predict_cached = time.perf_counter() - t0
    counts = launch_counts()
    log(f"launch counts of the main-path run: {counts} "
        f"({2 * b} pose updates)")
    check(counts["fitc"] == 2 * b,
          f"fitc launches {counts['fitc']} != pose updates {2 * b}")
    check(counts["gram"] > 0, "gram kernel never launched by predict")
    check(int(n_used.sum()) == int(dm.sum()), "collected masks != n_used")

    grid = hotel0_query_grid(lo, hi)
    lo32, _ = bat.predict(grid)
    lo32 = lo32.cpu().numpy()
    t0 = time.perf_counter()
    lo64 = replay_f64(np.ascontiguousarray(pseudo.T), setting.sp_gp.kernel.scale,
                      bat.sp_gp._kernel, dx, dy, dm, setting.logodd_variance,
                      grid, device=dev)
    t_replay64 = time.perf_counter() - t0
    drift = drift_metric(lo32, lo64)
    agree = sign_agreement(lo32, lo64)
    log(f"drift vs plain f64 replay on {grid.shape[0]} grid cells: "
        f"{drift:.6e} (gate <= {DRIFT_GATE_MAX}); confident-cell sign "
        f"agreement {agree:.6f}; f64 replay {t_replay64:.3f} s")
    check(np.isfinite(lo32).all() and drift <= DRIFT_GATE_MAX,
          f"drift {drift} > {DRIFT_GATE_MAX}")
    timings = {
        "update_ms_per_pose": 1e3 * t_seq / b,
        "replay_updates_per_s": b / t_bat,
        "predict_ms_first": 1e3 * t_predict["update_batch"],
        "predict_ms_cached": 1e3 * t_predict_cached,
        "n_predict": int(len(sel)),
    }
    log(f"times on {card}: update {timings['update_ms_per_pose']:.4f} "
        f"ms/pose; update_batch {timings['replay_updates_per_s']:.2f} "
        f"updates/s; predict of {len(sel)} points "
        f"{timings['predict_ms_first']:.3f} ms with prepare, "
        f"{timings['predict_ms_cached']:.3f} ms cached")
    return counts, timings, {"drift": drift, "sign_agreement": agree,
                             "quality": fracs}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from erl_gaussian_process_tpu_torch.models.gp_core import (
        use_full_fp32_matmul,
    )
    from erl_gaussian_process_tpu_torch.ops._build import load_library
    from erl_gaussian_process_tpu_torch.workloads import hotel0_workload

    use_full_fp32_matmul()
    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    kl = load_library()
    log(f"build: {kl.path} compiled in {kl.seconds:.2f} s "
        f"(load {time.perf_counter() - t0:.2f} s)")
    for line in kl.log.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

    t0 = time.perf_counter()
    sensors, pts, masks, hits, traj, setting, pseudo, lo, hi = \
        hotel0_workload()
    log(f"workload: {len(sensors)} poses, {pts.shape[1]} rays, "
        f"{pseudo.shape[1]} pseudo points, scanned in "
        f"{time.perf_counter() - t0:.2f} s")

    kern = check_kernels(dev, setting, pseudo, lo, hi, sensors, pts, masks)
    for name, r in kern.items():
        log(f"time on {card}: {name} kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms (median of {REPS})")

    counts, timings, drift = run_slice(dev, card, setting, pseudo, lo, hi,
                                       sensors, pts, masks, hits, traj)
    log(json.dumps({"timings": timings, "drift": drift["drift"],
                    "sign_agreement": drift["sign_agreement"],
                    "card": card}))
    src = {"gram": ("erl_gaussian_process_tpu_torch/csrc/gram.cu",
                    "erl_gaussian_process_tpu/ops/pallas_gram.py:92"),
           "fitc": ("erl_gaussian_process_tpu_torch/csrc/fitc.cu",
                    "erl_gaussian_process_tpu/ops/pallas_fitc.py:145")}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src[name][0],
         "replaces": src[name][1], "launches": counts[name],
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"]} for name in ("fitc", "gram")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
