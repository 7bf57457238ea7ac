#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each a hard failure (non-zero exit, no result line) when it fails.
The SPGP occupancy map's path:

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
2. the build: nvcc compiles ``erl_gaussian_process_tpu_torch/csrc`` into one
   library (first use, into ``erl_gaussian_process_tpu_torch/_build/``);
3. the gram kernel at its three path shapes, (a) the SPGP predict's
   k(P, x*) 1152 x 2048 matern32 d=3, (b) the exact GP's test k(X, X*)
   8192 x 4096 rbf d=2 with the state's train mask, (c) the lidar test's
   routed-predict bucket 688 x 100 x 128 ou d=2 with the members' masks:
   in every family at float32 and float64 against its plain version
   (masked and far-point rows exactly +0.0, two calls bitwise equal), then
   timed at float32 (CUDA-event median of 20 and range, device time by
   ``torch.profiler``, the wrapper's host time, the plain version, the
   bound); every other kernel against its plain PyTorch version on the
   card, at the main path's shapes, with kernel and plain times (CUDA
   events, median of 20; the FITC rows' over batches of 20 calls);
   at the map's variance (1e-4) the float32 FITC kernel and its plain
   version against the float64 update of the same inputs, the kernel's
   errors no worse than 2x the plain version's; FITC's two products alone
   (``torch.matmul`` on a precomputed kmn) as a note;
4. the slice: the 983-pose replica-hotel-0 replay at full width (1089
   pseudo points padded to 1152, 384 rays, 2048-sample budget, float32)
   through ``SpGpOccupancyMap`` on the card (one CUDA-graph replay a pose,
   ``models/pose_graph.py``) — once pose by pose through ``update``, once
   through ``update_batch(collect_datasets=True)`` — then ``predict`` (a
   graph replay too) with the map-quality gates (surface > 0.9 occupied,
   trajectory > 0.95 free);
5. the launch counts of that run, counted from the graphs: the FITC
   launches the replays ran (each graph's captured launches times its
   replays) equal the pose updates, and the wrappers' count is those plus
   one eager warm-up run a capture; at least one gram launch; one more
   graphed pose under ``torch.profiler``: the FITC kernels that ran equal
   its plan's (3 per call); the cached predict timed as the median of 5;
6. the drift check: the collected datasets replayed through the port's
   plain float64 path, posterior drift on the fixed query grid <= 0.2;
   then more replays of each entry for the median and range of ms/pose and
   updates/s.

The 3D range-sensor GP's path:

7. the bank kernels against their plain versions at the path's shapes
   (bank fit: the lidar protocol's 736 x 100 members in float32 and
   float64, a default-grouped 271x91 scan's 408 x 144 in float32; bank
   Cholesky: 1000 x 104; the batched gram on the operands the routed
   predict builds for the lidar and depth tests and for ``compute_occ``),
   a non-SPD member NaN in L, L^-1 and alpha with its neighbours bit for
   bit unchanged, kernel and plain times, ``torch.linalg.cholesky`` on the
   same grams as the yardstick at each float32 shape, and the bank fit at
   each members-a-block count that fits beside the plan's;
8. the lidar protocol (271x91 scan of the reference room, 10 000 sphere
   queries) through ``RangeSensorGaussianProcess3D.train``/``test`` at
   float32: one ``train`` under ``torch.profiler`` (one bank-fit launch and
   no matrix product), MSE <= 4.2e-4, ``compute_occ`` signs, one bank-fit
   launch per train; one ``test`` of the host path under
   ``torch.profiler`` (one gram launch, no ``where`` over the gram) and
   the routed test's graph (one gram launch captured); the same scan at
   the default 12/4 grouping (408 x 144); then the depth protocol: MSE <=
   2.2e-4. Each ``train`` and ``test`` on the card is one CUDA-graph
   replay (``models/sensor_graph.py``; the test routes and groups its
   queries on the device): the device-routed 10 000-query lidar test and
   the depth test against the host path (the same model's graphs set
   aside), valid flags exact, ranges and variances within
   ``ROUTED_TOL`` of their magnitude, both under the MSE gates, and
   timed beside it; against the eager chain of the same model bit for
   bit — banks, and the 2D GPs' means, variances and valid masks (the 3D
   test's within ``ROUTED_TOL``) —, train and test ms graphed and eager
   (alternated, medians of 5 with ranges), the host's CUDA API calls and
   the kernels a train, the device's idle share a train and a test, the
   eager routed predict's phase split (host grouping, copies in, device,
   copy out and scatter), each captured shape's warm-up and capture ms
   and pool MiB;
9. offline replay: ``train_scan_batch`` of 64 lidar scans (47 104 members)
   in one bank-fit launch, eager as the port runs it, equal bit for bit to
   per-scan ``train``, timed as the median of 5 after a warm-up; against a
   graph of it (its first call and its cached calls, with the copy out a
   graph needs), with train and test again as in phase 8; the same 64
   scans one by one (train, the 10 000 queries, ``compute_occ`` on the
   scan's own points) eager and graphed as shipped: the sequence's ms,
   its captures and their cost, every way equal to the eager run (bit for
   bit; the 3D test within ``ROUTED_TOL``);
10. ``BatchGPBank`` at (1000, 104): one bank-Cholesky launch, results
    against numpy float64, identity padding exact, the solve timed as the
    median of 5 after a warm-up.

The exact GPs' paths:

11. the blocked Cholesky kernels against their plain versions: the plain-A
    entry at the exact-GP gram (n = 8192, float32) and at n = 1000 float64,
    the gram-fused entry at the exact-GP shape (with masked rows), the
    joint entry at the NIGP shape (7680^2); metric the backward error
    ||L L^T - K||_max / ||K||_max, at float32 no worse than 4x the plain
    version's (cuSOLVER) on the same K, at float64 <= 1e-12; strict upper
    part exactly 0, masked rows identity, a non-SPD input NaN; the
    triangular solves (with and without the Cholesky's Dinv) by their
    residuals, no worse than 4x the plain solve's; kernel, plain and
    library times (``torch.linalg.cholesky``,
    ``torch.linalg.solve_triangular``);
11b. the whitening of many right-hand sides (``ops/trsm.py``) at the
    exact-GP cell's shape, n = 8192 against the 100 x 100 grid: the kernel,
    the 64-row loop it replaced and ``torch.linalg.solve_triangular`` timed
    beside the 3xTF32 and FP32 SIMT bounds, each one's error against the
    float64 solve; the kernel within 2x the loop's error and under the
    FP32 SIMT floor (10.0 ms);
12. the exact GP: ``VanillaGaussianProcess`` (float32) trains on 8192
    points and tests 4096 queries, each fit, test and variance query one
    replay of a CUDA graph (``models/exact_graph.py``; the first train and
    test are the captures, timed apart); mean MAE and variance max error
    against the plain float64 fit on the card no worse than 2x those of
    the plain float32 fit; one replay a train (one gram-fused Cholesky, two
    substitutions) and a test (a gram); against the eager chain of the
    same model (its graphs set aside) bit for bit, state and outputs;
    train and test ms graphed and eager (alternated, medians of 5 with
    ranges), the host's CUDA API calls, the device's busy ms and idle
    share a train and a test, the variance graph's replay alone (the
    whitening), each capture's warm-up and capture ms and pool MiB; a test
    under ``torch.profiler`` (one gram launch, no ``where`` over the
    gram, the chain run eagerly; the test graph captured one gram launch);
    then one more ``train``, its eager chain, under ``torch.profiler``:
    launches and device ms of the factorization's update, diagonal and
    apply kernels and of the substitution (one launch per direction);
13. the noisy-input GP (float32) with gradients on the 7680^2 joint system,
    mean, gradient, variance and covariance gated the same way; the same
    data with a scale mixture of rbf (whose joint gram is built outside the
    kernel and factored by the plain-A entry); each graphed against its
    eager chain as in phase 12;
14. the reference's 50x50 noisy-input golden at float64 (7500^2 joint
    system): MAE < 1.0e-5, gradient errors < 1.1e-4 / 2.6e-4; graphed
    against its eager chain as in phase 12.

The 2D paths and reduced rank:

15. the 2D map at its production config (``config/spgp_occupancy_map_2d
    .yaml``, built in code: matern32 d=2 at scale 0.18, 31x31 pseudo
    points padded to 1024, 2000 samples in a 2048 budget, var 1e-4, 135
    rays, 20 free slots a ray, float32): FITC at (1024, 2048, d=2) and the
    predict's gram against their plain versions at float32 and float64,
    the float32 FITC 2x gate against float64 at var 1e-4, times and
    bounds; the 50-pose ellipse through ``update``, then ``predict`` with
    gradients (surface > 0.9 occupied, trajectory > 0.95 free, gradients
    finite), one FITC plan's launches a pose by ``torch.profiler``,
    ms/pose as the median of 5 replays; the 200 poses of
    tests/test_long_horizon.py through the float32 ``spgp_update`` chain
    against the plain float64 replay (drift < 1e-3, sign agreement >
    0.999, mean relative error < 1e-4);
16. the 2D lidar GP (tests/test_lidar_gp_2d.py's setting): the bank fit at
    (14, 26, d=1) and the 28-scan replay's 392 members against its plain
    version at both dtypes, with ``torch.linalg.cholesky`` of the same
    grams and the bound; the batched gram on the routed test's operands
    (d=1); frame 0 of data/double/train.dat at float64 (MAE < 0.022, with
    discontinuity detection < 0.08) and of data/float/train.dat at float32
    (< 0.04), world-frame queries (< 0.022), ``compute_occ`` signs; one
    ``train`` (one bank-fit launch, no matrix product) and one ``test``
    (one gram launch) under ``torch.profiler``; the 28 scans in one
    bank-fit launch, every scan's slice bit for bit its own ``train``;
    train, test and replay as medians of 5; train, test and replay graphed
    against the eager chain as in phase 9, the 28 scans one by one as in
    phase 9 (test at the scan's angles, ``compute_occ`` at 0.5 and 1.2 of
    each hit ray's range); the 28 scans with
    ``partition_on_hit_rays`` graphed, each bit for bit the eager chain,
    with the captures that takes and their cost;
17. reduced rank: the vanilla reduced-rank GP of
    tests/test_reduced_rank.py:240-259 (2D Matérn, 16x16 basis) at float64
    and float32 against its plain version on the card, its fit under
    ``torch.profiler`` (the blocked Cholesky and one substitution a
    direction), those kernels at its (256, 256) system against their plain
    versions and the library calls; the reduced-rank lidar GP of
    tests/test_lidar_gp_2d.py:155-210 at its MAE gate (< 0.02), its graphed
    train (the well-posed chain captured, no jitter ladder run) and test
    against the eager chain as in phase 8.

The modules ported last (the native host runtime, ``poses_per_step``,
deployment, scale selection, the ops):

18. the native host runtime built with the host's C++ compiler (its build
    time), hotel-0's scans raycast natively (``main``'s workload) and
    again by the numpy raycaster, both timed, the scans equal; an ``.egpt``
    checkpoint of the hotel-0 map of phase 19 loaded with the state equal;
19. hotel-0 at ``poses_per_step`` = 4 (983 poses padded to 984, 246 FITC
    updates of N = 8192): the quality gates, Q_M and alpha against the
    c = 1 replay of the same seeds (rtol 1e-3, atol 1e-4), FITC at (1152,
    8192, d = 3) against its plain version and the float32 2x gate at var
    1e-4 against float64, FITC's launches per 4 poses by
    ``torch.profiler``, ms/pose beside c = 1 (medians of alternated
    replays);
20. the 2D map's update and predict artifacts (``utils/deploy.py``,
    ``torch.export``) exported on the card, through bytes, each call a
    CUDA-graph replay: 10 updates and a predict equal bit for bit to the
    eager step and to the loaded module's own call, the FITC and gram
    launches counted from the replays, an artifact call timed against the
    module's own call and the eager step;
21. ``select_scale_spgp`` on the 2D map's 50-pose datasets with the
    production pseudo grid through the gram kernel, its float32 NLML
    within 3e-3 (relative) of the plain float64 sweep, the chosen scale
    beside the YAML's 0.18 (reported); ``select_scale`` at the exact-GP
    cell (n = 8192, 24 candidates batched); ``fit_scale_spgp``, 80 steps;
22. the registered ops' dispatch: rows 1 and 2a beside their event
    times before the wrappers went through the ops (PERF.md §6), each op
    against its CUDA implementation called directly (event and host ms,
    alternated), and hotel-0's first 256 poses with FITC through the op
    and called directly (ms/pose, alternated replays; the pose is a graph
    replay, so the dispatcher runs only at each map's capture).

The mesh (``parallel/mesh.py``), ranks spawned by this script, each joined
within a limit (a dead rank fails the phase; its traceback is printed):

23. the kernels the mesh reaches at one rank's shapes (FITC at (1152,
    4096, d = 3) with 3 masked pad samples bit for bit the unpadded update,
    the bank fit at 368 x 100, the gram at 1152 x 1024) against their plain
    versions with times and bounds; (a) NCCL, one rank: hotel-0 pose by
    pose through ``update(mesh=)``, bit for bit phase 4's replay; (b) gloo,
    two ranks on ``cuda:0``: hotel-0 through ``update_batch(
    poses_per_step=4)`` against phase 19 (samples used equal, Q_M and
    alpha within 5e-6 relative Frobenius, the quality gates, the sharded
    predict of the drift grid within 1e-4 of the maximum of the one-rank
    predict of the same state with sign agreement > 0.999, its drift
    against phase 4's float64 replay <= 0.2); (c) gloo: the 3D lidar protocol and the 2D lidar GP with
    ``mesh=``, banks bit for bit the one-card trains', the MSE and MAE
    gates; launches a gloo rank by ``torch.profiler`` (FITC a chunk, a bank
    fit a train, grams a predict); ms/pose beside phases 4 and 19, the
    all_reduce's ms an update, the time to spawn and initialise.

The map's CUDA graphs (``models/pose_graph.py``):

24. each against the eager functional chain (``update_batch_steps``, the
    same kernels launched one by one) bit for bit — Q_M, alpha, both Kahan
    terms and the samples used: hotel-0's 983 poses through ``update``
    (phase 4's replay) and through ``update_batch``, at ``poses_per_step``
    = 4 (phase 19's replay), the 2D map's 50 poses through ``update``; the
    graphed predict of 2000 hotel-0 points and of the 2D map's surface,
    with and without the gradient, against the eager predict of the same
    prepare; the quality gates on the graphed ``update_batch`` map; one
    graphed pose under ``torch.cuda.set_sync_debug_mode("error")``; 16
    graphed poses under ``torch.profiler`` (FITC's kernels 3 a pose, the
    host's CUDA API calls a pose beside the eager chain's, device ms a
    pose); ms/pose graphed (after the capture) and eager, the device's
    idle share, the cached predict graphed and eager; each captured
    shape's warm-up and capture ms and pool memory; the four example
    scripts (``erl_gaussian_process_tpu_torch/examples/``) at their smoke
    sizes on the card, exit 0.

The surface the port took over from the JAX package last:

25. each name called once on the card: ``kernels.pairwise_dist`` at
    float32 and float64 against its CPU result (8 ulps of the largest
    distance); ``models.spgp_init`` and ``models.spgp_update`` at hotel-0's
    width (M = 1152, N = 2048, var 0.1), one FITC launch, against the same
    call on CPU tensors (the plain FITC; FITC_TOL of the increment);
    ``fitc_delta(reduce=)`` bit for bit the products wrapped; the SPGP's
    ``update`` and getters with ``parallel=True`` bit for bit the calls
    without; ``models.vanilla_fit`` (n = 1024) and ``models.nigp_fit``
    (n = 256 with gradients) at float64, one gram-fused and one joint
    Cholesky launch, within 1e-10 of their CPU fits; a graphed hotel-0
    map's ``predict`` and ``predict_gradient`` with ``parallel=True`` bit
    for bit the calls without, through the same two graphs; the host's
    ``Aabb.contains``, ``TriangleMesh.box(inward=True)``,
    ``surface_points``, ``is_mixture_setting`` and ``kernel_names``; the
    phase's wall time beside the card's name and power limit.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. ``main`` starts with
``utils/backend.require_backend`` (CUDA initialized and one op run on
``cuda:0`` under a deadline): without a usable card the script exits 2
before doing anything.
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
# more hotel-0 replays of each entry after the counted one, for the median
# and range of ms/pose and updates/s (the pose is host-bound)
TIMING_REPLAYS = 4
# gram: max abs error; FITC: relative to max |result|, at the variance
# given (float32 at 0.1: the 1/(lambda + var) amplification of float32
# rounding at the main path's 1e-4 makes a pointwise check against the
# float32 plain version meaningless; at 1e-4 both are held against the
# float64 truth instead, fitc_against_truth)
GRAM_TOL = {torch.float32: 1e-6, torch.float64: 1e-12}
FITC_TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
FITC_VAR = {torch.float64: 1e-4, torch.float32: 0.1}
MIXTURE = ("matern32", 1.5, (1.0, 2.0, 0.5))
# bank kernels vs plain (the JAX package's bank parity tolerances): L's
# lower triangle and ||L^{-1} L - I|| absolute, alpha relative to max|alpha|
BANK_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
BANK_CHOL_ALPHA_TOL = {torch.float32: 1e-3, torch.float64: 1e-10}
LIDAR_MSE_GATE = 4.2e-4
DEPTH_MSE_GATE = 2.2e-4
# the device-routed test against the host path, of each result's
# magnitude, by the model's dtype (tests/test_torch_routed_chunks.py's
# TOL): its rows have another shape than the host's bucket, so its
# products may round otherwise
ROUTED_TOL = {np.dtype(np.float32): 1e-4, np.dtype(np.float64): 1e-12}
SENSOR_REPS = 10
REPLAY_SCANS = 64
# timed runs of the replay and of BatchGPBank.solve after a warm-up, for
# their median and range
TIMED_RUNS = 5
# compute_occ's points: each ray at these fractions of its measured range
OCC_FRACTIONS = (0.6, 1.3)


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_times(fn, reps=REPS) -> list:
    """Milliseconds of ``fn()`` on the card, each rep between two CUDA
    events, after three warm-up calls."""
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
    return times


def cuda_ms(fn, reps=REPS) -> float:
    """Median of :func:`event_times`."""
    return statistics.median(event_times(fn, reps))


BATCH = 20  # calls between two CUDA events in batch_ms


def batch_ms(fn, batch=BATCH, reps=REPS) -> float:
    """Milliseconds a call of ``fn()`` takes on the card when calls follow
    one another: :func:`cuda_ms` of ``batch`` calls in a row, divided by
    ``batch``, so that the host's time to launch a call overlaps the card's
    work on the calls before it (a single call between two events also
    times the host's launch of that call)."""
    return cuda_ms(lambda: [fn() for _ in range(batch)], reps) / batch


def host_ms(fn, calls=200) -> float:
    """Milliseconds of the host a call of ``fn()`` takes to enqueue its
    work: ``calls`` calls with no synchronize between them (few enough that
    the launch queue never fills), then one synchronize outside the
    window."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / calls


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def check_kernels(dev, setting, pseudo, lo, hi, sensors, pts, masks):
    """Phase 3: the FITC kernel against its plain version at the main
    path's shapes (the gram: :func:`check_gram`). Returns {name:
    {max_abs_err, ms, plain_ms}}."""
    from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
        pad_pseudo_points,
        spgp_init,
    )
    from erl_gaussian_process_tpu_torch.models.spgp_occupancy_map import (
        sample_pose,
        step_seed,
    )
    from erl_gaussian_process_tpu_torch.ops import (
        cross_gram_plain,
        fitc_update_cuda,
        fitc_update_plain,
    )

    scale = float(setting.sp_gp.kernel.scale)
    m_valid = pseudo.shape[1]
    p_pad = pad_pseudo_points(np.ascontiguousarray(pseudo.T))   # (1152, 3)
    out = {}

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
    fitc_against_truth(fitc_args)
    out["fitc"] = {
        "max_abs_err": fitc_err32,
        "ms": batch_ms(lambda: fitc_update_cuda(*fitc_args)),
        "plain_ms": batch_ms(lambda: fitc_update_plain(*fitc_args)),
    }
    # no one PyTorch call computes the update; the note times its two
    # products (full FP32 cuBLAS) on a kmn and weights computed beforehand
    name, P, linv, x, y, var, mask, _ = fitc_args
    kmn = cross_gram_plain(name, P, x, scale)
    lam = torch.clamp(1.0 - torch.sum((linv @ kmn) ** 2, dim=0), min=0.0)
    ksc = kmn * torch.where(mask, 1.0 / (lam + var), torch.zeros_like(lam))
    gemm_ms = cuda_ms(lambda: (torch.matmul(linv, kmn),
                               torch.matmul(ksc, kmn.T)))
    log(f"fitc note: torch.matmul(L_inv, kmn) and torch.matmul(kmn w, "
        f"kmn^T) on a precomputed kmn {tuple(kmn.shape)} float32 "
        f"{gemm_ms:.4f} ms (the two products alone; kernel "
        f"{out['fitc']['ms']:.4f} ms, plain {out['fitc']['plain_ms']:.4f} ms)")
    log_device_split("fitc M=1152 N=2048 float32",
                     lambda: fitc_update_cuda(*fitc_args))
    out["fitc"].update(time_fitc_syrk(fitc_args, "1"))
    return out


def fitc_against_truth(args):
    """Phase 3's gate at the main path's variance: the float32 FITC kernel
    and the float32 plain version against the float64 update of the same
    inputs (the float32 pseudo points, samples and variances in float64,
    L_inv from a float64 init), relative errors max |err| / max |truth| of
    dQ and dalpha; the kernel's no worse than 2x the plain version's, as
    the exact GPs are gated."""
    from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
        spgp_init,
    )
    from erl_gaussian_process_tpu_torch.ops import (
        fitc_update_cuda,
        fitc_update_plain,
    )

    name, P, _, x, y, var, mask, scale = args
    st64 = spgp_init(P.double(), scale, kernel=name)
    truth = fitc_update_plain(name, st64.pseudo, st64.L_inv, x.double(),
                              y.double(), var.double(), mask, scale)

    def rel(got):
        return tuple(float((g.double() - t).abs().max() / t.abs().max())
                     for g, t in zip(got, truth))

    (kq, ka) = rel(fitc_update_cuda(*args))
    torch.cuda.synchronize()
    (pq, pa) = rel(fitc_update_plain(*args))
    v = float(var[0])
    log(f"fitc float32 at var {v:g} vs the float64 update of the same "
        f"inputs: relative error dQ kernel {kq:.3e} plain {pq:.3e}, dalpha "
        f"kernel {ka:.3e} plain {pa:.3e} (gate <= {POSTERIOR_FACTOR:g}x "
        "plain)")
    check(kq <= POSTERIOR_FACTOR * pq and ka <= POSTERIOR_FACTOR * pa,
          f"fitc float32 at var {v:g}: kernel error {kq}, {ka} > "
          f"{POSTERIOR_FACTOR} x plain {pq}, {pa}")


def time_fitc_syrk(args, label) -> dict:
    """The float32 SYRK and dalpha, the FITC kernel's third launch, alone
    (``ops/fitc.py::fitc_syrk_alone``) on the kmn and weights of ``args``
    computed by the plain version: :func:`batch_ms` of its launch, beside
    its bound, the
    lower half's M (M + 1) N operations at the 3xTF32 rate. Checks dQ
    against kmn w kmn^T (float32 SYRK tolerance) and its exact symmetry,
    and logs rows 1-1d's SYRK line. Returns {"syrk_us", "syrk_bound_us"}."""
    from erl_gaussian_process_tpu_torch.ops.fitc import fitc_syrk_alone
    from erl_gaussian_process_tpu_torch.ops.gram import cross_gram_plain

    name, P, linv, x, y, var, mask, scale = args
    kmn = cross_gram_plain(name, P, x, scale).contiguous()
    lam = torch.clamp(1.0 - torch.sum((linv @ kmn) ** 2, dim=0), min=0.0)
    w = torch.where(mask, 1.0 / (lam + var), torch.zeros_like(lam))
    launch, dq, _ = fitc_syrk_alone(kmn, w.contiguous(), y, mask)
    launch()
    ref = (kmn * w[None, :]) @ kmn.T
    err = float((dq - ref).abs().max() / ref.abs().max())
    check(err <= FITC_TOL[torch.float32] and bool(torch.equal(dq, dq.T)),
          f"fitc SYRK alone {label}: rel err {err}, or dQ asymmetric")
    us = 1e3 * batch_ms(launch)
    m, n = kmn.shape
    bound_us = 1e6 * m * (m + 1) * n / TF32X3_FLOPS
    log(f"fitc SYRK alone, row {label}, M={m} N={n} float32 on "
        f"{card_line()}: {us:.2f} us (CUDA events, median of {REPS} batches "
        f"of {BATCH}), bound {bound_us:.2f} us at 3xTF32 "
        f"({100 * bound_us / us:.1f}% of it); rel err {err:.2e}")
    return {"syrk_us": us, "syrk_bound_us": bound_us}


def syrk_grid(plan) -> str:
    """The float32 SYRK's grid in words (``ops/fitc.py::fitc_plan``)."""
    return (f"{plan.super_tiles} super-tiles x {plan.col_blocks} panels "
            f"over {plan.blocks} blocks, strips by "
            + ("the copy engine" if plan.copy_engine else "cp.async"))


PROFILE_ATTEMPTS = 3


def device_kernels(fn, expect=()) -> dict:
    """{kernel name: (launches, device ms)} of one ``fn()`` on the card, by
    ``torch.profiler``, recorded after a warm-up call of its own (as
    :func:`gram_profile`). A trace with no device event at all, or with
    no kernel whose name holds one of ``expect``, is taken again, up to
    PROFILE_ATTEMPTS times: in whole-script card runs one profile of a
    late phase came back empty now and then (the FITC split at the 2D
    map's shape once, the reduced-rank fit once), and one gloo rank's
    trace of a sensor GP's train and test lost the train's bank fit once,
    though the same calls had launched their kernels (the wrappers'
    counts)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            fn()
            torch.cuda.synchronize()
        found = {e.key: (e.count, e.self_device_time_total / 1e3)
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
        missing = [x for x in expect if not any(x in k for k in found)]
        if found and not missing:
            return found
        log(f"torch.profiler returned no device event"
            f"{' of ' + ', '.join(missing) if found else ''} (attempt "
            f"{attempt + 1} of {PROFILE_ATTEMPTS})")
    return found


def log_device_split(label, fn, reps=10):
    """Log each kernel's device time per call of ``fn`` (``reps`` calls
    under ``torch.profiler``): the CUDA-event times above also hold the
    wrapper's host time, since each rep starts on an idle card."""
    split = device_kernels(lambda: [fn() for _ in range(reps)])
    log(f"{label} device time per call (torch.profiler, {reps} calls): "
        + "; ".join(f"{k.split('(')[0][:48]} {1e3 * ms / reps:.2f} us"
                    for k, (_, ms) in split.items())
        + f"; sum {1e3 * sum(ms for _, ms in split.values()) / reps:.2f} us")


# the FITC kernel's launches by name (csrc/fitc.cu)
FITC_KERNELS = ("kmn_kernel", "beta_tc_kernel", "syrk_tc_kernel")


def clone_state(state):
    """A copy of a map state (the graphed map overwrites its own)."""
    return type(state)(*(t.clone() for t in state))


def graph_launches(maps, wrapper) -> tuple:
    """(launches of ``wrapper``'s kernel that the maps' graph replays ran,
    those their captures' eager warm-ups ran): each captured graph's
    launches a replay (``models/pose_graph.py``) times its replays, and
    once for the warm-up run before its capture."""
    graphs = [g for m in maps for g in m._graphs.captures]
    return (sum(g.replays * g.launches.get(wrapper, 0) for g in graphs),
            sum(g.launches.get(wrapper, 0) for g in graphs))


def run_slice(dev, card, setting, pseudo, lo, hi, sensors, pts, masks, hits,
              traj):
    """Phases 4-6. Returns (launch counts, timings, drift results, the
    pose-by-pose replay's state and samples used with the drift grid's
    float32 and float64 posteriors)."""
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
    seq_used = [seq.update(sensors[i], pts[i], masks[i]) for i in range(b)]
    torch.cuda.synchronize()
    t_seq = time.perf_counter() - t0
    # a copy: the graphed map updates its state buffers in place
    seq_ref = {"state": clone_state(seq.state),
               "n_used": torch.stack(seq_used)}

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
    cached_ms = [timed(lambda: bat.predict(sel.astype(np.float32)))[1]
                 for _ in range(TIMED_RUNS)]
    counts = launch_counts()
    from erl_gaussian_process_tpu_torch.ops import fitc_update_cuda

    replayed, warm_ups = graph_launches((seq, bat), fitc_update_cuda)
    log(f"launch counts of the main-path run: {counts} "
        f"({2 * b} pose updates; FITC: {replayed} by the graphs' replays, "
        f"{warm_ups} by their captures' eager warm-ups)")
    check(replayed == 2 * b,
          f"fitc launches by the replays {replayed} != pose updates {2 * b}")
    check(counts["fitc"] == replayed + warm_ups,
          f"fitc launches {counts['fitc']} != {replayed} replayed + "
          f"{warm_ups} warm-ups")
    check(counts["gram"] > 0, "gram kernel never launched by predict")
    check(int(n_used.sum()) == int(dm.sum()), "collected masks != n_used")
    # FITC's kernel launches per call (its plan) and per pose (one more pose
    # update under torch.profiler, after the counts above were read)
    from erl_gaussian_process_tpu_torch.ops.fitc import fitc_plan

    plan = fitc_plan(seq.state.pseudo.shape[0],
                     int(setting.sp_gp.max_num_samples),
                     torch.cuda.get_device_properties(dev).multi_processor_count)
    pose_kernels = device_kernels(
        lambda: seq.update(sensors[0], pts[0], masks[0]))
    fitc_pose = sum(c for k, (c, _) in pose_kernels.items()
                    if any(f in k for f in FITC_KERNELS))
    log(f"FITC launches: {plan.launches} per call (plan: {syrk_grid(plan)}"
        f"), {fitc_pose} per pose "
        f"by torch.profiler, of {sum(c for c, _ in pose_kernels.values())} "
        "kernel launches "
        "per pose")
    check(fitc_pose == plan.launches,
          f"FITC launches per pose {fitc_pose} != plan {plan.launches}")

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
    seq_ref.update(lo32=lo32, lo64=lo64)

    t_seqs, t_bats = [t_seq], [t_bat]
    for _ in range(TIMING_REPLAYS):
        omap = new_map()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(b):
            omap.update(sensors[i], pts[i], masks[i])
        torch.cuda.synchronize()
        t_seqs.append(time.perf_counter() - t0)
        omap = new_map()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        omap.update_batch(sensors, pts, masks, collect_datasets=True)
        torch.cuda.synchronize()
        t_bats.append(time.perf_counter() - t0)
    ms_pose = [1e3 * t / b for t in t_seqs]
    ups = [b / t for t in t_bats]
    log(f"hotel-0 replays on {card}, counted run first: update ms/pose "
        + ", ".join(f"{v:.4f}" for v in ms_pose) + "; update_batch "
        "updates/s " + ", ".join(f"{v:.2f}" for v in ups))
    timings = {
        "update_ms_per_pose": statistics.median(ms_pose),
        "update_ms_per_pose_range": [min(ms_pose), max(ms_pose)],
        "replay_updates_per_s": statistics.median(ups),
        "replay_updates_per_s_range": [min(ups), max(ups)],
        "replays": len(ms_pose),
        "predict_ms_first": 1e3 * t_predict["update_batch"],
        "predict_ms_cached": statistics.median(cached_ms),
        "predict_ms_cached_range": [min(cached_ms), max(cached_ms)],
        "n_predict": int(len(sel)),
        "fitc_launches_per_pose": fitc_pose,
        "kernel_launches_per_pose": sum(c for c, _ in
                                        pose_kernels.values()),
    }
    log(f"times on {card}: update {timings['update_ms_per_pose']:.4f} "
        f"ms/pose; update_batch {timings['replay_updates_per_s']:.2f} "
        f"updates/s (medians of {len(ms_pose)} replays); predict of "
        f"{len(sel)} points "
        f"{timings['predict_ms_first']:.3f} ms with prepare, "
        f"{timings['predict_ms_cached']:.4f} ms cached (median of "
        f"{TIMED_RUNS}, range {min(cached_ms):.4f}-{max(cached_ms):.4f})")
    return counts, timings, {"drift": drift, "sign_agreement": agree,
                             "quality": fracs}, seq_ref


def bank_errors(L, L_inv, alpha, ref):
    """(L lower-triangle max abs error, alpha max error relative to
    max|alpha|, max|L_inv L_ref - I|) of a bank result against the plain
    version's."""
    L_ref, _, a_ref = ref
    n = L.shape[-1]
    eye = torch.eye(n, dtype=L.dtype, device=L.device)
    return (float((torch.tril(L) - L_ref).abs().max()),
            float((alpha - a_ref).abs().max() / a_ref.abs().max()),
            float((L_inv @ L_ref - eye).abs().max()))


def check_bank_kernels(dev, lidar, depth):
    """Phase 7: the bank kernels and the batched gram against their plain
    versions at the sensor-GP path's shapes (the batched gram's times:
    :func:`time_gram`). Returns {name: {max_abs_err, ms, plain_ms,
    library_ms}}."""
    from erl_gaussian_process_tpu_torch.kernels import train_gram
    from erl_gaussian_process_tpu_torch.models import (
        RangeSensorGaussianProcess3D,
    )
    from erl_gaussian_process_tpu_torch.ops import (
        bank_cholesky_solve_cuda,
        bank_cholesky_solve_plain,
        bank_fit_cuda,
        bank_fit_plain,
        cross_gram_batched_cuda,
        cross_gram_plain,
    )
    from erl_gaussian_process_tpu_torch.workloads import lidar3d_setting

    from erl_gaussian_process_tpu_torch.ops.bank import (
        MAX_MEMBERS_PER_BLOCK,
        bank_chol_plan,
        member_tiles,
        smem_optin,
    )

    smem = smem_optin(dev.index or 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = [("bank_fit", "lidar protocol, groups 10/4", lidar3d_setting(),
              np.float32),
             ("bank_fit_408x144", "271x91 scan, groups 12/4",
              default_grouped_setting(), np.float32),
             (None, "lidar protocol, groups 10/4", lidar3d_setting(),
              np.float64)]
    out = {}
    for key, label, setting, np_dt in cases:
        gp = RangeSensorGaussianProcess3D(setting, dtype=np_dt, device=dev)
        x, y, v, m = gp._gather_scans(lidar[3][None])
        dt, kern, scale = x.dtype, gp._kernel, gp._scale
        B, n = x.shape[:2]
        got = bank_fit_cuda(kern, x, y, v, m, scale)
        torch.cuda.synchronize()
        ref = bank_fit_plain(kern, x, y, v, m, scale)
        eL, ea, eI = bank_errors(*got, ref)
        tol = BANK_TOL[dt]
        ms = cuda_ms(lambda: bank_fit_cuda(kern, x, y, v, m, scale))
        plain_ms = cuda_ms(lambda: bank_fit_plain(kern, x, y, v, m, scale))
        plan = bank_chol_plan(n, dt, smem, B, sms)
        log(f"bank_fit {label} {str(dt):14s} B={B} n={n} {kern} ({plan.path}"
            f", {plan.members_per_block} members a block): L max_abs_err "
            f"{eL:.3e}, alpha rel_err {ea:.3e}, |L_inv L - I| {eI:.3e} (tol "
            f"{tol:g}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        check(max(eL, ea, eI) <= tol,
              f"bank_fit {label} {dt}: errors {eL}, {ea}, {eI} > {tol}")
        check(bool((torch.triu(got[0], 1) == 0).all()),
              f"bank_fit {label} {dt}: L not lower triangular")
        if key is None:
            continue
        # no one call builds the gram and gives L, L^{-1} and alpha; the
        # Cholesky of the same grams, built outside, is the yardstick
        Kb = train_gram(kern, x, torch.where(m, v, torch.zeros_like(v)),
                        scale, mask=m)
        chol_ms = cuda_ms(lambda: torch.linalg.cholesky(Kb))
        b_ms, b_by = bank_fit_bound(B, n, x.shape[2], y.shape[2])
        log(f"bank_fit yardstick: torch.linalg.cholesky on the "
            f"{tuple(Kb.shape)} {str(dt)} grams {chol_ms:.4f} ms (L alone); "
            f"kernel {ms / chol_ms:.3f}x of it; bound {b_ms:.4f} ms ({b_by})")
        out[key] = {"max_abs_err": eL, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        # the plan's members a block against the other counts that fit
        fits = min(MAX_MEMBERS_PER_BLOCK, smem // (member_tiles(n) * 1024))
        sweep = {c: cuda_ms(lambda: bank_fit_cuda(kern, x, y, v, m, scale,
                                                  members_per_block=c))
                 for c in range(1, fits + 1)}
        log(f"bank_fit B={B} n={n} members a block (blocks): "
            + ", ".join(f"{c} ({-(-B // c)}) {t:.4f} ms"
                        for c, t in sweep.items())
            + f"; the plan takes {plan.members_per_block}")
        if key == "bank_fit":
            first = (kern, x, y, v, m, scale, got)

    # a trained member of the lidar bank made indefinite: all NaN, and its
    # neighbours bit for bit what they were
    kern, x, y, v, m, scale, ok = first
    b = int(torch.nonzero(m[:, 0])[3])
    v_bad = v.clone()
    v_bad[b, 0] = -50.0
    bad = bank_fit_cuda(kern, x, y, v_bad, m, scale)
    rest = torch.arange(x.shape[0], device=dev) != b
    check(all(bool(torch.isnan(t[b]).all()) for t in bad),
          "bank_fit: a non-SPD member is not NaN")
    check(all(bool(torch.equal(t[rest], u[rest])) for t, u in zip(bad, ok)),
          "bank_fit: a non-SPD member changed its neighbours")
    log(f"bank_fit: non-SPD member {b} all NaN (L, L^-1, alpha), the other "
        f"{int(rest.sum())} members bit for bit unchanged")

    # BatchGPBank.solve's shape (the JAX package's torch-sweep shape)
    rng = np.random.default_rng(1)
    X = rng.normal(size=(1000, 104, 8)).astype(np.float32)
    K = torch.as_tensor(np.einsum("bnd,bmd->bnm", X, X) / 8
                        + 2 * np.eye(104, dtype=np.float32), device=dev)
    y = torch.as_tensor(rng.normal(size=(1000, 104, 1)).astype(np.float32),
                        device=dev)
    got = bank_cholesky_solve_cuda(K, y)
    torch.cuda.synchronize()
    eL, ea, eI = bank_errors(*got, bank_cholesky_solve_plain(K, y))
    ms = cuda_ms(lambda: bank_cholesky_solve_cuda(K, y))
    plain_ms = cuda_ms(lambda: bank_cholesky_solve_plain(K, y))
    tol, atol = BANK_TOL[torch.float32], BANK_CHOL_ALPHA_TOL[torch.float32]
    log(f"bank_chol torch.float32 B=1000 n=104: L max_abs_err {eL:.3e} "
        f"(tol {tol:g}), alpha rel_err {ea:.3e} (tol {atol:g}), "
        f"|L_inv L - I| {eI:.3e}; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms")
    check(eL <= tol and ea <= atol and eI <= tol,
          f"bank_chol: errors {eL}, {ea}, {eI}")
    # the library yardstick: one torch.linalg.cholesky call on the same
    # batch computes L alone (the kernel also gives L^{-1} and alpha)
    lib_ms = cuda_ms(lambda: torch.linalg.cholesky(K))
    n = K.shape[1]
    b_ms, b_by = bound(4 * 1000 * (n * (n + 1) // 2 + 2 * n * n + 2 * n),
                       1000 * (2 * n ** 3 / 3 + 2 * n * n))
    log(f"bank_chol library yardstick: torch.linalg.cholesky on the "
        f"{tuple(K.shape)} float32 batch {lib_ms:.4f} ms (L alone); bound "
        f"{b_ms:.4f} ms ({b_by})")
    out["bank_chol"] = {"max_abs_err": eL, "ms": ms, "plain_ms": plain_ms,
                        "library_ms": lib_ms, "bound_ms": b_ms,
                        "bound_by": b_by}
    log_device_split("bank_chol (1000, 104) float32 (alpha in the kernel)",
                     lambda: bank_cholesky_solve_cuda(K, y))

    # the batched gram on the operands the routed predict gives it: the
    # lidar and depth tests' buckets and compute_occ's, whose few queries
    # per member leave most of each warp past the row's end
    gp = RangeSensorGaussianProcess3D(lidar[0], dtype=np.float32, device=dev)
    check(gp.train(*lidar[1:4]), "lidar train for the gram operands")
    dgp = RangeSensorGaussianProcess3D(depth[0], dtype=np.float32, device=dev)
    check(dgp.train(*depth[1:4]), "depth train for the gram operands")
    ops = [("lidar test", gp, routed_gram_operands(
                gp, gp.global_to_local_so3(lidar[4].astype(np.float32)))),
           ("depth test", dgp, routed_gram_operands(
                dgp, dgp.global_to_local_so3(depth[4].astype(np.float32))))]
    for f in OCC_FRACTIONS:
        p = occ_points(gp, lidar[3], f).astype(np.float32)
        dist = np.linalg.norm(p, axis=-1)         # as compute_occ routes
        ops.append((f"compute_occ x{f}", gp, routed_gram_operands(
            gp, p / np.where(dist > 0, dist, 1.0)[:, None])))
    for dt in (torch.float32, torch.float64):
        for label, model, (x1, x2, ms) in ops:
            x1, x2 = x1.to(dt), x2.to(dt)
            kern, scale = model._kernel, model._scale
            k = cross_gram_batched_cuda(kern, x1, x2, scale, ms)
            torch.cuda.synchronize()
            err = float((k - cross_gram_plain(kern, x1, x2, scale, ms)
                         ).abs().max())
            log(f"gram_batched {label:18s} {kern} scale {scale:g} "
                f"{str(dt):14s} shape {tuple(k.shape)} max_abs_err "
                f"{err:.3e} (tol {GRAM_TOL[dt]:g})")
            check(err <= GRAM_TOL[dt], f"gram_batched {label} {dt}: {err}")
            check(bool((k[~ms] == 0).all()),
                  f"gram_batched {label} {dt}: a masked row is not 0")
    return out


def default_grouped_setting():
    """The lidar protocol's scan at the setting's default 12/4 grouping
    (408 partitions of 144 samples)."""
    from erl_gaussian_process_tpu_torch.workloads import lidar3d_setting

    s = lidar3d_setting()
    s.row_group_size = s.col_group_size = 12
    return s


def bank_fit_bound(B, n, d, q):
    """(ms, by) of the bank fit of B members: x, var, mask and y read once,
    L, L^{-1} and alpha written once; the factor and inverse 2 n^3 / 3, the
    gram ~11 operations an entry of its lower half, alpha 2 n^2 a column."""
    nbytes = 4 * B * (2 * n * n + n * d + n + 2 * n * q) + B * n
    return bound(nbytes, B * (2 * n ** 3 / 3 + 11 * n * n / 2 + 2 * n * n * q))


def routed_gram_operands(gp, dirs_local):
    """The batched gram's operands (x1, x2, row mask) as
    ``bank_predict_assigned`` builds them for these sensor-frame
    directions: the active members' samples, their bucketed queries and
    the members' sample masks."""
    from erl_gaussian_process_tpu_torch.models.batch_gp import group_queries

    coords, idx = gp.route_directions(dirs_local)
    _, slots, _, member_ids = group_queries(idx,
                                            gp.bank.trained.cpu().numpy())
    x = gp.bank.x
    ids = torch.as_tensor(member_ids, device=x.device)
    return (x[ids],
            torch.as_tensor(coords[slots], dtype=x.dtype, device=x.device),
            gp.bank.mask[ids])


def occ_points(gp, ranges, fraction):
    """Every 53rd ray of the scan at ``fraction`` of its measured range, in
    the sensor frame: the points of the ``compute_occ`` check."""
    dirs = gp.sensor_frame.ray_directions_in_frame().reshape(-1, 3)[::53]
    return dirs * (fraction * ranges.reshape(-1)[::53])[:, None]


def timed(fn):
    """(result, milliseconds) of ``fn()`` on the host clock, the card
    synchronized before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, 1e3 * (time.perf_counter() - t0)


def bank_copy(bank) -> tuple:
    """A bank (or any tuple of tensors) copied off the graphs' buffers."""
    return tuple(None if t is None else t.clone() for t in bank)


def bits(a, b) -> bool:
    """Bit for bit, NaN included: tensors, arrays, or tuples of them."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(bits(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is None and b is None
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def sensor_result(res) -> tuple:
    """A sensor GP's test result: (mean, variance, valid)."""
    return res._mean, res._var, res._valid


def routed_close(a, b, tol) -> bool:
    """Two routed predicts' outputs (tuples of host arrays): bit for bit
    when ``tol`` is None, else boolean arrays and the finite pattern exact
    and the finite values within ``tol`` of their magnitude."""
    if tol is None:
        return bits(a, b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        if x.dtype == bool:
            if not np.array_equal(x, y):
                return False
            continue
        fin = np.isfinite(y)
        if not np.array_equal(np.isfinite(x), fin):
            return False
        if fin.any() and np.abs(x[fin] - y[fin]).max() > \
                tol * max(np.abs(y[fin]).max(), 1e-300):
            return False
    return True


def replay_graph_side(gp, rb):
    """The offline replay as a graph of its own, the side the port does not
    take (``train_scan_batch`` runs eagerly): a ``SensorGraphs`` table
    holding a graph of the same body (``gp._scan_step``) on ``rb``, and a
    call that replays it and copies the bank out, as a graphed
    ``train_scan_batch`` must (the next replay overwrites its outputs).
    Returns (the table, the call)."""
    from erl_gaussian_process_tpu_torch.models.sensor_graph import (
        SensorGraphs,
    )

    side = SensorGraphs(gp.device)
    rb = np.asarray(rb, gp.dtype)
    feeds = (rb, gp._scan_scalars())
    if hasattr(gp, "_table_tensors"):            # the 2D lidar GP
        c = gp._build_scan_fit_cache()
        key, tables = gp._step_key(rb.shape, c["idx"].shape), (c["idx"],
                                                               c["inb"])
    else:
        key, tables = gp._step_key(rb.shape), ()
    return side, lambda: bank_copy(side.fit(key, gp._scan_step, feeds,
                                            tables))


def routed_vs_host(label, card, gp, test, gt, gate) -> dict:
    """The 3D GP's device-routed ``test()`` (one replay) against the host
    path of the same model (its graphs set aside): valid flags exact,
    ranges and variances within ``ROUTED_TOL`` of their magnitude, both
    MSEs against ``gt`` under ``gate``; each path's ms (alternated,
    medians of TIMED_RUNS with ranges)."""
    graphs = gp._graphs

    def host():
        gp._graphs = None
        try:
            return test()
        finally:
            gp._graphs = graphs

    def answers(fn):
        res = fn()
        rng, valid = res.get_mean()
        return rng, res.get_variance()[0], valid

    dev_a, host_a = answers(test), answers(host)
    tol = ROUTED_TOL[gp.dtype]
    same = routed_close(dev_a, host_a, tol)
    both = dev_a[2] & host_a[2]
    gaps = [float(np.max(np.abs(dev_a[0][both] - host_a[0][both])
                         / np.abs(host_a[0][both]))),
            float(np.max(np.abs(dev_a[1][both] - host_a[1][both])))]
    mse = [float(np.mean((a[0][a[2]] - gt[a[2]]) ** 2))
           for a in (dev_a, host_a)]
    t_d, t_h = [], []
    for _ in range(TIMED_RUNS):
        t_d.append(timed(lambda: answers(test))[1])
        t_h.append(timed(lambda: answers(host))[1])
    out = {"same": same, "valid": float(dev_a[2].mean()),
           "range_gap": gaps[0], "var_gap": gaps[1], "mse_device": mse[0],
           "mse_host": mse[1], "ms": statistics.median(t_d),
           "ms_range": [min(t_d), max(t_d)], "host_ms": statistics.median(t_h),
           "host_ms_range": [min(t_h), max(t_h)]}
    log(f"{label} device-routed test against the host path on {card}: "
        f"valid flags equal and values within {tol:g} {same} "
        f"(valid {out['valid']:.4f}, widest relative range gap "
        f"{gaps[0]:.3e}, variance gap {gaps[1]:.3e}); MSE {mse[0]:.6e} "
        f"device-routed, {mse[1]:.6e} host (gate <= {gate:g}); "
        f"{out['ms']:.4f} ms ({min(t_d):.4f}-{max(t_d):.4f}) against "
        f"{out['host_ms']:.4f} ({min(t_h):.4f}-{max(t_h):.4f}) on the host "
        f"path (medians of {TIMED_RUNS}, alternated)")
    check(same and dev_a[2].any() and max(mse) <= gate,
          f"{label}: the device-routed test against the host path: same "
          f"{same}, MSE {mse}")
    return out


def capture_record(g) -> dict:
    return {"key": str(g.key)[:120], "warmup_ms": g.warmup_ms,
            "capture_ms": g.capture_ms, "pool_mib": g.pool_bytes / 2**20,
            "replays": g.replays}


def sensor_graphs_vs_eager(label, card, gp, train, test, route,
                           replay_scans=None, profile=True,
                           test_tol=None) -> dict:
    """A graphed sensor GP (``models/sensor_graph.py``) against its eager
    chain (the same model with its graphs set aside), on the card: (a) the
    graphed ``train`` (``train()``) and ``test`` (``test()``, a
    TestResult) bit for bit the eager ones: banks, means, variances, valid
    masks; (b) train and test ms graphed and eager, alternated, medians of
    TIMED_RUNS with their ranges; (c) the host's CUDA API calls a train
    and a test (``torch.profiler``); (d) the device's idle share a train
    and a test; (e) the eager routed predict's phase split
    (``bank_predict_assigned(profile=)``, ``route()`` the test's (queries,
    member ids); the graphed test's phases are its ``egp.bank.*`` spans,
    which ``portbench``'s readers report); (f) each captured shape's
    warm-up and capture ms and pool MiB. ``replay_scans``: the offline
    replay of these scans, eager as the port runs it, against a graph of
    its own
    (:func:`replay_graph_side`): bit for bit, the graph's first call (its
    capture) and its cached calls against the eager call, its capture and
    pool. ``profile=False`` leaves out (c)-(e) (a model already profiled).
    ``test_tol``: the test's outputs within it of their magnitude
    (:func:`routed_close`; the 3D GP's float32 test, the reduced-rank 2D
    GP's), else bit for bit. Returns them, with the wall seconds the
    report took."""
    from erl_gaussian_process_tpu_torch.models.batch_gp import (
        bank_predict_assigned,
    )

    t_start = time.perf_counter()
    graphs = gp._graphs
    check(graphs is not None, f"{label}: the model on the card has no graphs")

    def eager(fn):
        gp._graphs = None
        try:
            return fn()
        finally:
            gp._graphs = graphs

    check(train(), f"{label}: graphed train")
    bank_g = bank_copy(gp.bank)
    res_g = sensor_result(test())
    check(eager(train), f"{label}: eager train")
    same_bank = bits(bank_g, tuple(gp.bank))
    same_test = routed_close(res_g, sensor_result(eager(test)), test_tol)
    same_replay, side = None, None
    if replay_scans is not None:
        side, side_call = replay_graph_side(gp, replay_scans)
        st_g, first_ms = timed(side_call)
        same_replay = bits(st_g, tuple(gp.train_scan_batch(replay_scans)))
        del st_g
    train()
    log(f"{label} graphed vs eager on the card: train bank bit for bit "
        f"{same_bank}, test mean/var/valid "
        f"{'bit for bit' if test_tol is None else f'within {test_tol:g}'} "
        f"{same_test}"
        + ("" if replay_scans is None else
           f", train_scan_batch (eager) and a graph of it bit for bit "
           f"{same_replay}"))
    check(same_bank and same_test and same_replay in (None, True),
          f"{label}: a graphed step differs from the eager chain")
    t_g, t_e, q_g, q_e, r_g, r_e = [], [], [], [], [], []
    for _ in range(TIMED_RUNS):
        t_e.append(timed(lambda: eager(train))[1])
        t_g.append(timed(train)[1])
        q_g.append(timed(test)[1])
        q_e.append(timed(lambda: eager(test))[1])
        if side is not None:
            r_g.append(timed(side_call)[1])
            r_e.append(timed(lambda: gp.train_scan_batch(replay_scans))[1])

    def med(v):
        return {"median": statistics.median(v), "range": [min(v), max(v)]}

    out = {"train_ms": med(t_g), "train_eager_ms": med(t_e),
           "test_ms": med(q_g), "test_eager_ms": med(q_e),
           "captures": [capture_record(g) for g in graphs.captures],
           "ladder_runs": graphs.ladder_runs}
    if side is not None:
        out["replay_eager_ms"], out["replay_graph_ms"] = med(r_e), med(r_g)
        out["replay_graph_first_ms"] = first_ms
        out["replay_graph_capture"] = capture_record(side.captures[0])
        side._fits.drop()
        del side, side_call
        torch.cuda.empty_cache()
    times = (f"train {out['train_ms']['median']:.4f} ms graphed (range "
             f"{min(t_g):.4f}-{max(t_g):.4f}) vs "
             f"{out['train_eager_ms']['median']:.4f} eager ({min(t_e):.4f}-"
             f"{max(t_e):.4f}); test {out['test_ms']['median']:.4f} ms "
             f"graphed ({min(q_g):.4f}-{max(q_g):.4f}) vs "
             f"{out['test_eager_ms']['median']:.4f} eager ({min(q_e):.4f}-"
             f"{max(q_e):.4f})"
             + ("" if not r_e else
                f"; replay {out['replay_eager_ms']['median']:.4f} ms eager "
                f"(as shipped; {min(r_e):.4f}-{max(r_e):.4f}) vs a graph of "
                f"it {out['replay_graph_ms']['median']:.4f} cached "
                f"({min(r_g):.4f}-{max(r_g):.4f}), its first call "
                f"{first_ms:.4f} (the capture: warm-up "
                f"{out['replay_graph_capture']['warmup_ms']:.2f} ms, capture "
                f"{out['replay_graph_capture']['capture_ms']:.2f} ms, pool "
                f"{out['replay_graph_capture']['pool_mib']:.1f} MiB)")
             + f" (medians of {TIMED_RUNS}, alternated)")
    if not profile:
        out["report_s"] = time.perf_counter() - t_start
        log(f"{label} on {card}: {times}; report {out['report_s']:.1f} s")
        return out
    # one profile each: the graphed and the eager train, the graphed test
    host_tg, dev_tg, _ = api_calls(train)
    host_te, dev_te, _ = api_calls(lambda: eager(train))
    train()
    host_qg, dev_qg, _ = api_calls(test)

    def split():
        p = {}
        bank_predict_assigned(gp.bank, *route(), gp._scale,
                              kernel=gp._kernel,
                              reduced_rank=gp.reduced_rank_kernel,
                              basis=gp._basis, profile=p)
        return {k: (1e3 * v if k != "bucket" else v) for k, v in p.items()}

    split()
    prof_e = split()
    dev_train = sum(ms for _, ms in dev_tg.values())
    dev_test = sum(ms for _, ms in dev_qg.values())
    out.update({
        "train_api_calls": sum(host_tg.values()),
        "train_api_calls_eager": sum(host_te.values()),
        "train_api": host_tg, "test_api_calls": sum(host_qg.values()),
        "train_kernels": sum(c for c, _ in dev_tg.values()),
        "train_kernels_eager": sum(c for c, _ in dev_te.values()),
        "train_device_ms": dev_train, "test_device_ms": dev_test,
        "train_idle": 1.0 - dev_train / statistics.median(t_g),
        "test_idle": 1.0 - dev_test / statistics.median(q_g),
        "test_split_eager_ms": prof_e,
        "report_s": time.perf_counter() - t_start})
    log(f"{label} on {card}: {times}; host CUDA API calls a train "
        f"{out['train_api_calls']} ({host_tg}) vs "
        f"{out['train_api_calls_eager']} eager, a test "
        f"{out['test_api_calls']} graphed; kernels a train "
        f"{out['train_kernels']} vs {out['train_kernels_eager']}; device "
        f"{dev_train:.4f} ms a train (idle {100 * out['train_idle']:.1f}%), "
        f"{dev_test:.4f} ms a test (idle {100 * out['test_idle']:.1f}%); "
        f"report {out['report_s']:.1f} s")
    log(f"{label} eager test split (ms): {prof_e}")
    for c in out["captures"]:
        log(f"{label} graph {c['key']}: warm-up {c['warmup_ms']:.2f} ms, "
            f"capture {c['capture_ms']:.2f} ms, pool {c['pool_mib']:.1f} "
            f"MiB, replays {c['replays']}")
    return out


def sensor_sequence(label, card, gp, n, step, tol=None) -> dict:
    """A sensor GP on a real sequence of scans: ``step(k)`` trains scan k
    and runs its ``test`` and ``compute_occ`` on its own points, returning
    their results. The sequence runs with the model's graphs as shipped
    and eagerly, in the order E, S, S, E, each graphed run on graphs of
    its own (their captures are part of the run); every run's results bit
    for bit the first eager run's (``tol``: the tests' and
    ``compute_occ``'s within it, :func:`routed_close`, the trains' banks
    bit for bit all the same). Reports each way's wall ms for the whole
    sequence (both runs), its captures (trains, routed tests), their
    warm-up and capture ms and pool MiB."""
    from erl_gaussian_process_tpu_torch.models.sensor_graph import (
        SensorGraphs,
    )

    t_start = time.perf_counter()
    own = gp._graphs
    ref, same = None, True
    ways = ("eager", "shipped")
    out = {w: {"ms": [], "captures": []} for w in ways}
    try:
        for way in ("eager", "shipped", "shipped", "eager"):
            gp._graphs = None if way == "eager" else SensorGraphs(gp.device)
            results = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for k in range(n):
                results.append(step(k))
            torch.cuda.synchronize()
            out[way]["ms"].append(1e3 * (time.perf_counter() - t0))
            if ref is None:
                ref = results
            else:
                same &= all(routed_close(a, b, tol)
                            for a, b in zip(results, ref))
            if gp._graphs is not None:
                caps = gp._graphs.captures
                out[way]["captures"].append({
                    "train": sum(1 for g in caps if g.key[0] == "fit"),
                    "routed": sum(1 for g in caps if g.key[0] != "fit"),
                    "ms": sum(g.warmup_ms + g.capture_ms for g in caps),
                    "capture_ms": sum(g.capture_ms for g in caps),
                    "pool_mib": sum(g.pool_bytes for g in caps) / 2**20})
                for t in (gp._graphs._fits, gp._graphs._routed):
                    t.drop()
            del results
    finally:
        gp._graphs = own
        torch.cuda.empty_cache()
    out["same_bits"] = bool(same)
    out["scans"] = n
    out["report_s"] = time.perf_counter() - t_start
    log(f"{label} sequence of {n} scans (train, test, compute_occ) on "
        f"{card}: every way "
        f"{'bit for bit' if tol is None else f'within {tol:g} of'} the "
        f"eager run {same}; " + "; ".join(
            f"{w} {v['ms'][0]:.2f} / {v['ms'][1]:.2f} ms"
            + ("" if not v["captures"] else
               " (captures " + ", ".join(
                   f"{c['train']} train + {c['routed']} routed, "
                   f"{c['ms']:.2f} ms warm-up and capture of which capture "
                   f"{c['capture_ms']:.2f}, pool {c['pool_mib']:.1f} MiB"
                   for c in v["captures"]) + ")")
            for w in ways for v in [out[w]])
        + f"; report {out['report_s']:.1f} s")
    check(same, f"{label} sequence: a graphed way differs from the eager "
                "run")
    return out


def run_sensor_gp(dev, card, lidar, depth):
    """Phases 8-10: the 3D range-sensor GP on the card. Returns (launch
    counts per phase, timings)."""
    from erl_gaussian_process_tpu_torch.models import (
        BatchGPBank,
        RangeSensorGaussianProcess3D,
    )
    from erl_gaussian_process_tpu_torch.ops import (
        launch_counts,
        reset_launch_counts,
    )
    from erl_gaussian_process_tpu_torch.workloads import (
        lidar3d_replay_workload,
    )

    counts, timings = {}, {}
    setting, R, t, ranges, q, gt, _ = lidar
    gp = RangeSensorGaussianProcess3D(setting, dtype=np.float32, device=dev)
    gp.train(R, t, ranges)                     # warm-up, not counted
    gp.test(q, False, True).get_mean()
    # one train under torch.profiler: the bank fit is one launch and no
    # matrix product runs beside it (alpha is formed in the kernel)
    train_kernels = device_kernels(lambda: gp.train(R, t, ranges))
    fit_launches = sum(c for k, (c, _) in train_kernels.items()
                       if "bank_fit" in k)
    gemms = {k: c for k, (c, _) in train_kernels.items()
             if any(w in k.lower() for w in ("gemm", "gemv", "bmm"))}
    fit_ms = sum(ms for k, (_, ms) in train_kernels.items()
                 if "bank_fit" in k)
    dev_ms = sum(ms for _, ms in train_kernels.values())
    log(f"lidar train under torch.profiler: {fit_launches} bank-fit launch, "
        f"{fit_ms:.4f} of {dev_ms:.4f} ms device time "
        f"({sum(c for c, _ in train_kernels.values())} launches); products "
        f"{gemms or 'none'}")
    check(fit_launches == 1 and not gemms,
          f"lidar train kernels: {fit_launches} bank fits, products {gemms}")
    timings["train_device_ms"] = dev_ms
    timings["train_bank_fit_device_ms"] = fit_ms
    reset_launch_counts()
    train_ms = [timed(lambda: gp.train(R, t, ranges))[1]
                for _ in range(SENSOR_REPS)]
    test_ms = []
    for _ in range(5):
        (pred, valid), ms = timed(lambda: gp.test(q, False, True).get_mean())
        test_ms.append(ms)
    mse = float(np.mean((pred[valid] - gt[valid]) ** 2))
    log(f"lidar protocol float32: {gp.bank.x.shape[0]} members of "
        f"{gp.bank.x.shape[1]}, valid {valid.mean():.4f} of {len(q)} "
        f"queries, MSE {mse:.6e} (gate <= {LIDAR_MSE_GATE:g})")
    check(valid.any() and mse <= LIDAR_MSE_GATE, f"lidar MSE {mse}")
    timings["routed_vs_host"] = routed_vs_host(
        "lidar (10 000 directions)", card, gp, lambda: gp.test(q, False, True),
        gt, LIDAR_MSE_GATE)
    # occupancy along the scan's own rays, in the sensor frame: with the
    # decreasing inverse-sqrt mapping, (mapped prediction - mapped
    # distance) is negative in front of the surface, so the reference's
    # occ formula reads +1 there and -1 behind it
    v1, _, _, occ_near = gp.compute_occ(occ_points(gp, ranges,
                                                   OCC_FRACTIONS[0]))
    v2, _, _, occ_far = gp.compute_occ(occ_points(gp, ranges,
                                                  OCC_FRACTIONS[1]))
    log(f"compute_occ: {int(v1.sum())}/{len(v1)} near points valid, occ "
        f"min {occ_near[v1].min():.6f}; {int(v2.sum())}/{len(v2)} far points "
        f"valid, occ max {occ_far[v2].max():.6f}")
    check(v1.any() and v2.any() and occ_near[v1].min() > 0.9
          and occ_far[v2].max() < -0.9, "compute_occ near/far signs")
    counts["lidar"] = launch_counts()
    check(counts["lidar"]["bank_fit"] == SENSOR_REPS,
          f"bank_fit launches {counts['lidar']['bank_fit']} != "
          f"{SENSOR_REPS} trains")
    check(counts["lidar"]["gram_batched"] >= 5,
          "batched gram not launched by every test")
    timings["train_ms"] = statistics.median(train_ms)
    timings["train_ms_range"] = [min(train_ms), max(train_ms)]
    timings["test_ms_10000"] = statistics.median(test_ms)
    timings["test_ms_10000_range"] = [min(test_ms), max(test_ms)]
    # one test of the host path under torch.profiler: one gram launch, the
    # member masks applied in it (no where over the gram); each routed
    # graph (the test's, compute_occ's) captured one gram launch (a
    # profile of a replay can lose kernels)
    from erl_gaussian_process_tpu_torch.ops import cross_gram_batched_cuda

    x1, x2, _ = routed_gram_operands(
        gp, gp.global_to_local_so3(q.astype(np.float32)))
    shape = (x1.shape[0], x1.shape[1], x2.shape[1])
    graphs = gp._graphs
    gp._graphs = None
    try:
        g_launches, g_wheres, g_kernels = gram_profile(
            lambda: gp.test(q, False, True).get_mean(), shape)
    finally:
        gp._graphs = graphs
    routed = [g for g in graphs.captures if g.key[1] == "chunked"]
    captured = [g.launches.get(cross_gram_batched_cuda, 0) for g in routed]
    log(f"lidar test (host path) under torch.profiler: {g_launches} gram "
        f"launch, {g_wheres} where ops over the {shape} gram; kernels "
        f"{g_kernels}; the routed test's graphs captured {captured} gram "
        "launches")
    check(g_launches == 1 and g_wheres == 0 and captured
          and all(c == 1 for c in captured),
          f"lidar test: {g_launches} gram launches, {g_wheres} where ops "
          f"over the gram, routed graphs' gram launches {captured}")
    log(f"lidar launch counts {counts['lidar']}; train "
        f"{timings['train_ms']:.4f} ms (median of {SENSOR_REPS}, range "
        f"{min(train_ms):.4f}-{max(train_ms):.4f}), test of {len(q)} queries "
        f"{timings['test_ms_10000']:.4f} ms (median of 5, range "
        f"{min(test_ms):.4f}-{max(test_ms):.4f}) on {card}")
    dirs_local = gp.sensor_frame.dir_world_to_frame(np.asarray(q, gp.dtype))
    timings["graphs"] = sensor_graphs_vs_eager(
        "3D lidar (736 x 100)", card, gp, lambda: gp.train(R, t, ranges),
        lambda: gp.test(q, False, True),
        lambda: gp.route_directions(dirs_local),
        test_tol=ROUTED_TOL[gp.dtype])

    # the same scan at the setting's default grouping: 408 members of 144
    ggp = RangeSensorGaussianProcess3D(default_grouped_setting(),
                                       dtype=np.float32, device=dev)
    ggp.train(R, t, ranges)                    # warm-up, not counted
    reset_launch_counts()
    grouped_ms = [timed(lambda: ggp.train(R, t, ranges))[1]
                  for _ in range(SENSOR_REPS)]
    counts["lidar_default_grouping"] = launch_counts()
    gpred, gvalid = ggp.test(q, False, True).get_mean()
    gmse = float(np.mean((gpred[gvalid] - gt[gvalid]) ** 2))
    check(tuple(ggp.bank.L.shape) == (408, 144, 144)
          and counts["lidar_default_grouping"]["bank_fit"] == SENSOR_REPS
          and gvalid.any() and gmse <= LIDAR_MSE_GATE,
          f"lidar at the default grouping: {tuple(ggp.bank.L.shape)}, "
          f"{counts['lidar_default_grouping']}, MSE {gmse}")
    timings["train_ms_default_grouping"] = statistics.median(grouped_ms)
    log(f"lidar at the default 12/4 grouping (408 x 144): train "
        f"{statistics.median(grouped_ms):.4f} ms (median of {SENSOR_REPS}, "
        f"range {min(grouped_ms):.4f}-{max(grouped_ms):.4f}), MSE "
        f"{gmse:.6e} (gate <= {LIDAR_MSE_GATE:g})")
    del ggp

    ds, dR, dt_, dranges, dq, dgt, _ = depth
    dgp = RangeSensorGaussianProcess3D(ds, dtype=np.float32, device=dev)
    dgp.train(dR, dt_, dranges)                # the capture, not counted
    reset_launch_counts()
    check(dgp.train(dR, dt_, dranges), "depth train")
    dpred, dvalid = dgp.test(dq, False, True).get_mean()
    counts["depth"] = launch_counts()
    dmse = float(np.mean((dpred[dvalid] - dgt[dvalid]) ** 2))
    log(f"depth protocol float32: {dgp.bank.x.shape[0]} members, valid "
        f"{dvalid.mean():.4f}, MSE {dmse:.6e} (gate <= {DEPTH_MSE_GATE:g}); "
        f"launch counts {counts['depth']}")
    check(dvalid.any() and dmse <= DEPTH_MSE_GATE, f"depth MSE {dmse}")
    timings["depth_routed_vs_host"] = routed_vs_host(
        "depth", card, dgp, lambda: dgp.test(dq, False, True), dgt,
        DEPTH_MSE_GATE)
    check(counts["depth"]["bank_fit"] == 1, "depth: bank_fit launches != 1")

    t0 = time.perf_counter()
    _, Rs, ts, rb = lidar3d_replay_workload(REPLAY_SCANS)
    log(f"replay: {REPLAY_SCANS} scans ({rb.size} rays) raycast in "
        f"{time.perf_counter() - t0:.2f} s (host, outside the timed window)")
    # warm-up, then the counted replay and more for the median and range
    gp.train_scan_batch(rb)
    rep_times = []
    for i in range(TIMED_RUNS):
        if i == 0:
            reset_launch_counts()
        stacked, rep_ms = timed(lambda: gp.train_scan_batch(rb))
        if i == 0:
            counts["replay"] = launch_counts()
            first_replay = stacked
        rep_times.append(rep_ms)
        del stacked
    stacked = first_replay
    rep_ms = statistics.median(rep_times)
    check(counts["replay"]["bank_fit"] == 1,
          f"replay bank_fit launches {counts['replay']['bank_fit']} != 1")
    timings["replay_scans_per_s"] = REPLAY_SCANS / (rep_ms / 1e3)
    timings["replay_ms"] = rep_ms
    timings["replay_ms_range"] = [min(rep_times), max(rep_times)]
    B = gp.bank.x.shape[0]
    check(stacked.L.shape[0] == REPLAY_SCANS * B and bool(
        torch.isfinite(stacked.L).all()), "replay bank not finite")
    for k in (0, REPLAY_SCANS - 1):
        gp.train(Rs[k], ts[k], rb[k])
        per = gp.bank
        gp.use_scan_bank(stacked, k)
        differ = [f for f, a, b in zip(per._fields, gp.bank, per)
                  if not torch.equal(a, b)]
        check(not differ, f"replay scan {k} differs from its per-scan "
                          f"train in {differ}")
    log(f"replay: {stacked.L.shape[0]} members, L and L_inv "
        f"{stacked.L.nbytes / 2**30:.3f} GiB each, {rep_ms:.3f} ms (median "
        f"of {TIMED_RUNS}, range {min(rep_times):.3f}-{max(rep_times):.3f}) "
        f"= {timings['replay_scans_per_s']:.2f} scans/s; scans 0 and "
        f"{REPLAY_SCANS - 1} equal to per-scan train bit for bit; launch "
        f"counts {counts['replay']}")
    del stacked, first_replay
    # the eager replay against a graph of it (and train, test again)
    timings["graphs_replay"] = sensor_graphs_vs_eager(
        f"3D lidar replay ({REPLAY_SCANS} scans)", card, gp,
        lambda: gp.train(R, t, ranges), lambda: gp.test(q, False, True),
        lambda: gp.route_directions(dirs_local), replay_scans=rb,
        profile=False, test_tol=ROUTED_TOL[gp.dtype])
    torch.cuda.empty_cache()
    # the trajectory scan by scan: train, the protocol's 10 000 queries,
    # compute_occ on the scan's own points
    occ = [[occ_points(gp, rb[k], fr) for fr in OCC_FRACTIONS]
           for k in range(REPLAY_SCANS)]

    def step(k):
        check(gp.train(Rs[k], ts[k], rb[k]), f"trajectory scan {k} train")
        res = sensor_result(gp.test(q, False, True))
        return res + tuple(gp.compute_occ(o) for o in occ[k])

    timings["sequence"] = sensor_sequence("3D lidar (736 x 100)", card, gp,
                                          REPLAY_SCANS, step,
                                          ROUTED_TOL[gp.dtype])

    rng = np.random.default_rng(2)
    bank = BatchGPBank(1000, 104, y_dim=1, dtype=np.float32, device=dev)
    sizes = rng.integers(60, 105, 1000)
    problems = []
    for i, n in enumerate(sizes):
        X = rng.normal(size=(n, 8))
        K = X @ X.T / 8 + 2 * np.eye(n)
        y = rng.normal(size=(n, 1))
        bank.load_gp_data(i, n, K, y)
        problems.append((K, y))
    # solve() overwrites the right-hand sides with alpha (the reference's
    # in-place semantics): each run starts from the loaded ones, restored
    # outside the timed window
    rhs = bank._alpha.copy()

    def solve_once():
        bank._alpha = rhs.copy()
        return timed(bank.solve)[1]

    solve_once()                               # warm-up, not counted
    reset_launch_counts()
    solve_times = [solve_once()]
    counts["batch_gp_bank"] = launch_counts()
    solve_times += [solve_once() for _ in range(TIMED_RUNS - 1)]
    solve_ms = statistics.median(solve_times)
    check(counts["batch_gp_bank"]["bank_chol"] == 1,
          "BatchGPBank.solve did not launch the bank Cholesky once")
    worst_L = worst_a = 0.0
    for i in range(0, 1000, 37):
        n = sizes[i]
        K, y = problems[i]
        L, a = bank.get_gp_result(i)
        worst_L = max(worst_L, float(np.abs(np.tril(L[:n, :n])
                                            - np.linalg.cholesky(K)).max()))
        a_ref = np.linalg.solve(K, y)
        worst_a = max(worst_a, float(np.abs(a[:n] - a_ref).max()
                                     / np.abs(a_ref).max()))
        check(np.array_equal(L[n:, n:], np.eye(104 - n)) and not a[n:].any(),
              f"BatchGPBank member {i}: padding not exact")
    log(f"BatchGPBank (1000, 104) float32: solve {solve_ms:.3f} ms (median "
        f"of {TIMED_RUNS}, range {min(solve_times):.3f}-"
        f"{max(solve_times):.3f}); vs numpy "
        f"float64 on 28 members: L max_abs_err {worst_L:.3e}, alpha rel_err "
        f"{worst_a:.3e} (tol {BANK_TOL[torch.float32]:g}, "
        f"{BANK_CHOL_ALPHA_TOL[torch.float32]:g}); padding exact; launch "
        f"counts {counts['batch_gp_bank']}")
    check(worst_L <= BANK_TOL[torch.float32]
          and worst_a <= BANK_CHOL_ALPHA_TOL[torch.float32],
          "BatchGPBank results vs numpy")
    timings["batch_gp_bank_solve_ms"] = solve_ms
    timings["batch_gp_bank_solve_ms_range"] = [min(solve_times),
                                               max(solve_times)]
    return counts, timings


# the card's published peaks (NVIDIA H100 SXM data sheet): HBM, and FP32 /
# FP64 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
TF32X3_FLOPS = 495e12 / 3   # dense TF32 tensor cores, three products each
FP64_TC_FLOPS = 67e12       # FP64 tensor cores
CHOL_F32_FACTOR = 4.0       # backward error vs the plain version's, float32
CHOL_F64_BERR = 1e-12
POSTERIOR_FACTOR = 2.0      # posterior error vs the plain f32 fit's
JAX_TPU_POSTERIOR_MAE = 2e-3   # tests/test_ops.py:498-506 (n = 2600)


def bound(nbytes: float, flops: float, dtype=torch.float32):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move ``nbytes`` and do ``flops`` at its published peaks."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / PEAK_FLOPS[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


SFU_PER_SM_CLOCK = 16      # special-function results an SM issues a clock


def sm_clock_mhz() -> float:
    """The SM clock's maximum that ``nvidia-smi`` reports, in MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def gram_work(kern):
    """(FP32 operations, special-function results) of one gram element
    past its squared distance: each component's multiply and exp (and
    matern32's FMA), the square root of ou and matern32, a mixture's
    weighted sum."""
    from erl_gaussian_process_tpu_torch.kernels.base import mixture_params

    mix = mixture_params(kern)
    base, ncomp = (kern, 1) if mix is None else (mix[0], len(mix[1]))
    root = 0 if base == "rbf" else 1
    per = {"rbf": 2, "ou": 2, "matern32": 4}[base]
    ops = ncomp * per + root + (2 * ncomp if ncomp > 1 else 0)
    return ops, ncomp + root


def gram_bound(kern, dtype, batch, m, n, d, rows, masked, sms, mhz):
    """(ms, by, {by: ms}) of a gram of ``batch`` members: x1, x2 (and the
    row mask) read once and the output written once; the distance (3
    operations a coordinate) and the family of the ``rows`` rows that are
    computed (a masked row is written, not computed), at FP32 (FP64) SIMT
    and, at float32, the special-function units' issue rate."""
    es = torch.finfo(dtype).bits // 8
    nbytes = es * batch * (m * n + (m + n) * d) + (batch * m if masked else 0)
    ops, sfu = gram_work(kern)
    t = {"bytes": 1e3 * nbytes / HBM_BYTES_PER_S,
         "operations": 1e3 * rows * n * (3 * d + ops) / PEAK_FLOPS[dtype],
         "special functions": (1e3 * rows * n * sfu
                               / (SFU_PER_SM_CLOCK * sms * mhz * 1e6)
                               if dtype == torch.float32 else 0.0)}
    by = max(t, key=t.get)
    return t[by], by, t


def gram_cases(dev, setting, pseudo, lo, hi, lidar):
    """The gram's three shapes on its paths, float32: (a) the SPGP
    predict's k(P, x*), 1152 x 2048 matern32 d = 3; (b) the exact GP's
    test, k(X, X*) of the fitted state's 8192 samples (and train mask)
    against 4096 queries, rbf d = 2; (c) the lidar test's bucket of the
    routed predict, 688 members x 100 x 128, ou d = 2, with the member
    masks. Returns [(key, label, kernel, scale, x1, x2, mask or None)]."""
    from erl_gaussian_process_tpu_torch.kernels import KernelSetting
    from erl_gaussian_process_tpu_torch.models import (
        RangeSensorGaussianProcess3D,
        VanillaGaussianProcess,
        VanillaGPSetting,
    )
    from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
        pad_pseudo_points,
    )
    from erl_gaussian_process_tpu_torch.workloads import exact_gp_workload

    f32 = torch.float32
    p_pad = pad_pseudo_points(np.ascontiguousarray(pseudo.T))
    xq = np.random.default_rng(0).uniform(lo, hi, (2048, 3))
    cases = [("gram", "(a) SPGP predict", "matern32",
              float(setting.sp_gp.kernel.scale),
              torch.as_tensor(p_pad, device=dev, dtype=f32),
              torch.as_tensor(xq, device=dev, dtype=f32), None)]
    x, y, var, q, scale, kern = exact_gp_workload()
    gp = VanillaGaussianProcess(VanillaGPSetting(
        kernel_type=kern, kernel=KernelSetting(x_dim=2, scale=scale),
        max_num_samples=x.shape[0]), dtype=np.float32, device=dev)
    check(gp.train(x.T, y, var), "exact GP train for the gram operands")
    cases.append(("gram_exact", "(b) exact-GP test", kern, scale,
                  gp.state.x, torch.as_tensor(q, device=dev),
                  gp.state.mask))
    sgp = RangeSensorGaussianProcess3D(lidar[0], dtype=np.float32,
                                       device=dev)
    check(sgp.train(*lidar[1:4]), "lidar train for the gram operands")
    x1, x2, ms = routed_gram_operands(
        sgp, sgp.global_to_local_so3(lidar[4].astype(np.float32)))
    cases.append(("gram_batched", "(c) lidar test bucket", sgp._kernel,
                  sgp._scale, x1, x2, ms))
    return cases


def gram_call(kern, x1, x2, scale, mask):
    """The gram kernel as its path calls it: the SPGP predict's
    ``cross_gram_cuda``, the exact GP's ``kernels.cross_gram`` with the
    train mask, the routed predict's ``cross_gram_batched_cuda`` with the
    members' masks (the kernel writes the masked rows)."""
    from erl_gaussian_process_tpu_torch.kernels import cross_gram
    from erl_gaussian_process_tpu_torch.ops import cross_gram_batched_cuda

    if x1.dim() == 3:
        return cross_gram_batched_cuda(kern, x1, x2, scale, mask)
    return cross_gram(kern, x1, x2, scale, mask1=mask)


def check_gram(dev, cases, mixture) -> dict:
    """The gram kernel against its plain version at its three path shapes
    (:func:`gram_cases`), in every family (rbf, ou, matern32 and a
    three-component matern32 mixture) at float32 and float64: max abs error
    <= GRAM_TOL, masked rows and far-point rows (the SPGP predict's padded
    pseudo points) exactly +0.0, two calls bitwise equal. Returns {key:
    float32 max abs error over the families}."""
    from erl_gaussian_process_tpu_torch.ops import cross_gram_plain

    out = {}
    for key, label, _, scale, x1, x2, mask in cases:
        err32 = 0.0
        for dt in (torch.float32, torch.float64):
            a, b = x1.to(dt), x2.to(dt)
            for name in ("rbf", "ou", "matern32", mixture):
                k = gram_call(name, a, b, scale, mask)
                k2 = gram_call(name, a, b, scale, mask)
                torch.cuda.synchronize()
                ref = cross_gram_plain(name, a, b, scale, mask)
                err = float((k - ref).abs().max())
                tol = GRAM_TOL[dt]
                zero = torch.zeros((), dtype=torch.bool, device=dev)
                if mask is not None:
                    off = k[~mask]
                    zero = (off != 0).any() | torch.signbit(off).any()
                if key == "gram":     # far-point rows past the 1089 points
                    far = k[1089:]
                    zero = zero | (far != 0).any() | torch.signbit(far).any()
                log(f"gram {label} {name:28s} {str(dt):14s} shape "
                    f"{tuple(k.shape)} max_abs_err {err:.3e} (tol {tol:g})")
                check(err <= tol, f"gram {label} {name} {dt}: error {err} > "
                      f"{tol}")
                check(not bool(zero), f"gram {label} {name} {dt}: a masked "
                      "or far-point row is not exactly +0.0")
                check(bool(torch.equal(k, k2)), f"gram {label} {name} {dt}: "
                      "two calls differ")
                if dt == torch.float32:
                    err32 = max(err32, err)
        out[key] = err32
    return out


def time_gram(dev, card, cases) -> dict:
    """At each of the gram's path shapes: CUDA-event ms (median of 20 and
    range), device ms a call (torch.profiler over 10 calls, every kernel
    the call launches), host ms a call (enqueue, :func:`host_ms`), the
    plain version's event ms and the bound. Returns {key: {...}}."""
    from erl_gaussian_process_tpu_torch.ops import cross_gram_plain

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mhz = sm_clock_mhz()
    out = {}
    for key, label, kern, scale, x1, x2, mask in cases:
        def fn():
            return gram_call(kern, x1, x2, scale, mask)

        ev = event_times(fn)
        split = device_kernels(lambda: [fn() for _ in range(10)])
        dev_ms = sum(ms for _, ms in split.values()) / 10
        h_ms = host_ms(fn)
        plain_ms = cuda_ms(lambda: cross_gram_plain(kern, x1, x2, scale,
                                                    mask))
        batch = x1.shape[0] if x1.dim() == 3 else 1
        m, n, d = x1.shape[-2], x2.shape[-2], x1.shape[-1]
        rows = int(mask.sum()) if mask is not None else batch * m
        b_ms, b_by, b_all = gram_bound(kern, x1.dtype, batch, m, n, d, rows,
                                       mask is not None, sms, mhz)
        r = {"shape": [batch, m, n, d], "kernel": kern,
             "ms": statistics.median(ev), "ms_range": [min(ev), max(ev)],
             "device_ms": dev_ms, "host_ms": h_ms, "plain_ms": plain_ms,
             "bound_ms": b_ms, "bound_by": b_by,
             "kernels_per_call": {
                 k.split("(")[0][:48]: [c / 10, ms / 10]
                 for k, (c, ms) in split.items()}}
        log(f"gram {label} {kern} B={batch} {m}x{n} d={d} float32 on {card}: "
            f"event {r['ms']:.4f} ms (median of {REPS}, range "
            f"{min(ev):.4f}-{max(ev):.4f}), device {dev_ms:.4f} ms, host "
            f"{h_ms:.4f} ms, plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms "
            f"({b_by}; " + ", ".join(f"{k} {v:.4f}" for k, v in b_all.items())
            + f" at {mhz:g} MHz); kernels a call (launches, device ms) "
            + f"{r['kernels_per_call']}")
        out[key] = r
    return out


def gram_profile(fn, gram_shape) -> tuple:
    """(gram-kernel launches, ``aten::where`` ops with an operand of the
    gram's shape, {device kernel: launches}) of one ``fn()`` under
    torch.profiler, recorded after a warm-up call of its own (without one
    the trace lost the first kernels of the call in one card run)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True,
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()            # the warm-up call ends; the recorded one
        fn()
        torch.cuda.synchronize()
    kernels = {e.key.split("(")[0][:60]: e.count
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    launches = sum(c for k, c in kernels.items() if "gram_kernel" in k)
    wheres = sum(1 for e in prof.events() if e.name == "aten::where" and any(
        list(sh) == list(gram_shape) for sh in e.input_shapes))
    return launches, wheres, kernels


def backward_error(L, K) -> float:
    """||L L^T - K||_max / ||K||_max, in float64."""
    L64 = L.double()
    K64 = K.double()
    return float((L64 @ L64.T - K64).abs().max() / K64.abs().max())


def reconstruction_error(L, K) -> float:
    """||L L^T - K||_max, in float64."""
    L64 = L.double()
    return float((L64 @ L64.T - K.double()).abs().max())


def residual(M, x, b) -> float:
    """||M x - b||_max / ||b||_max, in float64."""
    return float((M.double() @ x.double() - b.double()).abs().max()
                 / b.double().abs().max())


def check_chol_kernels(dev, card):
    """Phase 11: the blocked Cholesky and triangular-solve kernels against
    their plain versions at the exact-GP paths' shapes. Returns {name:
    {max_abs_err, ms, plain_ms, library_ms, bound_ms, bound_by}}."""
    from erl_gaussian_process_tpu_torch.kernels import (
        train_gram,
        train_gram_with_gradient,
    )
    from erl_gaussian_process_tpu_torch.ops import (
        cho_solve_vec,
        chol_blocked,
        chol_blocked_gram,
        chol_blocked_gram_joint,
        chol_blocked_gram_joint_plain,
        chol_blocked_gram_plain,
        chol_blocked_plain,
        inverses_from_chol_dinv,
        solve_lower,
        solve_lower_t,
        substitute_plain,
    )
    from erl_gaussian_process_tpu_torch.workloads import (
        exact_gp_workload,
        nigp_workload,
    )

    out = {}
    f32 = torch.float32
    x, y, var, _, scale, kern = exact_gp_workload()
    n = x.shape[0]
    X = torch.as_tensor(x, device=dev)
    V = torch.as_tensor(var, device=dev)
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    K = train_gram(kern, X, V, scale, mask=ones)

    # plain-A entry at the exact-GP gram, float32
    L, D = chol_blocked(K, return_dinv=True)
    torch.cuda.synchronize()
    Lp = chol_blocked_plain(K)
    be, bp = backward_error(L, K), backward_error(Lp, K)
    check(bool((torch.triu(L, 1) == 0).all()), "chol: strict upper part not 0")
    check(be <= CHOL_F32_FACTOR * bp,
          f"chol f32 n={n}: backward error {be} > {CHOL_F32_FACTOR} x plain "
          f"{bp}")
    L2 = chol_blocked(K, return_dinv=False)
    check(bool(torch.equal(L, L2)), "chol: two launches differ")
    ms = cuda_ms(lambda: chol_blocked(K, return_dinv=True))
    plain_ms = cuda_ms(lambda: chol_blocked_plain(K, return_dinv=True))
    lib_ms = cuda_ms(lambda: torch.linalg.cholesky(K))
    b_ms, b_by = bound(4 * (2 * n * n + n * 64), n ** 3 / 3)
    out["chol"] = {"max_abs_err": reconstruction_error(L, K), "ms": ms,
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": b_ms, "bound_by": b_by}
    log(f"chol f32 n={n} (exact-GP gram): backward error {be:.3e}, plain "
        f"{bp:.3e} (gate <= {CHOL_F32_FACTOR:g}x); upper 0; two launches "
        f"bitwise equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.linalg.cholesky {lib_ms:.4f} ms ({ms / lib_ms:.3f}x), "
        f"bound {b_ms:.4f} ms ({b_by}; "
        f"{1e3 * n ** 3 / 3 / TF32X3_FLOPS:.4f} ms at the 3xTF32 rate the "
        f"update runs at) on {card}")

    # plain-A entry at an odd n, float64; and a non-SPD input
    rng = np.random.default_rng(4)
    A = rng.standard_normal((1000, 1008))
    A64 = torch.as_tensor(A @ A.T / 1000 + 2 * np.eye(1000), device=dev)
    L64 = chol_blocked(A64)
    torch.cuda.synchronize()
    be64 = backward_error(L64, A64)
    log(f"chol f64 n=1000: backward error {be64:.3e} (gate <= "
        f"{CHOL_F64_BERR:g}), plain {backward_error(chol_blocked_plain(A64), A64):.3e}")
    check(be64 <= CHOL_F64_BERR and bool((torch.triu(L64, 1) == 0).all()),
          f"chol f64 n=1000: backward error {be64}")
    bad = A64.clone()
    bad[700, 700] = -1.0
    Lbad = chol_blocked(bad)
    torch.cuda.synchronize()
    check(bool(torch.isnan(Lbad[700:, 700]).all()),
          "chol: a non-SPD input did not give NaN")
    log("chol: non-SPD input (negative pivot at 700) -> NaN from its tile on")

    # triangular solves on the exact-GP factor: one direction, both, with
    # and without the Cholesky's Dinv; gated by their residuals
    Y = torch.as_tensor(y, device=dev)
    inv = inverses_from_chol_dinv(D, n).contiguous()
    cases = [("solve_lower", solve_lower(L, Y), substitute_plain(L, Y, False),
              L),
             ("solve_lower_t", solve_lower_t(L, Y),
              substitute_plain(L, Y, True), L.T),
             ("cho_solve_vec Dinv", cho_solve_vec(L, Y, chol_dinv=D),
              torch.cholesky_solve(Y, L), K),
             ("cho_solve_vec", cho_solve_vec(L, Y),
              torch.cholesky_solve(Y, L), K)]
    torch.cuda.synchronize()
    trsv_err = 0.0
    for label, got, ref, M in cases:
        rk, rp = residual(M, got, Y), residual(M, ref, Y)
        err = float((got - ref).abs().max())
        log(f"trsv {label:20s} f32 n={n} q=1: residual {rk:.3e}, plain "
            f"{rp:.3e} (gate <= {CHOL_F32_FACTOR:g}x); max |x - x_plain| "
            f"{err:.3e}")
        check(rk <= CHOL_F32_FACTOR * rp, f"trsv {label}: residual {rk} > "
              f"{CHOL_F32_FACTOR} x {rp}")
        if label == "solve_lower":
            trsv_err = err
    ms = cuda_ms(lambda: solve_lower(L, Y, inv))
    plain_ms = cuda_ms(lambda: substitute_plain(L, Y, False))
    lib_ms = cuda_ms(lambda: torch.linalg.solve_triangular(L, Y, upper=False))
    b_ms, b_by = bound(4 * (n * n / 2 + n * 64 + 2 * n), n * n)
    out["trsv"] = {"max_abs_err": trsv_err, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
    log(f"trsv f32 n={n} q=1, one direction (solve_lower): kernel {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, torch.linalg.solve_triangular "
        f"{lib_ms:.4f} ms ({ms / lib_ms:.3f}x; the plain version is that "
        f"call), bound "
        f"{b_ms:.4f} ms ({b_by}) on {card}")

    # gram-fused entry at the exact-GP shape, all rows and 5% masked
    Lg = chol_blocked_gram(kern, X, V, ones, scale)
    torch.cuda.synchronize()
    Lgp = chol_blocked_gram_plain(kern, X, V, ones, scale)
    be, bp = backward_error(Lg, K), backward_error(Lgp, K)
    check(bool((torch.triu(Lg, 1) == 0).all()) and be <= CHOL_F32_FACTOR * bp,
          f"chol_gram f32: backward error {be} vs plain {bp}")
    mask = torch.as_tensor(rng.random(n) < 0.95, device=dev)
    Lm = chol_blocked_gram(kern, X, V, mask, scale)
    Km = train_gram(kern, X, torch.where(mask, V, 0.0), scale, mask=mask)
    bem = backward_error(Lm, Km)
    bpm = backward_error(chol_blocked_gram_plain(kern, X, V, mask, scale), Km)
    off = ~mask
    eye = torch.eye(int(off.sum()), device=dev)
    check(bool(torch.equal(Lm[off][:, off], eye))
          and bool((Lm[off][:, mask] == 0).all())
          and bool((Lm[mask][:, off] == 0).all())
          and bem <= CHOL_F32_FACTOR * bpm,
          f"chol_gram masked rows: identity / backward error {bem} vs {bpm}")
    ms = cuda_ms(lambda: chol_blocked_gram(kern, X, V, ones, scale,
                                           return_dinv=True))
    plain_ms = cuda_ms(lambda: chol_blocked_gram_plain(
        kern, X, V, ones, scale, return_dinv=True))
    b_ms, b_by = bound(4 * (n * 4 + n * n + n * 64),
                       n ** 3 / 3 + n * n / 2 * 12)
    out["chol_gram"] = {"max_abs_err": reconstruction_error(Lg, K), "ms": ms,
                        "plain_ms": plain_ms, "library_ms": None,
                        "bound_ms": b_ms, "bound_by": b_by}
    log(f"chol_gram f32 n={n} rbf: backward error {be:.3e}, plain {bp:.3e}; "
        f"{int(off.sum())} masked rows identity, backward error {bem:.3e} "
        f"(plain {bpm:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}) on {card}")
    del K, Km, L, Lp, L2, Lg, Lgp, Lm

    # joint entry at the NIGP shape (7680^2)
    xn, _, _, vx, vy, vg, _, scale, kern = nigp_workload()
    n0, d = xn.shape
    N = (1 + d) * n0
    Xn = torch.as_tensor(xn, device=dev)
    Vv = torch.as_tensor(vx + vy, device=dev)
    Vg = torch.as_tensor(vg, device=dev)
    sm = torch.ones(n0, dtype=torch.bool, device=dev)
    gm = torch.as_tensor(rng.random(n0) < 0.9, device=dev)
    Lj = chol_blocked_gram_joint(kern, Xn, Vv, Vg, sm, gm, scale)
    torch.cuda.synchronize()
    Kj = train_gram_with_gradient(kern, Xn, Vv, torch.zeros_like(Vv),
                                  torch.where(gm, Vg, 0.0), sm, gm, scale)
    Ljp = chol_blocked_gram_joint_plain(kern, Xn, Vv, Vg, sm, gm, scale)
    be, bp = backward_error(Lj, Kj), backward_error(Ljp, Kj)
    off = torch.cat([~sm] + [~gm] * d)
    check(bool((torch.triu(Lj, 1) == 0).all()) and be <= CHOL_F32_FACTOR * bp
          and bool(torch.equal(Lj[off][:, off],
                               torch.eye(int(off.sum()), device=dev))),
          f"chol_gram_joint f32: backward error {be} vs plain {bp}")
    ms = cuda_ms(lambda: chol_blocked_gram_joint(kern, Xn, Vv, Vg, sm, gm,
                                                 scale, return_dinv=True))
    plain_ms = cuda_ms(lambda: chol_blocked_gram_joint_plain(
        kern, Xn, Vv, Vg, sm, gm, scale, return_dinv=True))
    b_ms, b_by = bound(4 * (n0 * 5 + N * N + N * 64),
                       N ** 3 / 3 + N * N / 2 * 16)
    out["chol_gram_joint"] = {"max_abs_err": reconstruction_error(Lj, Kj),
                              "ms": ms, "plain_ms": plain_ms,
                              "library_ms": None, "bound_ms": b_ms,
                              "bound_by": b_by}
    log(f"chol_gram_joint f32 N={N} (n0={n0}, d={d}) rbf, "
        f"{int((~gm).sum())} gradient slots masked: backward error "
        f"{be:.3e}, plain {bp:.3e}; masked rows identity; kernel {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) on "
        f"{card}")
    return out


TRSM_SHAPE = (8192, 10_000)   # the exact-GP cell: its fit against the grid
TRSM_ERR_FACTOR = 2.0         # error vs float64, against the 64-row loop's
TRSM_MAX_MS = 10.0            # the FP32 SIMT floor of the same work
PEAK_TF32 = 495e12            # dense TF32 tensor-core peak (3xTF32: a third)


def check_whiten_kernel(dev, card):
    """Phase 11b: the whitening of many right-hand sides (``ops/trsm.py``)
    at the exact-GP cell's shape, n = 8192 samples of U(-1, 1)^2 (rbf 0.1,
    noise 1e-3, the gram-fused Cholesky and its Dinv) against the 100 x 100
    grid (m = 10 000): the kernel, the 64-row loop it replaced (its plain
    version) and ``torch.linalg.solve_triangular`` timed (CUDA events,
    median of 20), each one's max error against the float64 solve relative
    to the solution's largest entry; the kernel no worse than 2x the loop
    and under the FP32 SIMT floor (n^2 m operations at 67 TFLOP/s; 3xTF32's
    is 3 n^2 m at 495). Returns {"trsm": row}."""
    from erl_gaussian_process_tpu_torch.ops import (
        chol_blocked_gram,
        solve_lower_many,
        solve_lower_many_plain,
    )

    n, m = TRSM_SHAPE
    rng = np.random.default_rng(22)
    x = torch.as_tensor(rng.uniform(-1, 1, (n, 2)), device=dev)
    L, D = chol_blocked_gram("rbf", x.float(),
                             torch.full((n,), 1e-3, device=dev),
                             torch.ones(n, dtype=torch.bool, device=dev), 0.1,
                             return_dinv=True)
    g = torch.linspace(-1, 1, 100, dtype=torch.float64, device=dev)
    xq = torch.stack(torch.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    B = torch.exp(-0.5 * torch.cdist(x, xq) ** 2 / 0.1 ** 2).float()
    ref = torch.linalg.solve_triangular(L.double(), B.double(), upper=False)
    scale = float(ref.abs().max())
    errs = {}
    for name, fn in (("kernel", solve_lower_many),
                     ("plain", solve_lower_many_plain)):
        errs[name] = float((fn(L, D, B).double() - ref).abs().max()) / scale
    errs["library"] = float((torch.linalg.solve_triangular(
        L, B, upper=False).double() - ref).abs().max()) / scale
    del ref
    ms = cuda_ms(lambda: solve_lower_many(L, D, B))
    plain_ms = cuda_ms(lambda: solve_lower_many_plain(L, D, B))
    lib_ms = cuda_ms(lambda: torch.linalg.solve_triangular(L, B,
                                                           upper=False))
    ops = float(n) * n * m
    b_ms = 1e3 * 3 * ops / PEAK_TF32
    simt_ms = 1e3 * ops / PEAK_FLOPS[torch.float32]
    log(f"trsm f32 n={n} m={m}: kernel {ms:.4f} ms, plain (64-row loop) "
        f"{plain_ms:.4f} ms, torch.linalg.solve_triangular {lib_ms:.4f} ms; "
        f"bound {b_ms:.4f} ms at 3xTF32 ({100 * b_ms / ms:.1f}% of it), "
        f"{simt_ms:.4f} ms at FP32 SIMT; error vs float64: kernel "
        f"{errs['kernel']:.3e}, plain {errs['plain']:.3e}, library "
        f"{errs['library']:.3e} on {card}")
    check(errs["kernel"] <= TRSM_ERR_FACTOR * errs["plain"],
          f"trsm: error {errs['kernel']} > {TRSM_ERR_FACTOR} x the loop's "
          f"{errs['plain']}")
    check(ms <= TRSM_MAX_MS, f"trsm: {ms} ms, over the FP32 SIMT floor")
    return {"trsm": {"max_abs_err": errs["kernel"], "ms": ms,
                     "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": b_ms, "bound_by": "operations",
                     "simt_floor_ms": simt_ms}}


def plain_posterior(name, x, y, var, xq, scale, dtype, dev):
    """Mean and variance of the exact GP by the plain path on the card
    (train_gram, cuSOLVER Cholesky, cholesky_solve, triangular solve) at
    ``dtype``."""
    from erl_gaussian_process_tpu_torch.kernels import train_gram
    from erl_gaussian_process_tpu_torch.ops import cross_gram_plain

    X, Y, V, Q = (torch.as_tensor(a, device=dev, dtype=dtype)
                  for a in (x, y, var, xq))
    K = train_gram(name, X, V, scale)
    L = torch.linalg.cholesky(K)
    kt = cross_gram_plain(name, X, Q, scale)
    mean = kt.T @ torch.cholesky_solve(Y, L)
    w = torch.linalg.solve_triangular(L, kt, upper=False)
    return mean[:, 0], torch.clamp(1.0 - (w * w).sum(0), min=0.0)


def exact_graphs_vs_eager(label, card, gp, train, test) -> dict:
    """An exact GP with graphs (``models/exact_graph.py``) against its eager
    chain (the same model with its graphs set aside), on the card, after
    its captures: (a) a graphed ``train()`` and ``test()`` (a test and every
    output it gives, on the host) bit for bit the eager ones: the state (L,
    alpha, Dinv) and the outputs; (b) train and test ms graphed and eager,
    alternated, medians of TIMED_RUNS with their ranges; (c) the host's
    CUDA API calls a train and a test; (d) the device's busy ms and idle
    share a train and a test, graphed and eager (``torch.profiler``); (e)
    the variance graph's replay alone (the whitening and its reduction),
    CUDA events, median of REPS; (f) each captured graph's warm-up and
    capture ms and pool MiB. ``train`` refits the same data every call.
    Returns them, with the wall seconds the report took."""
    t_start = time.perf_counter()
    graphs = gp._graphs
    check(graphs is not None, f"{label}: the model on the card has no graphs")

    def eager(fn):
        gp._graphs = None
        try:
            return fn()
        finally:
            gp._graphs = graphs

    check(train(), f"{label}: graphed train")
    state_g = bank_copy(gp.state)
    out_g = test()
    check(eager(train), f"{label}: eager train")
    same_state = bits(state_g, tuple(gp.state))
    same_test = bits(out_g, eager(test))
    del state_g
    check(train(), f"{label}: graphed train")
    log(f"{label} graphed vs eager on the card: state (L, alpha, Dinv) bit "
        f"for bit {same_state}, test outputs bit for bit {same_test}")
    check(same_state and same_test,
          f"{label}: a graphed step differs from the eager chain")
    t_g, t_e, q_g, q_e = [], [], [], []
    for _ in range(TIMED_RUNS):
        t_e.append(timed(lambda: eager(train))[1])
        t_g.append(timed(train)[1])
        q_g.append(timed(test)[1])
        q_e.append(timed(lambda: eager(test))[1])
    prof = {"train": api_calls(train),
            "train_eager": api_calls(lambda: eager(train))}
    train()
    prof.update(test=api_calls(test), test_eager=api_calls(
        lambda: eager(test)))
    wall = {"train": t_g, "train_eager": t_e, "test": q_g, "test_eager": q_e}
    out = {}
    for k, v in wall.items():
        host, dev_k, busy = prof[k]
        out[f"{k}_ms"] = {"median": statistics.median(v),
                          "range": [min(v), max(v)]}
        out[f"{k}_api_calls"] = sum(host.values())
        out[f"{k}_kernels"] = sum(c for c, _ in dev_k.values())
        out[f"{k}_device_busy_ms"] = busy
        out[f"{k}_idle"] = 1.0 - busy / statistics.median(v)
    out["train_api"], out["test_api"] = prof["train"][0], prof["test"][0]
    variance = [g for g in graphs.captures
                if g.key[0] == "variance" and g.graph is not None]
    out["variance_graph_ms"] = cuda_ms(variance[-1].replay) \
        if variance else None
    out["captures"] = [capture_record(g) for g in graphs.captures]
    out["report_s"] = time.perf_counter() - t_start

    def line(k):
        m = out[f"{k}_ms"]
        return (f"{m['median']:.4f} ms ({m['range'][0]:.4f}-"
                f"{m['range'][1]:.4f}), {out[f'{k}_api_calls']} API calls, "
                f"{out[f'{k}_kernels']} kernels, device busy "
                f"{out[f'{k}_device_busy_ms']:.4f} ms (idle "
                f"{100 * out[f'{k}_idle']:.1f}%)")

    log(f"{label} on {card}, medians of {TIMED_RUNS} alternated: train "
        f"graphed {line('train')} vs eager {line('train_eager')}; test "
        f"graphed {line('test')} vs eager {line('test_eager')}; the "
        f"variance graph's replay (whitening + reduction) "
        + ("not run" if out["variance_graph_ms"] is None else
           f"{out['variance_graph_ms']:.4f} ms (CUDA events, median of "
           f"{REPS})") + f"; report {out['report_s']:.1f} s")
    log(f"{label} host CUDA API calls: train {out['train_api']}; test "
        f"{out['test_api']}")
    for c in out["captures"]:
        log(f"{label} graph {c['key']}: warm-up {c['warmup_ms']:.2f} ms, "
            f"capture {c['capture_ms']:.2f} ms, pool {c['pool_mib']:.1f} "
            f"MiB, replays {c['replays']}")
    return out


def run_exact_gp(dev, card):
    """Phase 12. Returns (launch counts, timings, errors)."""
    from erl_gaussian_process_tpu_torch.kernels import KernelSetting
    from erl_gaussian_process_tpu_torch.models import (
        VanillaGaussianProcess,
        VanillaGPSetting,
    )
    from erl_gaussian_process_tpu_torch.ops import (
        launch_counts,
        reset_launch_counts,
    )
    from erl_gaussian_process_tpu_torch.workloads import exact_gp_workload

    x, y, var, xq, scale, kern = exact_gp_workload()
    setting = VanillaGPSetting(kernel_type=kern,
                               kernel=KernelSetting(x_dim=2, scale=scale),
                               max_num_samples=x.shape[0])
    gp = VanillaGaussianProcess(setting, dtype=np.float32, device=dev)

    def train():
        return gp.train(x.T, y, var)

    def first_test():
        r = gp.test(xq.T)
        return r.get_mean(), r.get_variance()

    # the captures (not counted): the fit's graph, the test's and the
    # variance's (4096 queries whiten by substitution in every query: the
    # L^-1 path takes batches of at most 512)
    ok, capture_train_ms = timed(train)
    check(ok, "exact GP first train (its capture)")
    _, capture_test_ms = timed(first_test)
    reset_launch_counts()
    ok, train_ms = timed(train)
    check(ok, "exact GP train")
    res, test_ms = timed(lambda: gp.test(xq.T))
    (mean, var_k), var_ms = timed(lambda: (res.get_mean(), res.get_variance()))
    counts = launch_counts()
    m64, v64 = (t.cpu().numpy() for t in plain_posterior(
        kern, x, y, var, xq, scale, torch.float64, dev))
    m32, v32 = (t.cpu().numpy() for t in plain_posterior(
        kern, x, y, var, xq, scale, torch.float32, dev))
    mae_k, mae_p = np.abs(mean - m64).mean(), np.abs(m32 - m64).mean()
    ve_k, ve_p = np.abs(var_k - v64).max(), np.abs(v32 - v64).max()
    log(f"exact GP f32 n={x.shape[0]}, {xq.shape[0]} queries vs the plain "
        f"f64 fit: mean MAE {mae_k:.3e} (plain f32 {mae_p:.3e}; gate <= "
        f"{POSTERIOR_FACTOR:g}x; the JAX TPU test's class "
        f"{JAX_TPU_POSTERIOR_MAE:g}), variance max error {ve_k:.3e} (plain "
        f"f32 {ve_p:.3e}); first train (its capture) {capture_train_ms:.3f} "
        f"ms, first test {capture_test_ms:.3f} ms; then train "
        f"{train_ms:.3f} ms, test {test_ms:.3f} ms + mean and variance "
        f"{var_ms:.3f} ms on {card}; launches {counts}")
    check(np.isfinite(mean).all() and np.isfinite(var_k).all()
          and mean.shape == (xq.shape[0],), "exact GP output not finite")
    check(mae_k <= POSTERIOR_FACTOR * mae_p and ve_k <= POSTERIOR_FACTOR * ve_p,
          f"exact GP posterior: MAE {mae_k} vs {mae_p}, variance {ve_k} vs "
          f"{ve_p}")
    check(counts["chol_gram"] == 1 and counts["trsv"] == 2
          and counts["gram"] >= 1, f"exact GP launches {counts}")
    del res
    graphs = exact_graphs_vs_eager(f"exact GP f32 n={x.shape[0]}", card, gp,
                                   train, first_test)
    # the test's chain under torch.profiler, run eagerly (the graph replays
    # the same launches; a trace of the replay lost its first ~100 kernels,
    # the gram among them, in one card run)
    test_graph = next(g for g in gp._graphs.captures if g.key[0] == "test")
    captured = {w.__name__: k for w, k in test_graph.launches.items()}
    held, gp._graphs = gp._graphs, None
    try:
        shape = (x.shape[0], xq.shape[0])
        g_launches, g_wheres, g_kernels = gram_profile(first_test, shape)
    finally:
        gp._graphs = held
    log(f"exact GP test's chain under torch.profiler on {card}: {g_launches}"
        f" gram launch, {g_wheres} where ops over the {shape} gram; kernels "
        f"{g_kernels}; the test graph captured {captured}")
    check(g_launches == 1 and g_wheres == 0
          and captured == {"cross_gram_cuda": 1},
          f"exact GP test: {g_launches} gram launches, {g_wheres} where ops "
          f"over the gram, the test graph captured {captured}")
    return counts, {"exact_gp_first_train_ms": capture_train_ms,
                    "exact_gp_first_test_ms": capture_test_ms,
                    "exact_gp_graphs": graphs}, \
        {"mae": float(mae_k), "mae_plain_f32": float(mae_p),
         "var_err": float(ve_k), "var_err_plain_f32": float(ve_p)}


# the exact fit's kernels by name: the factorization's three launches per
# column and the two substitutions
FIT_PARTS = (("update", "chol_update"), ("diagonal", "chol_diag"),
             ("apply", "chol_apply"), ("substitution", "trsv_kernel"))


def profile_exact_fit(dev, card):
    """Phase 12b: one exact-GP ``train`` (n = 8192, float32; its eager
    chain) under ``torch.profiler``: launches and device ms of the
    factorization's update, diagonal and apply kernels and of the
    substitution. The substitution is one launch per direction. Returns
    {part: [launches, device ms]}."""
    from torch.profiler import ProfilerActivity, profile

    from erl_gaussian_process_tpu_torch.kernels import KernelSetting
    from erl_gaussian_process_tpu_torch.models import (
        VanillaGaussianProcess,
        VanillaGPSetting,
    )
    from erl_gaussian_process_tpu_torch.workloads import exact_gp_workload

    x, y, var, _, scale, kern = exact_gp_workload()
    gp = VanillaGaussianProcess(VanillaGPSetting(
        kernel_type=kern, kernel=KernelSetting(x_dim=2, scale=scale),
        max_num_samples=x.shape[0]), dtype=np.float32, device=dev)
    # the fit's chain, eagerly: a graph replays the same launches (phase
    # 12 counts them), and a trace of a replay lost its first kernels once
    gp._graphs = None
    check(gp.train(x.T, y, var), "exact GP train before the profile")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        check(gp.train(x.T, y, var), "profiled exact GP train")
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    parts = {}
    for part, key in FIT_PARTS:
        hit = [e for e in events if key in e.key]
        parts[part] = [sum(e.count for e in hit),
                       sum(e.self_device_time_total for e in hit) / 1e3]
    log(f"exact GP fit profile (n={x.shape[0]}, float32, torch.profiler) on "
        f"{card}: " + "; ".join(
            f"{part} {cnt} launches {ms:.3f} ms ({1e3 * ms / max(cnt, 1):.2f}"
            f" us each)" for part, (cnt, ms) in parts.items()))
    check(parts["substitution"][0] == 2,
          f"the substitution is not one launch per direction: {parts}")
    check(all(cnt > 0 and ms > 0 for cnt, ms in parts.values()),
          f"the profile saw no device time for a part of the fit: {parts}")
    return parts


def nigp_plain_outputs(name, x, y, grad, vx, vy, vg, xq, scale, dtype, dev):
    """(mean, gradient, mean var, grad var, cov) of the NIGP by the plain
    path on the card (joint gram, cuSOLVER Cholesky, triangular solves) at
    ``dtype``."""
    from erl_gaussian_process_tpu_torch.kernels import train_gram_with_gradient
    from erl_gaussian_process_tpu_torch.models.noisy_input_gp import (
        NoisyInputGPState,
        nigp_gradient,
        nigp_ktest,
        nigp_mean,
        nigp_variance_cov,
        pack_alpha,
    )

    X, Y, G, VX, VY, VG, Q = (torch.as_tensor(a, device=dev, dtype=dtype)
                              for a in (x, y, grad, vx, vy, vg, xq))
    n, d = X.shape
    m = torch.ones(n, dtype=torch.bool, device=dev)
    K = train_gram_with_gradient(name, X, VX, VY, VG, m, m, scale)
    L = torch.linalg.cholesky(K)
    st = NoisyInputGPState(X, m, m, L, torch.cholesky_solve(
        pack_alpha(Y, G, m, m), L))
    kt = nigp_ktest(st, Q, scale, kernel=name, with_test_grad=True,
                    with_train_grad=True)
    mq = Q.shape[0]
    return (nigp_mean(st, kt, mq)[:, 0], nigp_gradient(st, kt, mq, d)[:, :, 0],
            *nigp_variance_cov(st, kt, scale, d=d))


def run_nigp(dev, card):
    """Phase 13. Returns (launch counts, timings, errors)."""
    from erl_gaussian_process_tpu_torch.kernels import (
        KernelSetting,
        register_scale_mixture,
    )
    from erl_gaussian_process_tpu_torch.models import (
        NoisyInputGaussianProcess,
        NoisyInputGPSetting,
    )
    from erl_gaussian_process_tpu_torch.ops import (
        launch_counts,
        reset_launch_counts,
    )
    from erl_gaussian_process_tpu_torch.workloads import nigp_workload

    x, y, grad, vx, vy, vg, xq, scale, kern = nigp_workload()
    n, d = x.shape
    g_ref = grad[:, :, 0].T                          # (d * q, n)
    counts, timings, errors = {}, {}, {}
    mix = register_scale_mixture("rbf", 0.5, (0.7, 0.3))
    for label, kt in (("rbf", kern), ("mixture", "mix")):
        setting = NoisyInputGPSetting(
            kernel_type=kt if kt != "mix" else "rbf",
            kernel=KernelSetting(x_dim=d, scale=scale,
                                 **({"scale_mix": 0.5, "weights": [0.7, 0.3]}
                                    if kt == "mix" else {})),
            max_num_samples=n)
        gp = NoisyInputGaussianProcess(setting, dtype=np.float32, device=dev)
        name = gp._kernel
        check(name == (mix if kt == "mix" else kern), f"kernel {name}")

        def train():
            return gp.train(x.T, y, g_ref, vx, vy, vg)

        def predict():
            r = gp.test(xq.T, True)
            return (r.get_mean(), r.get_gradient().T, r.get_mean_variance(),
                    r.get_gradient_variance().T, r.get_covariance().T)

        # the captures (not counted): the fit's, the test's, the variance's
        ok, capture_train_ms = timed(train)
        check(ok, f"NIGP {label} first train (its capture)")
        _, capture_test_ms = timed(predict)
        reset_launch_counts()
        ok, train_ms = timed(train)
        check(ok, f"NIGP {label} train")
        got, test_ms = timed(predict)
        counts[label] = launch_counts()
        ref64 = [t.cpu().numpy() for t in nigp_plain_outputs(
            name, x, y, grad, vx, vy, vg, xq, scale, torch.float64, dev)]
        ref32 = [t.cpu().numpy() for t in nigp_plain_outputs(
            name, x, y, grad, vx, vy, vg, xq, scale, torch.float32, dev)]
        what = ("mean", "gradient", "mean var", "grad var", "cov")
        errs = {}
        for w, g, r64, r32 in zip(what, got, ref64, ref32):
            check(np.isfinite(g).all() and g.shape == r64.shape,
                  f"NIGP {label} {w}: shape {g.shape} or not finite")
            if w in ("mean", "gradient"):
                ek, ep = np.abs(g - r64).mean(), np.abs(r32 - r64).mean()
            else:
                ek, ep = np.abs(g - r64).max(), np.abs(r32 - r64).max()
            errs[w] = (float(ek), float(ep))
            check(ek <= POSTERIOR_FACTOR * ep,
                  f"NIGP {label} {w}: error {ek} > {POSTERIOR_FACTOR} x "
                  f"plain f32 {ep}")
        errors[label] = errs
        timings[f"nigp_{label}_first_train_ms"] = capture_train_ms
        timings[f"nigp_{label}_first_test_ms"] = capture_test_ms
        log(f"NIGP f32 {label} n={n} d={d} (joint {(1 + d) * n}^2), "
            f"{xq.shape[0]} queries vs the plain f64 fit (MAE for mean and "
            f"gradient, max error for the rest; plain f32 in brackets, gate "
            f"<= {POSTERIOR_FACTOR:g}x): "
            + ", ".join(f"{w} {e[0]:.3e} ({e[1]:.3e})"
                        for w, e in errs.items())
            + f"; first train (its capture) {capture_train_ms:.3f} ms, "
            f"first test {capture_test_ms:.3f} ms; then train "
            f"{train_ms:.3f} ms, test {test_ms:.3f} ms on {card}; launches "
            f"{counts[label]}")
        timings[f"nigp_{label}_graphs"] = exact_graphs_vs_eager(
            f"NIGP f32 {label} joint {(1 + d) * n}^2", card, gp, train,
            predict)
    check(counts["rbf"]["chol_gram_joint"] == 1 and counts["rbf"]["trsv"] == 2,
          f"NIGP launches {counts['rbf']}")
    check(counts["mixture"]["chol"] == 1 and counts["mixture"]["trsv"] == 2,
          f"NIGP mixture launches {counts['mixture']}")
    return counts, timings, errors


def run_nigp_golden(dev, card):
    """Phase 14: the reference's 50x50 golden at float64. Returns (launch
    counts, timings, (mae, mx, my))."""
    from erl_gaussian_process_tpu_torch.models import (
        NoisyInputGaussianProcess,
    )
    from erl_gaussian_process_tpu_torch.ops import (
        launch_counts,
        reset_launch_counts,
    )
    from erl_gaussian_process_tpu_torch.workloads import (
        NIGP_GOLDEN_BOUNDS,
        NIGP_GOLDEN_RECORDED,
        nigp_golden_workload,
    )

    setting, pts, z, grad, noise, qt, zt, gt = nigp_golden_workload()
    gp = NoisyInputGaussianProcess(setting, dtype=np.float64, device=dev)

    def train():
        return gp.train(pts, z, grad, var_x=noise, var_y=noise,
                        var_grad=noise)

    def predict():
        r = gp.test(qt, predict_gradient=True)
        return r.get_mean(0), r.get_gradient(0)

    # the captures (not counted): the fit's graph and the test's
    ok, capture_train_ms = timed(train)
    check(ok, "NIGP golden first train (its capture)")
    _, capture_test_ms = timed(predict)
    reset_launch_counts()
    ok, train_ms = timed(train)
    check(ok, "NIGP golden train")
    (mean, g), test_ms = timed(predict)
    counts = launch_counts()
    got = (np.abs(mean - zt).mean(), np.abs(g[0] - gt[0]).mean(),
           np.abs(g[1] - gt[1]).mean())
    log(f"NIGP golden f64 (7500^2 joint): MAE {got[0]:.6e}, mx {got[1]:.6e},"
        f" my {got[2]:.6e} (bounds {NIGP_GOLDEN_BOUNDS}); deviation from the "
        f"recorded values "
        + ", ".join(f"{a - r:.3e}" for a, r in zip(got, NIGP_GOLDEN_RECORDED))
        + f" (reported); first train (its capture) {capture_train_ms:.3f} "
        f"ms, first test {capture_test_ms:.3f} ms; then train "
        f"{train_ms:.3f} ms, test (mean and gradient) {test_ms:.3f} ms on "
        f"{card}; launches {counts}")
    check(all(a < b for a, b in zip(got, NIGP_GOLDEN_BOUNDS)),
          f"NIGP golden: {got} not under {NIGP_GOLDEN_BOUNDS}")
    check(counts["chol_gram_joint"] == 1, f"NIGP golden launches {counts}")
    graphs = exact_graphs_vs_eager("NIGP golden f64 joint 7500^2", card, gp,
                                   train, predict)
    return counts, {"nigp_golden_first_train_ms": capture_train_ms,
                    "nigp_golden_first_test_ms": capture_test_ms,
                    "nigp_golden_graphs": graphs}, \
        tuple(float(v) for v in got)


# -- the 2D paths and reduced rank (phases 15-17) ----------------------------

MAP2D_POSES = 50
MAP2D_FREE_SLOTS = 20
MAP2D_RAYS = 135
# tests/test_long_horizon.py:20-53 and its gates (:89-100): drift, confident
# sign agreement, mean relative error against the float64 replay
LONG_HORIZON_POSES = 200
LONG_HORIZON_NMAX = 2048
LONG_HORIZON_GATES = (1e-3, 0.999, 1e-4)
# tests/test_lidar_gp_2d.py's MAE gates: float64 without and with
# discontinuity detection, float32 (the float log), world-frame queries;
# the reduced-rank lidar GP's (:155-210) and the 2D Matérn's
# (tests/test_reduced_rank.py:240-259)
LIDAR2D_MAE = {"float64": 0.022, "float64 discontinuity": 0.08,
               "float32": 0.04, "world": 0.022}
RR_LIDAR_MAE = 0.02
RR_2D_MAE = 2e-2
MAP2D_SRC = ("erl_gaussian_process_tpu_torch/csrc/fitc.cu",
             "erl_gaussian_process_tpu/ops/pallas_fitc.py:145")


def map2d_setting():
    """config/spgp_occupancy_map_2d.yaml's production config, built in code
    (the card's machine has no PyYAML): matern32 d = 2 at scale 0.18, 2000
    samples, log-odds +-1 at variance 1e-4, 3 free points a meter."""
    from erl_gaussian_process_tpu_torch.kernels import KernelSetting
    from erl_gaussian_process_tpu_torch.models import (
        SpGpOccupancyMapSetting,
        SpGpSetting,
    )

    return SpGpOccupancyMapSetting(
        sp_gp=SpGpSetting(kernel_type="matern32",
                          kernel=KernelSetting(x_dim=2, scale=0.18),
                          max_num_samples=2000),
        min_distance=0.0, max_distance=30.0, free_points_per_meter=3.0,
        free_sampling_margin=0.01, logodd_free=-1.0, logodd_occupied=1.0,
        logodd_variance=1e-4)


def map2d_pseudo() -> np.ndarray:
    """The 31 x 31 pseudo points on [-3, 3]^2, (2, 961) column-major."""
    c = np.linspace(-3.0, 3.0, 31)
    pv, qv = np.meshgrid(c, c, indexing="ij")
    return np.stack([pv.ravel(), qv.ravel()], axis=0)


def map2d_scans(n_poses, rays=MAP2D_RAYS, half_angle=135 / 180 * np.pi):
    """(sensors (P, 2), world end points (P, R, 2), hit masks (P, R)) of
    the reference ellipse's n_poses poses, float32."""
    from erl_gaussian_process_tpu_torch.geometry.simulators import (
        Lidar2D,
        lidar_scan_points_2d,
        reference_space_2d,
        reference_trajectory_2d,
    )

    lidar = Lidar2D(Lidar2D.Setting(min_angle=-half_angle,
                                    max_angle=half_angle, num_lines=rays),
                    reference_space_2d())
    traj = reference_trajectory_2d(n_poses)
    scans = [lidar_scan_points_2d(lidar, p) for p in traj]
    return (traj[:, :2].astype(np.float32),
            np.stack([s[1] for s in scans]).astype(np.float32),
            np.stack([s[2] for s in scans]))


def long_horizon_batches():
    """tests/test_long_horizon.py:20-53's datasets: 200 poses of the
    ellipse, 135 rays over +-2.356 rad, each hit and 4 uniform free points
    on its ray (rng seed 0), in a 2048-slot budget, float32."""
    from erl_gaussian_process_tpu_torch.geometry.simulators import (
        Lidar2D,
        lidar_scan_points_2d,
        reference_space_2d,
        reference_trajectory_2d,
    )

    n, nmax = LONG_HORIZON_POSES, LONG_HORIZON_NMAX
    lidar = Lidar2D(Lidar2D.Setting(min_angle=-2.356, max_angle=2.356,
                                    num_lines=MAP2D_RAYS),
                    reference_space_2d())
    rng = np.random.default_rng(0)
    dx = np.zeros((n, nmax, 2), np.float32)
    dy = np.zeros((n, nmax, 1), np.float32)
    dm = np.zeros((n, nmax), bool)
    for i, pose in enumerate(reference_trajectory_2d(n)):
        _, pts, hit = lidar_scan_points_2d(lidar, pose)
        pts = pts[hit]
        t = rng.uniform(0.05, 0.95, (len(pts), 4))
        free = (pose[:2][None, :] + (pts - pose[:2][None, :])[:, None, :]
                * t[:, :, None]).reshape(-1, 2)
        X = np.concatenate([pts, free])[:nmax]
        y = np.concatenate([np.ones(len(pts)), -np.ones(len(free))])[:nmax]
        dx[i, :len(X)] = X
        dy[i, :len(X), 0] = y
        dm[i, :len(X)] = True
    return dx, dy, dm


def fitc_bound(m, n, d):
    """(ms, by) of one float32 FITC update at M = m, N = n, d: L_inv's
    lower triangle and the samples (x, y, var, mask) read, dQ written; the
    triangular L_inv product M (M + 1) N at the FP64 tensor cores' rate
    (the float32 beta runs there), the lower SYRK M (M + 1) N at the
    3xTF32 rate, kmn ~20 M N at the FP32 rate outside the tensor cores,
    one after the other."""
    nbytes = 4 * (m * (m + 1) // 2 + m * m + (d + 3) * n)
    half = m * (m + 1) * n
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * (half / FP64_TC_FLOPS + half / TF32X3_FLOPS
                   + 20 * m * n / PEAK_FLOPS[torch.float32])
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_map2d_kernels(dev, card) -> dict:
    """Phase 15a: FITC at the 2D map's shape (M = 1024: 961 pseudo points
    far-point padded; N = 2048: pose 0's sampled dataset; d = 2) against
    its plain version at float64 and float32 (FITC_VAR, FITC_TOL), the
    float32 2x gate against float64 at the map's variance 1e-4, the kernel
    and plain times and the bound; the predict's gram k(P, x*) at 1024 x
    2048 d = 2 likewise. Returns {"fitc_2d": ..., "gram_2d": ...}."""
    from erl_gaussian_process_tpu_torch.geometry.simulators import (
        reference_space_2d,
    )
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

    s = map2d_setting()
    scale = float(s.sp_gp.kernel.scale)
    p_pad = pad_pseudo_points(np.ascontiguousarray(map2d_pseudo().T))
    sensors, pts, masks = map2d_scans(1)
    lo, hi = np.array([-3.0, -3.0]), np.array([3.0, 3.0])
    out, fitc_args, err32 = {}, None, 0.0
    for dt in (torch.float64, torch.float32):
        st = spgp_init(torch.as_tensor(p_pad, device=dev, dtype=dt), scale,
                       kernel="matern32")
        g = torch.Generator(device=dev)
        g.manual_seed(step_seed(0, 1))
        x, y, _, mask = sample_pose(
            *(torch.as_tensor(a, device=dev, dtype=dt)
              for a in (sensors[0], pts[0])),
            torch.as_tensor(masks[0], device=dev),
            *(torch.as_tensor(a, device=dev, dtype=dt) for a in (lo, hi)),
            free_slots=MAP2D_FREE_SLOTS,
            max_samples=int(s.sp_gp.max_num_samples),
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
            log(f"fitc_2d M={dq.shape[0]} N={x.shape[0]} d=2 active "
                f"{int(mask.sum())} {str(dt):14s} var {var_val:g}: rel_err "
                f"dQ {rel_q:.3e} dalpha {rel_a:.3e}"
                + (f" (tol {FITC_TOL[dt]:g})" if gated else " (reported)"))
            check(bool(torch.equal(dq, dq.T)), f"fitc_2d {dt}: dQ not "
                  "symmetric")
            check(bool((dq[961:] == 0).all() and (da[961:] == 0).all()),
                  f"fitc_2d {dt}: far-point rows not exactly 0")
            if gated:
                check(rel_q <= FITC_TOL[dt] and rel_a <= FITC_TOL[dt],
                      f"fitc_2d {dt} var {var_val}: rel err {rel_q}, "
                      f"{rel_a} > {FITC_TOL[dt]}")
                if dt == torch.float32:
                    err32 = float((dq - dq_ref).abs().max())
            if dt == torch.float32 and var_val == s.logodd_variance:
                fitc_args = args
    check(fitc_args[1].shape == (1024, 2) and fitc_args[3].shape == (2048, 2),
          f"fitc_2d shapes {fitc_args[1].shape}, {fitc_args[3].shape}")
    fitc_against_truth(fitc_args)
    b_ms, b_by = fitc_bound(1024, 2048, 2)
    out["fitc_2d"] = {
        "max_abs_err": err32, "library_ms": None, "bound_ms": b_ms,
        "bound_by": b_by,
        "ms": batch_ms(lambda: fitc_update_cuda(*fitc_args)),
        "plain_ms": batch_ms(lambda: fitc_update_plain(*fitc_args))}
    log(f"fitc_2d M=1024 N=2048 d=2 float32 on {card}: kernel "
        f"{out['fitc_2d']['ms']:.4f} ms, plain {out['fitc_2d']['plain_ms']:.4f}"
        f" ms (median of {REPS} batches of {BATCH}), bound {b_ms:.4f} ms "
        f"({b_by})")
    log_device_split("fitc_2d M=1024 N=2048 float32",
                     lambda: fitc_update_cuda(*fitc_args))
    out["fitc_2d"].update(time_fitc_syrk(fitc_args, "1b"))

    # the predict's gram: the padded pseudo points against 2048 queries
    xq = np.random.default_rng(0).uniform(-3, 3, (2048, 2))
    sp = reference_space_2d().surface_points(0.05)
    err32 = 0.0
    for dt in (torch.float32, torch.float64):
        P = torch.as_tensor(p_pad, device=dev, dtype=dt)
        Q = torch.as_tensor(np.concatenate([xq, sp])[:2048], device=dev,
                            dtype=dt)
        k = cross_gram_cuda("matern32", P, Q, scale)
        torch.cuda.synchronize()
        err = float((k - cross_gram_plain("matern32", P, Q, scale)
                     ).abs().max())
        log(f"gram_2d (a 2D map predict) matern32 {str(dt):14s} shape "
            f"{tuple(k.shape)} max_abs_err {err:.3e} (tol {GRAM_TOL[dt]:g})")
        check(err <= GRAM_TOL[dt] and not bool((k[961:] != 0).any()),
              f"gram_2d {dt}: error {err} or a far-point row not 0")
        if dt == torch.float32:
            err32, P32, Q32 = err, P, Q
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    b_ms, b_by, _ = gram_bound("matern32", torch.float32, 1, 1024, 2048, 2,
                               1024, False, sms, sm_clock_mhz())
    out["gram_2d"] = {
        "max_abs_err": err32, "library_ms": None, "bound_ms": b_ms,
        "bound_by": "bytes" if b_by == "bytes" else "operations",
        "ms": cuda_ms(lambda: cross_gram_cuda("matern32", P32, Q32, scale)),
        "plain_ms": cuda_ms(lambda: cross_gram_plain("matern32", P32, Q32,
                                                     scale))}
    log(f"gram_2d 1024x2048 d=2 float32 on {card}: kernel "
        f"{out['gram_2d']['ms']:.4f} ms, plain "
        f"{out['gram_2d']['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return out


def run_map_2d(dev, card):
    """Phases 15b-d: the 2D map at its production config on the card: the
    50-pose ellipse through ``update`` then ``predict`` with gradients
    (surface > 0.9 occupied, trajectory > 0.95 free, every gradient
    finite), one pose under ``torch.profiler`` (FITC's plan's launches),
    ms/pose over 5 replays; then the 200-pose float32 ``spgp_update`` chain
    against the plain float64 replay of the same datasets. Returns (launch
    counts, timings)."""
    from erl_gaussian_process_tpu_torch.geometry import Aabb, GridMapInfo2D
    from erl_gaussian_process_tpu_torch.geometry.simulators import (
        reference_space_2d,
        reference_trajectory_2d,
    )
    from erl_gaussian_process_tpu_torch.models import SpGpOccupancyMap
    from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
        pad_pseudo_points,
        spgp_init,
        spgp_predict,
        spgp_prepare,
        spgp_update,
    )
    from erl_gaussian_process_tpu_torch.ops import (
        launch_counts,
        reset_launch_counts,
    )
    from erl_gaussian_process_tpu_torch.ops.fitc import fitc_plan
    from erl_gaussian_process_tpu_torch.utils.drift import (
        drift_metric,
        replay_f64,
        sign_agreement,
    )

    setting, pseudo = map2d_setting(), map2d_pseudo()
    box = Aabb.from_min_max([-3.0, -3.0], [3.0, 3.0])
    sensors, pts, masks = map2d_scans(MAP2D_POSES)
    surf = reference_space_2d().surface_points(0.05).astype(np.float32)
    traj = reference_trajectory_2d(MAP2D_POSES)[:, :2].astype(np.float32)

    def new_map():
        return SpGpOccupancyMap(setting, pseudo, box, seed=0,
                                dtype=torch.float32,
                                free_slots_per_ray=MAP2D_FREE_SLOTS,
                                device=dev)

    def replay():
        m = new_map()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(MAP2D_POSES):
            m.update(sensors[i], pts[i], masks[i])
        torch.cuda.synchronize()
        return m, 1e3 * (time.perf_counter() - t0) / MAP2D_POSES

    warm = new_map()                           # warm-up, not counted
    for i in range(2):
        warm.update(sensors[i], pts[i], masks[i])
    warm.predict(surf[:8], compute_gradient=True)
    torch.cuda.synchronize()
    reset_launch_counts()
    m, first_ms = replay()
    lo_surf, grad = m.predict(surf, compute_gradient=True)
    lo_traj, _ = m.predict(traj)
    counts = launch_counts()
    occ = float((lo_surf > 0).float().mean())
    free = float((lo_traj < 0).float().mean())
    log(f"2D map ({MAP2D_POSES} poses, 961 pseudo points padded to "
        f"{m.state.pseudo.shape[0]}, float32): surface occupied {occ:.4f} "
        f"(gate > 0.9), trajectory free {free:.4f} (gate > 0.95), gradients "
        f"finite {bool(torch.isfinite(grad).all())}; launch counts {counts}")
    check(occ > 0.9 and free > 0.95 and bool(torch.isfinite(grad).all()),
          f"2D map quality: surface {occ}, trajectory {free}")
    from erl_gaussian_process_tpu_torch.ops import fitc_update_cuda

    replayed, warm_ups = graph_launches((m,), fitc_update_cuda)
    check(replayed == MAP2D_POSES and counts["fitc"] == replayed + warm_ups
          and counts["gram"] > 0,
          f"2D map launches {counts}: FITC {replayed} by the replays, "
          f"{warm_ups} by the warm-ups")
    plan = fitc_plan(m.state.pseudo.shape[0],
                     int(setting.sp_gp.max_num_samples),
                     torch.cuda.get_device_properties(dev).multi_processor_count)
    pose_kernels = device_kernels(
        lambda: m.update(sensors[0], pts[0], masks[0]))
    fitc_pose = sum(c for k, (c, _) in pose_kernels.items()
                    if any(f in k for f in FITC_KERNELS))
    log(f"2D map: FITC launches per pose {fitc_pose} by torch.profiler (plan "
        f"{plan.launches}: {syrk_grid(plan)}), of "
        f"{sum(c for c, _ in pose_kernels.values())} "
        "kernel launches per pose")
    check(fitc_pose == plan.launches,
          f"2D map FITC launches per pose {fitc_pose} != {plan.launches}")
    ms_pose = [first_ms] + [replay()[1] for _ in range(TIMED_RUNS - 1)]
    predict_ms = [timed(lambda: m.predict(surf, compute_gradient=True))[1]
                  for _ in range(TIMED_RUNS)]
    timings = {"map2d_ms_per_pose": statistics.median(ms_pose),
               "map2d_ms_per_pose_range": [min(ms_pose), max(ms_pose)],
               "map2d_predict_grad_ms": statistics.median(predict_ms),
               "map2d_predict_grad_ms_range": [min(predict_ms),
                                               max(predict_ms)],
               "map2d_n_predict": int(len(surf)),
               "map2d_kernel_launches_per_pose": sum(
                   c for c, _ in pose_kernels.values())}
    log(f"2D map on {card}: update {timings['map2d_ms_per_pose']:.4f} "
        f"ms/pose (median of {TIMED_RUNS} replays of {MAP2D_POSES}, range "
        f"{min(ms_pose):.4f}-{max(ms_pose):.4f}); cached predict with "
        f"gradients of {len(surf)} points "
        f"{timings['map2d_predict_grad_ms']:.4f} ms (median of "
        f"{TIMED_RUNS}, range {min(predict_ms):.4f}-{max(predict_ms):.4f})")

    # 200 poses through the float32 spgp_update chain (the FITC kernel)
    # against the plain float64 replay of the same datasets
    dx, dy, dm = long_horizon_batches()
    p64 = GridMapInfo2D([-3, -3], [3, 3], [31, 31]) \
        .generate_meter_coordinates()
    grid = GridMapInfo2D([-2.5, -2.5], [2.5, 2.5], [31, 31]) \
        .generate_meter_coordinates().astype(np.float32)
    scale, var = 0.18, 1e-4
    st = spgp_init(torch.as_tensor(pad_pseudo_points(p64.astype(np.float32)),
                                   device=dev), scale, kernel="matern32")
    vv = torch.full((LONG_HORIZON_NMAX,), var, dtype=torch.float32,
                    device=dev)
    DX, DY, DM = (torch.as_tensor(a, device=dev) for a in (dx, dy, dm))
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(LONG_HORIZON_POSES):
        st = spgp_update(st, DX[i], DY[i], vv, DM[i], scale,
                         kernel="matern32")
    torch.cuda.synchronize()
    chain_ms = 1e3 * (time.perf_counter() - t0)
    counts_long = launch_counts()
    L_qm, a = spgp_prepare(st)
    mean, _, _ = spgp_predict(st, L_qm, a, torch.as_tensor(grid, device=dev),
                              scale, kernel="matern32", with_var=False)
    lo32 = mean[:, 0].double().cpu().numpy()
    t0 = time.perf_counter()
    lo64 = replay_f64(p64, scale, "matern32", dx, dy, dm, var, grid,
                      device=dev)
    t64 = time.perf_counter() - t0
    drift = drift_metric(lo32, lo64)
    agree = float(np.mean(np.sign(lo32) == np.sign(lo64)))
    mean_rel = float(np.abs(lo32 - lo64).mean() / np.abs(lo64).max())
    g_drift, g_agree, g_mean = LONG_HORIZON_GATES
    log(f"2D long horizon ({LONG_HORIZON_POSES} poses, float32 spgp_update "
        f"on the card, {counts_long['fitc']} FITC launches, {chain_ms:.2f} "
        f"ms): drift {drift:.6e} (gate < {g_drift:g}), sign agreement "
        f"{agree:.6f} (gate > {g_agree:g}; confident cells "
        f"{sign_agreement(lo32, lo64):.6f}), mean relative error "
        f"{mean_rel:.6e} (gate < {g_mean:g}); plain float64 replay "
        f"{t64:.3f} s")
    check(np.isfinite(lo32).all() and drift < g_drift and agree > g_agree
          and mean_rel < g_mean,
          f"2D long horizon: drift {drift}, agreement {agree}, mean "
          f"{mean_rel}")
    check(counts_long["fitc"] == LONG_HORIZON_POSES,
          f"2D long horizon FITC launches {counts_long['fitc']}")
    timings.update({"long_horizon_drift": drift,
                    "long_horizon_sign_agreement": agree,
                    "long_horizon_mean_rel_err": mean_rel,
                    "long_horizon_chain_ms": chain_ms})
    return counts, timings


def lidar2d_setting(angles, discontinuity: bool, kernel=None):
    """tests/test_lidar_gp_2d.py:25-50's setting: OU at scale 0.05,
    identity mapping, asymmetric 26/6 partitions, noise 0.01 (100 at a
    discontinuity); ``kernel`` replaces the gp entry."""
    from erl_gaussian_process_tpu_torch.models import LidarGP2DSetting

    return LidarGP2DSetting.from_dict(dict(
        partition_on_hit_rays=False, symmetric_partitions=False,
        group_size=26, overlap_size=6, margin=1, init_variance=1e6,
        sensor_range_var=0.01, discontinuity_var=100.0,
        max_valid_range_var=0.1,
        sensor_frame=dict(valid_range_min=0.1, valid_range_max=30.0,
                          angle_min=float(angles[0]),
                          angle_max=float(angles[-1]),
                          num_rays=int(angles.shape[0]),
                          discontinuity_detection=discontinuity),
        gp=kernel or dict(kernel_type="ou",
                          kernel=dict(x_dim=1, scale=0.05)),
        mapping=dict(type="identity")))


def lidar_logs():
    """(data/double/train.dat frames, data/float/train.dat frames)."""
    from erl_gaussian_process_tpu_torch.utils.loaders import load_lidar_log

    root = os.path.dirname(os.path.abspath(__file__))
    return (load_lidar_log(os.path.join(root, "data", "double",
                                        "train.dat")),
            load_lidar_log(os.path.join(root, "data", "float", "train.dat"),
                           np.float32))


def routed_gram_operands_2d(gp, angles_local):
    """The batched gram's operands (x1, x2, row mask) as the 2D lidar GP's
    graphed routed test builds them for these sensor-frame angles: padded
    with NaN to a multiple of ``batch_gp.ROUTE_PAD``, routed by
    ``_route_tensor`` on the partition bounds and grouped by
    ``batch_gp.group_chunks`` into rows of ``ROUTE_CHUNK`` slots, as
    ``batch_gp.bank_predict_chunked`` does."""
    from erl_gaussian_process_tpu_torch.models.batch_gp import (
        ROUTE_CHUNK,
        ROUTE_PAD,
        group_chunks,
    )

    bank = gp.bank
    dev = bank.x.device
    m = angles_local.shape[0]
    a = np.full(max(1, -(-m // ROUTE_PAD)) * ROUTE_PAD, np.nan, gp.dtype)
    a[:m] = angles_local
    q = torch.as_tensor(a, device=dev)
    idx = gp._route_tensor(q, torch.as_tensor(gp._part_bounds, device=dev))
    B = bank.trained.shape[0]
    ok = (idx >= 0) & (idx < B)
    ok = ok & bank.trained[torch.where(ok, idx, 0)]
    src, mids, _ = group_chunks(torch.where(ok, idx, B), B, ROUTE_CHUNK)
    qs = torch.cat([q, torch.zeros_like(q[:1])])[src][..., None]
    return bank.x[mids], qs, bank.mask[mids]


def check_lidar2d_kernels(dev, card, frames) -> dict:
    """Phase 16a: the bank fit at the 2D lidar GP's shape (frame 0: 14
    members of 26, d = 1, ou) against its plain version at float32 and
    float64, with kernel, plain, ``torch.linalg.cholesky`` of the same grams
    and bound times (float32), and at the 28-scan replay's 392 members; the
    batched gram on the graphed routed test's operands (d = 1: 46 rows of
    26 x 32 at the log's 270 angles) against its plain version at both
    dtypes, kernel, plain and bound times at both. Returns {"bank_fit_2d":
    ..., "gram_batched_d1": ...} (the float32 row)."""
    from erl_gaussian_process_tpu_torch.kernels import train_gram
    from erl_gaussian_process_tpu_torch.models import LidarGaussianProcess2D
    from erl_gaussian_process_tpu_torch.ops import (
        bank_fit_cuda,
        bank_fit_plain,
        cross_gram_batched_cuda,
        cross_gram_plain,
    )

    f = frames[0]
    rb = np.stack([fr.ranges for fr in frames])
    out = {}
    for np_dt in (np.float64, np.float32):
        gp = LidarGaussianProcess2D(lidar2d_setting(f.angles, True),
                                    dtype=np_dt, device=dev)
        for label, ranges in (("frame 0", f.ranges[None]),
                              ("28-scan replay", rb)):
            x, y, v, m = gp._gather_scans(ranges)
            dt, kern, scale = x.dtype, gp._kernel, gp._scale
            B, n = x.shape[:2]
            got = bank_fit_cuda(kern, x, y, v, m, scale)
            torch.cuda.synchronize()
            eL, ea, eI = bank_errors(*got, bank_fit_plain(kern, x, y, v, m,
                                                          scale))
            tol = BANK_TOL[dt]
            ms = cuda_ms(lambda: bank_fit_cuda(kern, x, y, v, m, scale))
            plain_ms = cuda_ms(lambda: bank_fit_plain(kern, x, y, v, m,
                                                      scale))
            Kb = train_gram(kern, x, torch.where(m, v, torch.zeros_like(v)),
                            scale, mask=m)
            chol_ms = cuda_ms(lambda: torch.linalg.cholesky(Kb))
            b_ms, b_by = bank_fit_bound(B, n, 1, 1)
            log(f"bank_fit_2d {label} {str(dt):14s} B={B} n={n} d=1 {kern}: "
                f"L max_abs_err {eL:.3e}, alpha rel_err {ea:.3e}, "
                f"|L_inv L - I| {eI:.3e} (tol {tol:g}); kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, torch.linalg.cholesky of the "
                f"same grams {chol_ms:.4f} ms (L alone), bound {b_ms:.3e} ms "
                f"({b_by}) on {card}")
            check(max(eL, ea, eI) <= tol, f"bank_fit_2d {label} {dt}: "
                  f"errors {eL}, {ea}, {eI} > {tol}")
            if dt == torch.float32 and label == "frame 0":
                out["bank_fit_2d"] = {
                    "max_abs_err": eL, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        check(gp.train(np.eye(2), np.zeros(2), f.ranges), "lidar 2D train "
              "for the gram operands")
        x1, x2, ms_ = routed_gram_operands_2d(
            gp, gp.sensor_frame.angles_world_to_frame(
                np.asarray(f.angles, gp.dtype)))
        kern, scale = gp._kernel, gp._scale
        k = cross_gram_batched_cuda(kern, x1, x2, scale, ms_)
        torch.cuda.synchronize()
        err = float((k - cross_gram_plain(kern, x1, x2, scale,
                                          ms_)).abs().max())
        log(f"gram_batched_d1 (the 2D lidar graphed test's rows) {kern} "
            f"{str(x1.dtype):14s} shape {tuple(k.shape)} max_abs_err "
            f"{err:.3e} (tol {GRAM_TOL[x1.dtype]:g})")
        check(err <= GRAM_TOL[x1.dtype] and not bool((k[~ms_] != 0).any()),
              f"gram_batched_d1 {x1.dtype}: error {err} or a masked row "
              "not 0")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        b_ms, b_by, _ = gram_bound(kern, x1.dtype, x1.shape[0], x1.shape[1],
                                   x2.shape[1], 1, int(ms_.sum()), True, sms,
                                   sm_clock_mhz())
        row = {
            "max_abs_err": err, "library_ms": None, "bound_ms": b_ms,
            "bound_by": "bytes" if b_by == "bytes" else "operations",
            "ms": cuda_ms(lambda: cross_gram_batched_cuda(kern, x1, x2,
                                                          scale, ms_)),
            "plain_ms": cuda_ms(lambda: cross_gram_plain(kern, x1, x2, scale,
                                                         ms_))}
        log(f"gram_batched_d1 {tuple(k.shape)} {x1.dtype} on {card}: kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
            f"{b_ms:.3e} ms ({b_by})")
        if x1.dtype == torch.float32:
            out["gram_batched_d1"] = row
    return out


def run_lidar_2d(dev, card, frames, frames32):
    """Phases 16b-d: frame 0 of both logs through ``train`` and ``test``
    on the card (MAE gates, world-frame queries, ``compute_occ`` signs),
    one ``train`` and one ``test`` under ``torch.profiler``, the 28-scan
    replay in one bank-fit launch equal bit for bit to per-scan ``train``;
    train, test and replay as medians of 5 with range. Returns (launch
    counts, timings)."""
    from erl_gaussian_process_tpu_torch.models import LidarGaussianProcess2D
    from erl_gaussian_process_tpu_torch.ops import (
        launch_counts,
        reset_launch_counts,
    )

    eye, zero = np.eye(2), np.zeros(2)
    counts, timings = {}, {}
    cases = (("float64", frames[0], np.float64, False),
             ("float64 discontinuity", frames[0], np.float64, True),
             ("float32", frames32[0], np.float32, False))
    for label, f, np_dt, disc in cases:
        gp = LidarGaussianProcess2D(lidar2d_setting(f.angles, disc),
                                    dtype=np_dt, device=dev)
        gp.train(eye, zero, f.ranges)           # warm-up, not counted
        gp.test(f.angles, False, True).get_mean()
        reset_launch_counts()
        check(gp.train(eye, zero, f.ranges), f"lidar 2D {label} train")
        pred, valid = gp.test(f.angles, False, True).get_mean()
        counts[label] = launch_counts()
        mae = float(np.abs(pred[valid] - f.ranges[valid]).mean())
        log(f"lidar 2D {label}: {gp.bank.x.shape[0]} members of "
            f"{gp.bank.x.shape[1]}, valid {valid.mean():.4f}, MAE {mae:.6e} "
            f"(gate < {LIDAR2D_MAE[label]:g}); launch counts {counts[label]}")
        check(valid.any() and mae < LIDAR2D_MAE[label] and pred.dtype == np_dt,
              f"lidar 2D {label}: MAE {mae}")
        check(counts[label]["bank_fit"] == 1
              and counts[label]["gram_batched"] == 1,
              f"lidar 2D {label} launches {counts[label]}")
        if label == "float64":
            th = 0.7
            R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
            wgp = LidarGaussianProcess2D(lidar2d_setting(f.angles, False),
                                         device=dev)
            check(wgp.train(R, np.array([1.0, -2.0]), f.ranges),
                  "lidar 2D world-frame train")
            wp, wv = wgp.test(f.angles + th, False, True).get_mean()
            wmae = float(np.abs(wp[wv] - f.ranges[wv]).mean())
            idx = np.arange(20, 250, 40)
            ang, r = f.angles[idx], f.ranges[idx]
            near = np.stack([0.5 * r * np.cos(ang), 0.5 * r * np.sin(ang)], -1)
            far = np.stack([1.2 * r * np.cos(ang), 1.2 * r * np.sin(ang)], -1)
            v1, _, rp1, occ_near = gp.compute_occ(near)
            v2, _, _, occ_far = gp.compute_occ(far)
            log(f"lidar 2D world-frame queries (pose 0.7 rad, (1, -2)): MAE "
                f"{wmae:.6e} (gate < {LIDAR2D_MAE['world']:g}); compute_occ "
                f"near max {occ_near[v1].max():.6f} (< -0.9), far min "
                f"{occ_far[v2].min():.6f} (> 0.9), range error "
                f"{np.abs(rp1[v1] - r[v1]).mean():.6f} (< 0.5)")
            check(wv.any() and wmae < LIDAR2D_MAE["world"],
                  f"lidar 2D world-frame MAE {wmae}")
            check(v1.any() and v2.any() and occ_near[v1].max() < -0.9
                  and occ_far[v2].min() > 0.9
                  and np.abs(rp1[v1] - r[v1]).mean() < 0.5,
                  "lidar 2D compute_occ signs")
    # gp is the float32 model on the float log's frame 0
    f = frames32[0]
    train_kernels = device_kernels(lambda: gp.train(eye, zero, f.ranges))
    fit_launches = sum(c for k, (c, _) in train_kernels.items()
                       if "bank_fit" in k)
    gemms = {k: c for k, (c, _) in train_kernels.items()
             if any(w in k.lower() for w in ("gemm", "gemv", "bmm"))}
    test_kernels = device_kernels(
        lambda: gp.test(f.angles, False, True).get_mean())
    gram_launches = sum(c for k, (c, _) in test_kernels.items()
                        if "gram_kernel" in k)
    log(f"lidar 2D float32 train under torch.profiler: {fit_launches} "
        f"bank-fit launch, products {gemms or 'none'}, "
        f"{sum(c for c, _ in train_kernels.values())} launches, "
        f"{sum(ms for _, ms in train_kernels.values()):.4f} ms device; "
        f"test: {gram_launches} gram launch of "
        f"{sum(c for c, _ in test_kernels.values())}")
    check(fit_launches == 1 and not gemms and gram_launches == 1,
          f"lidar 2D train/test kernels: {fit_launches} bank fits, products "
          f"{gemms}, {gram_launches} gram launches")
    train_ms = [timed(lambda: gp.train(eye, zero, f.ranges))[1]
                for _ in range(TIMED_RUNS)]
    test_ms = [timed(lambda: gp.test(f.angles, False, True).get_mean())[1]
               for _ in range(TIMED_RUNS)]

    rb = np.stack([fr.ranges for fr in frames32])
    gp.train_scan_batch(rb)                      # warm-up, not counted
    rep_ms = []
    for i in range(TIMED_RUNS):
        if i == 0:
            reset_launch_counts()
        stacked, t = timed(lambda: gp.train_scan_batch(rb))
        if i == 0:
            counts["replay"] = launch_counts()
            first = stacked
        rep_ms.append(t)
    B = len(gp.partitions)
    check(counts["replay"]["bank_fit"] == 1
          and tuple(first.L.shape) == (len(rb) * B, 26, 26),
          f"lidar 2D replay: launches {counts['replay']}, "
          f"{tuple(first.L.shape)}")
    for s in range(len(rb)):
        gp.train(eye, zero, rb[s])
        differ = [n for n, a, b in zip(first._fields, first, gp.bank)
                  if not torch.equal(a[s * B:(s + 1) * B], b)]
        check(not differ, f"lidar 2D replay scan {s} differs from its "
                          f"train in {differ}")
    a_local = gp.sensor_frame.angles_world_to_frame(
        np.asarray(f.angles, gp.dtype).reshape(-1))
    timings["lidar2d_graphs"] = sensor_graphs_vs_eager(
        "2D lidar (14 x 26, f32)", card, gp,
        lambda: gp.train(eye, zero, f.ranges),
        lambda: gp.test(f.angles, False, True),
        lambda: (a_local[:, None], gp.search_partition(a_local)),
        replay_scans=rb)
    # the log scan by scan: train, test at its own angles, compute_occ at
    # half and 1.2 times each hit ray's range
    occ = []
    for fr in frames32:
        hit = np.isfinite(fr.ranges)
        a, r = fr.angles[hit], fr.ranges[hit]
        occ.append([np.stack([c * r * np.cos(a), c * r * np.sin(a)], -1)
                    for c in (0.5, 1.2)])

    def step(k):
        check(gp.train(eye, zero, frames32[k].ranges), f"log scan {k} train")
        res = sensor_result(gp.test(frames32[k].angles, True, False))
        return res + tuple(gp.compute_occ(o) for o in occ[k])

    timings["lidar2d_sequence"] = sensor_sequence(
        "2D lidar (14 x 26, f32)", card, gp, len(frames32), step)
    timings["lidar2d_hit_rays"] = hit_ray_graphs(dev, card, frames32)
    timings.update({
        "lidar2d_train_ms": statistics.median(train_ms),
        "lidar2d_train_ms_range": [min(train_ms), max(train_ms)],
        "lidar2d_test_ms_270": statistics.median(test_ms),
        "lidar2d_test_ms_270_range": [min(test_ms), max(test_ms)],
        "lidar2d_replay_ms_28": statistics.median(rep_ms),
        "lidar2d_replay_ms_28_range": [min(rep_ms), max(rep_ms)],
        "lidar2d_train_device_ms": sum(ms for _, ms in
                                       train_kernels.values()),
        "lidar2d_train_launches": sum(c for c, _ in train_kernels.values())})
    log(f"lidar 2D float32 on {card}: train "
        f"{timings['lidar2d_train_ms']:.4f} ms (median of {TIMED_RUNS}, range "
        f"{min(train_ms):.4f}-{max(train_ms):.4f}), test of 270 angles "
        f"{timings['lidar2d_test_ms_270']:.4f} ms ({min(test_ms):.4f}-"
        f"{max(test_ms):.4f}); 28-scan replay "
        f"{timings['lidar2d_replay_ms_28']:.4f} ms ({min(rep_ms):.4f}-"
        f"{max(rep_ms):.4f}), one bank-fit launch, every scan's slice equal "
        "to its train bit for bit")
    return counts, timings


def hit_ray_graphs(dev, card, frames) -> dict:
    """The 2D lidar GP with ``partition_on_hit_rays`` (float32) through the
    log's scans, graphed, each scan's bank and test bit for bit the eager
    chain's: the partition table, and so the shape, may change from scan
    to scan (a graph per shape). Returns the captures and train ms."""
    from erl_gaussian_process_tpu_torch.models import LidarGaussianProcess2D

    f0 = frames[0]
    s = lidar2d_setting(f0.angles, False)
    s.partition_on_hit_rays = True
    gp = LidarGaussianProcess2D(s, dtype=np.float32, device=dev)
    eye, zero = np.eye(2), np.zeros(2)
    graphs, ms, same = gp._graphs, [], True
    for f in frames:
        ok, t = timed(lambda: gp.train(eye, zero, f.ranges))
        ms.append(t)
        bank, res = bank_copy(gp.bank), sensor_result(
            gp.test(f.angles, True, False))
        gp._graphs = None
        try:
            check(ok and gp.train(eye, zero, f.ranges), "hit-ray train")
            same &= bits(bank, tuple(gp.bank)) and bits(
                res, sensor_result(gp.test(f.angles, True, False)))
        finally:
            gp._graphs = graphs
    fits = [g for g in graphs.captures if g.key[0] == "fit"]
    out = {"scans": len(frames), "fit_captures": len(fits),
           "capture_ms": sum(g.warmup_ms + g.capture_ms for g in fits),
           "pool_mib": sum(g.pool_bytes for g in fits) / 2**20,
           "train_ms": {"median": statistics.median(ms),
                        "range": [min(ms), max(ms)]}}
    log(f"2D lidar, partition_on_hit_rays, {len(frames)} scans graphed on "
        f"{card}: every bank and test bit for bit the eager chain's {same}; "
        f"{len(fits)} train capture(s) ({out['capture_ms']:.2f} ms warm-up "
        f"and capture, {out['pool_mib']:.1f} MiB), train "
        f"{out['train_ms']['median']:.4f} ms (median, range "
        f"{min(ms):.4f}-{max(ms):.4f}, the first one the capture)")
    check(same, "hit-ray 2D lidar GP: a graphed scan differs from eager")
    return out


# the reduced-rank fit's kernels by name: the blocked Cholesky's launches
# and the substitution
RR_FIT_PARTS = (("chol", "chol_"), ("substitution", "trsv_kernel"))


def rr_plain_posterior(basis, x, y, var, xq):
    """Mean and variance of a reduced-rank GP by the plain path on the
    card: the features and information system, ``torch.linalg.cholesky``,
    ``cholesky_solve``, a triangular solve."""
    from erl_gaussian_process_tpu_torch.kernels.reduced_rank import (
        rr_train_system,
    )

    mask = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    A, b = rr_train_system(basis.features(x, mask), y, var, mask)
    L = torch.linalg.cholesky(A)
    kt = basis.features(xq).mT
    w = torch.linalg.solve_triangular(L, kt, upper=False)
    return (kt.mT @ torch.cholesky_solve(b, L))[:, 0], (w * w).sum(0), A


def run_reduced_rank(dev, card):
    """Phase 17: the vanilla reduced-rank GP of
    tests/test_reduced_rank.py:240-259 (2D Matérn, 400 points, 16 x 16
    basis, noise 1e-4) on the card against its plain version (float64 to
    1e-9; float32: errors against the float64 plain posterior no worse
    than 2x the float32 plain one's), one fit under ``torch.profiler``
    (the blocked Cholesky and one substitution launch a direction); the
    kernels at its (256, 256) system against their plain versions, timed;
    the reduced-rank lidar GP of tests/test_lidar_gp_2d.py:155-210 at its
    MAE gate. Returns (launch counts, kernel rows).

    The float32 gate's "plain version" is the worse of two library
    factorizations of the same float32 system, cuSOLVER's on the card and
    LAPACK's on the host: at noise 1e-4 the (256, 256) information matrix
    leaves each within a few 1e-5 of the float64 posterior, and which of
    them lands closer is the luck of rounding (the first card run: mean
    errors 2.07e-5 and 6.15e-5)."""
    from erl_gaussian_process_tpu_torch.kernels import ReducedRankSetting
    from erl_gaussian_process_tpu_torch.models import (
        LidarGaussianProcess2D,
        VanillaGaussianProcess,
        VanillaGPSetting,
    )
    from erl_gaussian_process_tpu_torch.ops import (
        chol_blocked,
        chol_blocked_plain,
        inverses_from_chol_dinv,
        launch_counts,
        reset_launch_counts,
        solve_lower,
        substitute_plain,
    )

    rng = np.random.default_rng(1)
    n = 400
    x = rng.uniform(-0.8, 0.8, (2, n))
    y = np.sin(2 * x[0]) * np.cos(2 * x[1]) + rng.normal(0, 1e-2, n)
    var = np.full(n, 1e-4)
    g = np.linspace(-0.6, 0.6, 21)
    gx, gy = np.meshgrid(g, g, indexing="ij")
    xq = np.stack([gx.ravel(), gy.ravel()])
    truth = np.sin(2 * gx.ravel()) * np.cos(2 * gy.ravel())

    def setting():
        return VanillaGPSetting(kernel_type="rr_matern32",
                                kernel=ReducedRankSetting(
                                    x_dim=2, scale=0.6, num_basis=[16, 16],
                                    boundary=[2.0, 2.0],
                                    coord_origin=[0.0, 0.0]))

    counts, out, res = {}, {}, {}
    for np_dt in (np.float64, np.float32):
        dt = torch.float64 if np_dt == np.float64 else torch.float32
        gp = VanillaGaussianProcess(setting(), dtype=np_dt, device=dev)
        gp.train(x, y, var)                      # warm-up, not counted
        reset_launch_counts()
        check(gp.train(x, y, var), f"reduced-rank GP {np_dt.__name__} train")
        r = gp.test(xq)
        mean, v = r.get_mean(), r.get_variance()
        counts[np_dt.__name__] = launch_counts()
        plain = []
        for where in (dev, torch.device("cpu")):
            X, Q = (torch.as_tensor(a.T, device=where, dtype=dt)
                    for a in (x, xq))
            pm, pv, A = rr_plain_posterior(
                gp._basis, X,
                torch.as_tensor(y[:, None], device=where, dtype=dt),
                torch.as_tensor(var, device=where, dtype=dt), Q)
            plain.append((pm.cpu().numpy(), pv.cpu().numpy(), A))
        A = plain[0][2]
        res[np_dt.__name__] = (mean, v, plain)
        mae = float(np.abs(mean - truth).mean())
        log(f"reduced-rank GP {np_dt.__name__} (2D matern32, {n} points, "
            f"{gp.state.L.shape[0]} basis) on the card: MAE {mae:.6e} (gate "
            f"< {RR_2D_MAE:g}), variance > 0 {bool((v > 0).all())}; launch "
            f"counts {counts[np_dt.__name__]}")
        check(mae < RR_2D_MAE and (v > 0).all(), f"reduced-rank GP MAE {mae}")
        check(counts[np_dt.__name__]["chol"] == 1
              and counts[np_dt.__name__]["trsv"] == 2,
              f"reduced-rank fit launches {counts[np_dt.__name__]}")
        if dt == torch.float32:
            A32, gp32 = A, gp
    m64, v64, plain64 = res["float64"]
    pm64, pv64, _ = plain64[0]
    e_m = float(np.abs(m64 - pm64).max() / np.abs(pm64).max())
    e_v = float(np.abs(v64 - pv64).max() / np.abs(pv64).max())
    m32, v32, plain32 = res["float32"]
    k_m, k_v = np.abs(m32 - pm64).max(), np.abs(v32 - pv64).max()
    p_ms = [np.abs(pm - pm64).max() for pm, _, _ in plain32]
    p_vs = [np.abs(pv - pv64).max() for _, pv, _ in plain32]
    p_m, p_v = max(p_ms), max(p_vs)
    log(f"reduced-rank GP vs its plain version on the card: float64 mean "
        f"{e_m:.3e}, variance {e_v:.3e} (relative, gate <= 1e-9); float32 "
        f"against the float64 plain posterior: mean kernel {k_m:.3e}, plain "
        f"(cuSOLVER, LAPACK) {p_ms[0]:.3e}, {p_ms[1]:.3e}; variance kernel "
        f"{k_v:.3e}, plain {p_vs[0]:.3e}, {p_vs[1]:.3e} (gate <= "
        f"{POSTERIOR_FACTOR:g}x the worse plain)")
    check(e_m <= 1e-9 and e_v <= 1e-9, f"reduced-rank float64: {e_m}, {e_v}")
    check(k_m <= POSTERIOR_FACTOR * p_m + 1e-6
          and k_v <= POSTERIOR_FACTOR * p_v + 1e-9,
          f"reduced-rank float32: mean {k_m} vs {p_m}, var {k_v} vs {p_v}")
    fit_kernels = device_kernels(lambda: gp32.train(x, y, var))
    parts = {part: sum(c for k, (c, _) in fit_kernels.items() if key in k)
             for part, key in RR_FIT_PARTS}
    log(f"reduced-rank fit (float32) under torch.profiler: {parts}; kernels "
        + str({k.split('(')[0][:40]: c for k, (c, _) in fit_kernels.items()}))
    check(parts["chol"] > 0 and parts["substitution"] == 2,
          f"reduced-rank fit kernels {parts}")

    # the kernels at the fit's (256, 256) float32 system
    m = A32.shape[0]
    L, D = chol_blocked(A32, return_dinv=True)
    torch.cuda.synchronize()
    Lp = chol_blocked_plain(A32)
    be, bp = backward_error(L, A32), backward_error(Lp, A32)
    check(be <= CHOL_F32_FACTOR * bp, f"chol_rr: backward error {be} > "
          f"{CHOL_F32_FACTOR} x {bp}")
    b_ms, b_by = bound(4 * (2 * m * m + m * 64), m ** 3 / 3)
    out["chol_rr"] = {
        "max_abs_err": reconstruction_error(L, A32), "bound_ms": b_ms,
        "bound_by": b_by,
        "ms": cuda_ms(lambda: chol_blocked(A32, return_dinv=True)),
        "plain_ms": cuda_ms(lambda: chol_blocked_plain(A32,
                                                       return_dinv=True)),
        "library_ms": cuda_ms(lambda: torch.linalg.cholesky(A32))}
    bvec = torch.as_tensor(rng.normal(size=(m, 1)), device=dev,
                           dtype=torch.float32)
    inv = inverses_from_chol_dinv(D, m).contiguous()
    got = solve_lower(L, bvec, inv)
    ref = substitute_plain(L, bvec, False)
    rk, rp = residual(L, got, bvec), residual(L, ref, bvec)
    check(rk <= CHOL_F32_FACTOR * rp, f"trsv_rr: residual {rk} > "
          f"{CHOL_F32_FACTOR} x {rp}")
    b_ms, b_by = bound(4 * (m * m / 2 + m * 64 + 2 * m), m * m)
    out["trsv_rr"] = {
        "max_abs_err": float((got - ref).abs().max()), "bound_ms": b_ms,
        "bound_by": b_by, "ms": cuda_ms(lambda: solve_lower(L, bvec, inv)),
        "plain_ms": cuda_ms(lambda: substitute_plain(L, bvec, False)),
        "library_ms": cuda_ms(lambda: torch.linalg.solve_triangular(
            L, bvec, upper=False))}
    log(f"chol_rr f32 m={m}: backward error {be:.3e}, plain {bp:.3e}; "
        f"kernel {out['chol_rr']['ms']:.4f} ms, plain "
        f"{out['chol_rr']['plain_ms']:.4f} ms, torch.linalg.cholesky "
        f"{out['chol_rr']['library_ms']:.4f} ms, bound "
        f"{out['chol_rr']['bound_ms']:.4f} ms; trsv_rr residual {rk:.3e}, "
        f"plain {rp:.3e}; kernel {out['trsv_rr']['ms']:.4f} ms, plain "
        f"{out['trsv_rr']['plain_ms']:.4f} ms, solve_triangular "
        f"{out['trsv_rr']['library_ms']:.4f} ms, bound "
        f"{out['trsv_rr']['bound_ms']:.4f} ms on {card}")

    # the reduced-rank lidar GP: a smooth 270-ray scan, 96 basis, float64
    angles = np.linspace(-2.2, 2.2, 270)
    ranges = 3.0 + 0.8 * np.sin(2.0 * angles)
    s = lidar2d_setting(angles, False, kernel=dict(
        kernel_type="reduced_rank_rbf",
        kernel=dict(x_dim=1, scale=0.25, num_basis=[96], boundary=[3.0],
                    coord_origin=[0.0])))
    s.sensor_range_var, s.max_valid_range_var = 1e-4, 0.5
    lgp = LidarGaussianProcess2D(s, device=dev)
    reset_launch_counts()
    check(lgp.train(np.eye(2), np.zeros(2), ranges), "reduced-rank lidar "
          "train")
    pred, valid = lgp.test(angles, True, True).get_mean()
    lvar, _ = lgp.test(angles, True, True).get_variance()
    counts["lidar"] = launch_counts()
    mae = float(np.abs(pred[valid] - ranges[valid]).mean())
    log(f"reduced-rank lidar GP (float64, {lgp.bank.L.shape[0]} members of "
        f"{lgp.bank.L.shape[1]} basis): valid {valid.mean():.4f}, MAE "
        f"{mae:.6e} (gate < {RR_LIDAR_MAE:g}), variances > 0 "
        f"{bool((lvar[valid] > 0).all())}; launch counts {counts['lidar']}")
    check(valid.sum() > 0.9 * len(angles) and mae < RR_LIDAR_MAE
          and (lvar[valid] > 0).all(), f"reduced-rank lidar MAE {mae}")
    # the graphed test groups on the device into more rows than the host's
    # bucket, and on the card its products round otherwise: within
    # ROUTED_TOL of float64
    graphs = sensor_graphs_vs_eager(
        "reduced-rank lidar (96 basis, f64)", card, lgp,
        lambda: lgp.train(np.eye(2), np.zeros(2), ranges),
        lambda: lgp.test(angles, True, True),
        lambda: (angles[:, None], lgp.search_partition(angles)),
        test_tol=ROUTED_TOL[lgp.dtype])
    check(graphs["ladder_runs"] == 0, "the reduced-rank lidar fit ran its "
          "jitter ladder")
    log(json.dumps({"rr_lidar_graphs": graphs, "card": card}))
    return counts, out


# -- phases 18-22: the native runtime, poses_per_step, deployment
# -- artifacts, scale selection, the ops' dispatch -------------------------

PPS = 4                  # poses fused into one FITC update (hotel-0)
PPS_REPLAYS = 3          # more replays of each of c = 1 and c = PPS
PPS_TOL = dict(rtol=1e-3, atol=1e-4)   # tests/test_spgp_occupancy_map.py
DEPLOY_POSES = 10        # 2D map poses through the artifact and the eager step
# phase 20's artifact and eager-step event times before the artifacts
# replayed graphs (NVIDIA H100 80GB HBM3, 700 W; PERF.md §5)
ARTIFACT_MS_BEFORE_GRAPHS = {"update": 1.7246, "update_eager": 1.3888,
                    "predict": 0.1858, "predict_eager": 0.0745}
# the f32 SPGP sweep's NLML against the plain float64 sweep, relative, where
# both are finite: 3.3x the 9.06e-4 that three runs on an H100 read
SWEEP_TOL = 3e-3
FIT_STEPS = 80
# rows 1 and 2a's event times when the wrappers called the kernels without
# the registered ops (PERF.md §6, same card and script)
EVENT_MS_BEFORE_OPS = {"fitc": 0.3446, "gram": 0.0403}
# hotel-0's first poses, replayed with FITC through the op and through its
# CUDA implementation called directly, alternated
DISPATCH_POSES = 256
DISPATCH_ROUNDS = 3


def allclose_excess(a, b, rtol, atol) -> float:
    """max(|a - b| - (atol + rtol |b|)): <= 0 where ``torch.allclose``
    holds."""
    return float(((a - b).abs() - (atol + rtol * b.abs())).max())


def run_native(t_build: float, t_scan_native: float):
    """Phase 18a: the native host runtime was built and loaded before
    ``main``'s hotel-0 workload (``t_build`` s), whose scans it raycast
    (``t_scan_native`` s); the numpy raycaster's pass over the same scans
    is timed beside it and the scans compared."""
    from erl_gaussian_process_tpu_torch.utils import native as nat
    from erl_gaussian_process_tpu_torch.workloads import hotel0_workload

    check(nat.native_available(), "the native host runtime did not build")
    nat_scans = hotel0_workload()
    os.environ["ERL_GP_NO_NATIVE"] = "1"
    nat._lib, nat._tried = None, False
    try:
        t0 = time.perf_counter()
        np_scans = hotel0_workload()
        t_numpy = time.perf_counter() - t0
    finally:
        del os.environ["ERL_GP_NO_NATIVE"]
        nat._lib, nat._tried = None, False
    check(nat.native_available(), "native runtime after the numpy pass")
    same = all(np.array_equal(a, b) for a, b in zip(nat_scans[:3],
                                                    np_scans[:3]))
    log(f"native host runtime {nat.get_lib()._name}: built and loaded in "
        f"{t_build:.2f} s; hotel-0 setup with the native raycaster "
        f"{t_scan_native:.2f} s, with numpy {t_numpy:.2f} s; scans equal "
        f"{same}")
    check(same, "native and numpy raycasts of hotel-0 differ")
    return {"host_build_s": t_build, "hotel0_setup_native_s": t_scan_native,
            "hotel0_setup_numpy_s": t_numpy, "scans_equal": same}


def check_egpt(omap, new_map) -> None:
    """Phase 18b: an ``.egpt`` checkpoint of ``omap`` loads into a fresh
    map with the state equal."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "hotel0.egpt")
        t0 = time.perf_counter()
        omap.save(path)
        t_save = time.perf_counter() - t0
        back = new_map()
        back.load(path)
        size = os.path.getsize(path)
    check(back == omap, ".egpt checkpoint of the hotel-0 map differs")
    check(all(torch.equal(a, b) for a, b in zip(back.state, omap.state)),
          ".egpt checkpoint: state tensors differ")
    log(f".egpt checkpoint of the hotel-0 map: {size} bytes, saved in "
        f"{1e3 * t_save:.1f} ms, loaded with the state equal")


def run_poses_per_step(dev, card, setting, pseudo, lo, hi, sensors, pts,
                       masks, hits, traj):
    """Phase 19: hotel-0 with ``poses_per_step`` = PPS (983 poses padded to
    984, one FITC update of N = PPS x 2048 a chunk): the quality gates, Q_M
    and alpha against the c = 1 replay of the same seeds, FITC at (1152,
    8192, d = 3) against its plain version and the float32 2x gate at var
    1e-4 against the float64 update, FITC's launches a chunk, ms/pose
    beside c = 1 (medians of replays, alternated). Returns (launches,
    kernel row, timings, the c = PPS map, new_map, the c = PPS replay's
    state, samples used and drift-grid predict)."""
    from erl_gaussian_process_tpu_torch.geometry import Aabb
    from erl_gaussian_process_tpu_torch.models import SpGpOccupancyMap
    from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
        spgp_init,
    )
    from erl_gaussian_process_tpu_torch.ops import (
        fitc_update_cuda,
        fitc_update_plain,
        launch_counts,
        reset_launch_counts,
    )
    from erl_gaussian_process_tpu_torch.ops.fitc import fitc_plan
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

    def replay(c, collect=False):
        m = new_map()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = m.update_batch(sensors, pts, masks, poses_per_step=c,
                             collect_datasets=collect)
        torch.cuda.synchronize()
        return m, out, 1e3 * (time.perf_counter() - t0) / b

    b = len(sensors)
    warm = new_map()
    warm.update_batch(sensors[:2 * PPS], pts[:2 * PPS], masks[:2 * PPS],
                      poses_per_step=PPS)
    reset_launch_counts()
    m4, n4, first4 = replay(PPS)
    counts = launch_counts()
    pps_ref = {"state": clone_state(m4.state), "n_used": n4,
               "lo_grid": m4.predict(hotel0_query_grid(lo, hi))[0]}
    chunks = -(-b // PPS)
    replayed, warm_ups = graph_launches((m4,), fitc_update_cuda)
    check(replayed == chunks and counts["fitc"] == replayed + warm_ups,
          f"poses_per_step={PPS}: FITC launches {counts['fitc']}, "
          f"{replayed} by the replays != {chunks} chunks, {warm_ups} by the "
          "warm-up")
    # the one replay that keeps its datasets (the FITC check below); the
    # timed replays run c = 1 and c = PPS under the same flags
    m1, (n1, (dx, dy, dm)), _ = replay(1, collect=True)
    check(bool(torch.equal(n4, n1)), "poses_per_step: n_used differs")
    rng = np.random.default_rng(0)
    sel = hits[rng.choice(len(hits), min(2000, len(hits)), replace=False)]
    surf = float((m4.predict(sel.astype(np.float32))[0] > 0).float().mean())
    free = float((m4.predict(traj)[0] < 0).float().mean())
    log(f"hotel-0 poses_per_step={PPS} ({b} poses, {chunks} FITC updates of "
        f"N = {PPS * dx.shape[1]}): surface occupied {surf:.4f} (gate > "
        f"0.9), trajectory free {free:.4f} (gate > 0.95)")
    check(surf > 0.9 and free > 0.95,
          f"poses_per_step quality: surface {surf}, trajectory {free}")
    excess = {k: allclose_excess(getattr(m4.state, k), getattr(m1.state, k),
                                 **PPS_TOL) for k in ("qm", "alpha")}
    rel = {k: float((getattr(m4.state, k) - getattr(m1.state, k)).abs().max()
                    / getattr(m1.state, k).abs().max()) for k in excess}
    log(f"poses_per_step={PPS} vs the c = 1 replay of the same seeds: max "
        f"relative difference Q_M {rel['qm']:.3e} alpha {rel['alpha']:.3e}; "
        f"allclose(rtol 1e-3, atol 1e-4) excess {excess}")
    check(all(v <= 0 for v in excess.values()),
          f"poses_per_step state vs c = 1: {excess}")

    # FITC at (1152, 8192, d=3): poses 0-3's datasets concatenated
    scale = float(setting.sp_gp.kernel.scale)
    x32 = dx[:PPS].reshape(-1, 3).contiguous()
    y32 = dy[:PPS].reshape(-1, 1).contiguous()
    mask = dm[:PPS].reshape(-1).contiguous()
    n = x32.shape[0]
    m_valid = pseudo.shape[1]
    err32 = 0.0
    for dt in (torch.float64, torch.float32):
        st = spgp_init(m4.state.pseudo.to(dt), scale, kernel="matern32")
        var = torch.full((n,), FITC_VAR[dt], device=dev, dtype=dt)
        args = ("matern32", st.pseudo, st.L_inv, x32.to(dt), y32.to(dt),
                var, mask, scale)
        dq, da = fitc_update_cuda(*args)
        dq_ref, da_ref = fitc_update_plain(*args)
        rq = float((dq - dq_ref).abs().max() / dq_ref.abs().max())
        ra = float((da - da_ref).abs().max() / da_ref.abs().max())
        log(f"fitc M={dq.shape[0]} N={n} active {int(mask.sum())} {dt} var "
            f"{FITC_VAR[dt]:g}: rel_err dQ {rq:.3e} dalpha {ra:.3e} (tol "
            f"{FITC_TOL[dt]:g})")
        check(bool(torch.equal(dq, dq.T)), f"fitc N={n} {dt}: dQ asymmetric")
        check(bool((dq[m_valid:] == 0).all()),
              f"fitc N={n} {dt}: far-point rows not 0")
        check(rq <= FITC_TOL[dt] and ra <= FITC_TOL[dt],
              f"fitc N={n} {dt}: rel err {rq}, {ra}")
        if dt == torch.float32:
            err32 = float((dq - dq_ref).abs().max())
    var4 = torch.full((n,), setting.logodd_variance, device=dev)
    args = ("matern32", m4.state.pseudo, m4.state.L_inv, x32, y32, var4, mask,
            scale)
    fitc_against_truth(args)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = fitc_plan(m4.state.pseudo.shape[0], n, sms)
    bound_ms, bound_by = fitc_bound(m4.state.pseudo.shape[0], n, 3)
    row = {"max_abs_err": err32,
           "ms": batch_ms(lambda: fitc_update_cuda(*args)),
           "plain_ms": batch_ms(lambda: fitc_update_plain(*args)),
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    log(f"fitc M=1152 N={n} d=3 float32 on {card}: kernel {row['ms']:.4f} "
        f"ms, plain {row['plain_ms']:.4f} ms (median of {REPS} batches of "
        f"{BATCH}), bound "
        f"{bound_ms:.4f} ms ({bound_by}); plan {syrk_grid(plan)}")
    log_device_split(f"fitc M=1152 N={n} float32",
                     lambda: fitc_update_cuda(*args))
    row.update(time_fitc_syrk(args, "1c"))
    chunk_kernels = device_kernels(lambda: m4.update_batch(
        sensors[:PPS], pts[:PPS], masks[:PPS], poses_per_step=PPS))
    fitc_chunk = sum(c for k, (c, _) in chunk_kernels.items()
                     if any(f in k for f in FITC_KERNELS))
    log(f"poses_per_step={PPS}: FITC kernel launches per {PPS} poses "
        f"{fitc_chunk} by torch.profiler (plan {plan.launches}), of "
        f"{sum(c for c, _ in chunk_kernels.values())} kernel launches")
    check(fitc_chunk == plan.launches,
          f"FITC launches per chunk {fitc_chunk} != {plan.launches}")

    ms1, ms4 = [], [first4]
    for _ in range(PPS_REPLAYS):
        ms4.append(replay(PPS)[2])
        ms1.append(replay(1)[2])
    timings = {"pps": PPS,
               "pps_ms_per_pose": statistics.median(ms4),
               "pps_ms_per_pose_range": [min(ms4), max(ms4)],
               "c1_ms_per_pose": statistics.median(ms1),
               "c1_ms_per_pose_range": [min(ms1), max(ms1)],
               "fitc_launches_per_chunk": fitc_chunk,
               "kernel_launches_per_chunk": sum(
                   c for c, _ in chunk_kernels.values()),
               "pps_rel_diff": rel}
    log(f"hotel-0 update_batch on {card}: poses_per_step={PPS} "
        f"{timings['pps_ms_per_pose']:.4f} ms/pose (median of {len(ms4)}, "
        f"range {min(ms4):.4f}-{max(ms4):.4f}), c = 1 "
        f"{timings['c1_ms_per_pose']:.4f} ms/pose (median of {len(ms1)}, "
        f"range {min(ms1):.4f}-{max(ms1):.4f})")
    return counts["fitc"], row, timings, m4, new_map, pps_ref


def run_deploy(dev, card):
    """Phase 20: the update and predict artifacts at the 2D map's config
    (M = 1024, 135 rays, 20 free slots, float32) exported on the card and
    round-tripped through bytes; DEPLOY_POSES updates through the loaded
    artifact and through the eager step with the same draws equal bit for
    bit, and the predict on the surface points; the artifacts' FITC and
    gram launches by the launch counters; one artifact call timed against
    the eager step. Returns (launch counts, timings)."""
    from erl_gaussian_process_tpu_torch.geometry import (
        Aabb,
        free_sample_fractions,
    )
    from erl_gaussian_process_tpu_torch.geometry.simulators import (
        reference_space_2d,
    )
    from erl_gaussian_process_tpu_torch.models import SpGpOccupancyMap
    from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
        spgp_prepare,
    )
    from erl_gaussian_process_tpu_torch.models.spgp_occupancy_map import (
        predict_prepared_step,
        step_seed,
        update_step,
    )
    from erl_gaussian_process_tpu_torch.ops import (
        launch_counts,
        reset_launch_counts,
    )
    from erl_gaussian_process_tpu_torch.utils.deploy import (
        export_map_predict_step,
        export_map_update_step,
        load_fn,
        load_program,
    )

    setting = map2d_setting()
    m = SpGpOccupancyMap(setting, map2d_pseudo(),
                         Aabb.from_min_max([-3.0, -3.0], [3.0, 3.0]),
                         seed=0, dtype=torch.float32,
                         free_slots_per_ray=MAP2D_FREE_SLOTS, device=dev)
    n_pseudo = m.state.pseudo.shape[0]
    scale = float(setting.sp_gp.kernel.scale)
    t0 = time.perf_counter()
    ublob = export_map_update_step(setting, n_pseudo=n_pseudo,
                                   n_rays=MAP2D_RAYS,
                                   free_slots=MAP2D_FREE_SLOTS, device=dev)
    pblob = export_map_predict_step(n_pseudo=n_pseudo, scale=scale,
                                    kernel=m.sp_gp._kernel, device=dev)
    t_export = time.perf_counter() - t0
    t0 = time.perf_counter()
    step, predict = load_fn(ublob), load_fn(pblob)
    t_load = time.perf_counter() - t0
    ops = sorted({str(nd.target) for blob in (ublob, pblob)
                  for nd in load_program(blob).graph.nodes
                  if str(nd.target).startswith("egp.")})
    log(f"artifacts at the 2D map's config (M={n_pseudo}, {MAP2D_RAYS} rays, "
        f"{MAP2D_FREE_SLOTS} free slots, float32): update {len(ublob)} bytes,"
        f" predict {len(pblob)} bytes (dynamic queries); exported in "
        f"{t_export:.2f} s, loaded in {t_load:.2f} s; ops {ops}")
    check(ops == ["egp.cross_gram.default", "egp.fitc_update.default"],
          f"artifact ops {ops}")

    sensors, pts, masks = map2d_scans(DEPLOY_POSES)
    kw = m._step_kw()
    g = torch.Generator(device=dev)
    inputs = []
    for i in range(DEPLOY_POSES):
        g.manual_seed(step_seed(0, i + 1))
        u = free_sample_fractions(MAP2D_RAYS, MAP2D_FREE_SLOTS,
                                  setting.free_sampling_margin, g,
                                  torch.float32, dev)
        p = np.where(masks[i][:, None], pts[i], 0.0).astype(np.float32)
        inputs.append((u, torch.as_tensor(sensors[i], device=dev),
                       torch.as_tensor(p, device=dev),
                       torch.as_tensor(masks[i], device=dev),
                       m._aabb_min, m._aabb_max))
    st_e = st_m = m.state
    for u, *args in inputs:
        st_e, _, _ = update_step(st_e, *args, scale, u=u, **kw)
        st_m, _ = step.eager(st_m, u, *args)
    step(m.state, *inputs[0])              # the capture, not counted
    torch.cuda.synchronize()
    reset_launch_counts()
    st_a = m.state
    for u, *args in inputs:
        st_a, n_a = step(st_a, u, *args)
    torch.cuda.synchronize()
    counts = launch_counts()
    same = all(torch.equal(a, b) for a, b in zip(st_a, st_e))
    same_module = bits(tuple(st_a), tuple(st_m))
    surf = torch.as_tensor(reference_space_2d().surface_points(0.05),
                           dtype=torch.float32, device=dev)
    L_qm, alpha = spgp_prepare(st_a)
    predict(st_a, L_qm, alpha, surf)       # the capture, not counted
    torch.cuda.synchronize()
    reset_launch_counts()
    mean_a, _ = predict(st_a, L_qm, alpha, surf)
    torch.cuda.synchronize()
    pcounts = launch_counts()
    mean_e, _ = predict_prepared_step(st_a, L_qm, alpha, surf, scale,
                                      kernel=m.sp_gp._kernel, with_grad=False)
    mean_m, _ = predict.eager(st_a, L_qm, alpha, surf)
    occ = float((mean_a[:, 0] > 0).float().mean())
    log(f"artifact (a graph replay a call) vs eager: {DEPLOY_POSES} updates "
        f"equal bit for bit {same} (and to the module's own call "
        f"{same_module}), predict of {surf.shape[0]} points equal "
        f"{bool(torch.equal(mean_a, mean_e))} (and to the module's "
        f"{bits(mean_a, mean_m)}; surface occupied {occ:.4f}); launches by "
        f"the artifacts: update {counts}, predict {pcounts}")
    check(same and same_module and bool(torch.equal(mean_a, mean_e))
          and bits(mean_a, mean_m),
          "artifact results differ from the eager step")
    check(counts["fitc"] == DEPLOY_POSES and pcounts["gram"] == 1,
          f"artifact launches: update {counts}, predict {pcounts}")
    u, *args = inputs[0]
    st0 = m.state

    def eager_predict_step():
        return predict_prepared_step(st_a, L_qm, alpha, surf, scale,
                                     kernel=m.sp_gp._kernel, with_grad=False)

    times = {
        "update_artifact_ms": cuda_ms(lambda: step(st0, u, *args)),
        "update_artifact_module_ms": cuda_ms(lambda: step.eager(st0, u,
                                                                *args)),
        "update_eager_ms": cuda_ms(lambda: update_step(st0, *args, scale,
                                                       u=u, **kw)),
        "update_artifact_host_ms": host_ms(lambda: step(st0, u, *args)),
        "update_eager_host_ms": host_ms(lambda: update_step(
            st0, *args, scale, u=u, **kw)),
        "predict_artifact_ms": cuda_ms(lambda: predict(st_a, L_qm, alpha,
                                                       surf)),
        "predict_artifact_module_ms": cuda_ms(lambda: predict.eager(
            st_a, L_qm, alpha, surf)),
        "predict_eager_ms": cuda_ms(eager_predict_step),
        "predict_artifact_host_ms": host_ms(lambda: predict(
            st_a, L_qm, alpha, surf)),
        "predict_eager_host_ms": host_ms(eager_predict_step),
        "captures": [{"key": str(g.key[1])[:100], "warmup_ms": g.warmup_ms,
                      "capture_ms": g.capture_ms,
                      "pool_mib": g.pool_bytes / 2**20}
                     for f in (step, predict) for g in f.captures],
        "export_s": t_export, "load_s": t_load}
    log(f"artifact times on {card} (CUDA events, median of {REPS}): update "
        f"{times['update_artifact_ms']:.4f} ms graphed, the module's own "
        f"call {times['update_artifact_module_ms']:.4f}, the eager step "
        f"{times['update_eager_ms']:.4f} (before the graphs: artifact "
        f"{ARTIFACT_MS_BEFORE_GRAPHS['update']}, eager step "
        f"{ARTIFACT_MS_BEFORE_GRAPHS['update_eager']}); predict "
        f"{times['predict_artifact_ms']:.4f} ms graphed, module "
        f"{times['predict_artifact_module_ms']:.4f}, eager "
        f"{times['predict_eager_ms']:.4f} (before the graphs: "
        f"{ARTIFACT_MS_BEFORE_GRAPHS['predict']}, {ARTIFACT_MS_BEFORE_GRAPHS['predict_eager']});"
        f" host a call: update {times['update_artifact_host_ms']:.4f} vs "
        f"{times['update_eager_host_ms']:.4f} ms, predict "
        f"{times['predict_artifact_host_ms']:.4f} vs "
        f"{times['predict_eager_host_ms']:.4f} ms; captures "
        f"{times['captures']}")
    return {"fitc": counts["fitc"], "gram": pcounts["gram"]}, times


class _PlainGram:
    """``GramScale`` replaced by the plain gram: the float64 reference
    sweep runs no kernel."""

    @staticmethod
    def apply(name, x1, x2, scale, mask1=None):
        from erl_gaussian_process_tpu_torch.ops import cross_gram_plain

        return cross_gram_plain(name, x1, x2, float(scale), mask1)


def run_model_selection(dev, card):
    """Phase 21: ``select_scale_spgp`` on the 2D map's 50-pose datasets
    (the actives of each pose's 2048-slot budget) with the production 31 x
    31 pseudo grid, through the gram kernel, its float32 NLML against the
    plain float64 sweep of the same candidates on the card; the chosen
    scale beside the YAML's 0.18 (reported); ``select_scale`` at the exact
    GP's cell (n = 8192, 24 candidates batched); ``fit_scale_spgp``, 80
    steps. Returns (gram launches, the gram row at the sweep's shape,
    timings)."""
    from unittest import mock

    from erl_gaussian_process_tpu_torch.geometry import Aabb
    from erl_gaussian_process_tpu_torch.models import SpGpOccupancyMap
    from erl_gaussian_process_tpu_torch.ops import (
        cross_gram_cuda,
        cross_gram_plain,
        launch_counts,
        reset_launch_counts,
    )
    from erl_gaussian_process_tpu_torch.utils import model_selection as ms
    from erl_gaussian_process_tpu_torch.workloads import exact_gp_workload

    setting = map2d_setting()
    m = SpGpOccupancyMap(setting, map2d_pseudo(),
                         Aabb.from_min_max([-3.0, -3.0], [3.0, 3.0]),
                         seed=0, dtype=torch.float32,
                         free_slots_per_ray=MAP2D_FREE_SLOTS, device=dev)
    sensors, pts, masks = map2d_scans(MAP2D_POSES)
    _, (dx, dy, dm) = m.update_batch(sensors, pts, masks,
                                     collect_datasets=True)
    x, y = dx[dm].contiguous(), dy[dm].contiguous()
    n = x.shape[0]
    var = torch.full((n,), setting.logodd_variance, device=dev)
    P = torch.as_tensor(map2d_pseudo().T.copy(), dtype=torch.float32,
                        device=dev)
    reset_launch_counts()
    (best, scales, vals), t_sel = timed(lambda: ms.select_scale_spgp(
        P, x, y, var, kernel="matern32", refine=1, device=dev))
    counts = launch_counts()
    check(counts["gram"] == 2 * len(scales),
          f"select_scale_spgp gram launches {counts['gram']}")
    ref = []
    with mock.patch.object(ms, "GramScale", _PlainGram):
        for s in scales:
            ref.append(float(ms.nlml_sweep_spgp(
                P.double(), x.double(), y.double(), var.double(),
                torch.ones(n, dtype=torch.bool, device=dev),
                torch.tensor([s], dtype=torch.float64, device=dev),
                kernel="matern32")[0]))
    ref = np.asarray(ref)
    both = np.isfinite(vals) & np.isfinite(ref)
    rel = np.abs(vals[both] - ref[both]) / np.abs(ref[both])
    best64 = float(scales[np.argmin(np.where(np.isfinite(ref), ref, np.inf))])
    log(f"select_scale_spgp on the 2D map's {MAP2D_POSES}-pose datasets (n = "
        f"{n}, M = {P.shape[0]}, {len(scales)} candidates, refine 1, "
        f"float32): {t_sel:.1f} ms; chosen scale {best:.6g} (the YAML's "
        f"0.18; the float64 sweep's pick on the final grid {best64:.6g}); "
        f"finite f32 {int(np.isfinite(vals).sum())}, f64 "
        f"{int(np.isfinite(ref).sum())}; max relative NLML difference "
        f"{rel.max() if rel.size else float('nan'):.3e} (gate <= "
        f"{SWEEP_TOL:g})")
    check(both.any() and np.isfinite(best) and rel.max() <= SWEEP_TOL,
          f"select_scale_spgp: f32 vs f64 NLML {rel}")

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    b_ms, b_by, _ = gram_bound("matern32", torch.float32, 1, P.shape[0], n, 2,
                               P.shape[0], False, sms, sm_clock_mhz())
    k = cross_gram_cuda("matern32", P, x, best)
    err = float((k - cross_gram_plain("matern32", P, x, best)).abs().max())
    check(err <= GRAM_TOL[torch.float32], f"gram at the sweep's shape {err}")
    row = {"max_abs_err": err,
           "ms": cuda_ms(lambda: cross_gram_cuda("matern32", P, x, best)),
           "plain_ms": cuda_ms(lambda: cross_gram_plain("matern32", P, x,
                                                        best)),
           "bound_ms": b_ms, "bound_by": "bytes" if b_by == "bytes"
           else "operations", "library_ms": None}
    log(f"gram at the sweep's shape {P.shape[0]}x{n} matern32 d=2 float32 on "
        f"{card}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), max abs err {err:.2e}")

    xe, ye, ve, _, scale_e, kern_e = exact_gp_workload()
    (best_e, sc_e, v_e), t_exact = timed(lambda: ms.select_scale(
        xe, ye, ve, kernel=kern_e, refine=1, device=dev))
    log(f"select_scale at the exact-GP cell (n = {xe.shape[0]}, "
        f"{len(sc_e)} candidates batched, float32): {t_exact:.1f} ms; "
        f"chosen {best_e:.6g} (the workload's scale {scale_e:g}); "
        f"finite {int(np.isfinite(v_e).sum())} of {len(v_e)}; peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")
    check(np.isfinite(best_e) and np.isfinite(v_e).any(),
          "select_scale at the exact-GP cell")

    (bf, fs, fv), t_fit = timed(lambda: ms.fit_scale_spgp(
        P, x, y, var, kernel="matern32", init=best, steps=FIT_STEPS,
        device=dev))
    fin = fv[np.isfinite(fv)]
    log(f"fit_scale_spgp ({FIT_STEPS} steps from {best:.6g}): {t_fit:.1f} ms "
        f"({t_fit / FIT_STEPS:.2f} ms a step); best {bf:.6g}, NLML "
        f"{fin[0]:.6g} -> {fin.min():.6g}")
    check(fin.size > 0 and fin.min() <= fin[0], "fit_scale_spgp")
    return counts["gram"], row, {
        "spgp_n": n, "spgp_best": best, "spgp_best_f64": best64,
        "spgp_select_ms": t_sel, "spgp_nlml_rel_diff": float(rel.max()),
        "exact_best": best_e, "exact_select_ms": t_exact,
        "fit_best": bf, "fit_ms": t_fit}


def run_dispatch(dev, card, gram_times, kern, hotel0):
    """Phase 22: rows 1 and 2a through the registered ops beside their
    event times before the ops (EVENT_MS_BEFORE_OPS); then at their shapes
    each op against its CUDA implementation called directly (no
    dispatcher), event ms (median of 20) in the order op, direct, direct,
    op, and host ms a call; then the map's ms/pose on hotel-0's first
    DISPATCH_POSES poses (``hotel0`` = (setting, pseudo, lo, hi, sensors,
    pts, masks)) with FITC through the op and called directly, in
    DISPATCH_ROUNDS rounds of op, direct, direct, op."""
    import erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp as spgp
    from erl_gaussian_process_tpu_torch.geometry import Aabb
    from erl_gaussian_process_tpu_torch.models import SpGpOccupancyMap
    from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
        pad_pseudo_points,
        spgp_init,
    )
    from erl_gaussian_process_tpu_torch.workloads import FREE_SLOTS_PER_RAY
    from erl_gaussian_process_tpu_torch.ops import (
        cross_gram_cuda,
        fitc_update_cuda,
    )
    from erl_gaussian_process_tpu_torch.ops.fitc import _fitc_cuda
    from erl_gaussian_process_tpu_torch.ops.gram import _gram_cuda, family_spec

    rng = np.random.default_rng(0)
    axes = [np.linspace(-1.5, 1.5, 11)] * 2 + [np.linspace(-1.2, 1.2, 9)]
    grid = np.stack([a.ravel() for a in np.meshgrid(*axes, indexing="ij")],
                    -1)
    st = spgp_init(torch.as_tensor(pad_pseudo_points(grid),
                                   dtype=torch.float32, device=dev), 0.6,
                   kernel="matern32")

    def t(a, dt=torch.float32):
        return torch.as_tensor(a, dtype=dt, device=dev)

    x = t(rng.uniform(-1.5, 1.5, (2048, 3)))
    fitc_args = (st.pseudo, st.L_inv, x, t(rng.choice([-1.0, 1.0],
                                                      (2048, 1))),
                 t(np.full(2048, 1e-4)), t(rng.uniform(size=2048) < 0.9,
                                           torch.bool))
    spec = family_spec("matern32")
    pairs = {
        "gram": (lambda: cross_gram_cuda("matern32", st.pseudo, x, 0.6),
                 lambda: _gram_cuda(st.pseudo, x, None, *spec, 0.6)),
        "fitc": (lambda: fitc_update_cuda("matern32", *fitc_args, 0.6),
                 lambda: _fitc_cuda(*fitc_args, *spec, 0.6))}
    out = {"fitc_ms": kern["fitc"]["ms"], "gram_ms": gram_times["gram"]["ms"],
           "gram_device_ms": gram_times["gram"]["device_ms"]}
    for name, (op, direct) in pairs.items():
        ev = [cuda_ms(f) for f in (op, direct, direct, op)]
        out[name] = {"op_event_ms": [ev[0], ev[3]],
                     "direct_event_ms": [ev[1], ev[2]],
                     "op_host_ms": host_ms(op),
                     "direct_host_ms": host_ms(direct)}
    setting, pseudo, lo, hi, sensors, pts, masks = hotel0
    box = Aabb.from_min_max(lo, hi)

    def replay():
        m = SpGpOccupancyMap(setting, pseudo, box, seed=0,
                             dtype=torch.float32,
                             free_slots_per_ray=FREE_SLOTS_PER_RAY,
                             device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(DISPATCH_POSES):
            m.update(sensors[i], pts[i], masks[i])
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / DISPATCH_POSES

    def fitc_direct(name, *args):
        return _fitc_cuda(*args[:-1], *family_spec(name), float(args[-1]))

    through_op = spgp.fitc_update_cuda
    pose_ms = {"op": [], "direct": []}
    try:
        for way in ("op", "direct", "direct", "op") * DISPATCH_ROUNDS:
            spgp.fitc_update_cuda = through_op if way == "op" else \
                fitc_direct
            pose_ms[way].append(replay())
    finally:
        spgp.fitc_update_cuda = through_op
    out["hotel0_ms_per_pose"] = {
        way: {"median": statistics.median(v), "range": [min(v), max(v)]}
        for way, v in pose_ms.items()}
    log(f"op dispatch on {card}: hotel-0's first {DISPATCH_POSES} poses, "
        "FITC through the op vs called directly: " + "; ".join(
            f"{way} {statistics.median(v):.4f} ms/pose (median of {len(v)}, "
            f"range {min(v):.4f}-{max(v):.4f})" for way, v in pose_ms.items()))
    log(f"op dispatch on {card}: row 1 (FITC 1152x2048) {out['fitc_ms']:.4f} "
        f"ms event (before the ops {EVENT_MS_BEFORE_OPS['fitc']}), row 2a "
        f"(gram 1152x2048) {out['gram_ms']:.4f} ms event, "
        f"{out['gram_device_ms']:.4f} ms device (before the ops "
        f"{EVENT_MS_BEFORE_OPS['gram']} event); through the op vs the CUDA "
        "implementation called directly: " + "; ".join(
            f"{k} event op {v['op_event_ms'][0]:.4f}/"
            f"{v['op_event_ms'][1]:.4f} direct {v['direct_event_ms'][0]:.4f}/"
            f"{v['direct_event_ms'][1]:.4f} ms, host op "
            f"{v['op_host_ms']:.4f} direct {v['direct_host_ms']:.4f} ms"
            for k, v in out.items() if k in pairs))
    return out

# -- phase 23: the mesh (parallel/mesh.py) on the card ----------------------

MESH_TIMEOUT_S = 60      # init_process_group: a dead rank ends the others'
MESH_JOIN_S = 300        # a world, spawn to exit
MESH_DRIFT = 5e-6        # tests/test_parallel.py:190 and :397
MESH_PREDICT_TOL = 1e-4  # tests/test_parallel.py:197-198
MESH_SIGNS = 0.999
MESH_TRAINS = 5          # timed sensor-GP trains a rank
MESH_SHARD = 4093        # FITC's padding check: samples before the pad


def mesh_map(mesh_or_dev, hotel0):
    """A hotel-0 map (float32) on a mesh (``Mesh``) or one device."""
    from erl_gaussian_process_tpu_torch.geometry import Aabb
    from erl_gaussian_process_tpu_torch.models import SpGpOccupancyMap
    from erl_gaussian_process_tpu_torch.parallel.mesh import Mesh
    from erl_gaussian_process_tpu_torch.workloads import FREE_SLOTS_PER_RAY

    on_mesh = isinstance(mesh_or_dev, Mesh)
    return SpGpOccupancyMap(
        hotel0["setting"], hotel0["pseudo"],
        Aabb.from_min_max(hotel0["lo"], hotel0["hi"]), seed=0,
        dtype=torch.float32, free_slots_per_ray=FREE_SLOTS_PER_RAY,
        mesh=mesh_or_dev if on_mesh else None,
        device=mesh_or_dev.device if on_mesh else mesh_or_dev)


def fitc_count(kernels: dict) -> int:
    return sum(c for k, (c, _) in kernels.items()
               if any(f in k for f in FITC_KERNELS))


def allreduce_ms(mesh, state) -> float:
    """Event ms of one update's collectives: the all_reduce of a (M, M)
    dQ and a (M, 1) dalpha (median of REPS)."""
    from erl_gaussian_process_tpu_torch.parallel.mesh import all_reduce

    dq, da = torch.zeros_like(state.qm), torch.zeros_like(state.alpha)
    return cuda_ms(lambda: (all_reduce(mesh, dq), all_reduce(mesh, da)))


def mesh_replay(m, sensors, pts, masks) -> tuple:
    """(samples used, ms/pose) of hotel-0 pose by pose through ``update``
    on the map ``m``, the card synchronized before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    used = [m.update(sensors[i], pts[i], masks[i])
            for i in range(len(sensors))]
    torch.cuda.synchronize()
    return (torch.stack(used).cpu(),
            1e3 * (time.perf_counter() - t0) / len(sensors))


def map_state(m) -> dict:
    return {k: getattr(m.state, k).cpu() for k in STATE_KEYS}


def eager_mesh_map(mesh, hotel0):
    """A hotel-0 map on the mesh with its graphs set aside: the eager
    mesh chain, every kernel and collective launched one by one."""
    m = mesh_map(mesh, hotel0)
    m._graphs = None
    return m


def capture_records(maps) -> list:
    """Each captured graph of the maps or models: key, warm-up and
    capture ms, pool MiB, launches a replay, replays."""
    return [{"key": g.key[:3], "warmup_ms": g.warmup_ms,
             "capture_ms": g.capture_ms, "pool_mb": g.pool_bytes / 2**20,
             "launches": {w.__name__: n for w, n in g.launches.items()},
             "replays": g.replays}
            for m in maps for g in m._graphs.captures]


def mesh_job_update(mesh, w):
    """(a) hotel-0 on the NCCL mesh, the eager chain (the maps' graphs set
    aside) and the graphs (one replay a chunk, the all_reduce pair
    inside): pose by pose through ``update``, each run's state, samples
    used, wrapper counts and ms/pose (the graphed run's capture
    included); at c = PPS through ``update_batch`` and the sharded
    predict of the drift grid, both ways; ms/pose after the capture,
    graphed and eager alternated (medians of GRAPH_TIMING_REPLAYS); by
    torch.profiler over GRAPH_PROFILE_POSES poses each way, the host CUDA
    API calls and kernels a pose, the device ms a pose and the NCCL
    kernels' device ms inside a replay; each graph's capture cost; the
    all_reduce's event ms. Every collective in a graph is captured after
    the same collectives ran eagerly in its warm-up; a capture whose
    collective did not join back to the capturing stream raises at
    ``capture_end``, and the eager collective at the end checks that the
    process group still works after the replays."""
    import torch.distributed as dist

    from erl_gaussian_process_tpu_torch.ops import (
        cross_gram_cuda,
        fitc_update_cuda,
        launch_counts,
        reset_launch_counts,
    )

    h = w["hotel0"]
    sensors, pts, masks = h["sensors"], h["pts"], h["masks"]
    b, k = len(sensors), GRAPH_PROFILE_POSES
    warm = eager_mesh_map(mesh, h)
    for i in range(2):
        warm.update(sensors[i], pts[i], masks[i])
    out = {}
    for way, make in (("eager", eager_mesh_map), ("graphed", mesh_map)):
        reset_launch_counts()
        m = make(mesh, h)
        used, ms = mesh_replay(m, sensors, pts, masks)
        out[way] = {"ms_per_pose": ms, "counts": launch_counts(),
                    "n_used": used, "state": map_state(m),
                    "graphs": m._graphs is not None}
        if way == "graphed":
            out[way]["fitc_replayed"] = graph_launches((m,),
                                                       fitc_update_cuda)
            graphed = m
    out["allreduce_ms"] = allreduce_ms(mesh, graphed.state)

    # c = PPS and the sharded predict of the drift grid, both ways
    for way, make in (("eager", eager_mesh_map), ("graphed", mesh_map)):
        reset_launch_counts()
        m = make(mesh, h)
        used = m.update_batch(sensors, pts, masks, poses_per_step=PPS)
        lo = m.predict(h["grid"])[0]
        torch.cuda.synchronize()
        out[f"{way}_pps"] = {"counts": launch_counts(), "n_used": used.cpu(),
                             "state": map_state(m), "lo_grid": lo.cpu()}
        if way == "graphed":
            out["graphed_pps"]["gram_replayed"] = graph_launches(
                (m,), cross_gram_cuda)
            graphed_pps = m

    # ms/pose after the capture, graphed and eager alternated, pose by
    # pose and at c = PPS
    times = {"graphed": [], "eager": [], "graphed_pps": [], "eager_pps": []}
    for _ in range(GRAPH_TIMING_REPLAYS):
        for way, make in (("graphed", mesh_map), ("eager", eager_mesh_map)):
            m = make(mesh, h)
            m.update(sensors[0], pts[0], masks[0])
            _, ms = timed(lambda: [m.update(sensors[i], pts[i], masks[i])
                                   for i in range(1, b)])
            times[way].append(ms / (b - 1))
            m = make(mesh, h)
            m.update_batch(sensors[:PPS], pts[:PPS], masks[:PPS],
                           poses_per_step=PPS)
            _, ms = timed(lambda: m.update_batch(
                sensors[PPS:], pts[PPS:], masks[PPS:], poses_per_step=PPS))
            times[f"{way}_pps"].append(ms / (b - PPS))
    out["times"] = times

    # the profiler over k poses each way
    prof = {}
    for way, make in (("graphed", mesh_map), ("eager", eager_mesh_map)):
        m = make(mesh, h)
        m.update(sensors[0], pts[0], masks[0])
        host, dev, busy = api_calls(lambda: [m.update(sensors[i], pts[i],
                                                      masks[i])
                                             for i in range(1, 1 + k)])
        prof[way] = {
            "host_api_calls_per_pose": sum(host.values()) / k,
            "graph_launches": host.get("cudaGraphLaunch", 0),
            "kernels_per_pose": sum(c for c, _ in dev.values()) / k,
            "device_ms_per_pose": sum(ms for _, ms in dev.values()) / k,
            "busy_ms_per_pose": busy / k,
            "nccl_ms_per_pose": sum(ms for name, (_, ms) in dev.items()
                                    if "nccl" in name.lower()) / k,
            "nccl_kernels_per_pose": sum(c for name, (c, _) in dev.items()
                                         if "nccl" in name.lower()) / k,
            "fitc_kernels": sum(c for name, (c, _) in dev.items()
                                if any(f in name for f in FITC_KERNELS)),
            "host": host}
    out["profile"] = prof
    out["captures"] = capture_records((graphed, graphed_pps))
    t = torch.ones(4, device=mesh.device)
    dist.all_reduce(t)
    torch.cuda.synchronize()
    out["eager_collective_after_replays"] = float(t.sum()) == 4.0 * mesh.size
    return out


def mesh_job_sensor_graphs(mesh, w):
    """(a) the 3D lidar protocol and frame 0 of data/double/train.dat on
    the NCCL mesh: each GP's train and test graphed (the rank's bank fit
    and the gathers inside the train's replay; the capture, then a
    replay) against the same model's eager mesh chain (its graphs set
    aside), bit for bit: bank, means, valid masks (the 3D GP's
    device-routed means within ``ROUTED_TOL``); the wrapper counts of
    one replayed train and test; each train's ms, graphed and eager
    (medians of MESH_TRAINS); each graph's capture cost."""
    from erl_gaussian_process_tpu_torch.ops import (
        launch_counts,
        reset_launch_counts,
    )

    out = {}
    for name, (gp, scan, queries) in sensor_mesh_models(mesh, w).items():
        gp.train(*scan)                               # the captures
        gp.test(queries, False, True).get_mean()
        reset_launch_counts()
        ok = gp.train(*scan)
        bank = {k: getattr(gp.bank, k).clone() for k in ("L", "L_inv",
                                                        "alpha")}
        pred, valid = gp.test(queries, False, True).get_mean()
        torch.cuda.synchronize()
        counts = launch_counts()
        graphs, gp._graphs = gp._graphs, None
        ok_e = gp.train(*scan)
        pred_e, valid_e = gp.test(queries, False, True).get_mean()
        eager_ms = statistics.median(
            timed(lambda: gp.train(*scan))[1] for _ in range(MESH_TRAINS))
        same = same_bits(bank, {k: getattr(gp.bank, k)
                                for k in ("L", "L_inv", "alpha")}) and \
            routed_close((pred, valid), (pred_e, valid_e),
                         ROUTED_TOL[gp.dtype]
                         if hasattr(gp, "_routed_predict") else None)
        gp._graphs = graphs
        out[name] = {
            "ok": ok and ok_e, "graphs": graphs is not None,
            "same_as_eager": same, "counts": counts,
            "train_ms": statistics.median(
                timed(lambda: gp.train(*scan))[1]
                for _ in range(MESH_TRAINS)),
            "eager_train_ms": eager_ms,
            "captures": capture_records((gp,))}
    return out


def mesh_job_batch(mesh, w):
    """(b) hotel-0 through ``update_batch(poses_per_step=PPS)`` on the mesh
    and the sharded predicts of the quality points and the drift grid: the
    replay's state, samples used and ms/pose, the predictions, the wrapper
    counts of replay and predicts, the drift grid's predict of the same
    state and prepare unsharded (``spgp_predict``), FITC's launches a chunk
    and the gram's a predict by torch.profiler, the all_reduce's ms."""
    from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
        spgp_predict,
    )
    from erl_gaussian_process_tpu_torch.ops import (
        launch_counts,
        reset_launch_counts,
    )

    h = w["hotel0"]
    sensors, pts, masks = h["sensors"], h["pts"], h["masks"]
    warm = mesh_map(mesh, h)
    warm.update_batch(sensors[:2 * PPS], pts[:2 * PPS], masks[:2 * PPS],
                      poses_per_step=PPS)
    warm.predict(h["grid"])
    reset_launch_counts()
    m = mesh_map(mesh, h)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_used = m.update_batch(sensors, pts, masks, poses_per_step=PPS)
    torch.cuda.synchronize()
    out = {"ms_per_pose": 1e3 * (time.perf_counter() - t0) / len(sensors),
           "lo": {k: m.predict(h[k])[0].cpu()
                  for k in ("sel", "traj", "grid")},
           "graphs": m._graphs is not None}
    L_qm, a = m.sp_gp._prepared()
    out["lo_one"] = spgp_predict(
        m.state, L_qm, a, m._tensor(h["grid"]), m.sp_gp._scale,
        kernel=m.sp_gp._kernel, with_var=False)[0][:, 0].cpu()
    out.update(counts=launch_counts(), n_used=n_used.cpu(),
               state={k: getattr(m.state, k).cpu() for k in ("qm", "alpha")})
    kernels = device_kernels(lambda: (
        m.update_batch(sensors[:PPS], pts[:PPS], masks[:PPS],
                       poses_per_step=PPS), m.predict(h["grid"])),
        expect=(*FITC_KERNELS, "gram_kernel"))
    out["fitc_per_chunk"] = fitc_count(kernels)
    out["gram_per_predict"] = sum(c for k, (c, _) in kernels.items()
                                  if "gram_kernel" in k)
    out["allreduce_ms"] = allreduce_ms(mesh, m.state)
    return out


def sensor_mesh_models(mesh, w) -> dict:
    """{name: (model on the mesh, its train's arguments, its test
    queries)}: the 3D lidar protocol's RangeSensorGaussianProcess3D and
    frame 0 of data/double/train.dat through LidarGaussianProcess2D."""
    from erl_gaussian_process_tpu_torch.models import (
        LidarGaussianProcess2D,
        RangeSensorGaussianProcess3D,
    )

    setting, R, t, ranges, q, gt, _ = w["lidar"]
    f = w["frame2d"]
    return {"gp3d": (RangeSensorGaussianProcess3D(
                         setting, dtype=np.float32, mesh=mesh,
                         device=mesh.device), (R, t, ranges), q),
            "gp2d": (LidarGaussianProcess2D(
                         lidar2d_setting(f.angles, False), dtype=np.float64,
                         mesh=mesh, device=mesh.device),
                     (np.eye(2), np.zeros(2), f.ranges), f.angles)}


def mesh_job_sensor(mesh, w):
    """(c) the 3D lidar protocol through ``RangeSensorGaussianProcess3D``
    and frame 0 of data/double/train.dat through ``LidarGaussianProcess2D``
    on the mesh: each GP's gathered bank, its test, its wrapper counts for
    one train and one test, its bank fits a train and grams a test by
    torch.profiler, its train's ms (median of MESH_TRAINS)."""
    from erl_gaussian_process_tpu_torch.ops import (
        launch_counts,
        reset_launch_counts,
    )

    out = {}
    for name, (gp, scan, queries) in sensor_mesh_models(mesh, w).items():
        gp.train(*scan)                         # warm-up, not counted
        gp.test(queries, False, True).get_mean()
        reset_launch_counts()
        ok = gp.train(*scan)
        pred, valid = gp.test(queries, False, True).get_mean()
        r = {"ok": ok, "counts": launch_counts(), "pred": pred,
             "valid": valid, "graphs": gp._graphs is not None,
             "bank": {k: getattr(gp.bank, k).cpu()
                      for k in ("L", "L_inv", "alpha")}}
        kernels = device_kernels(lambda: (
            gp.train(*scan), gp.test(queries, False, True).get_mean()),
            expect=("bank_fit", "gram_kernel"))
        r["fits_per_train"] = sum(c for k, (c, _) in kernels.items()
                                  if "bank_fit" in k)
        r["grams_per_test"] = sum(c for k, (c, _) in kernels.items()
                                  if "gram_kernel" in k)
        r["train_ms"] = statistics.median(
            timed(lambda: gp.train(*scan))[1] for _ in range(MESH_TRAINS))
        out[name] = r
    return out


MESH_JOBS = {"update": mesh_job_update, "batch": mesh_job_batch,
             "sensor": mesh_job_sensor,
             "sensor_graphs": mesh_job_sensor_graphs}


def mesh_rank(rank, size, work):
    """One rank of a phase-23 world (``parallel/spawn.spawn_world``, which
    has initialised its process group with MESH_TIMEOUT_S): the mesh on
    ``work["device"]`` (``cuda:{rank % count}``), every float32 product in
    full FP32, then ``work["jobs"]``. Returns the jobs' results."""
    from erl_gaussian_process_tpu_torch.models.gp_core import (
        use_full_fp32_matmul,
    )
    from erl_gaussian_process_tpu_torch.parallel import make_mesh

    use_full_fp32_matmul()
    mesh = make_mesh(size, device=work["device"])
    out = {"init_s": time.time() - work["t_spawn"],
           "device": str(mesh.device), "host_staging": mesh.host_staging}
    for job in work["jobs"]:
        t0 = time.perf_counter()
        out[job] = MESH_JOBS[job](mesh, work)
        out[f"{job}_s"] = time.perf_counter() - t0
    return out


def mesh_world(size, backend, out_dir, work) -> tuple:
    """Spawn ``size`` ranks of :func:`mesh_rank` on ``backend``, joined
    within MESH_JOIN_S; any rank's failure fails the phase. Returns (each
    rank's results, seconds from the spawn to the last exit)."""
    from erl_gaussian_process_tpu_torch.parallel.spawn import spawn_world

    return spawn_world(mesh_rank, size, out_dir, backend=backend,
                       timeout_s=MESH_TIMEOUT_S, join_s=MESH_JOIN_S,
                       args=(dict(work, t_spawn=time.time()),))


def same_bits(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_bits(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and bool(torch.equal(a, b.to(a.device)))
    return bool(np.array_equal(a, b))


def predict_gap(lo, ref) -> tuple:
    """(max |lo - ref| / max |ref|, sign agreement) of two log-odds."""
    lo, ref = torch.as_tensor(lo).cpu(), torch.as_tensor(ref).cpu()
    return (float((lo - ref).abs().max() / ref.abs().max()),
            float((torch.sign(lo) == torch.sign(ref)).double().mean()))


def rel_frobenius(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def exact_prepare(dev, hotel0, states: dict) -> tuple:
    """The float32 hotel-0 states' sensitivity (ROADMAP Queue 3): for
    each state, cond(Q_M - Q_M_c) in float64 and the drift-grid posterior
    of its exact float64 host prepare (``spgp_prepare_exact_host``, the
    map's second tier). Returns ({name: cond}, {name: log-odds})."""
    from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
        spgp_predict,
        spgp_prepare_exact_host,
    )

    m = mesh_map(dev, hotel0)
    grid = m._tensor(hotel0["grid"])
    conds, lo = {}, {}
    for name, st in states.items():
        w = np.linalg.eigvalsh((st.qm.double() - st.qm_c.double()).cpu()
                               .numpy())
        conds[name] = float(w[-1] / w[0])
        L, a = spgp_prepare_exact_host(st)
        lo[name] = spgp_predict(st, L, a, grid, m.sp_gp._scale,
                                kernel=m.sp_gp._kernel,
                                with_var=False)[0][:, 0].cpu()
    return conds, lo


def mesh_kernel_rows(dev, card, hotel0, lidar) -> dict:
    """The rows of the kernels the mesh reaches, at one rank's shapes of
    the gloo world of two: FITC at (1152, 4096, d = 3) (rank 0's half of
    hotel-0's first chunk of PPS poses, sampled as the map samples them),
    with its padding checked (the first MESH_SHARD samples padded to 4096
    with masked zeros: dQ and dalpha bit for bit the unpadded ones); the
    bank fit at the lidar protocol's 368 x 100 (rank 0's members); the
    gram at 1152 x 1024 (rank 0's half of the drift grid). Each against
    its plain version, with event and plain ms and the bound."""
    from erl_gaussian_process_tpu_torch.models import (
        RangeSensorGaussianProcess3D,
    )
    from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
        spgp_init,
    )
    from erl_gaussian_process_tpu_torch.models.spgp_occupancy_map import (
        sample_pose,
        step_seed,
    )
    from erl_gaussian_process_tpu_torch.ops import (
        bank_fit_cuda,
        bank_fit_plain,
        cross_gram_cuda,
        cross_gram_plain,
        fitc_update_cuda,
        fitc_update_plain,
    )
    from erl_gaussian_process_tpu_torch.parallel.mesh import _pad_axis

    rows = {}
    m = mesh_map(dev, hotel0)
    kw = {k: v for k, v in m._step_kw().items()
          if k not in ("kernel", "diagonal_qm", "zero_threshold")}
    ds = []
    for i in range(PPS // 2):
        m._generator.manual_seed(step_seed(0, 1 + i))
        ds.append(sample_pose(
            m._tensor(hotel0["sensors"][i]),
            m._tensor(np.where(hotel0["masks"][i][:, None],
                               hotel0["pts"][i], 0.0)),
            torch.as_tensor(hotel0["masks"][i], device=dev), m._aabb_min,
            m._aabb_max, generator=m._generator, **kw))
    x, y, var, mask = (torch.cat(t) for t in zip(*ds))
    st, scale, kern = m.state, m.sp_gp._scale, m.sp_gp._kernel
    n = x.shape[0]
    err32 = 0.0
    for dt in (torch.float64, torch.float32):
        s_dt = spgp_init(st.pseudo.to(dt), scale, kernel=kern)
        a_dt = (kern, s_dt.pseudo, s_dt.L_inv, x.to(dt), y.to(dt),
                torch.full((n,), FITC_VAR[dt], device=dev, dtype=dt), mask,
                scale)
        dq, da = fitc_update_cuda(*a_dt)
        torch.cuda.synchronize()
        dq_ref, da_ref = fitc_update_plain(*a_dt)
        rq = float((dq - dq_ref).abs().max() / dq_ref.abs().max())
        ra = float((da - da_ref).abs().max() / da_ref.abs().max())
        log(f"fitc one rank's shard M={st.pseudo.shape[0]} N={n} {dt} var "
            f"{FITC_VAR[dt]:g}: rel_err dQ {rq:.3e} dalpha {ra:.3e} (tol "
            f"{FITC_TOL[dt]:g})")
        check(rq <= FITC_TOL[dt] and ra <= FITC_TOL[dt],
              f"fitc one rank's shard {dt}: rel err {rq}, {ra}")
        if dt == torch.float32:
            err32 = float((dq - dq_ref).abs().max())
    args = (kern, st.pseudo, st.L_inv, x, y, var, mask, scale)
    fitc_against_truth(args)
    short = [t[:MESH_SHARD] for t in (x, y, var, mask)]
    padded, _ = _pad_axis(short, 0, n)
    got = fitc_update_cuda(kern, st.pseudo, st.L_inv, *padded, scale)
    ref = fitc_update_cuda(kern, st.pseudo, st.L_inv, *short, scale)
    check(all(bool(torch.equal(a, b)) for a, b in zip(got, ref)),
          f"fitc: {n - MESH_SHARD} masked pad samples changed dQ or dalpha")
    b_ms, b_by = fitc_bound(st.pseudo.shape[0], n, 3)
    rows["fitc_mesh"] = {
        "max_abs_err": err32,
        "ms": batch_ms(lambda: fitc_update_cuda(*args)),
        "plain_ms": batch_ms(lambda: fitc_update_plain(*args)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        **time_fitc_syrk(args, "1d")}
    log(f"fitc one rank's shard: {MESH_SHARD} samples padded to {n} with "
        "masked zeros give dQ and dalpha bit for bit")

    setting, R, t, ranges = lidar[:4]
    gp = RangeSensorGaussianProcess3D(setting, dtype=np.float32, device=dev)
    xb, yb, vb, mb = gp._gather_scans(ranges[None])
    half = xb.shape[0] // 2
    xb, yb, vb, mb = (u[:half].contiguous() for u in (xb, yb, vb, mb))
    got = bank_fit_cuda(gp._kernel, xb, yb, vb, mb, gp._scale)
    torch.cuda.synchronize()
    eL, ea, eI = bank_errors(*got, bank_fit_plain(gp._kernel, xb, yb, vb, mb,
                                                  gp._scale))
    check(max(eL, ea, eI) <= BANK_TOL[torch.float32],
          f"bank_fit one rank's members: errors {eL}, {ea}, {eI}")
    b_ms, b_by = bank_fit_bound(half, xb.shape[1], xb.shape[2], yb.shape[2])
    rows["bank_fit_mesh"] = {
        "max_abs_err": eL,
        "ms": cuda_ms(lambda: bank_fit_cuda(gp._kernel, xb, yb, vb, mb,
                                            gp._scale)),
        "plain_ms": cuda_ms(lambda: bank_fit_plain(gp._kernel, xb, yb, vb, mb,
                                                   gp._scale)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

    xq = torch.as_tensor(hotel0["grid"], device=dev)
    xq = xq[:xq.shape[0] // 2].contiguous()
    k = cross_gram_cuda(kern, st.pseudo, xq, scale)
    torch.cuda.synchronize()
    err = float((k - cross_gram_plain(kern, st.pseudo, xq, scale)).abs().max())
    check(err <= GRAM_TOL[torch.float32], f"gram one rank's queries: {err}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g_ms, g_by, _ = gram_bound(kern, torch.float32, 1, st.pseudo.shape[0],
                               xq.shape[0], 3, st.pseudo.shape[0], False,
                               sms, sm_clock_mhz())
    rows["gram_mesh"] = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: cross_gram_cuda(kern, st.pseudo, xq, scale)),
        "plain_ms": cuda_ms(lambda: cross_gram_plain(kern, st.pseudo, xq,
                                                     scale)),
        "bound_ms": g_ms,
        "bound_by": "bytes" if g_by == "bytes" else "operations",
        "library_ms": None}
    for name, r in rows.items():
        batches = f" batches of {BATCH}" if name == "fitc_mesh" else ""
        log(f"time on {card}: {name} kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms (median of {REPS}{batches}), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


def run_mesh(dev, card, hotel0, slice_ref, pps_ref, lidar, frame2d,
             ref_ms) -> tuple:
    """Phase 23: the mesh. (a) NCCL, one rank on the card: hotel-0 pose by
    pose through ``update(mesh=)``, eager and graphed, Q_M, alpha, their
    compensations and the samples used bit for bit phase 4's pose-by-pose
    replay (``slice_ref``), at c = PPS and the sharded predict phase 19's,
    the sensor GPs' graphed trains their eager mesh chain's; (b) gloo, two ranks on ``cuda:0`` (their collectives
    staged through the host): hotel-0 through ``update_batch
    (poses_per_step=PPS)`` (FITC at 1152 x 4096 a rank), the samples used
    equal to phase 19's (``pps_ref``: its replay's state, samples used and
    drift-grid predict), Q_M and alpha within MESH_DRIFT relative Frobenius
    of its state, the quality gates, the sharded predict of the drift grid
    within MESH_PREDICT_TOL of the maximum of the one-rank predict of the
    same state (sign agreement > MESH_SIGNS) and within the drift gate of
    phase 4's float64 replay; its gap to phase 19's float32 posterior is
    reported beside phase 19's to phase 4's; (c) gloo, the 3D lidar
    protocol (368 members a rank) and the 2D lidar GP: L, L^-1 and alpha
    bit for bit the one-card train's, the MSE and MAE gates. Launches a
    gloo rank by torch.profiler: a PPS-pose chunk 3 FITC, a train 1 bank
    fit, a predict >= 1 gram. Reported: ms/pose beside phases 4 and
    19 (``ref_ms``), the all_reduce's ms an update, the spawn-and-init
    time. Returns (launches by row: the mesh rows' and the NCCL rank's
    graphed runs' by the rows of their shapes, timings, the graphed NCCL
    states)."""
    import tempfile

    from erl_gaussian_process_tpu_torch.models import (
        LidarGaussianProcess2D,
        RangeSensorGaussianProcess3D,
    )
    from erl_gaussian_process_tpu_torch.ops.fitc import LAUNCHES
    from erl_gaussian_process_tpu_torch.utils.drift import (
        drift_metric,
        sign_agreement,
    )

    torch.cuda.empty_cache()
    timings = {}
    with tempfile.TemporaryDirectory() as tmp:
        nccl, timings["nccl_wall_s"] = mesh_world(
            1, "nccl", os.path.join(tmp, "nccl"),
            {"device": "cuda", "jobs": ["update", "sensor_graphs"],
             "hotel0": hotel0, "lidar": lidar, "frame2d": frame2d})
        gloo, timings["gloo_wall_s"] = mesh_world(
            2, "gloo", os.path.join(tmp, "gloo"),
            {"device": "cuda", "jobs": ["batch", "sensor"], "hotel0": hotel0,
             "lidar": lidar, "frame2d": frame2d})

    # (a) NCCL, world of one: the eager chain and the graphs
    a = nccl[0]["update"]
    ae, ag = a["eager"], a["graphed"]
    b = len(hotel0["sensors"])
    check(nccl[0]["device"] == "cuda:0" and not nccl[0]["host_staging"],
          f"NCCL rank: {nccl[0]['device']}")
    check(not ae["graphs"] and ag["graphs"],
          "mesh NCCL D=1: the map on an NCCL mesh built no graphs")
    check(same_bits(ag["state"], ae["state"])
          and same_bits(ag["n_used"], ae["n_used"]),
          "mesh NCCL D=1: the graphed replay differs from the eager chain")
    phase4 = {k: getattr(slice_ref["state"], k) for k in STATE_KEYS}
    for way, r in (("eager", ae), ("graphed", ag)):
        check(same_bits(r["n_used"], slice_ref["n_used"]),
              f"mesh NCCL D=1 {way}: samples used differ from phase 4's "
              "replay")
        check(same_bits(r["state"], phase4),
              f"mesh NCCL D=1 {way}: Q_M, alpha or their compensations "
              "differ from phase 4's replay")
    check(ae["counts"]["fitc"] == b,
          f"mesh NCCL D=1 eager: FITC launches {ae['counts']['fitc']} != {b}")
    replayed, warm_ups = ag["fitc_replayed"]
    check(replayed == b and ag["counts"]["fitc"] == b + warm_ups,
          f"mesh NCCL D=1 graphed: FITC {ag['counts']['fitc']} launches, "
          f"{replayed} by replays, {warm_ups} by the warm-up")
    ep, gp_ = a["eager_pps"], a["graphed_pps"]
    for way, r in (("eager", ep), ("graphed", gp_)):
        check(same_bits(r["n_used"], pps_ref["n_used"])
              and same_bits(r["state"], {k: getattr(pps_ref["state"], k)
                                         for k in STATE_KEYS}),
              f"mesh NCCL D=1 {way} poses_per_step={PPS}: state or samples "
              "used differ from phase 19's replay")
        check(same_bits(r["lo_grid"], pps_ref["lo_grid"]),
              f"mesh NCCL D=1 {way}: the sharded predict of the drift grid "
              "differs from phase 19's one-card predict")
    chunks = -(-b // PPS)
    check(gp_["counts"]["fitc"] == chunks + 1
          and gp_["gram_replayed"][0] >= 1,
          f"mesh NCCL D=1 graphed poses_per_step={PPS}: counts "
          f"{gp_['counts']}, gram by replays and warm-ups "
          f"{gp_['gram_replayed']}")
    pg, pe = a["profile"]["graphed"], a["profile"]["eager"]
    k = GRAPH_PROFILE_POSES
    check(pg["graph_launches"] == k and pg["fitc_kernels"] == 3 * k,
          f"mesh NCCL D=1: {k} graphed poses made {pg['graph_launches']} "
          f"graph launches and ran {pg['fitc_kernels']} FITC kernels")
    # at D = 1 NCCL's in-place all_reduce launches nothing: the replay
    # holds the NCCL kernels the eager chain launches, whatever their count
    check(pg["nccl_kernels_per_pose"] == pe["nccl_kernels_per_pose"],
          f"mesh NCCL D=1: NCCL kernels a pose, graphed {pg} against eager "
          f"{pe}")
    check(a["eager_collective_after_replays"],
          "mesh NCCL D=1: an eager all_reduce after the replays failed")
    g_ms, e_ms, g4_ms, e4_ms = (statistics.median(a["times"][way]) for way in
                                ("graphed", "eager", "graphed_pps",
                                 "eager_pps"))
    idle = 1.0 - pg["device_ms_per_pose"] / g_ms
    log(f"mesh (a) NCCL, 1 rank: {b} poses through update(mesh=), eager and "
        "graphed, Q_M, alpha, compensations and samples used bit for bit "
        f"phase 4's; FITC {ae['counts']['fitc']} launches eager, "
        f"{replayed} by {len(a['captures'])} graph(s)' replays + {warm_ups} "
        f"warm-up; at poses_per_step={PPS} both bit for bit phase 19's, "
        "the graphed and eager sharded predicts of the drift grid bit for "
        f"bit phase 19's one-card predict; {k} graphed poses by "
        f"torch.profiler: {pg['graph_launches']} graph launches, host CUDA "
        f"API calls a pose {pg['host_api_calls_per_pose']:g} (eager "
        f"{pe['host_api_calls_per_pose']:g}), kernels a pose "
        f"{pg['kernels_per_pose']:g} (eager {pe['kernels_per_pose']:g}), "
        f"device {pg['device_ms_per_pose']:.4f} ms a pose (eager "
        f"{pe['device_ms_per_pose']:.4f}), the all_reduce pair's NCCL "
        f"kernels {pg['nccl_kernels_per_pose']:g} a pose (eager "
        f"{pe['nccl_kernels_per_pose']:g}), {pg['nccl_ms_per_pose']:.4f} ms "
        f"device inside a replay (eager {pe['nccl_ms_per_pose']:.4f}); "
        f"graphed host API "
        f"{pg['host']}; an eager all_reduce after the replays ok")
    for c in a["captures"]:
        log(f"mesh graph {c['key']}: warm-up {c['warmup_ms']:.2f} ms, "
            f"capture {c['capture_ms']:.2f} ms, pool {c['pool_mb']:.1f} MiB, "
            f"launches a replay {c['launches']}, replays {c['replays']}")
    sg = nccl[0]["sensor_graphs"]
    for name, c in sg.items():
        check(c["ok"] and c["graphs"] and c["same_as_eager"],
              f"mesh NCCL D=1 {name}: the graphed train or test differs "
              f"from the eager mesh chain ({c['ok']}, {c['graphs']})")
        check(c["counts"]["bank_fit"] == 1,
              f"mesh NCCL D=1 {name}: a replayed train's counts "
              f"{c['counts']}")
        log(f"mesh (a) NCCL {name}: graphed train and test equal to the "
            f"eager mesh chain; train {c['train_ms']:.4f} ms graphed, "
            f"{c['eager_train_ms']:.4f} ms eager (medians of "
            f"{MESH_TRAINS}); graphs "
            + "; ".join(f"{g['key'][:2]} warm-up {g['warmup_ms']:.2f} ms "
                        f"capture {g['capture_ms']:.2f} ms pool "
                        f"{g['pool_mb']:.1f} MiB replays {g['replays']}"
                        for g in c["captures"]))

    # (b) gloo, two ranks on one card
    r0 = gloo[0]["batch"]
    for r, res in enumerate(gloo):
        check(res["device"] == "cuda:0" and res["host_staging"],
              f"gloo rank {r}: {res['device']}, staging "
              f"{res['host_staging']}")
        check(not res["batch"]["graphs"]
              and not any(c["graphs"] for c in res["sensor"].values()),
              f"gloo rank {r}: a model on a host-staged mesh built graphs")
        c = res["batch"]
        check(same_bits(c["state"], r0["state"])
              and same_bits(c["lo"], r0["lo"]),
              f"mesh gloo D=2: rank {r}'s state or predictions differ from "
              "rank 0's")
        check(c["counts"]["fitc"] == chunks and c["counts"]["gram"] > 0,
              f"mesh gloo D=2 rank {r}: launch counts {c['counts']}")
        check(c["fitc_per_chunk"] == LAUNCHES
              and c["gram_per_predict"] >= 1,
              f"mesh gloo D=2 rank {r}: FITC a chunk {c['fitc_per_chunk']}, "
              f"gram a predict {c['gram_per_predict']}")
    check(same_bits(r0["n_used"], pps_ref["n_used"]),
          "mesh gloo D=2: samples used differ from phase 19's")
    drift = {k: rel_frobenius(r0["state"][k], getattr(pps_ref["state"], k))
             for k in ("qm", "alpha")}
    surf = float((r0["lo"]["sel"] > 0).float().mean())
    free = float((r0["lo"]["traj"] < 0).float().mean())
    lo = r0["lo"]["grid"]
    # the query sharding: the sharded predict against the one-rank predict
    # of the same state and prepare; the posterior: against phase 4's
    # float64 replay (the datasets are phase 4's, and the sum is order
    # free); reported: against phase 19's one-card float32 posterior, and
    # phase 19's against phase 4's (two float32 states a rounding order
    # apart, ROADMAP Queue 3), each map's prepare against the exact float64
    # prepare of its state, and the two states under that prepare
    conds, lo_exact = exact_prepare(dev, hotel0,
                                    {"phase4": slice_ref["state"],
                                     "phase19": pps_ref["state"]})
    pred = {"sharded_vs_one_rank": predict_gap(lo, r0["lo_one"]),
            "vs_phase19": predict_gap(lo, pps_ref["lo_grid"]),
            "phase19_vs_phase4": predict_gap(pps_ref["lo_grid"],
                                             slice_ref["lo32"]),
            "phase4_vs_exact_f64_prepare": predict_gap(slice_ref["lo32"],
                                                       lo_exact["phase4"]),
            "phase19_vs_exact_f64_prepare": predict_gap(
                pps_ref["lo_grid"], lo_exact["phase19"]),
            "phase19_vs_phase4_exact_f64_prepares": predict_gap(
                lo_exact["phase19"], lo_exact["phase4"])}
    lo64 = slice_ref["lo64"]
    drift64_19 = drift_metric(pps_ref["lo_grid"].cpu().numpy(), lo64)
    drift64 = drift_metric(lo.numpy(), lo64)
    signs64 = sign_agreement(lo.numpy(), lo64)
    log(f"mesh (b) gloo, 2 ranks on one card, poses_per_step={PPS}: {chunks} "
        f"sharded FITC updates of {PPS} poses; vs phase 19's map: Q_M "
        f"{drift['qm']:.3e} alpha {drift['alpha']:.3e} relative Frobenius "
        f"(gate < {MESH_DRIFT:g}); quality surface {surf:.4f} trajectory "
        f"{free:.4f}; grid predict (max |diff| / max, sign agreement): "
        f"{pred} (gate on sharded_vs_one_rank < {MESH_PREDICT_TOL:g}, > "
        f"{MESH_SIGNS}); drift vs phase 4's float64 replay {drift64:.6e} "
        f"(gate <= {DRIFT_GATE_MAX}), confident-cell sign agreement "
        f"{signs64:.6f}; phase 19's drift vs phase 4's float64 replay "
        f"{drift64_19:.6e}; cond(Q_M - Q_M_c) in float64 {conds}")
    check(max(drift.values()) < MESH_DRIFT, f"mesh gloo D=2 drift {drift}")
    check(surf > 0.9 and free > 0.95,
          f"mesh gloo D=2 quality: surface {surf}, trajectory {free}")
    gap, signs = pred["sharded_vs_one_rank"]
    check(gap < MESH_PREDICT_TOL and signs > MESH_SIGNS,
          f"mesh gloo D=2 sharded predict: {gap}, signs {signs}")
    check(np.isfinite(lo.numpy()).all() and drift64 <= DRIFT_GATE_MAX,
          f"mesh gloo D=2 drift vs float64 {drift64}")

    # (c) gloo, the sensor GPs
    setting, R, t, ranges, q, gt, _ = lidar
    one = {"gp3d": RangeSensorGaussianProcess3D(setting, dtype=np.float32,
                                                device=dev),
           "gp2d": LidarGaussianProcess2D(lidar2d_setting(frame2d.angles,
                                                          False),
                                          dtype=np.float64, device=dev)}
    check(one["gp3d"].train(R, t, ranges)
          and one["gp2d"].train(np.eye(2), np.zeros(2), frame2d.ranges),
          "one-card sensor GP trains")
    s0 = gloo[0]["sensor"]
    for r, res in enumerate(gloo):
        for name, c in res["sensor"].items():
            check(c["ok"] and same_bits(
                c["bank"], {k: getattr(one[name].bank, k)
                            for k in c["bank"]}),
                  f"mesh gloo D=2 rank {r} {name}: L, L^-1 or alpha differ "
                  "from the one-card train")
            check(c["counts"]["bank_fit"] == 1
                  and c["counts"]["gram_batched"] >= 1
                  and c["fits_per_train"] == 1 and c["grams_per_test"] >= 1,
                  f"mesh gloo D=2 rank {r} {name}: counts {c['counts']}, "
                  f"bank fits a train {c['fits_per_train']}, grams a test "
                  f"{c['grams_per_test']}")
    g3 = s0["gp3d"]
    mse = float(np.mean((g3["pred"][g3["valid"]] - gt[g3["valid"]]) ** 2))
    g2 = s0["gp2d"]
    mae = float(np.abs(g2["pred"][g2["valid"]]
                       - frame2d.ranges[g2["valid"]]).mean())
    log(f"mesh (c) gloo, 2 ranks: 3D lidar protocol "
        f"{one['gp3d'].bank.x.shape[0]} members, banks bit for bit the "
        f"one-card train's, MSE {mse:.6e} (gate <= {LIDAR_MSE_GATE:g}); 2D "
        f"lidar GP {one['gp2d'].bank.x.shape[0]} members, bit for bit, MAE "
        f"{mae:.6e} (gate < {LIDAR2D_MAE['float64']:g})")
    check(g3["valid"].any() and mse <= LIDAR_MSE_GATE, f"mesh MSE {mse}")
    check(g2["valid"].any() and mae < LIDAR2D_MAE["float64"],
          f"mesh 2D MAE {mae}")

    timings.update({
        "nccl_d1_update_ms_per_pose": ae["ms_per_pose"],
        "nccl_d1_graphed_update_ms_per_pose": ag["ms_per_pose"],
        "nccl_d1_after_capture_ms_per_pose": {
            way: {"median": statistics.median(v), "range": [min(v), max(v)]}
            for way, v in a["times"].items()},
        "nccl_d1_device_idle_share": idle,
        "nccl_d1_profile": {way: {key: v for key, v in r.items()
                                  if key != "host"}
                            for way, r in a["profile"].items()},
        "nccl_d1_captures": a["captures"],
        "nccl_d1_sensor_graphs": {
            name: {key: c[key] for key in ("train_ms", "eager_train_ms",
                                           "captures")}
            for name, c in sg.items()},
        "phase4_update_ms_per_pose": ref_ms["update"],
        "gloo_d2_pps_ms_per_pose": [res["batch"]["ms_per_pose"]
                                    for res in gloo],
        "phase19_pps_ms_per_pose": ref_ms["pps"],
        "nccl_d1_allreduce_ms": a["allreduce_ms"],
        "gloo_d2_allreduce_ms": [res["batch"]["allreduce_ms"]
                                 for res in gloo],
        "spawn_init_s": {"nccl": [res["init_s"] for res in nccl],
                         "gloo": [res["init_s"] for res in gloo]},
        "job_s": {"nccl": [[res["update_s"], res["sensor_graphs_s"]]
                           for res in nccl],
                  "gloo": [[res["batch_s"], res["sensor_s"]]
                           for res in gloo]},
        "train_ms": {name: [res["sensor"][name]["train_ms"]
                            for res in gloo] for name in s0},
        "drift": drift, "predict": pred, "drift_f64": drift64,
        "phase19_drift_f64": drift64_19, "cond_qm_f64": conds,
        "sign_agreement_f64": signs64,
        "mse": mse, "mae_2d": mae})
    log(f"mesh on {card}: NCCL D=1 update eager {ae['ms_per_pose']:.4f} "
        f"ms/pose, graphed {ag['ms_per_pose']:.4f} (capture included); "
        f"after the capture (medians of {GRAPH_TIMING_REPLAYS}) graphed "
        f"{g_ms:.4f} (range {min(a['times']['graphed']):.4f}-"
        f"{max(a['times']['graphed']):.4f}), eager {e_ms:.4f} (range "
        f"{min(a['times']['eager']):.4f}-{max(a['times']['eager']):.4f}); "
        f"at poses_per_step={PPS} graphed {g4_ms:.4f}, eager {e4_ms:.4f} "
        f"(phase 19: {ref_ms['pps']:.4f}); "
        f"device idle {100 * idle:.1f}% graphed (phase 4: "
        f"{ref_ms['update']:.4f}, median), gloo D=2 "
        f"poses_per_step={PPS} {timings['gloo_d2_pps_ms_per_pose']} ms/pose "
        f"a rank (phase 19: {ref_ms['pps']:.4f}, median), one replay a "
        "world; all_reduce "
        f"of an update's dQ and dalpha: NCCL D=1 {a['allreduce_ms']:.4f} ms, "
        f"gloo D=2 {timings['gloo_d2_allreduce_ms']} ms (median of {REPS}); "
        f"spawn to mesh {timings['spawn_init_s']} s, jobs "
        f"{timings['job_s']} s; worlds "
        f"{timings['nccl_wall_s']:.2f} / {timings['gloo_wall_s']:.2f} s")
    # the mesh rows (their shapes are a gloo rank's): the gloo ranks' runs;
    # the NCCL rank's graphed runs (each counted from 0) by the one-card
    # rows of their shapes, as D = 1 shards nothing: the pose-by-pose map
    # (FITC at N = 2048), the map at c = PPS (N = PPS x 2048) and its
    # predict of the drift grid (1152 x 2048), one replayed 3D train (the
    # 736-member bank)
    nccl_graphed = {"fitc": ag["counts"]["fitc"],
                    "fitc_8192": gp_["counts"]["fitc"],
                    "gram": gp_["counts"]["gram"],
                    "bank_fit": sg["gp3d"]["counts"]["bank_fit"]}
    log(f"mesh (a) NCCL D=1 graphed launches by the one-card row of their "
        f"shape: {nccl_graphed}")
    launches = {
        "fitc_mesh": sum(res["batch"]["counts"]["fitc"] for res in gloo),
        "bank_fit_mesh": sum(res["sensor"]["gp3d"]["counts"]["bank_fit"]
                             for res in gloo),
        "gram_mesh": sum(res["batch"]["counts"]["gram"] for res in gloo),
        **nccl_graphed}
    mesh_states = {"c1": (ag["state"], ag["n_used"]),
                   "pps": (gp_["state"], gp_["n_used"])}
    return launches, timings, mesh_states


# -- phase 24: the map's CUDA graphs (models/pose_graph.py) ------------------

GRAPH_PROFILE_POSES = 16   # graphed poses under torch.profiler
GRAPH_TIMING_REPLAYS = 3   # hotel-0 replays timed, graphed and eager
EXAMPLE_TIMEOUT_S = 300
# the example scripts at tests/test_examples_smoke.py's sizes
EXAMPLES = (("gp_regression", []),
            ("occupancy_mapping_2d", ["--hinged-grid-size", "15",
                                      "--test-grid-size", "32",
                                      "--n-poses", "6"]),
            ("replica_hotel_3d", ["8"]),
            ("deploy_serving", []))
STATE_KEYS = ("qm", "alpha", "qm_c", "alpha_c")


def eager_chain(m, sensors, pts, masks, c=1):
    """(state, samples used) of the eager functional chain
    (``update_batch_steps``, every kernel launched by its wrapper) from the
    fresh map ``m``'s state, as the class feeds it (masked points zeroed,
    the pose axis padded with all-masked poses to a multiple of c)."""
    from erl_gaussian_process_tpu_torch.models.spgp_occupancy_map import (
        update_batch_steps,
    )

    b = len(sensors)
    pad = -b % c
    p = np.where(masks[..., None], pts, 0).astype(np.float32)
    sp, mk = sensors, masks
    if pad:
        sp = np.concatenate([sp, np.zeros((pad,) + sp.shape[1:], sp.dtype)])
        p = np.concatenate([p, np.zeros((pad,) + p.shape[1:], p.dtype)])
        mk = np.concatenate([mk, np.zeros((pad,) + mk.shape[1:], bool)])
    st, used = update_batch_steps(
        m.state, m.seed, 1, m._tensor(sp), m._tensor(p),
        torch.as_tensor(mk, device=m.device), m._aabb_min, m._aabb_max,
        m.sp_gp._scale, generator=torch.Generator(device=m.device),
        poses_per_step=c, **m._step_kw())
    return st, used[:b]


def same_state(a, b) -> bool:
    return all(torch.equal(getattr(a, k), getattr(b, k)) for k in STATE_KEYS)


def eager_predict(m, xq, with_grad):
    """The map's predict without its graph: the eager
    ``predict_prepared_step`` on the same cached prepare."""
    from erl_gaussian_process_tpu_torch.models.spgp_occupancy_map import (
        predict_prepared_step,
    )

    mean, grad = predict_prepared_step(
        m.state, *m.sp_gp._prepared(), m._tensor(xq), m.sp_gp._scale,
        kernel=m.sp_gp._kernel, with_grad=with_grad,
        zero_threshold=m.sp_gp._zero_threshold)
    return mean[:, 0], None if grad is None else grad[:, :, 0]


def api_calls(fn) -> tuple:
    """({CUDA runtime/driver API call: count}, {kernel: (count, device
    ms)}, the device's busy ms) of one ``fn()`` by ``torch.profiler`` (host
    and device; busy: the time in which at least one kernel ran, kernels
    that overlap on two streams counted once). A trace with no device event
    is taken again, up to PROFILE_ATTEMPTS times, as in
    :func:`device_kernels` (a sensor GP's eager train and graphed test came
    back without one once each in a whole-script card run)."""
    from torch.profiler import ProfilerActivity, profile

    from erl_gaussian_process_tpu_torch.profiling import busy_ms

    for attempt in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        if any(e.device_type == torch.autograd.DeviceType.CUDA
               for e in events):
            break
        log(f"torch.profiler returned no device event (attempt "
            f"{attempt + 1} of {PROFILE_ATTEMPTS})")
    host = {e.key: e.count for e in events
            if e.device_type == torch.autograd.DeviceType.CPU
            and e.key.startswith("cu")
            and e.key not in ("cudaDeviceSynchronize",
                              "cudaStreamSynchronize")}
    dev = {e.key: (e.count, e.self_device_time_total / 1e3) for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA}
    busy = busy_ms([(e.time_range.start, e.time_range.end)
                    for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA])
    return host, dev, busy


def run_examples() -> dict:
    """The four example scripts on the card at their smoke sizes, started
    together, each a process of its own; any non-zero exit fails."""
    procs = {}
    for name, argv in EXAMPLES:
        procs[name] = subprocess.Popen(
            [sys.executable, "-m",
             f"erl_gaussian_process_tpu_torch.examples.{name}", *argv],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    t0 = time.perf_counter()
    try:
        for name, proc in procs.items():
            left = max(1.0, EXAMPLE_TIMEOUT_S - (time.perf_counter() - t0))
            stdout, stderr = proc.communicate(timeout=left)
            out[name] = {"rc": proc.returncode,
                         "s": time.perf_counter() - t0,
                         "last": stdout.strip().splitlines()[-1:]}
            log(f"example {name} on the card: exit {proc.returncode}; "
                + " | ".join(stdout.strip().splitlines()))
            check(proc.returncode == 0,
                  f"example {name} failed:\n{stderr[-3000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def run_graphs(dev, card, hotel0, slice_ref, pps_ref, ref_ms, mesh_states):
    """Phase 24: the map's CUDA graphs against the eager functional chain,
    bit for bit (hotel-0 through ``update`` (``slice_ref``, phase 4) and
    ``update_batch``, at ``poses_per_step`` = PPS (``pps_ref``, phase 19),
    the 2D map), the graphed predicts against the eager ones, a graphed
    pose with the sync debug mode at "error", the profiler's counts, times
    and capture costs, the examples on the card. ``ref_ms``: phase 4's
    and 19's ms/pose, for the log. ``mesh_states``: phase 23's graphed
    NCCL replays at c = 1 and PPS ((state, samples used) each), held bit
    for bit to this phase's one-card graphed replays. Returns the
    timings."""
    from erl_gaussian_process_tpu_torch.geometry import Aabb
    from erl_gaussian_process_tpu_torch.geometry.simulators import (
        reference_space_2d,
    )
    from erl_gaussian_process_tpu_torch.models import SpGpOccupancyMap
    from erl_gaussian_process_tpu_torch.ops import (
        cross_gram_cuda,
        fitc_update_cuda,
        launch_counts,
        reset_launch_counts,
    )
    from erl_gaussian_process_tpu_torch.workloads import FREE_SLOTS_PER_RAY

    h = hotel0
    sensors, pts, masks = h["sensors"], h["pts"], h["masks"]
    b = len(sensors)
    box = Aabb.from_min_max(h["lo"], h["hi"])

    def new_map():
        return SpGpOccupancyMap(h["setting"], h["pseudo"], box, seed=0,
                                dtype=torch.float32,
                                free_slots_per_ray=FREE_SLOTS_PER_RAY,
                                device=dev)

    # hotel-0 at c = 1: the eager chain against phase 4's graphed `update`
    # replay and a graphed `update_batch` (the counted run of this phase)
    st1, used1 = eager_chain(new_map(), sensors, pts, masks)
    reset_launch_counts()
    mb = new_map()
    used_b = mb.update_batch(sensors, pts, masks)
    torch.cuda.synchronize()
    counts = launch_counts()
    replayed, warm_ups = graph_launches((mb,), fitc_update_cuda)
    same_update = same_state(st1, slice_ref["state"]) and bool(
        torch.equal(used1, slice_ref["n_used"]))
    same_batch = same_state(st1, mb.state) and bool(torch.equal(used1,
                                                                used_b))
    log(f"graphs vs the eager chain, hotel-0 {b} poses: update (phase 4) "
        f"bit for bit {same_update}, update_batch bit for bit {same_batch} "
        f"(launches {counts}; FITC {replayed} by {len(mb._graphs.captures)} "
        f"graph(s), {warm_ups} by the warm-up)")
    check(same_update, "graphed update differs from the eager chain")
    check(same_batch, "graphed update_batch differs from the eager chain")
    mesh_st, mesh_used = mesh_states["c1"]
    same_mesh = same_bits(mesh_st, {k: getattr(mb.state, k)
                                    for k in STATE_KEYS}) and \
        same_bits(mesh_used, used_b)
    log("phase 23's graphed NCCL replay (D = 1) against this one-card "
        f"graphed update_batch: bit for bit {same_mesh}")
    check(same_mesh, "the graphed NCCL mesh replay differs from the "
          "one-card graphed replay")
    check(replayed == b and counts["fitc"] == replayed + warm_ups,
          f"graphed update_batch launches {counts}")

    # poses_per_step = PPS: the eager chain against phase 19's graphed replay
    st4, used4 = eager_chain(new_map(), sensors, pts, masks, PPS)
    m4 = new_map()
    used_4 = m4.update_batch(sensors, pts, masks, poses_per_step=PPS)
    same4 = all(same_state(st4, st) and bool(torch.equal(used4, n))
                for st, n in ((pps_ref["state"], pps_ref["n_used"]),
                              (m4.state, used_4)))
    mesh_st, mesh_used = mesh_states["pps"]
    same4_mesh = same_bits(mesh_st, {k: getattr(m4.state, k)
                                     for k in STATE_KEYS}) and \
        same_bits(mesh_used, used_4)
    log(f"graphs vs the eager chain, hotel-0 at poses_per_step={PPS} "
        f"(phase 19's replay and a fresh one): bit for bit {same4}; phase "
        f"23's graphed NCCL replay at poses_per_step={PPS} against the fresh "
        f"one: bit for bit {same4_mesh}")
    check(same4, f"graphed poses_per_step={PPS} differs from the eager chain")
    check(same4_mesh, f"the graphed NCCL mesh replay at poses_per_step={PPS} "
          "differs from the one-card graphed replay")

    # the predicts, graphed against eager on the same prepare
    sel, traj = h["sel"], h["traj"]
    for grad in (False, True):
        got, ref = mb.predict(sel, grad), eager_predict(mb, sel, grad)
        ok = all((x is None and y is None) or bool(torch.equal(x, y))
                 for x, y in zip(got, ref))
        log(f"graphed predict of {len(sel)} hotel-0 points, gradient {grad}:"
            f" bit for bit the eager predict {ok}")
        check(ok, f"graphed predict (gradient {grad}) differs from eager")
    surf = float((mb.predict(sel)[0] > 0).float().mean())
    free = float((mb.predict(traj)[0] < 0).float().mean())
    check(surf > 0.9 and free > 0.95,
          f"graphed update_batch quality: surface {surf}, trajectory {free}")

    # the 2D map's 50 poses and its gradient predict
    s2, p2, m2k = map2d_scans(MAP2D_POSES)
    box2 = Aabb.from_min_max([-3.0, -3.0], [3.0, 3.0])

    def new_map2d():
        return SpGpOccupancyMap(map2d_setting(), map2d_pseudo(), box2,
                                seed=0, dtype=torch.float32,
                                free_slots_per_ray=MAP2D_FREE_SLOTS,
                                device=dev)

    st2, used2 = eager_chain(new_map2d(), s2, p2, m2k)
    m2 = new_map2d()
    used_2 = torch.stack([m2.update(s2[i], p2[i], m2k[i])
                          for i in range(MAP2D_POSES)])
    same2 = same_state(st2, m2.state) and bool(torch.equal(used2, used_2))
    surf2d = reference_space_2d().surface_points(0.05).astype(np.float32)
    pred2 = all(
        (x is None and y is None) or bool(torch.equal(x, y))
        for grad in (False, True)
        for x, y in zip(m2.predict(surf2d, grad),
                        eager_predict(m2, surf2d, grad)))
    log(f"graphs vs the eager chain, 2D map {MAP2D_POSES} poses: bit for "
        f"bit {same2}; predict of {len(surf2d)} points with and without "
        f"the gradient bit for bit {pred2}")
    check(same2 and pred2, "graphed 2D map differs from the eager chain")

    # one graphed pose may not synchronise with the card
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        mb.update(sensors[0], pts[0], masks[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("one graphed pose under torch.cuda.set_sync_debug_mode('error'): no "
        "synchronising call")

    # the profiler over GRAPH_PROFILE_POSES poses, graphed and eager
    k = GRAPH_PROFILE_POSES
    pm = new_map()
    pm.update(sensors[0], pts[0], masks[0])          # the capture
    host_g, dev_g, _ = api_calls(lambda: [pm.update(sensors[i], pts[i],
                                                 masks[i])
                                       for i in range(1, 1 + k)])
    em = new_map()
    host_e, dev_e, _ = api_calls(lambda: eager_chain(
        em, sensors[1:1 + k], pts[1:1 + k], masks[1:1 + k]))
    fitc_g = sum(c for name, (c, _) in dev_g.items()
                 if any(f in name for f in FITC_KERNELS))
    dev_ms = sum(ms for _, ms in dev_g.values()) / k
    log(f"{k} graphed poses by torch.profiler: FITC kernels {fitc_g} "
        f"({fitc_g / k:g} a pose), {sum(c for c, _ in dev_g.values()) / k:g}"
        f" kernels a pose, device {dev_ms:.4f} ms a pose; host CUDA API "
        f"calls a pose {sum(host_g.values()) / k:g} ({host_g}) against the "
        f"eager chain's {sum(host_e.values()) / k:g} "
        f"({sum(c for c, _ in dev_e.values()) / k:g} kernels a pose)")
    check(fitc_g == 3 * k, f"graphed poses ran {fitc_g} FITC kernels, not "
          f"{3 * k}")
    check(host_g.get("cudaGraphLaunch", 0) == k,
          f"{k} graphed poses made {host_g.get('cudaGraphLaunch', 0)} graph "
          "launches")

    # ms/pose: graphed after the capture, and the eager chain, alternated
    graphed_ms, eager_ms = [], []
    for _ in range(GRAPH_TIMING_REPLAYS):
        m = new_map()
        m.update(sensors[0], pts[0], masks[0])
        _, ms = timed(lambda: [m.update(sensors[i], pts[i], masks[i])
                               for i in range(1, b)])
        graphed_ms.append(ms / (b - 1))
        em = new_map()
        _, ms = timed(lambda: eager_chain(em, sensors, pts, masks))
        eager_ms.append(ms / b)
    idle = 1.0 - dev_ms / statistics.median(graphed_ms)
    predict_g = [timed(lambda: mb.predict(sel))[1] for _ in range(TIMED_RUNS)]
    predict_e = [timed(lambda: eager_predict(mb, sel, False))[1]
                 for _ in range(TIMED_RUNS)]
    timings = {
        "graphed_ms_per_pose": statistics.median(graphed_ms),
        "graphed_ms_per_pose_range": [min(graphed_ms), max(graphed_ms)],
        "eager_chain_ms_per_pose": statistics.median(eager_ms),
        "eager_chain_ms_per_pose_range": [min(eager_ms), max(eager_ms)],
        "device_ms_per_pose": dev_ms, "device_idle_share": idle,
        "host_api_calls_per_pose": sum(host_g.values()) / k,
        "host_api_submissions_per_pose": sum(
            n for name, n in host_g.items()
            if name != "cudaStreamIsCapturing") / k,
        "eager_host_api_calls_per_pose": sum(host_e.values()) / k,
        "predict_graphed_ms": statistics.median(predict_g),
        "predict_eager_ms": statistics.median(predict_e)}
    log(f"hotel-0 on {card}: graphed {timings['graphed_ms_per_pose']:.4f} "
        f"ms/pose after the capture (median of {GRAPH_TIMING_REPLAYS}, "
        f"range {min(graphed_ms):.4f}-{max(graphed_ms):.4f}; phase 4, "
        f"capture included: {ref_ms['update']:.4f}; phase 19 at c = {PPS}:"
        f" {ref_ms['pps']:.4f}), the eager chain "
        f"{timings['eager_chain_ms_per_pose']:.4f} (range "
        f"{min(eager_ms):.4f}-{max(eager_ms):.4f}); device idle "
        f"{100 * idle:.1f}%; cached predict of {len(sel)} points graphed "
        f"{timings['predict_graphed_ms']:.4f} ms, eager "
        f"{timings['predict_eager_ms']:.4f} ms (medians of {TIMED_RUNS})")
    captures = capture_records((mb, m4, m2))
    for c in captures:
        log(f"graph {c['key']}: warm-up {c['warmup_ms']:.2f} ms, capture "
            f"{c['capture_ms']:.2f} ms, pool {c['pool_mb']:.1f} MiB, "
            f"launches a replay {c['launches']}, replays {c['replays']}")
    timings["captures"] = captures
    check(cross_gram_cuda.launches > 0, "no gram launch in phase 24")
    timings["examples"] = run_examples()
    return timings


def rel_err(got, ref, scale=None) -> float:
    """max |got - ref| over max |scale| (default: over max |ref|), with
    ``got`` moved to ``ref``'s device."""
    scale = ref if scale is None else scale
    return float((got.to(ref.device) - ref).abs().max() / scale.abs().max())


def run_api_gaps(dev, card, hotel0) -> dict:
    """Phase 25: the names and keywords the port took over from the JAX
    package last, each called on the card (see the module docstring).
    Returns the phase's errors and its wall seconds."""
    from erl_gaussian_process_tpu_torch.geometry import Aabb
    from erl_gaussian_process_tpu_torch.geometry.simulators import (
        TriangleMesh,
        replica_hotel_like_mesh,
    )
    from erl_gaussian_process_tpu_torch.kernels import (
        is_mixture_setting,
        kernel_names,
        pairwise_dist,
        register_scale_mixture,
    )
    from erl_gaussian_process_tpu_torch.models import (
        SparsePseudoInputGaussianProcess,
        nigp_fit,
        spgp_init,
        spgp_update,
        vanilla_fit,
    )
    from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
        fitc_delta,
        pad_pseudo_points,
    )
    from erl_gaussian_process_tpu_torch.ops import launch_counts

    t0 = time.perf_counter()
    h = hotel0
    setting, kernel = h["setting"], "matern32"
    scale = float(setting.sp_gp.kernel.scale)
    errs = {}

    def launched(name, fn):
        """fn() and the launches of kernel ``name`` it made."""
        before = launch_counts()[name]
        out = fn()
        torch.cuda.synchronize()
        return out, launch_counts()[name] - before

    # kernels.pairwise_dist: the pseudo points against 2000 hit points
    for dt in (torch.float32, torch.float64):
        p = torch.as_tensor(np.ascontiguousarray(h["pseudo"].T), dtype=dt)
        q = torch.as_tensor(h["sel"], dtype=dt)
        ref = pairwise_dist(p, q)
        got = pairwise_dist(p.to(dev), q.to(dev))
        err = float((got.cpu() - ref).abs().max())
        tol = 8 * torch.finfo(dt).eps * float(ref.max())
        errs[f"pairwise_dist_{str(dt)[6:]}"] = err
        check(got.shape == (p.shape[0], q.shape[0]) and err <= tol,
              f"pairwise_dist {dt} on the card: max err {err} > {tol}")

    # models.spgp_init / spgp_update at hotel-0's width (M = 1152, N = 2048,
    # pose 0's hits and random free points, var 0.1: FITC_VAR), one FITC
    # launch, against the plain FITC (the same call on CPU tensors); the
    # error is over the increment max |Q_M - Q_M0|
    dt = torch.float32
    rng = np.random.default_rng(25)
    p_pad = pad_pseudo_points(np.ascontiguousarray(h["pseudo"].T))
    n = 2048
    x = rng.uniform(h["lo"], h["hi"], (n, 3))
    hit = h["pts"][0][h["masks"][0]]
    x[:len(hit)] = hit
    y = np.where(np.arange(n) < len(hit), 1.0, -1.0)[:, None]
    host = [torch.as_tensor(a, dtype=dt) for a in (x, y, np.full(n, 0.1))]
    host.append(torch.ones(n, dtype=torch.bool))
    st0 = spgp_init(torch.as_tensor(p_pad, dtype=dt), scale, kernel=kernel)
    ref = spgp_update(st0, *host, scale, kernel=kernel)
    on = [a.to(dev) for a in host]
    st0_dev = spgp_init(torch.as_tensor(p_pad, dtype=dt, device=dev), scale,
                        kernel=kernel)
    st, fitc_n = launched("fitc", lambda: spgp_update(
        st0_dev, *on, scale, kernel=kernel))
    errs["spgp_update_qm"] = rel_err(st.qm, ref.qm, ref.qm - st0.qm)
    errs["spgp_update_alpha"] = rel_err(st.alpha, ref.alpha)
    check(fitc_n == 1, f"spgp_update: {fitc_n} FITC launches, not 1")
    check(max(errs["spgp_update_qm"], errs["spgp_update_alpha"])
          <= FITC_TOL[dt], f"spgp_update on the card against plain: {errs}")

    # fitc_delta(reduce=): each product wrapped, bit for bit 3 x the call
    # without on the same inputs
    args = (st0_dev.pseudo, st0_dev.L_km, *on, scale)
    tripled = fitc_delta(*args, kernel=kernel, L_inv=st0_dev.L_inv,
                         reduce=lambda t: 3 * t)
    once = fitc_delta(*args, kernel=kernel, L_inv=st0_dev.L_inv)
    check(all(bits(a, 3 * b) for a, b in zip(tripled, once)),
          "fitc_delta(reduce=) is not the products wrapped")

    # the SPGP's update and getters with parallel=True, bit for bit the
    # calls without (float32, the hotel-0 pseudo points and setting)
    gps = [SparsePseudoInputGaussianProcess(setting.sp_gp, h["pseudo"],
                                            dtype=np.float32, device=dev)
           for _ in range(2)]
    xt, yt = x[:1024].T.astype(np.float32), y[:1024, 0].astype(np.float32)
    check(gps[0].update(xt, yt, 0.1, parallel=True)
          and gps[1].update(xt, yt, 0.1), "SPGP update returned False")
    check(bits(tuple(gps[0].state), tuple(gps[1].state)),
          "SPGP update(parallel=True) differs from update()")
    res = gps[0].test(h["sel"].T, True)
    check(bits(res.get_mean(0, parallel=True), res.get_mean(0))
          and bits(res.get_gradient(0, parallel=True), res.get_gradient(0))
          and bits(res.get_variance(parallel=True), res.get_variance()),
          "an SPGP getter with parallel=True differs from the call without")

    # models.vanilla_fit / nigp_fit at float64: one gram-fused and one
    # joint Cholesky launch each, against their CPU fits (plain)
    dt = torch.float64
    xv = torch.as_tensor(rng.uniform(-3, 3, (1024, 2)), dtype=dt)
    yv = torch.sin(xv[:, :1]) * torch.cos(xv[:, 1:])
    var, mask = torch.full((1024,), 0.1, dtype=dt), torch.arange(1024) < 1000
    fit_args = (xv, yv, var, mask)
    ref = vanilla_fit(*fit_args, 0.3, kernel="rbf")
    got, chol_n = launched("chol_gram", lambda: vanilla_fit(
        *(a.to(dev) for a in fit_args), 0.3, kernel="rbf"))
    errs["vanilla_fit_L"] = rel_err(got.L, ref.L)
    errs["vanilla_fit_alpha"] = rel_err(got.alpha, ref.alpha)
    xn = xv[:256]
    gn = torch.stack([torch.cos(xn[:, 0]) * torch.cos(xn[:, 1]),
                      -torch.sin(xn[:, 0]) * torch.sin(xn[:, 1])], -1)
    nigp_args = (xn, yv[:256], gn[..., None], torch.full((256,), 1e-2,
                 dtype=dt), torch.full((256,), 1e-2, dtype=dt),
                 torch.full((256,), 1e-1, dtype=dt), mask[:256],
                 torch.arange(256) % 3 > 0)
    ref = nigp_fit(*nigp_args, 0.5, kernel="rbf")
    got, joint_n = launched("chol_gram_joint", lambda: nigp_fit(
        *(a.to(dev) for a in nigp_args), 0.5, kernel="rbf"))
    errs["nigp_fit_L"] = rel_err(got.L, ref.L)
    errs["nigp_fit_alpha"] = rel_err(got.alpha, ref.alpha)
    check(chol_n == 1 and joint_n == 1,
          f"vanilla_fit / nigp_fit: {chol_n} / {joint_n} Cholesky launches")
    check(max(errs[k] for k in errs if "_fit_" in k) <= 1e-10,
          f"vanilla_fit / nigp_fit on the card against their CPU fits: "
          f"{errs}")

    # a graphed hotel-0 map after 8 poses: predict(..., parallel=True) and
    # predict_gradient(parallel=True) replay the graphs of the calls
    # without, bit for bit
    m = mesh_map(dev, h)
    m.update_batch(h["sensors"][:8], h["pts"][:8], h["masks"][:8])
    sel = h["sel"]
    for grad in (False, True):
        check(bits(m.predict(sel, grad, True), m.predict(sel, grad)),
              f"graphed predict(parallel=True), gradient {grad}, differs")
    check(bits(m.predict_gradient(sel, parallel=True),
               m.predict_gradient(sel)),
          "graphed predict_gradient(parallel=True) differs")
    check(len(m._graphs._predicts) == 2,
          "parallel= captured a predict graph of its own")

    # the host's names: Aabb.contains, TriangleMesh.box(inward=),
    # surface_points, is_mixture_setting, kernel_names
    box = Aabb.from_min_max(h["lo"], h["hi"])
    mesh = replica_hotel_like_mesh(h["lo"], h["hi"])
    surf = mesh.surface_points(4, rng=0)
    hull = Aabb.from_min_max(mesh.vertices.min(0) - 1e-9,
                             mesh.vertices.max(0) + 1e-9)
    shell = TriangleMesh.box(h["lo"], h["hi"], inward=True)
    plain_shell = TriangleMesh.box(h["lo"], h["hi"])
    mixture = register_scale_mixture(*MIXTURE)
    check(box.contains(np.stack([h["lo"], h["hi"]])).all()
          and not box.contains(np.asarray(h["hi"])[None] + 1.0).any()
          and surf.shape == (4 * mesh.num_triangles, 3)
          and hull.contains(surf).all()
          and bits(shell.triangles, plain_shell.triangles)
          and not is_mixture_setting(setting.sp_gp.kernel)
          and {kernel, mixture} <= set(kernel_names()),
          "a host name of the JAX package's surface misbehaved")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    log(f"phase 25 (the surface taken over last) on {card}: "
        f"{seconds:.2f} s; launches spgp_update FITC {fitc_n}, vanilla_fit "
        f"gram-fused Cholesky {chol_n}, nigp_fit joint Cholesky {joint_n}; "
        f"errors {errs}; every parallel= call bit for bit the call without")
    return {"seconds": seconds, "errors": errs}


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from erl_gaussian_process_tpu_torch.utils.backend import require_backend

    t0 = time.perf_counter()
    try:
        platform = require_backend()
    except RuntimeError as e:
        print(f"chip_smoke: {e}; this script runs only on an NVIDIA GPU",
              file=sys.stderr, flush=True)
        os._exit(2)   # a probe that timed out leaves its thread in CUDA
    t_probe = time.perf_counter() - t0
    from erl_gaussian_process_tpu_torch.models.gp_core import (
        use_full_fp32_matmul,
    )
    from erl_gaussian_process_tpu_torch.ops._build import load_library
    from erl_gaussian_process_tpu_torch.workloads import hotel0_workload

    t_script = time.perf_counter()
    use_full_fp32_matmul()
    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    log(f"require_backend: {platform!r} in {t_probe:.3f} s")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    kl = load_library()
    log(f"build: {kl.path} compiled in {kl.seconds:.2f} s "
        f"(load {time.perf_counter() - t0:.2f} s)")
    for line in kl.log.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

    from erl_gaussian_process_tpu_torch.utils import native as host_native

    t0 = time.perf_counter()
    check(host_native.native_available(),
          "the native host runtime did not build")
    t_host_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    sensors, pts, masks, hits, traj, setting, pseudo, lo, hi = \
        hotel0_workload()
    t_scan = time.perf_counter() - t0
    log(f"workload: {len(sensors)} poses, {pts.shape[1]} rays, "
        f"{pseudo.shape[1]} pseudo points, scanned in {t_scan:.2f} s")
    from erl_gaussian_process_tpu_torch.kernels import register_scale_mixture
    from erl_gaussian_process_tpu_torch.workloads import (
        depth3d_reference_workload,
        lidar3d_reference_workload,
    )
    lidar = lidar3d_reference_workload()
    cases = gram_cases(dev, setting, pseudo, lo, hi, lidar)
    gram_err = check_gram(dev, cases, register_scale_mixture(*MIXTURE))
    gram_times = time_gram(dev, card, cases)
    log(json.dumps({"gram_timings": gram_times, "card": card}))
    del cases

    kern = check_kernels(dev, setting, pseudo, lo, hi, sensors, pts, masks)
    for key, r in gram_times.items():
        kern[key] = {"max_abs_err": gram_err[key], "library_ms": None,
                     **{k: r[k] for k in ("ms", "plain_ms", "bound_ms")},
                     "bound_by": ("bytes" if r["bound_by"] == "bytes"
                                  else "operations")}
    for name, r in kern.items():
        log(f"time on {card}: {name} kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms (median of {REPS})")

    counts, timings, drift, slice_ref = run_slice(
        dev, card, setting, pseudo, lo, hi, sensors, pts, masks, hits, traj)
    log(json.dumps({"timings": timings, "drift": drift["drift"],
                    "sign_agreement": drift["sign_agreement"],
                    "card": card}))
    native = run_native(t_host_build, t_scan)
    pps_fitc, kern["fitc_8192"], pps_timings, pps_map, pps_new_map, \
        pps_ref = run_poses_per_step(dev, card, setting, pseudo, lo, hi,
                                     sensors, pts, masks, hits, traj)
    check_egpt(pps_map, pps_new_map)
    del pps_map
    log(json.dumps({"native": native, "poses_per_step": pps_timings,
                    "card": card}))

    depth = depth3d_reference_workload()
    bank = check_bank_kernels(dev, lidar, depth)
    sensor_counts, sensor_timings = run_sensor_gp(dev, card, lidar, depth)
    log(json.dumps({"sensor_timings": sensor_timings,
                    "sensor_launch_counts": sensor_counts, "card": card}))
    kern.update(bank)
    for name, r in bank.items():
        log(f"time on {card}: {name} kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms (median of {REPS})")

    kern.update(check_chol_kernels(dev, card))
    kern.update(check_whiten_kernel(dev, card))
    exact_counts, exact_timings, exact_err = run_exact_gp(dev, card)
    fit_profile = profile_exact_fit(dev, card)
    nigp_counts, nigp_timings, nigp_err = run_nigp(dev, card)
    golden_counts, golden_timings, golden = run_nigp_golden(dev, card)
    log(json.dumps({"exact_timings": {**exact_timings, **nigp_timings,
                                      **golden_timings},
                    "exact_fit_profile": fit_profile,
                    "exact_gp_errors": exact_err, "nigp_errors": nigp_err,
                    "nigp_golden": golden, "card": card}))

    frames, frames32 = lidar_logs()
    kern.update(check_map2d_kernels(dev, card))
    map2d_counts, map2d_timings = run_map_2d(dev, card)
    kern.update(check_lidar2d_kernels(dev, card, frames))
    lidar2d_counts, lidar2d_timings = run_lidar_2d(dev, card, frames,
                                                   frames32)
    rr_counts, rr_kern = run_reduced_rank(dev, card)
    kern.update(rr_kern)
    deploy_counts, deploy_timings = run_deploy(dev, card)
    sweep_grams, kern["gram_sweep"], select_timings = run_model_selection(
        dev, card)
    dispatch = run_dispatch(dev, card, gram_times, kern,
                            (setting, pseudo, lo, hi, sensors, pts, masks))
    log(json.dumps({"deploy_timings": deploy_timings,
                    "deploy_launch_counts": deploy_counts,
                    "model_selection": select_timings,
                    "op_dispatch": dispatch, "card": card}))
    log(json.dumps({"map2d_timings": map2d_timings,
                    "lidar2d_timings": lidar2d_timings,
                    "lidar2d_launch_counts": lidar2d_counts,
                    "reduced_rank_launch_counts": rr_counts, "card": card}))

    from erl_gaussian_process_tpu_torch.workloads import hotel0_query_grid

    rng = np.random.default_rng(0)
    hotel0 = {"setting": setting, "pseudo": pseudo, "lo": lo, "hi": hi,
              "sensors": sensors, "pts": pts, "masks": masks,
              "grid": hotel0_query_grid(lo, hi), "traj": traj,
              "sel": hits[rng.choice(len(hits), min(2000, len(hits)),
                                     replace=False)].astype(np.float32)}
    kern.update(mesh_kernel_rows(dev, card, hotel0, lidar))
    mesh_launches, mesh_timings, mesh_states = run_mesh(
        dev, card, hotel0, slice_ref, pps_ref, lidar, frames[0],
        {"update": timings["update_ms_per_pose"],
         "pps": pps_timings["pps_ms_per_pose"]})
    log(json.dumps({"mesh_timings": mesh_timings, "card": card}))
    graph_timings = run_graphs(
        dev, card, hotel0, slice_ref, pps_ref,
        {"update": timings["update_ms_per_pose"],
         "pps": pps_timings["pps_ms_per_pose"]}, mesh_states)
    log(json.dumps({"graph_timings": graph_timings, "card": card}))
    api_gaps = run_api_gaps(dev, card, hotel0)
    log(json.dumps({"api_gaps": api_gaps, "card": card}))

    # FITC's bound at its timed shape, M=1152, N=2048, d=3 (fitc_bound();
    # the bank kernels' are computed in check_bank_kernels, the gram's in
    # time_gram)
    kern["fitc"]["bound_ms"], kern["fitc"]["bound_by"] = fitc_bound(1152,
                                                                   2048, 3)
    kern["fitc"]["library_ms"] = None
    log(f"fitc: kernel {kern['fitc']['ms']:.4f} ms, bound "
        f"{kern['fitc']['bound_ms']:.4f} ms ({kern['fitc']['bound_by']}: "
        f"beta at the FP64 tensor-core rate, the SYRK at 3xTF32), on {card}")

    # launches of each kernel in the paths' runs: gram.cuh serves the SPGP
    # predict (gram), the exact GP's test (gram_exact) and the sensor GPs'
    # routed predict (gram_batched); trsv runs in every exact fit's solve
    exact_all = [exact_counts, golden_counts, *nigp_counts.values()]
    launches = {
        "fitc": counts["fitc"],
        "gram": counts["gram"],
        "gram_exact": exact_counts["gram"],
        "gram_batched": sum(c["gram_batched"]
                            for c in sensor_counts.values()),
        "bank_fit": sum(c["bank_fit"] for k, c in sensor_counts.items()
                        if k != "lidar_default_grouping"),
        "bank_fit_408x144":
            sensor_counts["lidar_default_grouping"]["bank_fit"],
        "bank_chol": sensor_counts["batch_gp_bank"]["bank_chol"],
    }
    for name in ("chol", "chol_gram", "chol_gram_joint", "trsv", "trsm"):
        launches[name] = sum(c[name] for c in exact_all)
    # the 2D paths' shapes: the 2D map (FITC and the predict's gram), the
    # 2D lidar GP's trains and tests, the reduced-rank fits
    lidar_runs = [c for k, c in lidar2d_counts.items() if k != "replay"]
    rr_fits = [rr_counts["float64"], rr_counts["float32"]]
    launches.update({
        "fitc_2d": map2d_counts["fitc"], "gram_2d": map2d_counts["gram"],
        "bank_fit_2d": sum(c["bank_fit"] for c in lidar_runs),
        "gram_batched_d1": sum(c["gram_batched"] for c in lidar_runs),
        "chol_rr": sum(c["chol"] for c in rr_fits),
        "trsv_rr": sum(c["trsv"] for c in rr_fits),
        # hotel-0 at poses_per_step = PPS (N = PPS x 2048),
        # the SPGP scale sweep's K_MN
        "fitc_8192": pps_fitc, "gram_sweep": sweep_grams})
    # the mesh (phase 23): its rows, and the NCCL rank's graphed runs added
    # to the rows of their shapes
    for name, n in mesh_launches.items():
        launches[name] = launches.get(name, 0) + n
    check(all(v > 0 for v in launches.values()),
          f"a kernel was not launched by its path: {launches}")
    chol_src = "erl_gaussian_process_tpu_torch/csrc/chol.cu"
    gram_src = ("erl_gaussian_process_tpu_torch/csrc/gram.cuh",
                "erl_gaussian_process_tpu/ops/pallas_gram.py:92")
    src = {"gram": gram_src, "gram_exact": gram_src, "gram_batched": gram_src,
           "fitc": ("erl_gaussian_process_tpu_torch/csrc/fitc.cu",
                    "erl_gaussian_process_tpu/ops/pallas_fitc.py:145"),
           "bank_fit": ("erl_gaussian_process_tpu_torch/csrc/bank.cu",
                        "erl_gaussian_process_tpu/ops/pallas_bank.py:249"),
           "bank_fit_408x144": (
               "erl_gaussian_process_tpu_torch/csrc/bank.cu",
               "erl_gaussian_process_tpu/ops/pallas_bank.py:249"),
           "bank_chol": ("erl_gaussian_process_tpu_torch/csrc/bank.cu",
                         "erl_gaussian_process_tpu/ops/pallas_bank.py:269"),
           "chol": (chol_src,
                    "erl_gaussian_process_tpu/ops/pallas_chol.py:454"),
           "chol_gram": (chol_src,
                         "erl_gaussian_process_tpu/ops/pallas_chol.py:571"),
           "chol_gram_joint": (
               chol_src, "erl_gaussian_process_tpu/ops/pallas_chol.py:502"),
           "trsv": ("erl_gaussian_process_tpu_torch/csrc/trsv.cu",
                    "erl_gaussian_process_tpu/ops/pallas_trsv.py:99"),
           "trsm": ("erl_gaussian_process_tpu_torch/csrc/trsm.cu",
                    "none (erl_gaussian_process_tpu/ops/blocked_solve.py "
                    "was XLA's)"),
           "fitc_2d": MAP2D_SRC, "gram_2d": gram_src,
           "bank_fit_2d": ("erl_gaussian_process_tpu_torch/csrc/bank.cu",
                           "erl_gaussian_process_tpu/ops/pallas_bank.py:249"),
           "gram_batched_d1": gram_src,
           "chol_rr": (chol_src,
                       "erl_gaussian_process_tpu/ops/pallas_chol.py:454"),
           "trsv_rr": ("erl_gaussian_process_tpu_torch/csrc/trsv.cu",
                       "erl_gaussian_process_tpu/ops/pallas_trsv.py:99"),
           "fitc_8192": ("erl_gaussian_process_tpu_torch/csrc/fitc.cu",
                         "erl_gaussian_process_tpu/ops/pallas_fitc.py:145"),
           "gram_sweep": gram_src,
           "fitc_mesh": ("erl_gaussian_process_tpu_torch/csrc/fitc.cu",
                         "erl_gaussian_process_tpu/ops/pallas_fitc.py:145"),
           "bank_fit_mesh": (
               "erl_gaussian_process_tpu_torch/csrc/bank.cu",
               "erl_gaussian_process_tpu/ops/pallas_bank.py:249"),
           "gram_mesh": gram_src}
    log(f"launch counts of the paths' runs: {launches}")
    log(f"chip_smoke: {time.perf_counter() - t_script:.1f} s from the start "
        f"of main to the result on {card}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src[name][0],
         "replaces": src[name][1], "launches": launches[name],
         **{k: kern[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")}}
        for name in src]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
