"""Where the time goes on the card: ``torch.profiler`` over the exact GP's
and the noisy-input GP's train and test at the workloads' full sizes
(``workloads.exact_gp_workload``, ``workloads.nigp_workload``, float32).

    python -m erl_gaussian_process_tpu_torch.profiling

For each phase it prints the host wall time per call, the device's busy
time per call (the time in which at least one kernel ran) and its idle
share, and the kernels by device time with their launch counts per call.
Needs a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch


def busy_ms(spans) -> float:
    """Milliseconds in which the device ran at least one of the
    ``(start_us, end_us)`` spans: kernels that overlap (the blocked
    Cholesky runs its update on a second stream) count once."""
    busy, end = 0.0, None
    for lo, hi in sorted(spans):
        if end is None or lo > end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    return busy / 1e3


def profile_phase(name: str, fn, reps: int = 3) -> None:
    """Print one phase's wall and device time per call and its top
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / reps
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    summed = sum(e.self_device_time_total for e in events) / reps / 1e3
    busy = busy_ms([(e.time_range.start, e.time_range.end)
                    for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA]) / reps
    print(f"== {name}: wall {wall:.3f} ms/call, device busy {busy:.3f} "
          f"ms/call, idle {100 * (1 - busy / wall):.1f}% (kernel time "
          f"summed over streams {summed:.3f} ms/call)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        ms = e.self_device_time_total / reps / 1e3
        print(f"   {e.key[:64]:64s} {ms:9.3f} ms  x{e.count // reps:<5d} "
              f"{1e3 * ms / max(1, e.count // reps):8.2f} us/launch")


def main() -> int:
    if not torch.cuda.is_available():
        print("profiling: needs a CUDA device", file=sys.stderr)
        return 2
    from erl_gaussian_process_tpu_torch.kernels import KernelSetting
    from erl_gaussian_process_tpu_torch.models import (
        NoisyInputGaussianProcess,
        NoisyInputGPSetting,
        VanillaGaussianProcess,
        VanillaGPSetting,
    )
    from erl_gaussian_process_tpu_torch.workloads import (
        exact_gp_workload,
        nigp_workload,
    )

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    x, y, var, xq, scale, kern = exact_gp_workload()
    gp = VanillaGaussianProcess(VanillaGPSetting(
        kernel_type=kern, kernel=KernelSetting(x_dim=2, scale=scale),
        max_num_samples=x.shape[0]), dtype=np.float32, device=dev)
    profile_phase(f"exact GP train (n={x.shape[0]})",
                  lambda: gp.train(x.T, y, var))

    def exact_test():
        res = gp.test(xq.T)
        return res.get_mean(), res.get_variance()
    profile_phase(f"exact GP test ({xq.shape[0]} queries, mean + variance)",
                  exact_test)

    x, y, g, vx, vy, vg, xq, scale, kern = nigp_workload()
    n, d = x.shape
    ngp = NoisyInputGaussianProcess(NoisyInputGPSetting(
        kernel_type=kern, kernel=KernelSetting(x_dim=d, scale=scale),
        max_num_samples=n), dtype=np.float32, device=dev)
    profile_phase(f"NIGP train ({(1 + d) * n}^2 joint)",
                  lambda: ngp.train(x.T, y, g[:, :, 0].T, vx, vy, vg))

    def nigp_test():
        res = ngp.test(xq.T, True)
        return (res.get_mean(), res.get_gradient(), res.get_mean_variance(),
                res.get_gradient_variance(), res.get_covariance())
    profile_phase(f"NIGP test ({xq.shape[0]} queries, all outputs)",
                  nigp_test)
    return 0


if __name__ == "__main__":
    sys.exit(main())
