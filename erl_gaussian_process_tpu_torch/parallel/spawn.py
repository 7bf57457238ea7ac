"""A world of ranks on one host: spawn ``size`` processes, each joins the
default process group and runs the same function (SPMD), and the caller
gets every rank's result back.

The ranks meet over a ``FileStore`` in ``out_dir`` (no port to pick, safe
under parallel test workers). Every wait is bounded: the process group's
``timeout_s`` ends a collective whose peer died, and the join gives the
world ``join_s`` in all before the ranks still alive are killed. A rank
that fails writes its traceback to ``out_dir/rank{r}.err``; the call then
raises with every traceback, so a failure never hangs the caller.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import time
import traceback

import torch
import torch.distributed as dist


def _rank_main(fn, rank, size, backend, store, timeout_s, out_dir, args):
    try:
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=size, timeout=datetime.timedelta(seconds=timeout_s))
        result = fn(rank, size, *args)
        dist.barrier()
        dist.destroy_process_group()
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_world(fn, size: int, out_dir: str, *, backend: str,
                timeout_s: float, join_s: float, args: tuple) -> tuple:
    """Spawn ``size`` ranks; rank r initialises ``backend`` (collectives
    bounded by ``timeout_s``) and returns ``fn(r, size, *args)``, which
    must be picklable, as ``fn`` (a module-level function) and ``args``
    are. Returns (each rank's result in rank order, seconds from the spawn
    to the last exit). Raises RuntimeError, with the failed ranks'
    tracebacks, unless every rank exited 0 within ``join_s``."""
    ctx = multiprocessing.get_context("spawn")
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "store")
    t0 = time.time()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, size, backend, store, timeout_s,
                               out_dir, args))
             for r in range(size)]
    alive = []
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(max(1.0, t0 + join_s - time.time()))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
    wall = time.time() - t0
    errs = []
    for r in range(size):
        path = os.path.join(out_dir, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                errs.append(f"rank {r}:\n{f.read()}")
    codes = [p.exitcode for p in procs]
    if alive or errs or any(c != 0 for c in codes):
        raise RuntimeError(
            f"{backend} world of {size}: exit codes {codes}, {len(alive)} "
            f"killed after {join_s} s\n" + "\n".join(errs))
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(size)], wall
