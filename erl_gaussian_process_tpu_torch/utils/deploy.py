"""Deployment artifacts with ``torch.export`` (counterpart of
``erl_gaussian_process_tpu/utils/deploy.py``, which uses ``jax.export``).

A serving host loads a bytes blob and runs the step: no Python tracing, and
a program that cannot drift under it. The artifact is the
``torch.export`` graph of the step, saved with ``torch.export.save``; the
hand-written kernels appear in it as the registered ops ``egp::fitc_update``
and ``egp::cross_gram`` (``ops/_library.py``), so the loaded program
launches the same kernel entries as the eager path (on CUDA tensors) or
their plain versions (on CPU tensors).

How the contract differs from the JAX module's:

- **Randomness.** ``torch.export`` takes no generator, so the update
  artifact takes the free-sample fractions ``u`` (n_rays, free_slots) in
  place of JAX's ``(key, step)``. ``geometry.free_sample_fractions``
  draws them as the map's own update does; from a generator seeded with
  ``step_seed(seed, step)`` they are the map's draws for that pose.
- **Baked scale.** The kernels take the family constants on the host, so
  the scale (and the family, mixtures included) is a constant of the
  artifact, not a serve-time input.
- **Example tensors, one device.** Artifacts are exported from example
  tensors (zeros of the bucket's shapes) on ``device``; constants the
  graph creates live there, so an artifact runs on the device it was
  exported on. JAX's multi-platform lowering has no counterpart.
- **Loading needs the package.** ``load_fn`` imports
  ``erl_gaussian_process_tpu_torch``, which registers the ``egp`` ops and
  the state NamedTuples the artifacts' inputs and outputs carry.

Shapes are frozen at export, except the query dimension of a predict
artifact exported with ``n_queries=None`` (a ``torch.export.Dim``).

A loaded artifact's call on CUDA inputs is one replay of a CUDA graph of
the module's call (:class:`LoadedStep`), as a loaded ``jax.export``
artifact is one compiled executable.
"""

from __future__ import annotations

import functools
import io
from typing import Callable

import torch

from erl_gaussian_process_tpu_torch.models.gp_core import (
    DEFAULT_DEVICE,
    resolve_device,
)

_REGISTERED = False


def register_serializations() -> None:
    """Register every model-state NamedTuple for the exported pytrees
    (idempotent): ``torch.export.save`` names them in the artifact and
    ``torch.export.load`` rebuilds them."""
    global _REGISTERED
    if _REGISTERED:
        return
    import torch.utils._pytree as pytree

    from erl_gaussian_process_tpu_torch.models.batch_gp import BankState
    from erl_gaussian_process_tpu_torch.models.noisy_input_gp import (
        NoisyInputGPState,
    )
    from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
        SpGpState,
    )
    from erl_gaussian_process_tpu_torch.models.vanilla_gp import (
        VanillaGPState,
    )

    classes = (BankState, NoisyInputGPState, SpGpState, VanillaGPState)
    for cls in classes:
        pytree._register_namedtuple(
            cls, serialized_type_name=(
                f"erl_gaussian_process_tpu_torch.{cls.__name__}"))
    torch.serialization.add_safe_globals(list(classes))
    _REGISTERED = True


def _is_state(a) -> bool:
    return isinstance(a, tuple) and hasattr(a, "_fields")


class _Step(torch.nn.Module):
    """``fn`` with its NamedTuple arguments taken as plain tuples: the
    artifact's input guards name each input by its path, and
    ``torch.export`` builds those from NamedTuple field names that prefix
    one another (``qm``, ``qm_c``) into code that does not parse. The
    NamedTuples are rebuilt here, inside the traced function."""

    def __init__(self, fn: Callable, types):
        super().__init__()
        self.fn = fn
        self.types = types

    def forward(self, *args):
        return self.fn(*[a if t is None else t(*a)
                         for a, t in zip(args, self.types)])


def _as_tuples(args) -> tuple:
    return tuple(tuple(a) if _is_state(a) else a for a in args)


def export_fn(fn: Callable, *example_args, dynamic_shapes=None) -> bytes:
    """The ``torch.export`` artifact of ``fn`` at the shapes of
    ``example_args`` (tensors, or NamedTuples of them): the bytes of
    ``torch.export.save``. ``dynamic_shapes`` as ``torch.export.export``
    takes it, one entry per argument (a tuple for a NamedTuple)."""
    register_serializations()
    types = [type(a) if _is_state(a) else None for a in example_args]
    ep = torch.export.export(
        _Step(fn, types), _as_tuples(example_args),
        dynamic_shapes=None if dynamic_shapes is None else {
            "args": tuple(dynamic_shapes)})
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def load_program(blob: bytes) -> torch.export.ExportedProgram:
    """The ``ExportedProgram`` of an artifact (its graph names the ops it
    runs)."""
    register_serializations()
    return torch.export.load(io.BytesIO(blob))


class LoadedStep:
    """A loaded artifact as a callable with the exported function's
    signature (NamedTuple states in and out; the module checks its inputs'
    shapes).

    On CUDA inputs a call is one replay of a CUDA graph of the module's
    call, captured at the first call of each set of input shapes and
    dtypes (``models/pose_graph.capture``; the predict artifact's dynamic
    query dimension gives a graph per query count), at most
    ``pose_graph.MAX_GRAPHS`` of them, the least recently used dropped
    first: the inputs are copied into the graph's static inputs, and the
    results come back as new tensors, bit for bit the module's own.
    On CPU inputs it calls the module (:meth:`eager`). ``captures`` records
    every graph captured."""

    def __init__(self, module):
        from erl_gaussian_process_tpu_torch.models.pose_graph import (
            GraphTable,
        )

        self.module = module
        self.captures: list = []
        self._graphs = GraphTable(self.captures)

    def eager(self, *args):
        """The module's own call, one launch at a time."""
        return self.module(*_as_tuples(args))

    def __call__(self, *args):
        import torch.utils._pytree as pytree

        from erl_gaussian_process_tpu_torch.models import pose_graph

        flat, spec = pytree.tree_flatten(_as_tuples(args))
        if not flat or not all(isinstance(t, torch.Tensor)
                               and t.device.type == "cuda" for t in flat):
            return self.eager(*args)
        key = tuple((t.shape, t.dtype, t.device) for t in flat)
        g = self._graphs.get(key)
        if g is None or g.spec != spec:
            inputs = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
                      for t in flat]
            torch._foreach_copy_(inputs, flat)

            def run():
                return self.module(*pytree.tree_unflatten(inputs, spec))

            g = self._graphs.keep(pose_graph.capture(
                key, flat[0].device, run, run, tuple(inputs)))
            g.spec = spec
        else:
            # one multi-tensor copy in, one out: the step's host cost
            torch._foreach_copy_(list(g.inputs), flat)
        g.replay()
        out, out_spec = pytree.tree_flatten(g.outputs)
        new = [torch.empty_like(t) if isinstance(t, torch.Tensor) else t
               for t in out]
        pairs = [(a, b) for a, b in zip(new, out)
                 if isinstance(b, torch.Tensor)]
        torch._foreach_copy_([a for a, _ in pairs], [b for _, b in pairs])
        return pytree.tree_unflatten(new, out_spec)


def load_fn(blob: bytes) -> LoadedStep:
    """An artifact as a callable with the exported function's signature
    (:class:`LoadedStep`: a CUDA-graph replay on CUDA inputs)."""
    return LoadedStep(load_program(blob).module())


def _state_example(n_pseudo: int, dim: int, dtype, device):
    from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
        SpGpState,
    )

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    m = n_pseudo
    return SpGpState(pseudo=z(m, dim), L_km=z(m, m), L_inv=z(m, m),
                     qm=z(m, m), alpha=z(m, 1), qm_c=z(m, m),
                     alpha_c=z(m, 1))


def export_map_update_step(setting, *, n_pseudo: int, n_rays: int,
                           free_slots: int, dim: int = 2,
                           dtype=torch.float32,
                           device=DEFAULT_DEVICE) -> bytes:
    """One occupancy-map update (free-space sampling, log-odds labels, the
    cap and compaction, the rank-N FITC update and its Kahan add) at a
    fixed shape bucket, from a ``SpGpOccupancyMapSetting``; the kernel
    (mixtures included) and its scale are the setting's, baked.

    Serve-time contract: ``new_state, n_used = step(state, u,
    sensor_position, scan_points, point_mask, aabb_min, aabb_max)``, with
    ``u`` (n_rays, free_slots) from ``geometry.free_sample_fractions``."""
    from erl_gaussian_process_tpu_torch.kernels import resolve_kernel_setting
    from erl_gaussian_process_tpu_torch.models.spgp_occupancy_map import (
        update_step,
    )

    s = setting
    dev = resolve_device(device)
    step = functools.partial(
        update_step,
        scale=float(s.sp_gp.kernel.scale),
        # the full setting resolves scale_mix/weights, so the artifact
        # bakes the kernel the live map runs
        kernel=resolve_kernel_setting(s.sp_gp.kernel_type, s.sp_gp.kernel,
                                      "export_map_update_step"),
        diagonal_qm=s.sp_gp.diagonal_qm, free_slots=free_slots,
        max_samples=int(s.sp_gp.max_num_samples),
        min_distance=s.min_distance, max_distance=s.max_distance,
        free_sampling_margin=s.free_sampling_margin,
        free_points_per_meter=s.free_points_per_meter,
        logodd_occupied=s.logodd_occupied, logodd_free=s.logodd_free,
        logodd_variance=s.logodd_variance,
        zero_threshold=(float(s.sp_gp.sparse_zero_threshold)
                        if s.sp_gp.use_sparse else 0.0))

    def fn(state, u, sensor, pts, mask, lo, hi):
        new_state, n_used, _ = step(state, sensor, pts, mask, lo, hi, u=u)
        return new_state, n_used

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    return export_fn(fn, _state_example(n_pseudo, dim, dtype, dev),
                     z(n_rays, free_slots), z(dim), z(n_rays, dim),
                     z(n_rays, dt=torch.bool), z(dim), z(dim))


def export_map_predict_step(*, n_pseudo: int, scale: float, n_queries=None,
                            dim: int = 2, kernel: str = "matern32",
                            with_grad: bool = False,
                            zero_threshold: float = 0.0, dtype=torch.float32,
                            device=DEFAULT_DEVICE) -> bytes:
    """The serving-side predict: queries against a prepared posterior,
    ``mean, grad = predict(state, L_qm, alpha_solved, points)`` (``grad``
    None unless ``with_grad``); ``kernel`` and ``scale`` are baked.

    ``n_queries``: an int freezes a query bucket; None exports a dynamic
    query dimension, one artifact for any batch size (the gram op takes
    any n, so the kernel stays in the graph)."""
    from erl_gaussian_process_tpu_torch.models.spgp_occupancy_map import (
        predict_prepared_step,
    )

    dev = resolve_device(device)
    step = functools.partial(predict_prepared_step, scale=float(scale),
                             kernel=kernel, with_grad=with_grad,
                             zero_threshold=zero_threshold)

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    state = _state_example(n_pseudo, dim, dtype, dev)
    dynamic = None
    if n_queries is None:
        dynamic = ((None,) * len(state), None, None,
                   {0: torch.export.Dim("n_queries", min=1)})
    return export_fn(lambda st, lq, a, q: step(st, lq, a, q), state,
                     z(n_pseudo, n_pseudo), z(n_pseudo, 1),
                     z(8 if n_queries is None else n_queries, dim),
                     dynamic_shapes=dynamic)
