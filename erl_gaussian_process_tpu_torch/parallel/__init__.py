"""Scaling over several ranks with ``torch.distributed`` (counterpart of
``erl_gaussian_process_tpu/parallel``).

- **GP banks** (lidar partitions, 3D partition grids): the bank axis is
  sharded over the ranks; no collective for the fit, the factors are
  gathered.
- **SPGP / occupancy-map updates**: the N training samples are sharded;
  each rank computes its FITC increment and the (Q_M, alpha) accumulation
  is one ``all_reduce`` pair.

Every rank calls the same function with the same inputs (SPMD) and gets
the result back whole; see ``parallel/mesh.py``.
"""

from erl_gaussian_process_tpu_torch.parallel.mesh import (
    make_mesh,
    sharded_bank_fit,
    sharded_spgp_predict,
    sharded_spgp_update,
    sharded_update_many,
)

__all__ = ["make_mesh", "sharded_bank_fit", "sharded_spgp_predict",
           "sharded_spgp_update", "sharded_update_many"]
