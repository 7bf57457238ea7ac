"""erl_gaussian_process_tpu_torch — the PyTorch/CUDA port of
``erl_gaussian_process_tpu``.

The JAX package next to this one is the reference: every module here has a
counterpart of the same name there, and the tests hold the two against each
other on the same inputs. This package imports ``torch`` and ``numpy`` (and
``scipy`` lazily, for the exact host refactorization); it never imports
``jax`` or the JAX package, so it runs on machines that have neither.

Hand-written Hopper kernels live in ``csrc/`` and are bound in ``ops/``:

- ``ops/gram.py`` + ``csrc/gram.cuh``: the cross-gram k(x1, x2), also over
  a leading member axis;
- ``ops/fitc.py`` + ``csrc/fitc.cu``: the rank-N FITC update;
- ``ops/bank.py`` + ``csrc/bank.cu``: the bank fit and bank Cholesky of B
  small exact GPs;
- ``ops/chol.py`` + ``csrc/chol.cu``: the blocked Cholesky of one large
  system (a given matrix, the train gram, or the joint value/gradient
  gram, built per tile);
- ``ops/trsv.py`` + ``csrc/trsv.cu``: the triangular solves after it.

Each wrapper runs its plain PyTorch version for CPU tensors and launches its
kernel (built with nvcc at first use, ``ops/_build.py``) for CUDA tensors.
The gram and FITC wrappers do so through the ``torch.library`` ops
``egp::cross_gram``, ``egp::cross_gram_batched`` and ``egp::fitc_update``
(``ops/_library.py``), which ``torch.export`` artifacts
(``utils/deploy.py``) record; importing this package registers them.
``api`` holds the reference's D/F-suffixed class names.
"""

from erl_gaussian_process_tpu_torch import (
    api,
    geometry,
    kernels,
    models,
    ops,
    utils,
)
from erl_gaussian_process_tpu_torch.init import init

init()  # the setting registry (utils/config.py)

__all__ = ["api", "geometry", "kernels", "models", "ops", "utils", "init"]
__version__ = "0.1.0"
