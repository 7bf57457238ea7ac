"""erl_gaussian_process_tpu_torch — the PyTorch/CUDA port of
``erl_gaussian_process_tpu``.

The JAX package next to this one is the reference: every module here has a
counterpart of the same name there, and the tests hold the two against each
other on the same inputs. This package imports ``torch`` and ``numpy`` (and
``scipy`` lazily, for the exact host refactorization); it never imports
``jax`` or the JAX package, so it runs on machines that have neither.

Hand-written Hopper kernels live in ``csrc/`` and are bound in ``ops/``:

- ``ops/gram.py`` + ``csrc/gram.cu``: the cross-gram k(x1, x2);
- ``ops/fitc.py`` + ``csrc/fitc.cu``: the rank-N FITC update.

Each wrapper runs its plain PyTorch version for CPU tensors and launches its
kernel (built with nvcc at first use, ``ops/_build.py``) for CUDA tensors.
"""

from erl_gaussian_process_tpu_torch import geometry, kernels, models, ops, utils

__all__ = ["geometry", "kernels", "models", "ops", "utils"]
__version__ = "0.1.0"
