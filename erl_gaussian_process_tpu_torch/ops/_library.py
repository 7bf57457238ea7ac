"""The ``egp`` operator namespace: every kernel that an exported function
(``utils/deploy.py``) reaches is a ``torch.library`` op here, so that
``torch.export`` records it as one node and a loaded artifact launches the
same entry as the eager path.

Each op has three implementations: CPU (the kernel's plain PyTorch
version), CUDA (the kernel's launch, or an error) and a fake one (the
output shapes, for tracing; it takes symbolic sizes too). The kernel
family enters as arguments that are not tensors — the base family, the
mixture's scale ratios and weights, and the scale — so an artifact bakes
them, and a mixture needs no registration in the process that loads it.
The ops are registered when ``erl_gaussian_process_tpu_torch.ops`` is
imported.

Their CUDA implementations count their launches with :func:`note_launch`,
which tells a launch that runs now from one recorded into a CUDA graph.
"""

from __future__ import annotations

import torch

LIB = torch.library.Library("egp", "FRAGMENT")


def define(schema: str, cpu, cuda, fake) -> None:
    """Define ``egp::<schema>`` with its CPU, CUDA and fake
    implementations."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"egp::{name}", fake, lib=LIB)


class LaunchCount:
    """A launch count of its own for a kernel that a wrapper launches among
    others (``launches`` and ``captured`` as on a wrapper, and a
    ``__name__``)."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0
        self.captured = 0


def note_launch(wrapper) -> None:
    """Count one launch of ``wrapper``'s kernel: in ``wrapper.launches``
    when it runs now; in ``wrapper.captured`` when the current stream is
    capturing a CUDA graph, where the kernel runs only when the graph is
    replayed (``models/pose_graph.py`` adds the launches a graph captured
    to ``launches`` at each of its replays)."""
    if torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
    else:
        wrapper.launches += 1
