"""A cache of generated inputs inside the checkout.

The scans a configuration replays do not depend on the run's seed, so they
are made once per checkout (the first run of a cell pays the raycast) and
read back from ``<cache_dir>/<name>-<key>.npz`` after that. The key hashes
the configuration and the sources of the generators, so a changed
generator makes new inputs.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile

import numpy as np

from portbench.reference import worlds


def key(cfg: dict, *sources) -> str:
    h = hashlib.sha256(json.dumps(cfg, sort_keys=True).encode())
    for path in (worlds.__file__, *sources):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def cached(cache_dir: str, name: str, cfg: dict, make, *sources) -> dict:
    """``make()``'s dict of arrays, from the cache when it is there."""
    path = os.path.join(cache_dir, f"{name}-{key(cfg, *sources)}.npz")
    if os.path.exists(path):
        with np.load(path) as f:
            return {k: f[k] for k in f.files}
    out = make()
    os.makedirs(cache_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".npz")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **out)
    os.replace(tmp, path)
    return out
