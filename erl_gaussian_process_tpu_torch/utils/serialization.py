"""Checkpoint / resume: flat-key .npz serialization of nested state dicts
with exact round-trip equality (counterpart of
``erl_gaussian_process_tpu/utils/serialization.py``, npz only; numpy only —
the models' ``state_dict`` hands over host numpy copies)."""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np

_SEP = "/"
_META_KEY = "__meta__"


def _flatten(prefix: str, obj: Any, out: Dict[str, Any], meta: Dict[str, Any]):
    if isinstance(obj, dict):
        meta[prefix] = {"type": "dict", "keys": list(obj.keys())}
        for k, v in obj.items():
            _flatten(f"{prefix}{_SEP}{k}" if prefix else str(k), v, out, meta)
    elif obj is None:
        meta[prefix] = {"type": "none"}
    elif isinstance(obj, (bool, int, float, str)):
        meta[prefix] = {"type": type(obj).__name__, "value": obj}
    elif isinstance(obj, (list, tuple)):
        arr = np.asarray(obj)
        if arr.dtype == object:
            meta[prefix] = {"type": "json", "value": json.dumps(obj)}
        else:
            meta[prefix] = {"type": "list" if isinstance(obj, list) else "tuple"}
            out[prefix] = arr
    else:  # array-like
        meta[prefix] = {"type": "array"}
        out[prefix] = np.asarray(obj)


def save_pytree(path: str, state: Dict[str, Any]) -> None:
    arrays: Dict[str, Any] = {}
    meta: Dict[str, Any] = {}
    _flatten("", state, arrays, meta)
    arrays[_META_KEY] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_pytree(path: str) -> Dict[str, Any]:
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z[_META_KEY].tobytes()).decode("utf-8"))

        def build(prefix: str):
            info = meta[prefix]
            t = info["type"]
            if t == "dict":
                return {k: build(f"{prefix}{_SEP}{k}" if prefix else str(k))
                        for k in info["keys"]}
            if t == "none":
                return None
            if t in ("bool", "int", "float", "str"):
                return info["value"]
            if t == "json":
                return json.loads(info["value"])
            arr = z[prefix]
            if t == "list":
                return arr.tolist() if arr.dtype.kind in "OU" else arr
            if t == "tuple":
                return tuple(arr.tolist())
            return arr

        return build("")


def eq_state(a: Any, b: Any) -> bool:
    """Deep exact equality over nested state dicts (arrays compared
    bitwise, NaN equal to NaN)."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(eq_state(a[k], b[k]) for k in a)
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, (bool, int, float, str)) and isinstance(
            b, (bool, int, float, str)):
        return a == b
    aa, bb = np.asarray(a), np.asarray(b)
    return aa.shape == bb.shape and aa.dtype == bb.dtype and np.array_equal(
        aa, bb, equal_nan=True)
