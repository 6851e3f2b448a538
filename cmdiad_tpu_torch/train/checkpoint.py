"""The JAX package's flat-npz checkpoint format, without JAX.

A nested dict of arrays (a flax variables pytree such as ``{"params": ...,
"batch_stats": ...}``) is one ``np.savez`` file, each leaf keyed by its path
joined with the unit separator, plus a ``__meta__`` entry holding a JSON
byte array.  Files written here load in the JAX package's
``train/checkpoint.load_pytree`` and the other way round, so a fusion net
the JAX package trained (``fusion_module_path=*.npz``) serves in the port,
and the trainers' checkpoints (``params``, ``batch_stats``, ``opt_state``)
resume in either package (``train.distill``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np

_SEP = "\x1f"  # unit separator — never appears in module names


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    """Leaves of nested dicts keyed by their joined paths, in
    ``jax.tree_util``'s order (keys sorted)."""
    if not isinstance(tree, dict):
        out[prefix] = np.asarray(tree)
        return
    for k in sorted(tree):
        _flatten(tree[k], f"{prefix}{_SEP}{k}" if prefix else str(k), out)


def flatten(tree) -> Dict[str, np.ndarray]:
    """{joined path: leaf} of a nested dict, as the file keys it."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    return flat


def save_pytree(path: str, tree, meta: dict | None = None) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = flatten(tree)
    flat["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8)
    np.savez(path, **flat)


def load_pytree(path: str) -> Dict[str, Any]:
    """The nested dict of numpy arrays (``__meta__`` left out)."""
    with np.load(path, allow_pickle=False) as z:
        out: Dict[str, Any] = {}
        for key in z.files:
            if key == "__meta__":
                continue
            parts = key.split(_SEP)
            node = out
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return out


def load_meta(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        if "__meta__" in z.files:
            return json.loads(bytes(z["__meta__"].tobytes()).decode())
    return {}
