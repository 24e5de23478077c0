"""Read side of the JAX package's ``persisted_m*.npz`` snapshots.

A snapshot (written by ``cindm_tpu/utils/persist.py:save_npz``) is one
compressed ``.npz`` whose keys are pytree key-paths such as
``['ema_params']['params']['Dense_0']['Dense_0']['kernel']``. bfloat16 leaves
are stored as their ``uint16`` bit patterns and listed in a JSON blob under
``__dtype_overrides__``; they are decoded here with numpy bit operations alone.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Optional

import numpy as np

_PERSIST_RE = re.compile(r"persisted_m(\d+)\.npz$")
_OVERRIDES_KEY = "__dtype_overrides__"
_KEY_RE = re.compile(r"\['([^']*)'\]")


def bf16_bits_to_f32(u16: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (uint16) -> float32, exactly."""
    return (np.asarray(u16, np.uint16).astype(np.uint32) << 16).view(np.float32)


def parse_keypath(key: str) -> tuple[str, ...]:
    """``"['a']['b']"`` -> ``("a", "b")``; raises on any other format."""
    parts = _KEY_RE.findall(key)
    if not parts or "".join(f"['{p}']" for p in parts) != key:
        raise ValueError(f"not a dict key-path: {key!r}")
    return tuple(parts)


def load_flax_npz(path: str) -> dict[str, np.ndarray]:
    """Every array of a snapshot keyed by its key-path string, bf16 decoded to float32."""
    with np.load(path) as data:
        keys = set(data.files)
        overrides = {}
        if _OVERRIDES_KEY in keys:
            keys.discard(_OVERRIDES_KEY)
            overrides = json.loads(bytes(data[_OVERRIDES_KEY]).decode())
        out = {}
        for k in sorted(keys):
            arr = data[k]
            dtype = overrides.get(k)
            if dtype == "bfloat16":
                arr = bf16_bits_to_f32(arr)
            elif dtype is not None:
                raise ValueError(f"{path}: unsupported dtype override {dtype!r} for {k}")
            out[k] = arr
    return out


def find_persisted(directory: str, milestone: Optional[int] = None) -> Optional[str]:
    """Newest (or exact-milestone) persisted_m*.npz under ``directory``."""
    cands = []
    for p in glob.glob(os.path.join(directory, "persisted_m*.npz")):
        m = _PERSIST_RE.search(os.path.basename(p))
        if m:
            cands.append((int(m.group(1)), p))
    if milestone is not None:
        for s, p in cands:
            if s == milestone:
                return p
        return None
    return max(cands)[1] if cands else None


def select_subtree(flat: dict[str, np.ndarray], name: str) -> dict[str, np.ndarray]:
    """The entries under top-level key ``name``, with that level stripped from
    their key-paths (e.g. a snapshot's ``ema_params``). Empty if none."""
    out = {}
    for k, v in flat.items():
        path = parse_keypath(k)
        if path[0] == name and len(path) > 1:
            out["".join(f"['{p}']" for p in path[1:])] = v
    return out
