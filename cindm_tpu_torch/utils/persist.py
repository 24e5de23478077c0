"""The JAX package's ``persisted_m*.npz`` snapshots, read and written.

A snapshot (``cindm_tpu/utils/persist.py:save_npz``) is one compressed
``.npz`` whose keys are pytree key-paths such as
``['ema_params']['params']['Dense_0']['Dense_0']['kernel']``, plus
``['step']``. bfloat16 leaves are stored as their ``uint16`` bit patterns and
listed in a JSON blob under ``__dtype_overrides__``; they are encoded
(round to nearest even) and decoded here with numpy bit operations alone.

``save_npz`` writes a port TrainState of any model with a ``flax_mapping``
(TemporalUnet1D, Unet2D, ForceUnet, ...) in that layout, with Flax's
parameter names and kernel layouts, so the JAX package's
``load_npz(path, template)`` restores it; ``load_npz`` fills a port
TrainState from a snapshot of either package.
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


def f32_to_bf16_bits(a: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bit patterns (uint16), rounded to nearest even.
    NaN becomes the quiet NaN of its sign (0x7FC0 / 0xFFC0); a value that
    rounds past the largest bfloat16 becomes infinity."""
    a = np.ascontiguousarray(a, np.float32)
    u = a.view(np.uint32).astype(np.uint64)
    rounded = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
    nan = np.where(np.signbit(a), np.uint16(0xFFC0), np.uint16(0x7FC0))
    return np.where(np.isnan(a), nan, rounded)


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


def _keypath(*parts: str) -> str:
    return "".join(f"['{p}']" for p in parts)


def save_npz(state, path: str, ema_only: bool = False, dtype: Optional[str] = None) -> str:
    """Write ``{params, ema_params, step}`` of a TrainState to ``path`` in the
    JAX package's snapshot layout.

    ``ema_only`` drops the raw ``params`` copy (a loader then restores
    ``params`` from ``ema_params``); ``dtype`` ("bfloat16", or a numpy float
    type such as "float16") down-casts the parameters.
    """
    from ..models.unet1d import flax_from_params

    trees = {"ema_params": state.ema} if ema_only else {"params": state.model,
                                                         "ema_params": state.ema}
    arrs, overrides = {}, {}
    for name, module in trees.items():
        for k, v in flax_from_params(module).items():
            key = _keypath(name, "params") + k
            if dtype == "bfloat16":
                overrides[key] = "bfloat16"
                v = f32_to_bf16_bits(v)
            elif dtype is not None:
                v = v.astype(dtype)
            arrs[key] = v
    arrs[_keypath("step")] = np.asarray(state.step, np.int32)
    if overrides:
        arrs[_OVERRIDES_KEY] = np.frombuffer(json.dumps(overrides).encode(), np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **arrs)
    os.replace(tmp, path)
    return path


def load_npz(path: str, state):
    """Fill a TrainState from a snapshot, in place.

    ``params`` come from the file's ``params`` (from its ``ema_params`` in an
    EMA-only snapshot), ``ema_params`` and ``step`` from the file where it has
    them; the optimizer state is left as it is. Raises, naming the key-paths,
    if the snapshot does not match the model or holds anything else.
    """
    from ..models.unet1d import params_from_flax

    flat = load_flax_npz(path)
    params, ema = select_subtree(flat, "params"), select_subtree(flat, "ema_params")
    step_key = _keypath("step")
    other = sorted(k for k in flat
                   if k != step_key and parse_keypath(k)[0] not in ("params", "ema_params"))
    if other or not (params or ema):
        raise ValueError(f"{path}: not a TrainState snapshot (unexpected keys {other[:5]}, "
                         f"params: {bool(params)}, ema_params: {bool(ema)})")
    for module, tree in ((state.model, params or ema), (state.ema, ema)):
        if tree:
            module.load_state_dict(params_from_flax(tree, module))
    if step_key in flat:
        state.step = int(flat[step_key])
    return state
