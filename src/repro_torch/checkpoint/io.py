"""Checkpoints: flattened-keypath ``.npz`` plus a JSON sidecar (port of
``repro.checkpoint.io``): the step-numbered checkpoints (``save``,
``restore``, ``valid_steps``, ``latest_step``; the resilience layer's
snapshots ride on them) and the named exports (the serving adapters).

The on-disk format is the reference's, so a file written by either
package loads bit for bit in the other:

* keys are the tree's key path joined with ``"::"`` (dict keys in sorted
  order, list and tuple items by index, a NamedTuple field as
  ``.name`` -- the reference's ``GetAttrKey``, so a ``TrainState``
  snapshot holds ``.params``, ``.opt_state::.mu``, ``.guard::.lr_scale``
  ...; a bare leaf is ``"_root"``);
* the sidecar holds the sorted keys, each array's shape, dtype and
  CRC32, the export's ``name`` and any extra metadata;
* both files are written ATOMICALLY (``*.tmp``, fsync, ``os.replace``),
  the npz before the sidecar, so the sidecar's arrival commits the pair;
* a load verifies the key set and every array's CRC32 and raises
  ValueError on any mismatch; ``restore`` without a step falls back (with
  a warning) to the newest older checkpoint that passes, and
  ``valid_steps`` skips (with a warning) a pair whose sidecar is missing
  or corrupt.  A named export is an explicit request, with no older
  entry to fall back to.

Leaves are numpy arrays, scalars or tensors (copied to the host); a
template's tensor leaves come back as tensors on the template leaf's
device and dtype, its Python numbers as numbers.
"""

from __future__ import annotations

import json
import os
import re
import warnings
import zipfile
import zlib
from typing import Any

import numpy as np
import torch

_SEP = "::"

# everything a torn or corrupt npz/sidecar pair can raise while loading;
# json.JSONDecodeError subclasses ValueError
_CORRUPTION_ERRORS = (OSError, ValueError, KeyError, zipfile.BadZipFile,
                      EOFError)


def _is_namedtuple(tree: Any) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _leaves_with_path(tree: Any, path: tuple = ()):
    """(key path, leaf) pairs in the reference's flattening order: dict
    keys sorted, NamedTuple fields in order (keyed ``.field``), sequences
    by index, None an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (k,))
    elif _is_namedtuple(tree):
        for f, v in zip(tree._fields, tree):
            yield from _leaves_with_path(v, path + ("." + f,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def _key(path: tuple) -> str:
    return _SEP.join(str(p) for p in path) or "_root"


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu").numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {_key(p): _host(leaf) for p, leaf in _leaves_with_path(tree)}


def _array_crc(arr: np.ndarray) -> int:
    # the CRC32 of the array's bytes, read in place (no bytes copy)
    return zlib.crc32(memoryview(np.ascontiguousarray(arr)).cast("B"))


def _write_atomic(path: str, write_fn) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write_fn(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _save_pair(base: str, arrays: dict[str, np.ndarray],
               extra_meta: dict | None = None) -> str:
    """Write ``base``.npz + ``base``.json: atomic tmp+fsync+rename, CRC32
    per array, npz first (the sidecar's arrival commits the pair)."""
    meta = {
        "keys": sorted(arrays),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
        "crc32": {k: _array_crc(v) for k, v in arrays.items()},
    }
    if extra_meta:
        meta.update(extra_meta)
    _write_atomic(base + ".npz", lambda f: np.savez(f, **arrays))
    _write_atomic(base + ".json",
                  lambda f: f.write(json.dumps(meta).encode("utf-8")))
    return base + ".npz"


def _load_pair(base: str) -> tuple[dict[str, np.ndarray], dict]:
    """Load one npz+sidecar pair with full verification: the sidecar
    matches the npz key set and every array passes its CRC32.  Returns
    (arrays, meta); raises ValueError on any mismatch."""
    with open(base + ".json") as fh:
        meta = json.load(fh)
    try:
        with np.load(base + ".npz") as data:
            if set(data.files) != set(meta["keys"]):
                raise ValueError("npz/sidecar key sets differ")
            crcs = meta.get("crc32", {})
            out = {}
            for k in data.files:
                arr = data[k]
                if k in crcs and _array_crc(arr) != int(crcs[k]):
                    raise ValueError(f"array {k!r} failed its CRC32 check")
                out[k] = arr
    except ValueError:
        raise
    except _CORRUPTION_ERRORS as e:
        # zip- or npy-level damage (bad zip CRC, torn member, ...)
        raise ValueError(f"corrupt npz payload: {e}") from e
    return out, meta


def save_named(directory: str, tree: Any, name: str,
               extra_meta: dict | None = None) -> str:
    """Save a tree under a NAME (the serving adapters' exports).
    ``extra_meta`` lands in the JSON sidecar (strings and ints only).
    Returns the npz path."""
    if os.sep in name or "/" in name or name.startswith("."):
        raise ValueError(f"invalid export name {name!r}")
    os.makedirs(directory, exist_ok=True)
    meta = {"name": name}
    if extra_meta:
        meta.update(extra_meta)
    return _save_pair(os.path.join(directory, name), _flatten(tree), meta)


def load_named(directory: str, name: str, template: Any = None):
    """Verified load of a named export.  With a ``template`` tree the
    arrays are reassembled into it (shape-checked); otherwise returns the
    raw ``(arrays, meta)`` pair.  Raises ValueError on any CRC or sidecar
    mismatch."""
    data, meta = _load_pair(os.path.join(directory, name))
    if meta.get("name", name) != name:
        raise ValueError(f"sidecar name {meta.get('name')!r} != {name!r}")
    if template is not None:
        return _unflatten(template, data)
    return data, meta


def save(directory: str, tree: Any, step: int) -> str:
    """Save a tree as the step-``step`` checkpoint
    (``ckpt_<step:08d>.npz`` + sidecar).  Returns the npz path."""
    os.makedirs(directory, exist_ok=True)
    return _save_pair(os.path.join(directory, f"ckpt_{step:08d}"),
                      _flatten(tree), {"step": step})


def valid_steps(directory: str) -> list[int]:
    """Steps whose npz + sidecar pair is structurally valid (both files
    present, the sidecar parses and names the step).  Stray or partial
    entries are skipped with a warning; every array's CRC is checked at
    ``restore``."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for f in sorted(os.listdir(directory)):
        m = re.match(r"ckpt_(\d+)\.npz$", f)
        if not m:
            continue
        step = int(m.group(1))
        sidecar = os.path.join(directory, f"ckpt_{step:08d}.json")
        if not os.path.exists(sidecar):
            warnings.warn(
                f"{directory}/ckpt_{step:08d}.npz has no .json sidecar "
                "(partial write?) -- skipped", stacklevel=2)
            continue
        try:
            with open(sidecar) as fh:
                meta = json.load(fh)
            if int(meta.get("step", -1)) != step or "keys" not in meta:
                raise ValueError("sidecar step/keys mismatch")
        except _CORRUPTION_ERRORS as e:
            warnings.warn(
                f"{directory}/ckpt_{step:08d}.json is corrupt ({e}) -- "
                "skipped", stacklevel=2)
            continue
        steps.append(step)
    return steps


def latest_step(directory: str) -> int | None:
    steps = valid_steps(directory)
    return max(steps) if steps else None


def _load_verified(directory: str, step: int) -> dict[str, np.ndarray]:
    """Step-numbered :func:`_load_pair` (the sidecar's step checked)."""
    data, meta = _load_pair(os.path.join(directory, f"ckpt_{step:08d}"))
    if int(meta.get("step", -1)) != step:
        raise ValueError(f"sidecar step {meta.get('step')} != {step}")
    return data


def restore(directory: str, template: Any, step: int | None = None) -> Any:
    """Restore the given step (verified, raising on corruption) or -- with
    ``step=None`` -- the NEWEST checkpoint that passes verification,
    warning and falling back to older ones past any corrupt or partial
    entry.  The arrays are reassembled into ``template``."""
    if step is not None:
        return _unflatten(template, _load_verified(directory, step))
    last_err: Exception | None = None
    for s in sorted(valid_steps(directory), reverse=True):
        try:
            data = _load_verified(directory, s)
        except _CORRUPTION_ERRORS as e:
            warnings.warn(
                f"checkpoint step {s} in {directory} is corrupt ({e}); "
                "falling back to an older one", stacklevel=2)
            last_err = e
            continue
        return _unflatten(template, data)
    if last_err is not None:
        raise FileNotFoundError(
            f"no intact checkpoint in {directory} "
            f"(last error: {last_err})")
    raise FileNotFoundError(f"no checkpoints in {directory}")


def _unflatten(template: Any, data: dict[str, np.ndarray]) -> Any:
    """``data`` reassembled into the structure of ``template``; each leaf
    takes the template leaf's dtype (and, for a tensor, its device; a
    Python number stays a number)."""

    def build(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k], path + (k,)) for k in node}
        if _is_namedtuple(node):
            return type(node)(*(build(v, path + ("." + f,))
                                for f, v in zip(node._fields, node)))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, path + (i,))
                              for i, v in enumerate(node))
        key = _key(path)
        arr = data[key]
        if tuple(arr.shape) != tuple(np.shape(node)):
            raise ValueError(
                f"export/template shape mismatch at {key}: {arr.shape} vs "
                f"{tuple(np.shape(node))}")
        if isinstance(node, torch.Tensor):
            if not (arr.flags.writeable and arr.flags.c_contiguous):
                arr = arr.copy()   # (np.ascontiguousarray makes 0-d 1-d)
            return torch.from_numpy(arr).to(device=node.device,
                                            dtype=node.dtype)
        if isinstance(node, (bool, int, float)):
            return type(node)(arr)
        if hasattr(node, "dtype"):
            return arr.astype(node.dtype)
        return arr

    return build(template, ())
