"""Named exports: flattened-keypath ``.npz`` plus a JSON sidecar (port of
the named-export half of ``repro.checkpoint.io``).

The on-disk format is the reference's, so an export written by either
package loads bit for bit in the other:

* keys are the tree's key path joined with ``"::"`` (dict keys in sorted
  order, list and tuple items by index; a bare leaf is ``"_root"``);
* the sidecar holds the sorted keys, each array's shape, dtype and
  CRC32, the export's ``name`` and any extra metadata;
* both files are written ATOMICALLY (``*.tmp``, fsync, ``os.replace``),
  the npz before the sidecar, so the sidecar's arrival commits the pair;
* a load verifies the key set and every array's CRC32 and raises
  ValueError on any mismatch -- a named export is an explicit request,
  with no older entry to fall back to.

Leaves are numpy arrays or scalars.  The step-numbered checkpoints
(``save``/``restore``/``valid_steps``/``latest_step``) are not ported yet
(ROADMAP.md Queue A 13).
"""

from __future__ import annotations

import json
import os
import zipfile
import zlib
from typing import Any

import numpy as np

_SEP = "::"

# everything a torn or corrupt npz/sidecar pair can raise while loading;
# json.JSONDecodeError subclasses ValueError
_CORRUPTION_ERRORS = (OSError, ValueError, KeyError, zipfile.BadZipFile,
                      EOFError)


def _leaves_with_path(tree: Any, path: tuple = ()):
    """(key path, leaf) pairs in the reference's flattening order: dict
    keys sorted, sequences by index, None an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def _key(path: tuple) -> str:
    return _SEP.join(str(p) for p in path) or "_root"


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {_key(p): np.asarray(leaf) for p, leaf in _leaves_with_path(tree)}


def _array_crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


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


def _unflatten(template: Any, data: dict[str, np.ndarray]) -> Any:
    """``data`` reassembled into the structure of ``template``; each leaf
    takes the template leaf's dtype."""

    def build(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k], path + (k,)) for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, path + (i,))
                              for i, v in enumerate(node))
        key = _key(path)
        arr = data[key]
        if tuple(arr.shape) != np.shape(node):
            raise ValueError(
                f"export/template shape mismatch at {key}: {arr.shape} vs "
                f"{np.shape(node)}")
        if hasattr(node, "dtype"):
            return arr.astype(node.dtype)
        return arr

    return build(template, ())
