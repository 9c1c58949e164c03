"""Orbax checkpoint directories, read and written without JAX, orbax or
tensorstore: the port's counterpart of the JAX package's
``train/checkpoints.py::load_weights`` / ``load_asdqe_weights`` and of the
directories its ``save_weights`` and ``raie convert`` write.

A checkpoint directory holds ``_METADATA`` (JSON: each leaf's key path and
value type, and whether the arrays live in one OCDBT database) and zarr v2
arrays, one per leaf, named by the key path joined with dots
(``params.encoder_level1.0.ffn.project_in.kernel``): a ``.zarray`` (dtype,
shape, chunks, order, fill value, compressor zstd or none) and its chunks
(``0.0.0.0``; ``0`` for a 0-d array). With ``use_ocdbt: true`` they are keys
of the OCDBT database (``convert/ocdbt.py``), else files in a directory per
leaf.

``read_checkpoint(path)`` returns the nested dict of numpy arrays (Python
ints and floats for orbax "scalar" leaves, ``None`` in place of an empty
leaf: value type ``'None'`` with ``skip_deserialize``, as orbax saves
optax's ``EmptyState`` and ``MaskedNode``, so that a sequence keeps its
indices). bfloat16 arrays come back with
dtype ``BF16`` (``V2``: the raw 16 bits, which numpy refuses to cast by
accident); ``to_torch`` makes them ``torch.bfloat16``, ``bf16_to_float32``
widens them. ``write_checkpoint(path, tree)`` writes the ``use_ocdbt:
false`` layout with uncompressed chunks, which orbax restores, atomically
(a temporary directory renamed into place).
"""

from __future__ import annotations

import json
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Mapping

import numpy as np
import torch

from ..utils import zstd
from .ocdbt import Database

BF16 = np.dtype("V2")  # the bits of a bfloat16
METADATA, CHECKPOINT_METADATA = "_METADATA", "_CHECKPOINT_METADATA"
KEY_SEQUENCE, KEY_DICT = 1, 2  # orbax's KeyType
HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")
DECODE_THREADS = 8


class CheckpointError(ValueError):
    """A checkpoint layout this reader does not know, or a malformed one."""


# -------------------------------------------------------------- bfloat16 --

def bf16_to_float32(a: np.ndarray) -> np.ndarray:
    """bfloat16 bits -> the float32 of the same value (exact)."""
    return (np.ascontiguousarray(a).view(np.uint16).astype(np.uint32) << 16).view(np.float32)


def to_torch(a) -> torch.Tensor:
    """A numpy array (``BF16`` included) -> a CPU tensor of its dtype (a copy)."""
    a = np.array(a, order="C")
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_torch(t: torch.Tensor) -> np.ndarray:
    """A tensor -> a numpy array of its dtype (bfloat16 as ``BF16``)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().copy().view(BF16)
    return t.numpy().copy()


# ---------------------------------------------------------------- reading --

def is_checkpoint(path: str) -> bool:
    """True for an orbax checkpoint directory (it holds ``_METADATA``)."""
    return os.path.isfile(os.path.join(path, METADATA))


def _tree_metadata(path: str) -> dict:
    meta_path = os.path.join(path, METADATA)
    if not os.path.isfile(meta_path):
        raise CheckpointError(f"{path}: no {METADATA} (not an orbax checkpoint)")
    with open(meta_path) as fh:
        return json.load(fh)


def payload_keys(path: str) -> list[str]:
    """The top-level keys of a checkpoint's payload (no array is read)."""
    keys = (info["key_metadata"][0]["key"]
            for info in _tree_metadata(path)["tree_metadata"].values())
    return sorted({str(k) for k in keys})


def _dtype(name: str) -> np.dtype:
    if name == "bfloat16":
        return BF16
    if not isinstance(name, str):
        raise CheckpointError(f"zarr dtype {name!r}: structured dtypes are not read")
    dt = np.dtype(name)
    if dt.kind not in "biuf":
        raise CheckpointError(f"zarr dtype {name!r}: this reader takes bool, int, "
                              "uint, float and bfloat16")
    return dt


def _fill(value, dt: np.dtype):
    if value is None:
        return None
    if isinstance(value, str):
        value = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}[value]
    if dt == BF16:  # the high half of the float32
        return (np.array([value], np.float32).view(np.uint32) >> 16
                ).astype(np.uint16).view(BF16)[0]
    return dt.type(value)


class _Store:
    """The arrays' bytes: OCDBT keys or files under the directory."""

    def __init__(self, path: str, ocdbt: bool, decoder: str):
        self.path = path
        self.db = Database(path, decoder) if ocdbt else None

    def get(self, key: str) -> bytes | None:
        if self.db is not None:
            return self.db.get(key) if key in self.db else None
        parts = key.split("/")
        if ".." in parts or os.path.isabs(key):  # names come from _METADATA
            raise CheckpointError(f"{self.path}: leaf key {key!r} leaves the directory")
        file = os.path.join(self.path, *parts)
        if not os.path.isfile(file):
            return None
        with open(file, "rb") as fh:
            return fh.read()


def _read_array(store: _Store, name: str, decoder: str) -> np.ndarray:
    raw = store.get(f"{name}/.zarray")
    if raw is None:
        raise CheckpointError(f"{store.path}: leaf {name!r} has no .zarray")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise CheckpointError(f"{name}: zarr_format {meta.get('zarr_format')}; "
                              "this reader knows zarr v2")
    if meta.get("filters"):
        raise CheckpointError(f"{name}: zarr filters {meta['filters']} are not read")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise CheckpointError(f"{name}: compressor {comp.get('id')!r}; this reader "
                              "takes zstd and none")
    order = meta.get("order", "C")
    if order not in ("C", "F"):
        raise CheckpointError(f"{name}: order {order!r}")
    dt = _dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise CheckpointError(f"{name}: chunks {chunks} for shape {shape}")
    sep = meta.get("dimension_separator", ".")
    fill = _fill(meta.get("fill_value"), dt)
    out = np.empty(shape, dt)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid) if shape else [()]:
        key = sep.join(str(i) for i in idx) if idx else "0"
        data = store.get(f"{name}/{key}")
        sl = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        if data is None:
            if fill is None:
                raise CheckpointError(f"{name}: chunk {key} missing and no fill value")
            out[sl] = fill
            continue
        n = int(np.prod(chunks, dtype=np.int64)) * dt.itemsize
        if comp is not None:
            data = zstd.decompress(data, decoder, size=n)
        if len(data) != n:
            raise CheckpointError(f"{name}: chunk {key} holds {len(data)} bytes, "
                                  f"expected {n}")
        chunk = np.frombuffer(data, dt).reshape(chunks, order=order)
        out[sl] = chunk[tuple(slice(0, s.stop - s.start) for s in sl)]
    if dt.byteorder == ">":
        out = out.astype(dt.newbyteorder("="))
    return out


def _assemble(leaves: dict[tuple, Any], kinds: dict[tuple, int]) -> dict:
    """Nested dicts of the leaves; a node whose keys are sequence keys
    becomes a list. ``kinds[prefix]`` is the key type below ``prefix``."""
    tree: dict = {}
    for path, value in leaves.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value

    def lists(node, prefix):
        if not isinstance(node, dict):
            return node
        out = {k: lists(v, prefix + (k,)) for k, v in node.items()}
        if kinds[prefix] == KEY_SEQUENCE:
            return [out[k] for k in sorted(out, key=int)]
        return out

    return lists(tree, ())


def read_checkpoint(path: str, decoder: str = "native") -> dict:
    """Every leaf of the checkpoint directory ``path``, as orbax restores it
    without a target: numpy arrays (``BF16`` for bfloat16), Python scalars
    for "scalar" leaves, None for empty leaves, dicts (lists for sequence
    keys)."""
    meta = _tree_metadata(path)
    if meta.get("use_zarr3"):
        raise CheckpointError(f"{path}: use_zarr3 is true; this reader knows zarr v2")
    store = _Store(path, bool(meta.get("use_ocdbt")), decoder)
    entries = []
    for key, info in meta["tree_metadata"].items():
        keys = info["key_metadata"]
        kinds = [k["key_type"] for k in keys]
        if any(k not in (KEY_SEQUENCE, KEY_DICT) for k in kinds):
            raise CheckpointError(f"{path}: key types {kinds} of {key}")
        value = info["value_metadata"]
        value_type = value["value_type"]
        empty = value_type == "None" and value.get("skip_deserialize") is True
        if value_type not in ("np.ndarray", "jax.Array", "scalar") and not empty:
            raise CheckpointError(f"{path}: leaf {key} of value type "
                                  f"{value_type!r}; this reader takes arrays, scalars "
                                  "and empty ('None', skip_deserialize) leaves")
        path_keys = tuple(str(k["key"]) for k in keys)
        entries.append((path_keys, kinds, value_type))
    with ThreadPoolExecutor(DECODE_THREADS) as pool:  # zstd releases the GIL
        arrays = list(pool.map(
            lambda e: None if e[2] == "None" else _read_array(store, ".".join(e[0]), decoder),
            entries))
    leaves, kinds = {}, {}
    for (keys, types, value_type), a in zip(entries, arrays):
        leaves[keys] = a.item() if value_type == "scalar" else a
        kinds.update((keys[:i], t) for i, t in enumerate(types))
    return _assemble(leaves, kinds)


def load_weights(path: str, param_key: str | None = "params"):
    """A weights checkpoint's ``param_key`` subtree, or the whole payload
    where it has no such key (JAX ``train/checkpoints.py::load_weights``)."""
    restored = read_checkpoint(path)
    return restored.get(param_key, restored) if param_key else restored


def load_asdqe_weights(path: str):
    """(params, batch_stats) of an ASDQE checkpoint, or None where ``path``
    is not a directory: ``train-asdqe`` nests ``{'params', 'batch_stats'}``
    under the payload's 'params', direct saves are flat (JAX
    ``train/checkpoints.py::load_asdqe_weights``)."""
    if not os.path.isdir(path):
        return None
    return asdqe_variables(read_checkpoint(path))


def asdqe_variables(restored: dict):
    """(params, batch_stats) of a restored ASDQE payload, nested or flat."""
    inner = restored.get("params", restored)
    if "batch_stats" not in inner:
        inner = restored
    return inner["params"], inner["batch_stats"]


# ---------------------------------------------------------------- writing --

def _leaves(tree, prefix=()):
    if isinstance(tree, Mapping):  # in key order, as orbax flattens a tree
        items = sorted((str(k), v) for k, v in tree.items())
        kind = KEY_DICT
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
        kind = KEY_SEQUENCE
    else:
        yield prefix, tree
        return
    for k, v in items:
        k = str(k)
        if "/" in k or not k:
            raise CheckpointError(f"key {k!r} of {prefix}: empty or holding '/'")
        for path, leaf in _leaves(v, prefix + ((k, kind),)):
            yield path, leaf


def _zarray(a: np.ndarray) -> dict:
    return {"chunks": list(a.shape), "compressor": None, "dimension_separator": ".",
            "dtype": "bfloat16" if a.dtype == BF16 else a.dtype.str,
            "fill_value": None, "filters": None, "order": "C",
            "shape": list(a.shape), "zarr_format": 2}


def write_checkpoint(path: str, tree: Mapping[str, Any]) -> str:
    """Write ``tree`` (nested dicts of numpy arrays, ``BF16`` arrays, CPU
    tensors or Python scalars) as an orbax checkpoint directory that the
    JAX package's ``load_weights`` restores: one zarr v2 array per leaf,
    uncompressed, ``use_ocdbt: false``. An existing ``path`` is replaced.
    Returns the absolute path."""
    path = os.path.abspath(path)
    start = time.time_ns()
    tmp = f"{path}.orbax-checkpoint-tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    tree_meta = {}
    names = set()
    for keys, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = from_torch(leaf)
        if isinstance(leaf, (bool, int, float)) and not isinstance(leaf, np.generic):
            value_type, a = "scalar", np.asarray(leaf)
        elif isinstance(leaf, (np.ndarray, np.generic)):
            value_type, a = "np.ndarray", np.asarray(leaf)
        else:
            raise CheckpointError(f"leaf {keys} of type {type(leaf).__name__}")
        if a.dtype != BF16:
            _dtype(a.dtype.str)  # refuse what the reader would refuse
            a = a.astype(a.dtype.newbyteorder("<"))
        name = ".".join(k for k, _ in keys)
        if name in names:
            raise CheckpointError(f"two leaves named {name!r}")
        names.add(name)
        leaf_dir = os.path.join(tmp, name)
        os.makedirs(leaf_dir)
        with open(os.path.join(leaf_dir, ".zarray"), "w") as fh:
            json.dump(_zarray(a), fh)
        chunk = ".".join("0" for _ in a.shape) or "0"
        with open(os.path.join(leaf_dir, chunk), "wb") as fh:
            fh.write(np.ascontiguousarray(a).tobytes())
        tree_meta[str(tuple(k for k, _ in keys))] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in keys],
            "value_metadata": {"value_type": value_type, "skip_deserialize": False}}
    with open(os.path.join(tmp, METADATA), "w") as fh:
        json.dump({"tree_metadata": tree_meta, "use_ocdbt": False, "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, fh)
    with open(os.path.join(tmp, CHECKPOINT_METADATA), "w") as fh:
        json.dump({"item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": start,
                   "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {}}, fh)
    old = None
    if os.path.exists(path):
        old = f"{path}.orbax-checkpoint-old-{os.getpid()}"
        os.replace(path, old)
    os.replace(tmp, path)
    if old is not None:
        shutil.rmtree(old)
    return path
