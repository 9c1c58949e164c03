"""Path pairing — which files train together.

Ports of Train/basicsr/data/data_util.py pairing functions plus the
student's temporal grouping (paired_image_dataset.py:42-84). One deliberate
change: the reference bakes the random per-group stride into the dataset
at __init__ time with global RNG; here grouping takes an explicit seed and
can be re-rolled per epoch (``regroup(seed)``), which is both reproducible
and closer to what the training intended.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Sequence

import numpy as np


def scan_files(folder: str) -> list[str]:
    return sorted(f for f in os.listdir(folder)
                  if osp.isfile(osp.join(folder, f)))


def paired_paths_from_folder(folders: Sequence[str], keys: Sequence[str],
                             filename_tmpl: str = "{}") -> list[dict]:
    """Index-aligned pairing with template check (data_util.py:253-304)."""
    assert len(folders) == len(keys) and len(folders) >= 2
    lists = [scan_files(f) for f in folders]
    n = len(lists[0])
    for key, lst in zip(keys[1:], lists[1:]):
        assert len(lst) == n, f"{key}: {len(lst)} files vs {n}"
    pairs = []
    for idx in range(n):
        base_last = osp.splitext(osp.basename(lists[-1][idx]))[0]
        pair = {}
        for fi, (folder, key) in enumerate(zip(folders, keys)):
            if fi == 0:
                _, ext = osp.splitext(lists[0][idx])
                name = f"{filename_tmpl.format(base_last)}{ext}"
                assert name in lists[0], f"{name} not found for key {keys[0]}"
                pair[f"{key}_path"] = osp.join(folder, name)
            else:
                pair[f"{key}_path"] = osp.join(folder, lists[fi][idx])
        pairs.append(pair)
    return pairs


def paired_paths_from_folder_param(folders: Sequence[str],
                                   keys: Sequence[str]) -> list[dict]:
    """Basename-matched N-folder pairing keyed on the 'gt' folder
    (data_util.py:306-351). Deterministic ordering (the reference iterates
    a set; we sort)."""
    assert len(folders) == len(keys) and len(folders) >= 2
    base_maps = []
    for folder in folders:
        base_maps.append({osp.splitext(f)[0]: f for f in scan_files(folder)})
    ref_idx = keys.index("gt")
    ref_bases = set(base_maps[ref_idx])
    for i, key in enumerate(keys):
        if i == ref_idx:
            continue
        missing = ref_bases - set(base_maps[i])
        assert not missing, f"{key} folder missing files: {sorted(missing)[:5]}"
    pairs = []
    for base in sorted(ref_bases):
        pairs.append({f"{key}_path": osp.join(folders[i], base_maps[i][base])
                      for i, key in enumerate(keys)})
    return pairs


def paired_paths_from_meta_info_file(folders, keys, meta_info_file,
                                     filename_tmpl: str = "{}") -> list[dict]:
    """Pairing from a meta-info text file, one gt name per line
    (data_util.py:158-206)."""
    assert len(folders) == 2 and len(keys) == 2
    input_folder, gt_folder = folders
    input_key, gt_key = keys
    with open(meta_info_file) as f:
        gt_names = [line.split(" ")[0].strip() for line in f if line.strip()]
    pairs = []
    for gt_name in gt_names:
        basename, ext = osp.splitext(osp.basename(gt_name))
        input_name = f"{filename_tmpl.format(basename)}{ext}"
        pairs.append({
            f"{input_key}_path": osp.join(input_folder, input_name),
            f"{gt_key}_path": osp.join(gt_folder, gt_name),
        })
    return pairs


def paired_paths_from_lmdb(folders: Sequence[str],
                           keys: Sequence[str]) -> list[dict]:
    """Pairing from LMDB shards (data_util.py:92-156): both folders must be
    ``*.lmdb`` envs; keys (basenames without extension) come from each
    shard's ``meta_info.txt`` and must match across shards. The returned
    'paths' are the shared lmdb keys."""
    assert len(folders) == 2 and len(keys) == 2
    input_folder, gt_folder = folders
    input_key, gt_key = keys
    if not (str(input_folder).endswith(".lmdb")
            and str(gt_folder).endswith(".lmdb")):
        raise ValueError(
            f"{input_key}/{gt_key} folders must both be .lmdb envs; got "
            f"{input_folder!r}, {gt_folder!r}")

    def meta_keys(folder):
        with open(osp.join(folder, "meta_info.txt")) as f:
            return [line.split(".")[0] for line in f if line.strip()]

    input_keys, gt_keys = meta_keys(input_folder), meta_keys(gt_folder)
    if set(input_keys) != set(gt_keys):
        raise ValueError(f"keys in {input_key} and {gt_key} lmdb shards "
                         "differ")
    return [{f"{input_key}_path": k, f"{gt_key}_path": k}
            for k in sorted(input_keys)]


def _numeric_prefix_key(name: str):
    """Sort key: leading integer before '_' (paired_image_dataset.py:60)."""
    return int(name.split("_")[0])


def paired_multipaths_from_folder(
    folders: Sequence[str],
    keys: Sequence[str],
    num_pairs: int = 3,
    stride_range: Sequence[int] = (1, 5),
    seed: int = 0,
) -> list[list[dict]]:
    """Temporal grouping (paired_image_dataset.py:42-84): frames sorted by
    numeric prefix, groups of ``num_pairs`` consecutive frames with a
    per-group random stride in stride_range. Seeded (see module docstring).
    """
    assert len(folders) == 2 and len(keys) == 2
    input_folder, gt_folder = folders
    input_key, gt_key = keys
    input_files = sorted(scan_files(input_folder), key=_numeric_prefix_key)
    gt_files = sorted(scan_files(gt_folder), key=_numeric_prefix_key)
    assert len(input_files) == len(gt_files), "different number of images"

    rng = np.random.default_rng(seed)
    lo, hi = stride_range
    n = len(gt_files)
    groups = []
    for i in range(0, n - max(lo, hi) * (num_pairs - 1)):
        stride = int(rng.integers(lo, hi + 1))
        if i + (num_pairs - 1) * stride >= n:
            continue
        group = []
        for j in range(num_pairs):
            idx = i + j * stride
            group.append({
                f"{input_key}_path": osp.join(input_folder, input_files[idx]),
                f"{gt_key}_path": osp.join(gt_folder, gt_files[idx]),
            })
        groups.append(group)
    return groups
