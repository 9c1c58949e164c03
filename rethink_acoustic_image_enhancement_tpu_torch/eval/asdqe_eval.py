"""ASDQE evaluation protocol, the paper's benchmark harness (ASDQE_test.py).

Score each method directory against the originals (name-matched sorted
pairs), compute per-method statistics (mean/std/min/25/50/75/max), print a
comparison table, and write ``stats_transposed.csv`` in the reference's
layout and precision.
"""

from __future__ import annotations

import csv
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Mapping, Sequence

import numpy as np

from ..utils.image_io import imread_rgb_ubyte
from .infer import ASDQEScorer

STAT_KEYS = ("mean", "std", "min", "25%", "50%", "75%", "max")


def paired_files(lq_dir: str, method_dir: str) -> list[tuple[str, str]]:
    """Name-matched sorted pairing (ASDQE_test.py:26-50); raises on a count
    or basename mismatch, like the reference."""
    lq_files = sorted(os.listdir(lq_dir))
    gt_files = sorted(os.listdir(method_dir))
    if len(lq_files) != len(gt_files):
        raise ValueError(
            f"image count mismatch: {len(lq_files)} in {lq_dir} vs "
            f"{len(gt_files)} in {method_dir}")
    for a, b in zip(lq_files, gt_files):
        if os.path.splitext(a)[0] != os.path.splitext(b)[0]:
            raise ValueError(f"file names do not match: {a} vs {b}")
    return [(os.path.join(lq_dir, a), os.path.join(method_dir, b))
            for a, b in zip(lq_files, gt_files)]


def calculate_statistics(values: np.ndarray) -> dict[str, float]:
    """ASDQE_test.py:107-119."""
    return {
        "mean": float(np.mean(values)),
        "std": float(np.std(values)),
        "min": float(np.min(values)),
        "25%": float(np.percentile(values, 25)),
        "50%": float(np.percentile(values, 50)),
        "75%": float(np.percentile(values, 75)),
        "max": float(np.max(values)),
    }


def score_pairs(scorer: ASDQEScorer, items: Sequence,
                load: Callable = lambda pair: pair) -> np.ndarray:
    """Batch-1 scores of ``items`` in order, as float64; ``load(item)``
    gives the (lq, gt) arrays of one. A one-slot worker thread loads and
    uploads pair k+1 while pair k computes and pair k-1's score is fetched,
    so the scores are those of the plain sequential loop."""
    preds = []
    pending = None

    def load_upload(item):
        return scorer.upload(*load(item))

    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(load_upload, items[0]) if items else None
        for i in range(len(items)):
            uploaded = fut.result()
            fut = (ex.submit(load_upload, items[i + 1])
                   if i + 1 < len(items) else None)
            handle = scorer.dispatch(uploaded)
            if pending is not None:
                preds.append(pending.reshape(-1)[0].item())
            pending = handle
    if pending is not None:
        preds.append(pending.reshape(-1)[0].item())
    return np.asarray(preds, np.float64)


def score_method(scorer: ASDQEScorer, lq_dir: str, method_dir: str,
                 verbose: bool = True) -> np.ndarray:
    """Batch-1 scores of one method directory against the originals (the
    images differ in size, so each pair is its own forward); files are
    decoded to uint8 on the worker."""
    return score_pairs(scorer, paired_files(lq_dir, method_dir),
                       lambda pq: (imread_rgb_ubyte(pq[0]), imread_rgb_ubyte(pq[1])))


def run_asdqe_eval(
    scorer: ASDQEScorer,
    base_lq_dir: str,
    methods: Mapping[str, str],
    csv_path: str | None = "stats_transposed.csv",
    verbose: bool = True,
) -> dict[str, dict[str, float]]:
    """Evaluate every method dir against the originals; returns
    {method: stats}."""
    all_stats: dict[str, dict[str, float]] = {}
    for name, gt_dir in methods.items():
        if verbose:
            print(f"===== Processing denoising method: {name} =====")
        stats = calculate_statistics(score_method(scorer, base_lq_dir, gt_dir,
                                                  verbose))
        all_stats[name] = stats
        if verbose:
            for k in STAT_KEYS:
                print(f"{k}: {stats[k]:.6f}")
    if verbose:
        print("\n===== Statistical data comparison of different denoising methods =====")
        print(format_stats_table(all_stats))
    if csv_path:
        write_stats_csv(all_stats, csv_path)
    return all_stats


def format_stats_table(all_stats: Mapping[str, Mapping[str, float]]) -> str:
    methods = list(all_stats)
    rows = [" ".join([f"{'':>6}"] + [f"{m:>14}" for m in methods])]
    for k in STAT_KEYS:
        rows.append(" ".join(
            [f"{k:>6}"] + [f"{all_stats[m][k]:>14.6f}" for m in methods]))
    return "\n".join(rows)


def write_stats_csv(all_stats: Mapping[str, Mapping[str, float]],
                    path: str) -> None:
    """Transposed CSV: rows = stats, columns = methods (ASDQE_test.py:128-133
    pandas ``stats_df.T.to_csv`` layout, float_format %.6f)."""
    methods = list(all_stats)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow([""] + methods)
        for k in STAT_KEYS:
            writer.writerow([k] + [f"{all_stats[m][k]:.6f}" for m in methods])


def default_methods(sample_root: str, dataset: str = "MDD") -> tuple[str, dict]:
    """The reference's shipped protocol (ASDQE_test.py:139-149)."""
    base = os.path.join(sample_root, dataset, "origin")
    denoise = os.path.join(sample_root, dataset, "denoise")
    return base, {
        "origin": base,
        "Teacher": os.path.join(denoise, "KDLAE-T"),
        "Student@0.05": os.path.join(denoise, "KDLAE-S_prob@0.05"),
    }
