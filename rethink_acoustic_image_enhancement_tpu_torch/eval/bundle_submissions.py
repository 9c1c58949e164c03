"""DND benchmark submission bundler (port of
Train/basicsr/utils/bundle_submissions.py — stock BasicSR tooling for the
Darmstadt Noise Dataset; the acoustic path does not use it). Needs
scipy.

Collects the 50 images x 20 crops of per-crop ``%04d_%02d.mat`` files
(each holding 'Idenoised_crop') into 50 bundled ``%04d.mat`` files with
the benchmark's expected keys.
"""

from __future__ import annotations

import os

import numpy as np


def _bundle(submission_folder: str, session: str, israw: bool,
            eval_version: str = "1.0", num_images: int = 50,
            num_blocks: int = 20) -> str:
    import scipy.io as sio

    out_folder = os.path.join(submission_folder, session)
    os.makedirs(out_folder, exist_ok=True)
    for i in range(num_images):
        denoised = np.zeros((num_blocks,), dtype=object)
        for bb in range(num_blocks):
            name = f"{i + 1:04d}_{bb + 1:02d}.mat"
            s = sio.loadmat(os.path.join(submission_folder, name))
            denoised[bb] = s["Idenoised_crop"]
        sio.savemat(
            os.path.join(out_folder, f"{i + 1:04d}.mat"),
            {"Idenoised": denoised, "israw": israw,
             "eval_version": eval_version})
    return out_folder


def bundle_submissions_raw(submission_folder: str, session: str,
                           **kw) -> str:
    return _bundle(submission_folder, session, israw=True, **kw)


def bundle_submissions_srgb(submission_folder: str, session: str,
                            **kw) -> str:
    return _bundle(submission_folder, session, israw=False, **kw)
