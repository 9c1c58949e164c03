"""Export the in-repo orbax model zoo to reference-layout ``.pth`` files that
the PyTorch port loads without JAX, orbax or zstd.

    python scripts/export_torch_zoo.py [--out DIR] [--only NAME ...]

Runs on the CPU and imports the JAX package (its orbax loader and its
``convert/torch_export.py`` name mapping). Writes, into
``artifacts/torch_zoo/`` by default:

  teacher.pth          kdlaet_full50k, bfloat16 as stored
  student-us.pth       kdlaes_full100k, float32
  student-fls.pth      kdlaes_flsft5k, float32
  asdqe.pth            asdqe_full50ep, float32, with its BatchNorm statistics
  manifest.json        each file's source, arch, dtype, parameter count, sha256

Each file is ``{"params": state_dict}`` with the names of
``export_teacher`` / ``export_student`` / ``export_asdqe``. bfloat16 arrays
go to torch through a ``uint16`` view (``torch.from_numpy`` refuses
``ml_dtypes.bfloat16``, so ``torch_export.save_pth`` cannot write a bf16
teacher). ``--only teacher-l2dice`` also writes the second teacher
(kdlaet_l2dice50k), which is not committed. The output is deterministic:
running the script twice gives the same bytes.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# name -> (repo-relative orbax dir, arch)
ENTRIES = {
    "teacher": ("artifacts/kdlaet_full50k/weights/net_g_50000_bf16",
                "KDLAE_teacher"),
    "student-us": ("artifacts/kdlaes_full100k/weights/net_g_100000",
                   "KDLAE_student"),
    "student-fls": ("artifacts/kdlaes_flsft5k/weights/net_g_5000",
                    "KDLAE_student"),
    "asdqe": ("artifacts/asdqe_full50ep/weights/net_g_best",
              "DenoiseRatePredictor"),
    "teacher-l2dice": ("artifacts/kdlaet_l2dice50k/weights/net_g_50000_bf16",
                       "KDLAE_teacher"),
}
COMMITTED = ("teacher", "student-us", "student-fls", "asdqe")


def to_torch(a):
    """A numpy array (bfloat16 included) -> a torch tensor of its dtype."""
    import numpy as np
    import torch

    a = np.array(a, order="C")  # a copy; 0-d arrays stay 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def reference_state_dict(name: str) -> dict:
    """The zoo entry's reference-layout state dict as numpy arrays, read
    through the JAX package's orbax loader."""
    import jax
    import numpy as np

    from rethink_acoustic_image_enhancement_tpu.convert.torch_export import (
        export_asdqe,
        export_student,
        export_teacher,
    )
    from rethink_acoustic_image_enhancement_tpu.train.checkpoints import (
        load_asdqe_weights,
        load_weights,
    )

    rel, arch = ENTRIES[name]
    path = os.path.join(REPO, rel)
    if arch == "DenoiseRatePredictor":
        params, stats = load_asdqe_weights(path)
        host = jax.tree_util.tree_map(np.asarray, (params, stats))
        return export_asdqe(*host)
    params = jax.tree_util.tree_map(np.asarray, load_weights(path))
    return (export_teacher if arch == "KDLAE_teacher" else export_student)(params)


def serialize(sd: dict) -> bytes:
    import torch

    buf = io.BytesIO()
    torch.save({"params": {k: to_torch(v) for k, v in sorted(sd.items())}}, buf)
    return buf.getvalue()


def export(name: str, out_dir: str) -> dict:
    """Write ``<name>.pth`` and return its manifest entry."""
    import numpy as np

    sd = reference_state_dict(name)
    data = serialize(sd)
    with open(os.path.join(out_dir, f"{name}.pth"), "wb") as fh:
        fh.write(data)
    floats = [v for v in sd.values() if np.issubdtype(v.dtype, np.floating)
              or v.dtype.name == "bfloat16"]
    rel, arch = ENTRIES[name]
    return {"file": f"{name}.pth", "source": rel, "arch": arch,
            "dtype": sorted({v.dtype.name for v in floats}),
            "parameters": int(sum(v.size for v in floats)),
            "bytes": len(data), "sha256": hashlib.sha256(data).hexdigest()}


def main(argv=None) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "artifacts", "torch_zoo"))
    ap.add_argument("--only", nargs="+", choices=sorted(ENTRIES), default=None,
                    help="export these entries (default: the committed four)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    manifest_path = os.path.join(args.out, "manifest.json")
    manifest = {}
    if os.path.exists(manifest_path):
        with open(manifest_path) as fh:
            manifest = json.load(fh)
    for name in args.only or COMMITTED:
        manifest[name] = export(name, args.out)
        print(f"{ENTRIES[name][0]} -> {os.path.join(args.out, name + '.pth')} "
              f"({manifest[name]['parameters']} parameters, "
              f"{manifest[name]['bytes']} bytes)")
    with open(manifest_path, "w") as fh:
        json.dump(dict(sorted(manifest.items())), fh, indent=1, sort_keys=True)
        fh.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
