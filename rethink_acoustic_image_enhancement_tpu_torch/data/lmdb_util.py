"""LMDB corpus creation (utils/lmdb_util.py + create_lmdb.py of the
reference).

``make_lmdb_from_folder`` packs an image folder into one LMDB shard in the
BasicSR layout: keys are basenames without extension, values are the
images re-encoded as PNG at ``compress_level``, and ``meta_info.txt`` holds
one "key.png (h,w,c) compress_level" line per image. It writes through the
``lmdb`` package where it is installed, else through ``data/lmdb_codec.py``
(the same on-disk format). ``paths_from_lmdb`` lists a shard's keys from
its meta_info.txt. Reading and re-encoding needs cv2.
"""

from __future__ import annotations

import os.path as osp

from ..utils.image_io import list_images


def make_lmdb_from_folder(folder: str, lmdb_path: str, batch: int = 100,
                          compress_level: int = 1,
                          map_size: int | None = None) -> int:
    """Write every image of ``folder`` into the shard ``lmdb_path`` (which
    must end in '.lmdb'); returns the number of images. ``batch`` is
    accepted for the reference's signature; the shard is written in one
    transaction."""
    import cv2

    if not lmdb_path.endswith(".lmdb"):
        raise ValueError("lmdb_path must end with '.lmdb'")
    paths = list_images(folder)
    if not paths:
        raise ValueError(f"no images in {folder}")

    items, lines = [], []
    for path in paths:
        key = osp.splitext(osp.basename(path))[0]
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        h, w = img.shape[:2]
        c = 1 if img.ndim == 2 else img.shape[2]
        _, buf = cv2.imencode(".png", img,
                              [cv2.IMWRITE_PNG_COMPRESSION, compress_level])
        items.append((key.encode("ascii"), buf.tobytes()))
        lines.append(f"{key}.png ({h},{w},{c}) {compress_level}")

    try:
        import lmdb
    except ImportError:
        from .lmdb_codec import write_lmdb

        write_lmdb(lmdb_path, items)
    else:
        if map_size is None:
            map_size = sum(len(v) for _, v in items) * 10 + (1 << 20)
        env = lmdb.open(lmdb_path, map_size=map_size)
        with env.begin(write=True) as txn:
            for k, v in items:
                txn.put(k, v)
        env.close()
    with open(osp.join(lmdb_path, "meta_info.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return len(paths)


def lmdb_route() -> str:
    """'lmdb' where the package is installed, else 'codec'."""
    try:
        import lmdb  # noqa: F401
    except ImportError:
        return "codec"
    return "lmdb"


def paths_from_lmdb(lmdb_path: str) -> list[str]:
    """The keys a shard's meta_info.txt lists (data_util.py lmdb pairing)."""
    with open(osp.join(lmdb_path, "meta_info.txt")) as f:
        return [line.split(".")[0] for line in f if line.strip()]
