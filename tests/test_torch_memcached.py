"""The port's memcached file backend through a fake ``mc`` module (the
protocol of Train/basicsr/utils/file_client.py:20-60:
``MemcachedClient.GetInstance(server_cfg, client_cfg)``, ``Get(filepath,
pyvector)``, ``ConvertBuffer(pyvector)``), injected through the backend's
``sys_path``, as tests/test_memcached_backend.py holds the JAX package's;
and a dataset reading through it."""

import sys

import numpy as np
import pytest

from rethink_acoustic_image_enhancement_tpu.data.file_client import FileClient as JaxFileClient
from rethink_acoustic_image_enhancement_tpu_torch.data import datasets as tds
from rethink_acoustic_image_enhancement_tpu_torch.data.file_client import FileClient
from rethink_acoustic_image_enhancement_tpu_torch.utils.image_io import imwrite

FAKE_MC = '''
"""Fake `mc` memcached client, serving files from disk."""

INSTANCES = []


class pyvector:
    def __init__(self):
        self.data = None


class MemcachedClient:
    def __init__(self, server_list_cfg, client_cfg):
        self.server_list_cfg = server_list_cfg
        self.client_cfg = client_cfg
        self.gets = []

    @staticmethod
    def GetInstance(server_list_cfg, client_cfg):
        inst = MemcachedClient(server_list_cfg, client_cfg)
        INSTANCES.append(inst)
        return inst

    def Get(self, filepath, buf):
        self.gets.append(filepath)
        with open(filepath, "rb") as f:
            buf.data = f.read()


def ConvertBuffer(buf):
    return buf.data
'''


@pytest.fixture
def fake_mc_dir(tmp_path):
    mod_dir = tmp_path / "fake_site"
    mod_dir.mkdir()
    (mod_dir / "mc.py").write_text(FAKE_MC)
    saved_path = list(sys.path)
    saved_mod = sys.modules.pop("mc", None)
    yield str(mod_dir)
    sys.path[:] = saved_path
    sys.modules.pop("mc", None)
    if saved_mod is not None:
        sys.modules["mc"] = saved_mod


def test_memcached_round_trip_as_jax(fake_mc_dir, tmp_path):
    payload = b"\x89PNG fake bytes \x00\x01"
    f = tmp_path / "img.png"
    f.write_bytes(payload)
    kw = dict(server_list_cfg="/etc/mc/server_list.conf",
              client_cfg="/etc/mc/client.conf", sys_path=fake_mc_dir)
    client = FileClient("memcached", **kw)
    assert client.get(str(f)) == payload
    import mc

    inst = mc.INSTANCES[-1]
    assert (inst.server_list_cfg, inst.client_cfg) == (kw["server_list_cfg"], kw["client_cfg"])
    assert inst.gets == [str(f)]
    # the JAX package's client gives the same bytes through the same calls
    assert JaxFileClient("memcached", **kw).get(str(f)) == payload
    assert mc.INSTANCES[-1].gets == [str(f)]


def test_memcached_key_is_stringified(fake_mc_dir, tmp_path):
    f = tmp_path / "x.bin"
    f.write_bytes(b"abc123")
    client = FileClient("memcached", server_list_cfg="s", client_cfg="c", sys_path=fake_mc_dir)
    assert client.get(f) == b"abc123"  # a pathlib.Path key
    import mc

    assert all(isinstance(k, str) for k in mc.INSTANCES[-1].gets)


def test_memcached_missing_client_raises_importerror(tmp_path, monkeypatch):
    # no client importable: none in sys.modules, none on the path
    monkeypatch.delitem(sys.modules, "mc", raising=False)
    monkeypatch.setattr(sys, "path", list(sys.path))
    empty = tmp_path / "empty_site"
    empty.mkdir()
    with pytest.raises(ImportError, match="mc"):
        FileClient("memcached", server_list_cfg="s", client_cfg="c", sys_path=str(empty))


def test_dataset_reads_through_memcached(fake_mc_dir, tmp_path):
    """A paired dataset with io_backend memcached reads the disk route's
    items, every read a Get of the file's path."""
    pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    for sub in ("lq", "gt"):
        (tmp_path / sub).mkdir()
        for i in range(3):
            imwrite(str(tmp_path / sub / f"{i}.png"), rng.integers(0, 256, (20, 24, 3), dtype=np.uint8))
    base = {"type": "Dataset_PairedImage", "phase": "train", "gt_size": 16, "scale": 1,
            "geometric_augs": True, "seed": 1,
            "dataroot_lq": str(tmp_path / "lq"), "dataroot_gt": str(tmp_path / "gt")}
    disk = tds.create_dataset(base)
    mem = tds.create_dataset(dict(base, io_backend={
        "type": "memcached", "server_list_cfg": "s", "client_cfg": "c",
        "sys_path": fake_mc_dir}))
    for i in range(3):
        for k in ("lq", "gt"):
            np.testing.assert_array_equal(disk[i][k], mem[i][k])
    import mc

    assert sorted(set(mc.INSTANCES[-1].gets)) == sorted(
        str(tmp_path / s / f"{i}.png") for s in ("lq", "gt") for i in range(3))
