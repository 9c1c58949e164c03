"""The port's LMDB codec, shard writer and lmdb file backend against the
JAX package's: byte-identical shards, each package reading the other's,
the same keys from make_lmdb_from_folder / paths_from_lmdb, bytes equal
to the disk files', and a seeded fuzz of corrupted shards (every outcome a
clean read or LmdbError, never another exception, never a hang)."""

import os

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from rethink_acoustic_image_enhancement_tpu.data import lmdb_codec as jcodec
from rethink_acoustic_image_enhancement_tpu.data import lmdb_util as jutil
from rethink_acoustic_image_enhancement_tpu_torch.data import lmdb_codec as tcodec
from rethink_acoustic_image_enhancement_tpu_torch.data import lmdb_util as tutil
from rethink_acoustic_image_enhancement_tpu_torch.data.file_client import FileClient
from rethink_acoustic_image_enhancement_tpu_torch.utils.image_io import imwrite


def _items(n, seed, big_every=3):
    """n keys with inline values and, every ``big_every``, overflow-page
    values (F_BIGDATA chains)."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        size = (int(rng.integers(2000, 20000)) if i % big_every == 0
                else int(rng.integers(1, 60)))
        out[f"key_{i:05d}"] = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    return out


def _data(path):
    with open(os.path.join(path, "data.mdb"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("n", [0, 2, 40, 1500])
def test_write_lmdb_is_byte_identical_to_jax(tmp_path, n):
    items = _items(n, seed=n)
    a, b = str(tmp_path / "port.lmdb"), str(tmp_path / "jax.lmdb")
    assert tcodec.write_lmdb(a, items.items()) == jcodec.write_lmdb(b, items.items()) == n
    assert _data(a) == _data(b)
    # and a file written in MDB_NOSUBDIR mode
    tcodec.write_lmdb(str(tmp_path / "port.mdb"), items.items(), subdir=False)
    jcodec.write_lmdb(str(tmp_path / "jax.mdb"), items.items(), subdir=False)
    assert (tmp_path / "port.mdb").read_bytes() == (tmp_path / "jax.mdb").read_bytes()


def test_each_reader_reads_the_other_packages_shards(tmp_path):
    items = _items(1500, seed=1)  # a two-level B+tree with overflow chains
    port, jax_ = str(tmp_path / "port.lmdb"), str(tmp_path / "jax.lmdb")
    tcodec.write_lmdb(port, items.items())
    jcodec.write_lmdb(jax_, items.items())
    for reader, path in ((tcodec.LmdbReader, jax_), (jcodec.LmdbReader, port)):
        r = reader(path)
        assert (r.entries, r.depth) == (1500, 2)
        assert [k.decode() for k in r.keys()] == sorted(items)
        for k, v in items.items():
            assert r.get(k) == v
        assert r.get("missing") is None


def _write_folder(root, n=5, h=40, w=48, seed=7):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        imwrite(os.path.join(root, f"{i:03d}.png"),
                rng.integers(0, 256, (h, w, 3), dtype=np.uint8), rgb=False)
    # one grayscale image: meta_info records its single channel
    imwrite(os.path.join(root, "gray.png"), rng.integers(0, 256, (h, w), dtype=np.uint8))


def test_make_lmdb_from_folder_matches_jax(tmp_path):
    pytest.importorskip("cv2")
    folder = str(tmp_path / "gt")
    _write_folder(folder)
    port, jax_ = str(tmp_path / "port.lmdb"), str(tmp_path / "jax.lmdb")
    assert tutil.make_lmdb_from_folder(folder, port) == \
        jutil.make_lmdb_from_folder(folder, jax_) == 6
    route = tutil.lmdb_route()
    assert route in ("codec", "lmdb")
    if route == "codec":  # both packages wrote through their codecs
        assert _data(port) == _data(jax_)
    assert (tmp_path / "port.lmdb" / "meta_info.txt").read_text() == \
        (tmp_path / "jax.lmdb" / "meta_info.txt").read_text()
    assert tutil.paths_from_lmdb(port) == jutil.paths_from_lmdb(jax_) == \
        ["000", "001", "002", "003", "004", "gray"]
    assert "gray.png (40,48,1) 1" in (tmp_path / "port.lmdb" / "meta_info.txt").read_text()
    with pytest.raises(ValueError, match=".lmdb"):
        tutil.make_lmdb_from_folder(folder, str(tmp_path / "x"))


def test_lmdb_backend_gives_the_files_pixels(tmp_path):
    import cv2

    folder = str(tmp_path / "gt")
    _write_folder(folder)
    tutil.make_lmdb_from_folder(folder, str(tmp_path / "gt.lmdb"))
    tutil.make_lmdb_from_folder(folder, str(tmp_path / "lq.lmdb"))
    client = FileClient("lmdb", db_paths=[str(tmp_path / "lq.lmdb"), str(tmp_path / "gt.lmdb")],
                        client_keys=["lq", "gt"])
    for key in ("003", "gray"):
        for ck in ("lq", "gt"):
            buf = client.get(key, ck)
            dec = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_UNCHANGED)
            ref = cv2.imread(os.path.join(folder, f"{key}.png"), cv2.IMREAD_UNCHANGED)
            np.testing.assert_array_equal(dec, ref)
    assert client.get("missing", "gt") is None
    with pytest.raises(ValueError, match="client keys"):
        FileClient("lmdb", db_paths=[str(tmp_path / "gt.lmdb")], client_keys=["a", "b"])


def test_codec_errors_are_the_packages_type(tmp_path):
    path = str(tmp_path / "short.lmdb")
    os.makedirs(path)
    with open(os.path.join(path, "data.mdb"), "wb") as f:
        f.write(b"\0" * 100)
    with pytest.raises(tcodec.LmdbError, match="truncated"):
        tcodec.LmdbReader(path)
    assert issubclass(tcodec.LmdbError, ValueError)


@pytest.fixture(scope="module")
def clean_shard(tmp_path_factory):
    """A valid shard with leaves, a branch level and overflow chains."""
    path = str(tmp_path_factory.mktemp("fuzz") / "clean.lmdb")
    items = _items(120, seed=5, big_every=10)
    tcodec.write_lmdb(path, items.items())
    return _data(path), items


def _outcome(reader_cls, path):
    """('ok', items) or ('error', None); any other exception escapes."""
    try:
        r = reader_cls(path)
        got = list(r.items())
        r.get(b"key_00003")
        r.get(b"definitely-missing")
        return "ok", got
    except ValueError as exc:
        assert type(exc).__name__ == "LmdbError", repr(exc)
        return "error", None


@settings(max_examples=60, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(flips=st.lists(st.tuples(st.integers(0, 10 ** 9), st.integers(0, 255)),
                      min_size=1, max_size=8),
       cut=st.one_of(st.none(), st.integers(0, 10 ** 9)))
def test_corrupted_shards_fail_cleanly_and_as_jax(tmp_path_factory, clean_shard, flips, cut):
    """Random byte flips and truncations: the port's reader ends in a
    clean read or LmdbError, never another exception or a hang, and in the
    same outcome as the JAX package's reader."""
    clean, _ = clean_shard
    buf = bytearray(clean)
    for pos, val in flips:
        buf[pos % len(buf)] = val
    if cut is not None:
        buf = buf[:cut % len(buf)]
    path = str(tmp_path_factory.mktemp("case") / "c.lmdb")
    os.makedirs(path)
    with open(os.path.join(path, "data.mdb"), "wb") as f:
        f.write(bytes(buf))
    assert _outcome(tcodec.LmdbReader, path) == _outcome(jcodec.LmdbReader, path)
