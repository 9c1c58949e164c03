"""Orbax checkpoints in the port without JAX (``convert/orbax.py``,
``convert/ocdbt.py``, ``utils/zstd.py``), held to orbax, tensorstore and the
JAX package on the CPU:

  * ``read_checkpoint`` on each of the six weights directories in the repo
    gives the JAX package's ``load_weights`` tree, bit for bit; the Python
    decoder reads every manifest and node of them, and one student's data;
  * trees that orbax writes (OCDBT and plain layouts; float32, bfloat16,
    int32, 0-d, scalar and sequence leaves; a chunked array) read back;
    tensorstore databases with interior nodes and old versions, and
    per-process databases merged as orbax merges them, read back;
  * ``write_checkpoint``'s directories restore through JAX's ``load_weights``
    bit for bit;
  * ``raie-torch convert`` (both ways) against ``raie convert`` and the zoo's
    ``.pth`` files;
  * ``--weights <dir>``, the ``teacher-l2dice`` alias, ``pretrain_network_g:
    <dir>`` and ``teacher_weights: <dir>`` load what the ``.pth`` route loads.
"""

import hashlib
import json
import os
import shutil
import struct
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from rethink_acoustic_image_enhancement_tpu.cli import main as jax_main
from rethink_acoustic_image_enhancement_tpu.convert.torch_export import export_asdqe
from rethink_acoustic_image_enhancement_tpu.train.checkpoints import (
    load_asdqe_weights as jax_load_asdqe_weights,
)
from rethink_acoustic_image_enhancement_tpu.train.checkpoints import (
    load_weights as jax_load_weights,
)
from rethink_acoustic_image_enhancement_tpu_torch import cli
from rethink_acoustic_image_enhancement_tpu_torch.convert import ocdbt
from rethink_acoustic_image_enhancement_tpu_torch.convert import orbax as po
from rethink_acoustic_image_enhancement_tpu_torch.convert import weights as w
from rethink_acoustic_image_enhancement_tpu_torch.models import (
    KDLAEStudent,
    build_network,
    flagship_teacher,
)
from rethink_acoustic_image_enhancement_tpu_torch.train import checkpoints as ckpt
from rethink_acoustic_image_enhancement_tpu_torch.train import config as tcfg
from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop
from rethink_acoustic_image_enhancement_tpu_torch.utils import zstd
from rethink_acoustic_image_enhancement_tpu_torch.utils.image_io import (
    imread_gray,
    imread_rgb_ubyte,
    imwrite,
    list_images,
)

ocp = pytest.importorskip("orbax.checkpoint")
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIRS = {
    "teacher": "artifacts/kdlaet_full50k/weights/net_g_50000_bf16",
    "teacher-l2dice": "artifacts/kdlaet_l2dice50k/weights/net_g_50000_bf16",
    "student-us": "artifacts/kdlaes_full100k/weights/net_g_100000",
    "student-fls100k": "artifacts/kdlaes_fls100k/weights/net_g_100000",
    "student-fls": "artifacts/kdlaes_flsft5k/weights/net_g_5000",
    "asdqe": "artifacts/asdqe_full50ep/weights/net_g_best",
}
ZOO = os.path.join(REPO, "artifacts", "torch_zoo")
NARROW_TEACHER = {"type": "KDLAE_teacher", "inp_channels": 3, "out_channels": 3,
                  "dim": 8, "num_blocks": [1, 1, 1, 1], "num_refinement_blocks": 1,
                  "heads": [1, 2, 4, 8], "ffn_expansion_factor": 2.66, "bias": False,
                  "LayerNorm_type": "BiasFree", "dual_pixel_task": False,
                  "static": "test", "params": "cat"}


def _dir(name):
    return os.path.join(REPO, DIRS[name])


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _bits(a):
    """Comparable (dtype name, shape, bytes) of a port or JAX leaf."""
    if isinstance(a, (int, float, bool)):
        return type(a).__name__, (), repr(a)
    a = np.asarray(a)
    name = "bfloat16" if a.dtype == po.BF16 else a.dtype.name
    return name, a.shape, np.ascontiguousarray(a).tobytes()


def _assert_same_tree(ours, theirs, ordered=True):
    ours, theirs = dict(_flat(ours)), dict(_flat(jax.tree.map(
        lambda x: x if isinstance(x, (int, float, bool)) else np.asarray(x), theirs)))
    assert (list(ours) == list(theirs)) if ordered else (sorted(ours) == sorted(theirs))
    for key in ours:
        assert _bits(ours[key]) == _bits(theirs[key]), key


def _state(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def _assert_same_state(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


# ---------------------------------------------------------- the six in-repo --

@pytest.mark.parametrize("name", list(DIRS))
def test_read_checkpoint_matches_jax(name):
    _assert_same_tree(po.read_checkpoint(_dir(name)), jax_load_weights(_dir(name), None))


@pytest.mark.parametrize("name", list(DIRS))
def test_python_decoder_reads_every_manifest_and_node(name):
    native = ocdbt.Database(_dir(name))
    python = ocdbt.Database(_dir(name), decoder="python")
    assert python.keys() == native.keys()
    assert all(python.get(k) == native.get(k) for k in native.keys())
    if name == "student-fls":  # and one student's zstd chunks
        _assert_same_tree(po.read_checkpoint(_dir(name), decoder="python"),
                          po.read_checkpoint(_dir(name)))


def test_asdqe_payload_unwrap_matches_jax():
    params, stats = po.load_asdqe_weights(_dir("asdqe"))
    jp, js = jax_load_asdqe_weights(_dir("asdqe"))
    _assert_same_tree({"p": params, "s": stats}, {"p": jp, "s": js})
    assert po.load_asdqe_weights(os.path.join(REPO, "no-such-dir")) is None


# ------------------------------------------------------ orbax-written trees --

def _orbax_tree():
    ml_dtypes = pytest.importorskip("ml_dtypes")
    rng = np.random.default_rng(0)
    return {
        "params": {
            "conv": {"kernel": rng.standard_normal((3, 3, 4, 5)).astype(np.float32),
                     "bias": rng.standard_normal(5).astype(np.float32)},
            "half": rng.standard_normal((6, 7)).astype(ml_dtypes.bfloat16),
            "index": np.arange(-3, 9, dtype=np.int32).reshape(3, 4),
            "temperature": np.array(0.25, np.float32),
            "count": np.array(7, np.int64),
            "pair": [np.arange(3, dtype=np.float32), np.ones((2, 2), np.int32)],
            "chunked": rng.standard_normal((5, 7)).astype(np.float32),
        },
        "batch_stats": {"bn": {"mean": np.zeros(4, np.float32),
                               "var": np.ones(4, np.float32)}},
        "step": 12,
    }


@pytest.mark.parametrize("use_ocdbt", [True, False], ids=["ocdbt", "plain"])
def test_orbax_written_trees_read_back(tmp_path, use_ocdbt):
    ts = pytest.importorskip("tensorstore")
    path = str(tmp_path / "ckpt")
    ckptr = ocp.Checkpointer(ocp.StandardCheckpointHandler(use_ocdbt=use_ocdbt))
    ckptr.save(path, args=ocp.args.StandardSave(_orbax_tree()))
    # rewrite one leaf in chunks of (2, 3): edge chunks are cropped
    kvstore = ({"driver": "ocdbt", "base": f"file://{path}/"} if use_ocdbt
               else f"file://{path}/params.chunked/")
    spec = {"driver": "zarr", "kvstore": kvstore,
            "metadata": {"shape": [5, 7], "chunks": [2, 3], "dtype": "<f4",
                         "compressor": {"id": "zstd", "level": 3}}}
    if use_ocdbt:
        spec["path"] = "params.chunked"
    arr = ts.open(spec, create=True, delete_existing=True).result()
    arr[...] = np.arange(35, dtype=np.float32).reshape(5, 7) - 17
    ours = po.read_checkpoint(path)
    _assert_same_tree(ours, jax_load_weights(path, None))
    assert ours["step"] == 12 and isinstance(ours["params"]["pair"], list)
    np.testing.assert_array_equal(ours["params"]["chunked"],
                                  np.arange(35, dtype=np.float32).reshape(5, 7) - 17)
    # the scorer's nested payload, as train-asdqe saves it
    nested = str(tmp_path / "asdqe")
    ckptr.save(nested, args=ocp.args.StandardSave(
        {"params": {"params": {"fc1": {"kernel": np.ones((2, 3), np.float32)}},
                    "batch_stats": {"bn": {"mean": np.zeros(3, np.float32)}}}}))
    params, stats = po.load_asdqe_weights(nested)
    jp, js = jax_load_asdqe_weights(nested)
    _assert_same_tree({"p": params, "s": stats}, {"p": jp, "s": js})


def test_tensorstore_databases_with_interior_nodes_and_old_versions(tmp_path):
    """Nodes of at most 300 bytes (a B-tree of height > 1), 40 versions (a
    version tree beside the manifest's inline ones), zstd level 5 nodes."""
    ts = pytest.importorskip("tensorstore")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/db/",
                          "config": {"max_decoded_node_bytes": 300,
                                     "max_inline_value_bytes": 16,
                                     "compression": {"id": "zstd", "level": 5}}}).result()
    want = {}
    for i in range(40):
        with ts.Transaction() as txn:
            for j in range(4):
                key = f"key/{i:03d}/{j}"
                want[key] = (b"v%d-%d." % (i, j)) * (1 + 5 * j)
                kv.with_transaction(txn)[key] = want[key]
    db = ocdbt.Database(str(tmp_path / "db"))
    assert db.manifest.height > 1 and db.manifest.generation > 16
    assert db.keys() == sorted(want)
    assert all(db.get(k) == v for k, v in want.items())
    python = ocdbt.Database(str(tmp_path / "db"), decoder="python")
    assert all(python.get(k) == v for k, v in want.items())


def test_merged_per_process_databases(tmp_path):
    """Two per-process databases with interior nodes merged into the top one
    as orbax merges them (``experimental_copy_range_to`` in one atomic
    transaction): the top tree's nodes point into ``ocdbt.process_<i>/``,
    whose own nodes name their files relative to that directory."""
    ts = pytest.importorskip("tensorstore")
    ctx = ts.Context({"cache_pool#ocdbt": {"total_bytes_limit": 100000000}})
    config = {"max_decoded_node_bytes": 400, "max_inline_value_bytes": 16,
              "compression": {"id": "zstd", "level": 3}}

    def open_db(path, cfg=None):
        spec = {"driver": "ocdbt", "base": {"driver": "file", "path": str(path)},
                "cache_pool": "cache_pool#ocdbt"}
        return ts.KvStore.open(dict(spec, config=cfg) if cfg else spec, context=ctx).result()

    want = {}
    for p in range(2):
        kv = open_db(tmp_path / f"ocdbt.process_{p}", config)
        with ts.Transaction() as txn:
            for i in range(60):
                key = f"params.p{p}.leaf{i:03d}/0"
                want[key] = (b"%d-%d;" % (p, i)) * (1 + i % 7)
                kv.with_transaction(txn)[key] = want[key]
    parent = open_db(tmp_path, config)
    txn = ts.Transaction(atomic=True)
    for p in range(2):
        open_db(tmp_path / f"ocdbt.process_{p}").experimental_copy_range_to(
            parent.with_transaction(txn)).result()
    txn.commit_sync()
    db = ocdbt.Database(str(tmp_path))
    assert db.manifest.height > 1
    assert db.keys() == sorted(want)
    assert all(db.get(k) == v for k, v in want.items())


def _reframe(raw: bytes, body: bytes, version: int = 0, method: int = 0) -> bytes:
    head = raw[:4] + struct.pack("<Q", 0) + bytes([version, method])
    out = bytearray(head + body + b"\0\0\0\0")
    out[4:12] = struct.pack("<Q", len(out))
    out[-4:] = struct.pack("<I", ocdbt.crc32c(bytes(out[:-4])))
    return bytes(out)


def test_ocdbt_refuses_what_it_does_not_know(tmp_path):
    raw = open(os.path.join(_dir("student-fls"), "manifest.ocdbt"), "rb").read()
    body = zstd.decompress(raw[14:-4])
    assert ocdbt.parse_manifest(_reframe(raw, body)).num_keys == 52
    numbered = body[:16] + b"\x01" + body[17:]
    cases = {
        "format version 1": _reframe(raw, body, version=1),
        "compression method 2": _reframe(raw, body, method=2),
        "manifest kind 'numbered'": _reframe(raw, numbered),
        "CRC32C": raw[:-1] + bytes([raw[-1] ^ 1]),
        "magic": b"\x00" + raw[1:],
        "header length": raw + b"\0",
        "after its last field": _reframe(raw, body + b"\x00"),
    }
    for match, data in cases.items():
        with pytest.raises(ocdbt.OcdbtError, match=match):
            ocdbt.parse_manifest(data)
    (tmp_path / "_METADATA").write_text(json.dumps({
        "tree_metadata": {}, "use_ocdbt": False, "use_zarr3": True}))
    with pytest.raises(po.CheckpointError, match="use_zarr3"):
        po.read_checkpoint(str(tmp_path))
    with pytest.raises(po.CheckpointError, match="not an orbax checkpoint"):
        po.read_checkpoint(str(tmp_path / "missing"))


# ------------------------------------------------------------ writing --

def test_write_checkpoint_restores_in_jax(tmp_path):
    tree = _orbax_tree()
    tree["params"]["half"] = tree["params"]["half"].view(np.uint16).view(po.BF16)
    tree["params"]["from_torch"] = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)
    tree["epoch"] = 3
    path = po.write_checkpoint(str(tmp_path / "out"), tree)
    restored = jax_load_weights(path, None)
    want = dict(tree, params=dict(tree["params"],
                                  from_torch=po.from_torch(tree["params"]["from_torch"])))
    _assert_same_tree(want, restored, ordered=False)
    _assert_same_tree(po.read_checkpoint(path), restored)
    meta = json.load(open(os.path.join(path, "_METADATA")))
    assert meta["use_ocdbt"] is False
    # a second write replaces the first whole, leaving nothing beside it
    po.write_checkpoint(path, {"params": {"x": np.ones(2, np.float32)}})
    assert sorted(os.listdir(tmp_path)) == ["out"]
    _assert_same_tree(jax_load_weights(path, None), {"params": {"x": np.ones(2, np.float32)}})


def test_write_checkpoint_of_a_flat_scorer_payload(tmp_path):
    params, stats = po.load_asdqe_weights(_dir("asdqe"))
    path = po.write_checkpoint(str(tmp_path / "asdqe"), {"params": params,
                                                        "batch_stats": stats})
    jp, js = jax_load_asdqe_weights(path)
    _assert_same_tree({"p": params, "s": stats}, {"p": jp, "s": js})


# -------------------------------------------------------------- convert --

def _load_pth(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _sha256(path):
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def test_reverse_convert_matches_the_jax_cli(tmp_path):
    args = ["convert", "--arch", "KDLAE_student", "--out", _dir("student-fls"), "--reverse"]
    assert jax_main(args + ["--pth", str(tmp_path / "jax.pth")]) == 0
    assert cli.main(args + ["--pth", str(tmp_path / "port.pth")]) == 0
    ours, theirs = _load_pth(tmp_path / "port.pth"), _load_pth(tmp_path / "jax.pth")
    assert list(ours) == list(theirs) == ["params"]
    _assert_same_state(ours["params"], {k: theirs["params"][k] for k in ours["params"]})
    assert sorted(ours["params"]) == sorted(theirs["params"])
    manifest = json.load(open(os.path.join(ZOO, "manifest.json")))
    assert _sha256(tmp_path / "port.pth") == manifest["student-fls"]["sha256"]


def test_reverse_convert_of_the_scorer(tmp_path):
    """``raie convert --reverse`` fails on the nested payload train-asdqe
    writes (its export is handed {'params', 'batch_stats'} as the params);
    the port unwraps it as ``load_asdqe_weights`` does and gives the JAX
    package's own export of the unwrapped weights, the zoo's asdqe.pth."""
    args = ["convert", "--arch", "DenoiseRatePredictor", "--out", _dir("asdqe"),
            "--reverse"]
    with pytest.raises(KeyError, match="unrecognized ASDQE module"):
        jax_main(args + ["--pth", str(tmp_path / "jax.pth")])
    assert cli.main(args + ["--pth", str(tmp_path / "port.pth")]) == 0
    ours = _load_pth(tmp_path / "port.pth")["params"]
    host = jax.tree.map(np.asarray, jax_load_asdqe_weights(_dir("asdqe")))
    want = {k: torch.from_numpy(np.array(v)) for k, v in export_asdqe(*host).items()}
    _assert_same_state(ours, {k: want[k] for k in ours})
    assert sorted(ours) == sorted(want)
    manifest = json.load(open(os.path.join(ZOO, "manifest.json")))
    assert _sha256(tmp_path / "port.pth") == manifest["asdqe"]["sha256"]


def test_reverse_convert_of_the_bf16_teacher_is_the_zoo_file(tmp_path):
    assert cli.main(["convert", "--arch", "KDLAE_teacher", "--out", _dir("teacher"),
                     "--reverse", "--pth", str(tmp_path / "t.pth")]) == 0
    ours, zoo = _load_pth(tmp_path / "t.pth"), _load_pth(os.path.join(ZOO, "teacher.pth"))
    _assert_same_state(ours["params"], zoo["params"])
    assert {v.dtype for v in ours["params"].values()} == {torch.bfloat16}
    manifest = json.load(open(os.path.join(ZOO, "manifest.json")))
    assert _sha256(tmp_path / "t.pth") == manifest["teacher"]["sha256"]


@pytest.mark.parametrize("entry", ["student-fls", "asdqe"])
def test_forward_convert_matches_the_jax_cli(tmp_path, entry):
    assert cli.ARCHS == list(w.FLAX_TREES)  # the JAX CLI's five --arch choices
    arch = "KDLAE_student" if entry == "student-fls" else "DenoiseRatePredictor"
    args = ["convert", "--pth", os.path.join(ZOO, f"{entry}.pth"), "--arch", arch]
    assert jax_main(args + ["--out", str(tmp_path / "jax")]) == 0
    assert cli.main(args + ["--out", str(tmp_path / "port")]) == 0
    theirs = jax_load_weights(str(tmp_path / "jax"), None)
    _assert_same_tree(jax_load_weights(str(tmp_path / "port"), None), theirs)
    _assert_same_tree(po.read_checkpoint(str(tmp_path / "port")), theirs)


def test_reverse_then_forward_round_trips(tmp_path):
    pth, out = str(tmp_path / "fls.pth"), str(tmp_path / "fls")
    assert cli.main(["convert", "--arch", "KDLAE_student", "--out", _dir("student-fls"),
                     "--reverse", "--pth", pth]) == 0
    assert cli.main(["convert", "--arch", "KDLAE_student", "--pth", pth, "--out", out]) == 0
    _assert_same_tree(po.read_checkpoint(out), po.read_checkpoint(_dir("student-fls")))


# ------------------------------------------------------- the weights routes --

def _teacher_args(weights, rate=None):
    return SimpleNamespace(weights=weights, denoise_rate=rate, param_key="params",
                           sr=False, layernorm_type="BiasFree")


def test_teacher_weights_dir_loads_the_pth_state():
    from_dir, rate = cli._load_teacher(_teacher_args(_dir("teacher")))
    from_pth, _ = cli._load_teacher(_teacher_args(os.path.join(ZOO, "teacher.pth")))
    assert rate == 1.0
    _assert_same_state(_state(from_dir), _state(from_pth))


def test_teacher_l2dice_alias_reads_its_orbax_dir(tmp_path, capsys):
    """The alias's .pth is not committed: it reads the orbax directory the
    JAX CLI names for it, with the 0.6 preset, and serves what a .pth
    exported from that directory serves."""
    assert not os.path.exists(os.path.join(ZOO, "teacher-l2dice.pth"))
    path, rate = cli._resolve_weights("teacher-l2dice")
    assert (path, rate) == (_dir("teacher-l2dice"), 0.6)
    assert DIRS["teacher-l2dice"] in capsys.readouterr().out
    model, rate = cli._load_teacher(_teacher_args("teacher-l2dice"))
    assert rate == 0.6
    want = w.teacher_state_dict(jax.tree.map(np.asarray, jax_load_weights(_dir("teacher-l2dice"))))
    got = _state(model)
    assert sorted(got) == sorted(want)
    _assert_same_state(got, {k: want[k] for k in got})
    frames = tmp_path / "in"
    img = np.random.default_rng(0).integers(0, 256, (32, 40, 3), dtype=np.uint8)
    imwrite(str(frames / "a.png"), img)
    pth = str(tmp_path / "l2dice.pth")
    assert cli.main(["convert", "--arch", "KDLAE_teacher", "--out", _dir("teacher-l2dice"),
                     "--reverse", "--pth", pth]) == 0
    base = ["infer-teacher", "--input", str(frames), "--device", "cpu"]
    assert cli.main(base + ["--weights", "teacher-l2dice", "--output", str(tmp_path / "a")]) == 0
    assert cli.main(base + ["--weights", pth, "--denoise-rate", "0.6",
                            "--output", str(tmp_path / "b")]) == 0
    np.testing.assert_array_equal(imread_rgb_ubyte(str(tmp_path / "a" / "a.png")),
                                  imread_rgb_ubyte(str(tmp_path / "b" / "a.png")))


def test_student_and_scorer_weights_dirs(tmp_path):
    frames = tmp_path / "frames"
    rng = np.random.default_rng(1)
    for i in range(7):
        imwrite(str(frames / f"{i:03d}.png"), rng.integers(0, 256, (32, 32), dtype=np.uint8),
                rgb=False)
    base = ["infer-student", "--input", str(frames), "--device", "cpu"]
    assert cli.main(base + ["--weights", _dir("student-fls"), "--output", str(tmp_path / "a")]) == 0
    assert cli.main(base + ["--weights", "student-fls", "--output", str(tmp_path / "b")]) == 0
    a, b = list_images(str(tmp_path / "a")), list_images(str(tmp_path / "b"))
    assert len(a) == len(b) == 7
    for x, y in zip(a, b):
        np.testing.assert_array_equal(imread_gray(x), imread_gray(y))
    lq = tmp_path / "lq"
    for i in range(2):
        img = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
        imwrite(str(lq / f"p{i}.png"), img)
        imwrite(str(tmp_path / "m" / f"p{i}.png"), img // 2 + 20)
    score = ["score", "--lq-dir", str(lq), "--methods", f"m={tmp_path / 'm'}",
             "--device", "cpu"]
    assert cli.main(score + ["--weights", _dir("asdqe"), "--csv", str(tmp_path / "a.csv")]) == 0
    assert cli.main(score + ["--csv", str(tmp_path / "b.csv")]) == 0
    assert open(tmp_path / "a.csv").read() == open(tmp_path / "b.csv").read()


def test_pretrain_network_g_dir(tmp_path, capsys):
    student = lambda: KDLAEStudent(residual=True, hidden_channels=(16, 32, 64))  # noqa: E731
    _assert_same_state(_state(ckpt.load_pretrained(student(), _dir("student-fls"))),
                       _state(ckpt.load_pretrained(student(),
                                                   os.path.join(ZOO, "student-fls.pth"))))
    # merged non-strictly into a teacher without the 2x head, as from the .pth
    with torch.random.fork_rng():
        torch.manual_seed(0)
        a = ckpt.load_pretrained(flagship_teacher(), _dir("teacher"), strict=False)
        torch.manual_seed(0)
        b = ckpt.load_pretrained(flagship_teacher(), os.path.join(ZOO, "teacher.pth"),
                                 strict=False)
    _assert_same_state(_state(a), _state(b))
    # a payload holding only 'params_ema' is used, with a note
    tree = po.load_weights(_dir("student-fls"))
    only_ema = po.write_checkpoint(str(tmp_path / "ema"), {"params_ema": tree})
    capsys.readouterr()
    c = ckpt.load_pretrained(student(), only_ema, "params")
    assert "only 'params_ema'" in capsys.readouterr().out
    _assert_same_state(_state(c), _state(ckpt.load_pretrained(student(), _dir("student-fls"))))


def test_online_teacher_weights_dir(tmp_path):
    with torch.random.fork_rng():
        torch.manual_seed(7)
        sd = build_network(NARROW_TEACHER).state_dict()
    pth = str(tmp_path / "teacher.pth")
    torch.save({"params": sd}, pth)
    orbax_dir = po.write_checkpoint(str(tmp_path / "teacher"),
                                    {"params": w.teacher_flax_tree(sd)})
    stack = torch.from_numpy(np.random.default_rng(0).random((2, 3, 16, 24), dtype=np.float32))
    out = []
    for weights in (pth, orbax_dir):
        distill = {"online": True, "teacher": NARROW_TEACHER, "teacher_weights": weights,
                   "denoise_rate": 0.7}
        tcfg.validate_distill(distill)
        fn = tloop.build_online_targets({"train": {"distill": distill}}, "cpu")
        out.append(tloop.online_targets(fn, stack))
    torch.testing.assert_close(out[0], out[1], rtol=0, atol=0)


def test_a_directory_without_metadata_is_refused(tmp_path):
    (tmp_path / "empty").mkdir()
    with pytest.raises(po.CheckpointError, match="not an orbax checkpoint"):
        w.read_state_dict(str(tmp_path / "empty"), "KDLAE_student")
    with pytest.raises(ValueError, match="neither"):
        tcfg.validate_distill({"teacher": NARROW_TEACHER,
                               "teacher_weights": str(tmp_path / "empty")})
    shutil.rmtree(tmp_path / "empty")
