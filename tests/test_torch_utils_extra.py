"""The port's numpy utilities against the JAX package's: MATLAB imresize
and the YCbCr conversions, the DND submission bundler's .mat files, the
face-restoration geometry (dlib absent), the .flo reader and writer and
the flow quantiser, and the weight fetcher and checker (a fake transport;
--from-dir on .pth files written from artifacts/torch_zoo/; no network)."""

import os

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu.eval import bundle_submissions as jbundle
from rethink_acoustic_image_enhancement_tpu.utils import download_weights as jdw
from rethink_acoustic_image_enhancement_tpu.utils import face_restoration as jface
from rethink_acoustic_image_enhancement_tpu.utils import flow as jflow
from rethink_acoustic_image_enhancement_tpu.utils import matlab as jmatlab
from rethink_acoustic_image_enhancement_tpu_torch.eval import bundle_submissions
from rethink_acoustic_image_enhancement_tpu_torch.utils import download_weights as dw
from rethink_acoustic_image_enhancement_tpu_torch.utils import face_restoration as face
from rethink_acoustic_image_enhancement_tpu_torch.utils import flow
from rethink_acoustic_image_enhancement_tpu_torch.utils import matlab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = os.path.join(REPO, "artifacts", "torch_zoo")


@pytest.mark.parametrize("shape", [(17, 23, 3), (24, 32), (9, 5, 1)])
@pytest.mark.parametrize("scale", [0.5, 2.0, 0.3, 1.7])
@pytest.mark.parametrize("antialiasing", [True, False])
def test_imresize_matches_jax(shape, scale, antialiasing):
    img = np.random.default_rng(2).random(shape)
    got = matlab.imresize(img, scale, antialiasing)
    ref = jmatlab.imresize(img, scale, antialiasing)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    f32 = matlab.imresize(img.astype(np.float32), scale, antialiasing)
    assert f32.dtype == np.float32
    np.testing.assert_allclose(f32, jmatlab.imresize(img.astype(np.float32), scale,
                                                     antialiasing), rtol=1e-6, atol=1e-6)


def test_ycbcr_conversions_match_jax():
    img = np.random.default_rng(1).random((5, 7, 3))
    for name in ("rgb2ycbcr", "bgr2ycbcr"):
        for y_only in (False, True):
            np.testing.assert_allclose(getattr(matlab, name)(img, y_only),
                                       getattr(jmatlab, name)(img, y_only), rtol=1e-6, atol=1e-6)
    ycc = matlab.rgb2ycbcr(img)
    for name in ("ycbcr2rgb", "ycbcr2bgr"):
        np.testing.assert_allclose(getattr(matlab, name)(ycc), getattr(jmatlab, name)(ycc),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(matlab.ycbcr2rgb(ycc), img, atol=1e-10)
    u8 = (img * 255).astype(np.float32)
    for order in ("rgb", "bgr"):
        np.testing.assert_allclose(matlab.to_y_channel(u8, order),
                                   jmatlab.to_y_channel(u8, order), rtol=1e-6, atol=1e-6)


def test_metrics_y_channel_agrees_with_matlab():
    """metrics/psnr_ssim.py keeps its own Y (its results unchanged); it is
    MATLAB's rgb2ycbcr Y within rounding."""
    from rethink_acoustic_image_enhancement_tpu_torch.metrics.psnr_ssim import _to_y_channel

    img = np.random.default_rng(3).random((6, 8, 3)) * 255
    np.testing.assert_allclose(_to_y_channel(img), matlab.to_y_channel(img)[..., 0],
                               rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("raw", [True, False])
def test_bundle_submissions_writes_what_jax_writes(tmp_path, raw):
    sio = pytest.importorskip("scipy.io")
    rng = np.random.default_rng(4)
    for i in range(2):
        for bb in range(3):
            sio.savemat(str(tmp_path / f"{i + 1:04d}_{bb + 1:02d}.mat"),
                        {"Idenoised_crop": rng.random((4, 5, 3)).astype(np.float32)})
    kw = dict(num_images=2, num_blocks=3)
    fn = "bundle_submissions_raw" if raw else "bundle_submissions_srgb"
    out = getattr(bundle_submissions, fn)(str(tmp_path), "port", **kw)
    ref = getattr(jbundle, fn)(str(tmp_path), "jax", **kw)
    assert out == str(tmp_path / "port")
    for i in range(2):
        a = sio.loadmat(os.path.join(out, f"{i + 1:04d}.mat"))
        b = sio.loadmat(os.path.join(ref, f"{i + 1:04d}.mat"))
        assert int(a["israw"][0, 0]) == int(raw) == int(b["israw"][0, 0])
        assert a["eval_version"][0] == b["eval_version"][0] == "1.0"
        for bb in range(3):
            crop = sio.loadmat(str(tmp_path / f"{i + 1:04d}_{bb + 1:02d}.mat"))["Idenoised_crop"]
            np.testing.assert_array_equal(a["Idenoised"][0, bb], crop)
            np.testing.assert_array_equal(a["Idenoised"][0, bb], b["Idenoised"][0, bb])


def test_face_similarity_and_affine_match_jax():
    rng = np.random.default_rng(0)
    src = rng.uniform(0, 100, size=(5, 2))
    dst = src @ np.array([[0.9, -0.4], [0.4, 0.9]]).T * 1.3 + [12.0, -5.0]
    m = face.estimate_similarity(src, dst)
    np.testing.assert_allclose(m, jface.estimate_similarity(src, dst), atol=1e-12)
    np.testing.assert_allclose(face.invert_affine(m), jface.invert_affine(m), atol=1e-12)
    np.testing.assert_array_equal(face.FFHQ_TEMPLATE_1024, jface.FFHQ_TEMPLATE_1024)


@pytest.mark.parametrize("upscale,face_size", [(1, 128), (2, 128)])
def test_face_crop_and_paste_match_jax(upscale, face_size):
    pytest.importorskip("cv2")
    yy, xx = np.mgrid[0:200, 0:220] / 200.0
    img = np.stack([0.2 + 0.6 * xx, 0.2 + 0.6 * yy, 0.5 + 0.3 * np.sin(4 * xx + 3 * yy)],
                   axis=-1).astype(np.float32)
    lm = face.FFHQ_TEMPLATE_1024 / (1024 // face_size) * 0.9 + 30.0
    outs = []
    for mod in (face, jface):
        helper = mod.FaceRestorationHelper(upscale_factor=upscale, face_size=face_size)
        helper.read_image(img)
        helper.add_landmarks(lm)
        crops = helper.warp_crop_faces()
        helper.add_restored_face(np.clip(crops[0] * 1.1, 0, 1))
        outs.append((crops[0], helper.paste_faces_to_image(),
                     helper.inverse_affine_matrices[0]))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert outs[0][1].shape == (200 * upscale, 220 * upscale, 3)


def test_face_numpy_warp_fallback_matches_jax(monkeypatch):
    """Without cv2, warp_affine is a nearest-neighbour gather in both."""
    import builtins

    real_import = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("cv2 hidden")
        return real_import(name, *a, **k)

    img = np.random.default_rng(5).random((30, 40, 3)).astype(np.float32)
    m = face.estimate_similarity(face.FFHQ_TEMPLATE_1024[:, ::-1] / 30,
                                 face.FFHQ_TEMPLATE_1024 / 40)
    monkeypatch.setattr(builtins, "__import__", no_cv2)
    np.testing.assert_array_equal(face.warp_affine(img, m, (24, 28)),
                                  jface.warp_affine(img, m, (24, 28)))


def test_face_dlib_path_is_gated_and_landmarks_checked():
    helper = face.FaceRestorationHelper()
    with pytest.raises(ValueError, match="landmarks"):
        helper.add_landmarks(np.zeros((4, 2)))
    try:
        import dlib  # noqa: F401
    except ImportError:
        helper.read_image(np.zeros((8, 8, 3), np.uint8))
        with pytest.raises(ImportError):
            helper.detect_landmarks_dlib("det.dat", "lm5.dat")


def test_flow_round_trips_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    f = rng.normal(size=(6, 8, 2)).astype(np.float32)
    flow.flowwrite(f, str(tmp_path / "port.flo"))
    jflow.flowwrite(f, str(tmp_path / "jax.flo"))
    assert (tmp_path / "port.flo").read_bytes() == (tmp_path / "jax.flo").read_bytes()
    np.testing.assert_array_equal(flow.flowread(str(tmp_path / "jax.flo")), f)
    (tmp_path / "bad.flo").write_bytes(b"\0" * 16)
    with pytest.raises(IOError, match="magic"):
        flow.flowread(str(tmp_path / "bad.flo"))
    g = rng.uniform(-5, 5, (8, 10, 2)).astype(np.float32)
    for norm in (True, False):
        dx, dy = flow.quantize_flow(g, max_val=0.02 if norm else 2.0, norm=norm)
        jdx, jdy = jflow.quantize_flow(g, max_val=0.02 if norm else 2.0, norm=norm)
        np.testing.assert_array_equal(dx, jdx)
        np.testing.assert_array_equal(dy, jdy)
        np.testing.assert_array_equal(
            flow.dequantize_flow(dx, dy, 0.02 if norm else 2.0, norm),
            jflow.dequantize_flow(dx, dy, 0.02 if norm else 2.0, norm))


def test_weight_table_and_fetcher_match_jax(tmp_path):
    assert dw.WEIGHTS == jdw.WEIGHTS and dw._RELEASE == jdw._RELEASE
    assert dw.gdrive_confirm_token({"download_warning_x": "tok"}) == "tok"
    assert dw.gdrive_confirm_token({"other": "v"}) is None
    calls = []

    def fake_fetch(url, params):
        calls.append(dict(params))
        if "confirm" not in params:
            return {"download_warning_abc": "T0K"}, iter([b"interstitial"])
        return {}, iter([b"abc", b"", b"defg"])

    dest = tmp_path / "w" / "w.pth"
    assert dw.download_from_google_drive("FILEID", str(dest), fetch=fake_fetch,
                                         log=lambda m: None) == 7
    assert dest.read_bytes() == b"abcdefg"
    assert calls == [{"id": "FILEID"}, {"id": "FILEID", "confirm": "T0K"}]

    def html(url, params):
        return {}, iter([b"<!DOCTYPE html><html>virus scan warning</html>"])

    with pytest.raises(IOError, match="HTML page"):
        dw.download_from_google_drive("F", str(tmp_path / "h.pth"), fetch=html,
                                      log=lambda m: None)
    assert not (tmp_path / "h.pth").exists()


def test_main_without_network_skips_each_weight(tmp_path, monkeypatch, capsys):
    """A failed fetch skips the file, as in JAX; the fetch is replaced, so
    nothing reaches the network."""
    def refused(url, dest):
        raise OSError("no route")

    monkeypatch.setattr(dw.urllib.request, "urlretrieve", refused)
    assert dw.main(["--dest", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.count("download failed") == len(dw.WEIGHTS)


def test_from_dir_checks_each_pth_strictly(tmp_path, capsys):
    """--from-dir on reference-layout .pth files written from the zoo: each
    family loads strictly into its architecture; a missing file is skipped;
    a wrong family fails; --no-convert skips the check."""
    from rethink_acoustic_image_enhancement_tpu_torch.convert.weights import read_pth

    src = tmp_path / "pth"
    src.mkdir()
    os.symlink(os.path.join(ZOO, "teacher.pth"), src / "KDLAE_T.pth")
    os.symlink(os.path.join(ZOO, "student-us.pth"), src / "KDLAE-S-US.pth")
    os.symlink(os.path.join(ZOO, "student-fls.pth"), src / "KDLAE-S-FLS.pth")
    torch.save(read_pth(os.path.join(ZOO, "asdqe.pth")), src / "ASDQE.pth")  # a bare state dict
    assert dw.main(["--from-dir", str(src)]) == 0
    out = capsys.readouterr().out
    assert "skip KDLAE_T_L2Dice.pth" in out
    assert out.count("load strictly") == 4
    n_teacher = dw.check_one(str(src / "KDLAE_T.pth"), "KDLAE_teacher", "params")
    assert n_teacher == 26882940  # the zoo manifest's count
    with pytest.raises(RuntimeError, match="state_dict"):
        dw.check_one(str(src / "KDLAE-S-US.pth"), "DenoiseRatePredictor", None)
    capsys.readouterr()
    assert dw.main(["--from-dir", str(src), "--no-convert"]) == 0
    assert "load strictly" not in capsys.readouterr().out
