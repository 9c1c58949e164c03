"""The port's image I/O: the numpy/zlib PNG route (``utils/png.py``, used
where neither cv2 nor PIL is installed) against cv2 both ways, for gray,
gray+alpha, RGB and RGBA at odd sizes, every row filter read; and the
readers and ``imwrite`` on each route (cv2, PIL, PNG) giving cv2's pixels."""

import struct
import zlib

import numpy as np
import pytest

from rethink_acoustic_image_enhancement_tpu_torch.utils import image_io, png

cv2 = pytest.importorskip("cv2")

SHAPES = {"gray": (23, 37), "gray_alpha": (19, 41, 2), "rgb": (29, 33, 3),
          "rgba": (17, 45, 4)}


def _img(kind, seed=0):
    return np.random.default_rng(seed).integers(0, 256, SHAPES[kind], dtype=np.uint8)


def _cv2_order(img):
    """File-order pixels -> what cv2.imwrite takes (BGR(A))."""
    if img.ndim == 2:
        return img
    return np.concatenate([img[:, :, 2::-1], img[:, :, 3:]], axis=2)


def _encode_filtered(img, filters):
    """A PNG of ``img`` whose row y uses filter ``filters[y % len]``."""
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * bpp).astype(np.int32)
    out = bytearray()
    prev = np.zeros(w * bpp, np.int32)
    for y in range(h):
        kind = filters[y % len(filters)]
        cur = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, ul))
        out.append(kind)
        out += ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur
    color = {1: 0, 2: 4, 3: 2, 4: 6}[bpp]
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (png.SIGNATURE + png._chunk(b"IHDR", header)
            + png._chunk(b"IDAT", zlib.compress(bytes(out))) + png._chunk(b"IEND", b""))


@pytest.fixture
def no_libraries(monkeypatch):
    """The machine without cv2 and PIL: the PNG route."""
    monkeypatch.setattr(image_io, "_cv2", lambda: None)
    monkeypatch.setattr(image_io, "_pil", lambda: None)


@pytest.mark.parametrize("kind", list(SHAPES))
def test_png_written_here_decodes_in_cv2(tmp_path, kind):
    img = _img(kind)
    path = str(tmp_path / "x.png")
    png.write(path, img)
    got = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if kind == "gray_alpha":  # cv2 reads gray+alpha as BGRA
        want = np.concatenate([np.repeat(img[:, :, :1], 3, axis=2), img[:, :, 1:]], axis=2)
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(got, _cv2_order(img))


@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba"])
def test_png_written_by_cv2_decodes_here(tmp_path, kind):
    img = _img(kind, seed=1)
    path = str(tmp_path / "x.png")
    assert cv2.imwrite(path, _cv2_order(img))
    np.testing.assert_array_equal(png.read(path), img)


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("kind", list(SHAPES))
def test_every_row_filter_is_read(kind, filters):
    img = _img(kind, seed=2)
    data = _encode_filtered(img, filters)
    np.testing.assert_array_equal(png.decode(data), img)
    if kind != "gray_alpha":  # and cv2 reads the same bytes the same way
        got = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(got, _cv2_order(img))


@pytest.mark.parametrize("shape", [(1, 41, 3), (29, 1, 4), (2, 2), (6, 37)])
@pytest.mark.parametrize("filters", [(3,), (4,), (2, 4, 1, 3)],
                         ids=["average", "paeth", "mixed"])
def test_average_and_paeth_rows_at_edge_shapes(shape, filters):
    """Rows of one pixel, columns of one pixel and more rows than columns:
    the decoder undoes these filters one anti-diagonal at a time."""
    img = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(png.decode(_encode_filtered(img, filters)), img)


@pytest.mark.parametrize("header,what", [
    ((16, 0, 0), "bit depth 16"), ((8, 3, 0), "colour type 3"), ((8, 2, 1), "interlace 1")])
def test_unsupported_png_raises_naming_the_file(tmp_path, header, what):
    depth, color, interlace = header
    ihdr = struct.pack(">IIBBBBB", 4, 4, depth, color, 0, 0, interlace)
    path = tmp_path / "odd.png"
    path.write_bytes(png.SIGNATURE + png._chunk(b"IHDR", ihdr)
                     + png._chunk(b"IDAT", zlib.compress(b"\0" * 64)) + png._chunk(b"IEND", b""))
    with pytest.raises(ValueError, match=what) as err:
        png.read(str(path))
    assert str(path) in str(err.value)


def _readers(path):
    data = open(path, "rb").read()
    return {"rgb": image_io.imread_rgb(path), "rgb_u8": image_io.imread_rgb_ubyte(path),
            "gray": image_io.imread_gray(path), "bgr": image_io.imread_bgr(path),
            "bytes_bgr": image_io.imfrombytes_bgr(data),
            "bytes_gray": image_io.imfrombytes_gray(data)}


@pytest.mark.parametrize("route", ["png", "pil"])
@pytest.mark.parametrize("kind", list(SHAPES))
def test_readers_give_cv2_pixels_on_every_route(tmp_path, monkeypatch, route, kind):
    img = _img(kind, seed=3)
    path = str(tmp_path / "x.png")
    png.write(path, img)
    want = _readers(path)  # cv2
    monkeypatch.setattr(image_io, "_cv2", lambda: None)
    if route == "png":
        monkeypatch.setattr(image_io, "_pil", lambda: None)
    else:
        pytest.importorskip("PIL")
    got = _readers(path)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("route", ["cv2", "pil", "png"])
@pytest.mark.parametrize("kind,rgb", [("gray", True), ("rgb", True), ("rgb", False),
                                      ("rgba", True)])
def test_imwrite_on_every_route(tmp_path, monkeypatch, route, kind, rgb):
    img = _img(kind, seed=4)
    path = str(tmp_path / "sub" / "x.png")
    if route != "cv2":
        monkeypatch.setattr(image_io, "_cv2", lambda: None)
    if route == "png":
        monkeypatch.setattr(image_io, "_pil", lambda: None)
    elif route == "pil":
        pytest.importorskip("PIL")
    image_io.imwrite(path, img, rgb=rgb)
    got = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    # 3 channels are RGB (BGR with rgb=False), 4 are BGRA: cv2 reads BGR(A)
    want = _cv2_order(img) if img.ndim == 3 and img.shape[2] == 3 and rgb else img
    np.testing.assert_array_equal(got, want)


def test_float_image_is_written_as_ubyte(tmp_path, no_libraries):
    img = np.random.default_rng(5).random((9, 11, 3)).astype(np.float32)
    path = str(tmp_path / "f.png")
    image_io.imwrite(path, img)
    np.testing.assert_array_equal(image_io.imread_rgb_ubyte(path), image_io.to_ubyte(img))


def test_without_libraries_only_png(tmp_path, no_libraries):
    with pytest.raises(ImportError, match="needs cv2 or PIL"):
        image_io.imwrite(str(tmp_path / "x.jpg"), _img("rgb"))
    (tmp_path / "y.jpg").write_bytes(b"\xff\xd8\xff")
    with pytest.raises(ImportError, match="y.jpg"):
        image_io.imread_rgb(str(tmp_path / "y.jpg"))
