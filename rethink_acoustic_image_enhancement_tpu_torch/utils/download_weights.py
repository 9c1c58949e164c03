"""Pretrained-weight fetcher and checker.

The reference's utils/download_weights.py:27-53: downloads the five release
weights from the upstream project's GitHub releases (``WEIGHTS``), then
checks each ``.pth``: it is read with ``convert/weights.py::read_pth`` and
loaded with ``strict=True`` into the architecture its family names (the
port serves reference-layout ``.pth`` files as they are; nothing is
converted). Network access is required; offline, point ``--from-dir`` at
pre-downloaded ``.pth`` files. ``--no-convert`` skips the check.

    python -m rethink_acoustic_image_enhancement_tpu_torch.utils.download_weights \
        --from-dir DIR
"""

from __future__ import annotations

import argparse
import os
import urllib.request

_RELEASE = ("https://github.com/yangtaihong59/Rethink_Acoustic_Image_"
            "Enhancement/releases/download/weight")

WEIGHTS = {
    "KDLAE_T.pth": ("KDLAE_teacher", "params"),
    "KDLAE_T_L2Dice.pth": ("KDLAE_teacher", "params"),
    "KDLAE-S-FLS.pth": ("KDLAE_student", "params"),
    "KDLAE-S-US.pth": ("KDLAE_student", "params"),
    "ASDQE.pth": ("DenoiseRatePredictor", None),
}


def gdrive_confirm_token(cookies: dict) -> str | None:
    """Google Drive 'large file' interstitial: the confirm token arrives
    as a ``download_warning*`` cookie (reference download_util.py:40-44)."""
    for key, value in cookies.items():
        if key.startswith("download_warning"):
            return value
    return None


def _urllib_fetch(url: str, params: dict):
    """(cookies dict, byte-chunk iterator) for a GET with query params."""
    import http.cookiejar
    import urllib.parse

    jar = http.cookiejar.CookieJar()
    opener = urllib.request.build_opener(
        urllib.request.HTTPCookieProcessor(jar))
    sep = "&" if "?" in url else "?"
    # a stalled connection must fail (IOError path), not hang forever
    resp = opener.open(url + sep + urllib.parse.urlencode(params),
                       timeout=30)
    cookies = {c.name: c.value for c in jar}

    def stream(chunk_size=32768):
        try:
            while True:
                chunk = resp.read(chunk_size)
                if not chunk:
                    break
                yield chunk
        finally:
            resp.close()

    return cookies, stream(), resp.close


def download_from_google_drive(file_id: str, save_path: str,
                               fetch=None, log=print) -> int:
    """Stream a Google Drive file to disk (reference
    download_util.py:8-37 behavior: initial GET, confirm-token retry for
    large files, chunked write). ``fetch(url, params) -> (cookies,
    chunk_iter[, close_fn])`` is injectable for tests/custom transports;
    returns the byte count written. Raises IOError if the server answers
    with an HTML page instead of file bytes (Drive interstitials that no
    longer use the download_warning cookie) — better than silently saving
    HTML as a .pth."""
    base = "https://docs.google.com/uc?export=download"
    fetch = fetch or _urllib_fetch
    params = {"id": file_id}
    res = fetch(base, params)
    cookies, stream = res[0], res[1]
    close = res[2] if len(res) > 2 else getattr(stream, "close",
                                                lambda: None)
    token = gdrive_confirm_token(cookies)
    if token:
        params["confirm"] = token
        close()  # abandon the interstitial response's socket
        res = fetch(base, params)
        stream = res[1]
    first = next(iter(stream), b"")
    head = first.lstrip()[:64].lower()
    if head.startswith((b"<!doctype html", b"<html")):
        raise IOError(
            f"Google Drive returned an HTML page for id {file_id!r} "
            "(interstitial without a confirm cookie); download manually")
    written = 0
    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    with open(save_path, "wb") as f:
        for chunk in _chain_first(first, stream):
            if chunk:  # skip keep-alive chunks
                f.write(chunk)
                written += len(chunk)
    log(f"downloaded {written} bytes -> {save_path}")
    return written


def _chain_first(first, rest):
    if first:
        yield first
    yield from rest


def download(name: str, dest_dir: str) -> str:
    os.makedirs(dest_dir, exist_ok=True)
    dest = os.path.join(dest_dir, name)
    if os.path.exists(dest):
        return dest
    url = f"{_RELEASE}/{name}"
    print(f"downloading {url}")
    urllib.request.urlretrieve(url, dest)
    return dest


def _architecture(arch: str, sd: dict):
    """The port's module of family ``arch`` that the state dict ``sd``
    should fill: the flagship teacher (with its 2x head where ``sd`` has
    one), the full-width student, the scorer."""
    from ..models import DenoiseRatePredictor, KDLAEStudent, flagship_teacher

    if arch == "KDLAE_teacher":
        return flagship_teacher(static="train" if "cen.weight" in sd else "test")
    if arch == "KDLAE_student":
        return KDLAEStudent(residual=True, hidden_channels=(16, 32, 64))
    if arch == "DenoiseRatePredictor":
        return DenoiseRatePredictor()
    raise KeyError(f"unknown architecture {arch!r}")


def check_one(pth_path: str, arch: str, param_key: str | None) -> int:
    """The JAX package's ``convert_one`` as a check: the ``.pth``'s state
    dict loads with ``strict=True`` into the architecture ``arch``. Returns
    the number of parameters; raises on a missing, unexpected or misshapen
    key."""
    from ..convert.weights import read_pth

    sd = read_pth(pth_path, param_key)
    model = _architecture(arch, sd)
    model.load_state_dict(sd, strict=True)
    n = sum(p.numel() for p in model.parameters())
    print(f"checked {pth_path} [{arch}]: {n} parameters load strictly")
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dest", default="weights", help="output directory")
    ap.add_argument("--from-dir", default=None,
                    help="use pre-downloaded .pth files instead of fetching")
    ap.add_argument("--no-convert", action="store_true",
                    help="skip the strict load of each .pth")
    args = ap.parse_args(argv)

    for name, (arch, key) in WEIGHTS.items():
        if args.from_dir:
            pth = os.path.join(args.from_dir, name)
            if not os.path.exists(pth):
                print(f"skip {name}: not in {args.from_dir}")
                continue
        else:
            try:
                pth = download(name, os.path.join(args.dest, "pth"))
            except Exception as e:  # offline env
                print(f"skip {name}: download failed ({e})")
                continue
        if not args.no_convert:
            check_one(pth, arch, key)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
