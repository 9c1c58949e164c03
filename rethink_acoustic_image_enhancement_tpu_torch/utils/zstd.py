"""Zstandard (RFC 8878) decompression without a zstd package.

Two decoders of one format:

* ``decompress(data)`` (``decoder="native"``, the default) calls
  ``csrc/zstd_decode.cpp`` through ctypes. The library is built with
  ``g++`` on first use into ``build/`` at the checkout root, named by the
  content hash of its source and flags; where ``g++`` is missing or the
  build fails, the call raises and names the compiler (nothing falls back
  to the Python decoder, which is orders of magnitude slower).
* ``decompress(data, decoder="python")`` is the plain Python decoder below,
  the reference the native one is held to in the tests.

Both take a sequence of frames back to back: zstd frames (with or without a
content size, single-segment or windowed, with the optional xxHash64
content checksum, which is checked) and skippable frames (skipped). Blocks
are raw, RLE or compressed; literals raw, RLE, Huffman-coded in 1 or 4
streams, or treeless (the frame's previous Huffman table); sequences in the
predefined, RLE, FSE-compressed and repeat modes, with the three repeat
offsets. Frames that need a dictionary raise ``ZstdError``.

``python -m rethink_acoustic_image_enhancement_tpu_torch.utils.zstd``
builds the native library eagerly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent.parent / "csrc" / "zstd_decode.cpp"
BUILD = Path(__file__).resolve().parent.parent.parent / "build"
CXX = "g++"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared"]
ABI_VERSION = 1
ERR_DST_TOO_SMALL = 2  # the native decoder's code for "grow the output"

FRAME_MAGIC = 0xFD2FB528
SKIPPABLE_MASK, SKIPPABLE_MAGIC = 0xFFFFFFF0, 0x184D2A50
BLOCK_MAX = 128 * 1024


class ZstdError(ValueError):
    """Malformed, truncated or unsupported zstd data."""


def decompress(data, decoder: str = "native", size: int | None = None) -> bytes:
    """The concatenated content of the frames in ``data``. ``size``, where
    the caller knows it, is the content's size: the native decoder then
    allocates its output once, and content of another size raises."""
    if decoder == "native":
        out = _native_decompress(bytes(data), size)
    elif decoder == "python":
        out = bytes(_py_decompress(memoryview(bytes(data))))
    else:
        raise ValueError(f"decoder {decoder!r}: 'native' or 'python'")
    if size is not None and len(out) != size:
        raise ZstdError(f"content of {len(out)} bytes, {size} expected")
    return out


# ------------------------------------------------------------ the tables --

# Literals_Length and Match_Length codes: (baseline, extra bits)
LL_CODES = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3),
    (48, 4), (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11),
    (4096, 12), (8192, 13), (16384, 14), (32768, 15), (65536, 16)]
ML_CODES = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3),
    (67, 4), (83, 4), (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10),
    (2051, 11), (4099, 12), (8195, 13), (16387, 14), (32771, 15), (65539, 16)]
# the predefined distributions (accuracy log 6, 5, 6)
LL_DEFAULT = [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2,
              2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1]
OF_DEFAULT = [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
              1, 1, 1, -1, -1, -1, -1, -1]
ML_DEFAULT = [1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7
# per kind (LL, OF, ML): the largest accuracy log and symbol
MAX_LOG = (9, 8, 9)
MAX_SYMBOL = (35, 31, 52)


# ------------------------------------------------------------ bit readers --

class _Forward:
    """Little-endian bits read upwards from a byte offset (FSE table
    descriptions)."""

    def __init__(self, buf, start: int, end: int):
        self.buf, self.bit, self.end = buf, start * 8, end * 8

    def read(self, n: int) -> int:
        v = self.peek(n)
        self.skip(n)
        return v

    def peek(self, n: int) -> int:
        """The next ``n`` bits, zeros past the end."""
        lo, hi = self.bit >> 3, min((self.bit + n + 7) >> 3, self.end >> 3)
        v = int.from_bytes(self.buf[lo:hi], "little")
        return (v >> (self.bit & 7)) & ((1 << n) - 1)

    def skip(self, n: int) -> None:
        self.bit += n
        if self.bit > self.end:
            raise ZstdError("FSE table description runs past its block")

    def byte_end(self) -> int:
        return (self.bit + 7) >> 3


class _Backward:
    """A zstd backward bitstream: bits read downwards from the one under
    the final byte's highest set bit; bits below the start read as 0 and
    leave ``pos`` negative (overflow)."""

    def __init__(self, buf):
        if len(buf) == 0 or buf[-1] == 0:
            raise ZstdError("bitstream without its end marker")
        self.buf = buf
        self.pos = 8 * (len(buf) - 1) + buf[-1].bit_length() - 1

    def _get(self, at: int, n: int) -> int:
        if n == 0:
            return 0
        if at >= 0:
            v = int.from_bytes(self.buf[at >> 3:(at + n + 7) >> 3], "little")
            return (v >> (at & 7)) & ((1 << n) - 1)
        have = at + n
        if have <= 0:
            return 0
        v = int.from_bytes(self.buf[:(have + 7) >> 3], "little") & ((1 << have) - 1)
        return v << -at

    def read(self, n: int) -> int:
        self.pos -= n
        return self._get(self.pos, n)

    def peek(self, n: int) -> int:
        return self._get(self.pos - n, n)


# ------------------------------------------------------------------ FSE --

def _read_distribution(buf, p: int, end: int, max_log: int, max_symbol: int):
    """An FSE table description at ``buf[p:]`` -> (probabilities, accuracy
    log, offset after it)."""
    r = _Forward(buf, p, end)
    log = r.read(4) + 5
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} above {max_log}")
    remaining = (1 << log) + 1
    threshold, nbits = 1 << log, log + 1
    probs: list[int] = []
    while remaining > 1:
        if len(probs) > max_symbol:
            raise ZstdError("FSE distribution has too many symbols")
        most = 2 * threshold - 1 - remaining
        v = r.peek(nbits)
        if (v & (threshold - 1)) < most:
            val = v & (threshold - 1)
            r.skip(nbits - 1)
        else:
            val = v & (2 * threshold - 1)
            if val >= threshold:
                val -= most
            r.skip(nbits)
        prob = val - 1
        remaining -= abs(prob)
        probs.append(prob)
        if prob == 0:
            while True:
                rep = r.read(2)
                probs.extend([0] * rep)
                if rep != 3:
                    break
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(probs) > max_symbol + 1:
        raise ZstdError("corrupt FSE distribution")
    return probs, log, r.byte_end()


def _build_fse(probs: list[int], log: int):
    """Decoding table: (symbol, nbits, baseline) lists indexed by state."""
    size = 1 << log
    sym = [0] * size
    high = size - 1
    nxt = [0] * len(probs)
    for s, p in enumerate(probs):
        if p == -1:
            sym[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = p
    step, mask, pos = (size >> 1) + (size >> 3) + 3, size - 1, 0
    for s, p in enumerate(probs):
        for _ in range(max(p, 0)):
            sym[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ZstdError("FSE distribution does not fill its table")
    nbits, base = [0] * size, [0] * size
    for u in range(size):
        x = nxt[sym[u]]
        nxt[sym[u]] += 1
        nbits[u] = log - (x.bit_length() - 1)
        base[u] = (x << nbits[u]) - size
    return sym, nbits, base, log


def _rle_table(symbol: int):
    return [symbol], [0], [0], 0


_PREDEFINED = (_build_fse(LL_DEFAULT, 6), _build_fse(OF_DEFAULT, 5),
               _build_fse(ML_DEFAULT, 6))


# -------------------------------------------------------------- Huffman --

def _huffman_weights_fse(buf) -> list[int]:
    probs, log, p = _read_distribution(buf, 0, len(buf), 6, 255)
    sym, nbits, base, _ = _build_fse(probs, log)
    r = _Backward(buf[p:])
    s1, s2 = r.read(log), r.read(log)
    out: list[int] = []
    while True:
        if len(out) > 254:
            raise ZstdError("too many Huffman weights")
        out.append(sym[s1])
        s1 = base[s1] + r.read(nbits[s1])
        if r.pos < 0:
            out.append(sym[s2])
            break
        out.append(sym[s2])
        s2 = base[s2] + r.read(nbits[s2])
        if r.pos < 0:
            out.append(sym[s1])
            break
    return out


def _read_huffman(buf, p: int, end: int):
    """A Huffman tree description -> (table symbols, table nbits, max bits),
    offset after it."""
    if p >= end:
        raise ZstdError("truncated Huffman tree description")
    head = buf[p]
    p += 1
    if head < 128:
        if p + head > end:
            raise ZstdError("truncated Huffman weights")
        weights = _huffman_weights_fse(buf[p:p + head])
        p += head
    else:
        n = head - 127
        nbytes = (n + 1) // 2
        if p + nbytes > end:
            raise ZstdError("truncated Huffman weights")
        weights = [(buf[p + i // 2] >> 4) if i % 2 == 0 else (buf[p + i // 2] & 15)
                   for i in range(n)]
        p += nbytes
    if any(w > 11 for w in weights):
        raise ZstdError("Huffman weight above 11")
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ZstdError("Huffman weights all zero")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1):
        raise ZstdError("Huffman weights do not complete a tree")
    weights.append(rest.bit_length())
    if max_bits > 11 or len(weights) > 256:
        raise ZstdError("Huffman tree too deep or too wide")
    size = 1 << max_bits
    syms, nbits = bytearray(size), bytearray(size)
    pos = 0
    for w in range(1, max_bits + 1):
        for s, ws in enumerate(weights):
            if ws == w:
                n = 1 << (w - 1)
                syms[pos:pos + n] = bytes([s]) * n
                nbits[pos:pos + n] = bytes([max_bits + 1 - w]) * n
                pos += n
    return (syms, nbits, max_bits), p


def _huffman_stream(table, buf, count: int) -> bytes:
    syms, nbits, max_bits = table
    r = _Backward(buf)
    out = bytearray(count)
    get = r._get
    pos = r.pos
    for i in range(count):
        idx = get(pos - max_bits, max_bits)
        out[i] = syms[idx]
        pos -= nbits[idx]
    if pos != 0:
        raise ZstdError("Huffman stream not consumed exactly")
    return bytes(out)


# ------------------------------------------------------------- a block --

class _FrameState:
    def __init__(self):
        self.rep = [1, 4, 8]
        self.huffman = None
        self.tables = [None, None, None]  # LL, OF, ML


def _literals(buf, st: _FrameState):
    b0 = buf[0]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind < 2:
        if fmt in (0, 2):
            size, p = b0 >> 3, 1
        elif fmt == 1:
            size, p = (b0 >> 4) + (buf[1] << 4), 2
        else:
            size, p = (b0 >> 4) + (buf[1] << 4) + (buf[2] << 12), 3
        if kind == 0:
            if p + size > len(buf):
                raise ZstdError("truncated raw literals")
            return bytes(buf[p:p + size]), p + size
        if p >= len(buf):
            raise ZstdError("truncated RLE literals")
        return bytes([buf[p]]) * size, p + 1
    streams, hsize, bits = {0: (1, 3, 10), 1: (4, 3, 10), 2: (4, 4, 14),
                            3: (4, 5, 18)}[fmt]
    if hsize > len(buf):
        raise ZstdError("truncated literals header")
    h = int.from_bytes(buf[:hsize], "little")
    size = (h >> 4) & ((1 << bits) - 1)
    csize = (h >> (4 + bits)) & ((1 << bits) - 1)
    p, end = hsize, hsize + csize
    if end > len(buf):
        raise ZstdError("truncated compressed literals")
    if kind == 2:
        st.huffman, p = _read_huffman(buf, p, end)
    elif st.huffman is None:
        raise ZstdError("treeless literals without a previous Huffman table")
    table = st.huffman
    if streams == 1:
        return _huffman_stream(table, buf[p:end], size), end
    if p + 6 > end:
        raise ZstdError("truncated jump table")
    s1, s2, s3 = (int.from_bytes(buf[p + 2 * i:p + 2 * i + 2], "little")
                  for i in range(3))
    p += 6
    s4 = end - p - s1 - s2 - s3
    if s4 < 0:
        raise ZstdError("jump table past the literals")
    seg = (size + 3) // 4
    if 3 * seg > size:
        raise ZstdError("four literal streams for fewer than four literals")
    out = []
    for i, n in enumerate((s1, s2, s3, s4)):
        out.append(_huffman_stream(table, buf[p:p + n], seg if i < 3 else size - 3 * seg))
        p += n
    return b"".join(out), end


def _sequences(buf, p: int, st: _FrameState):
    """(literal length, offset, match length) of each sequence."""
    if p >= len(buf):
        raise ZstdError("truncated sequences section")
    b0 = buf[p]
    if b0 == 0:
        if p + 1 != len(buf):
            raise ZstdError("bytes after an empty sequences section")
        return []
    if b0 < 128:
        count, p = b0, p + 1
    elif b0 < 255:
        count, p = ((b0 - 128) << 8) + buf[p + 1], p + 2
    else:
        count, p = buf[p + 1] + (buf[p + 2] << 8) + 0x7F00, p + 3
    if p >= len(buf):
        raise ZstdError("truncated sequences section")
    modes = buf[p]
    p += 1
    if modes & 3:
        raise ZstdError("reserved bits of the sequence modes set")
    for kind, mode in ((0, modes >> 6), (1, (modes >> 4) & 3), (2, (modes >> 2) & 3)):
        if mode == 0:
            table = _PREDEFINED[kind]
        elif mode == 1:
            if p >= len(buf) or buf[p] > MAX_SYMBOL[kind]:
                raise ZstdError("bad RLE sequence symbol")
            table = _rle_table(buf[p])
            p += 1
        elif mode == 2:
            probs, log, p = _read_distribution(buf, p, len(buf), MAX_LOG[kind],
                                               MAX_SYMBOL[kind])
            table = _build_fse(probs, log)
        else:
            table = st.tables[kind]
            if table is None:
                raise ZstdError("repeat mode without a previous table")
        st.tables[kind] = table
    (ll_sym, ll_nb, ll_base, ll_log), (of_sym, of_nb, of_base, of_log), \
        (ml_sym, ml_nb, ml_base, ml_log) = st.tables
    r = _Backward(buf[p:])
    read = r.read
    ll_s, of_s, ml_s = read(ll_log), read(of_log), read(ml_log)
    rep = st.rep
    out = []
    for i in range(count):
        ofc = of_sym[of_s]
        if ofc > 31:
            raise ZstdError("offset code above 31")
        ofv = (1 << ofc) + read(ofc)
        mb, mbits = ML_CODES[ml_sym[ml_s]]
        ml = mb + read(mbits)
        lb, lbits = LL_CODES[ll_sym[ll_s]]
        ll = lb + read(lbits)
        if ofv > 3:
            off = ofv - 3
            rep = [off, rep[0], rep[1]]
        else:
            idx = ofv - 1 + (ll == 0)
            if idx == 0:
                off = rep[0]
            elif idx == 3:
                off = rep[0] - 1
                rep = [off, rep[0], rep[1]]
            else:
                off = rep[idx]
                rep = [off, rep[0], rep[2]] if idx == 1 else [off, rep[0], rep[1]]
        if off <= 0:
            raise ZstdError("zero offset")
        out.append((ll, off, ml))
        if i != count - 1:
            ll_s = ll_base[ll_s] + read(ll_nb[ll_s])
            ml_s = ml_base[ml_s] + read(ml_nb[ml_s])
            of_s = of_base[of_s] + read(of_nb[of_s])
    if r.pos != 0:
        raise ZstdError("sequences bitstream not consumed exactly")
    st.rep = rep
    return out


def _compressed_block(buf, out: bytearray, st: _FrameState, frame_start: int):
    lit, p = _literals(buf, st)
    start = len(out)
    lp = 0
    for ll, off, ml in _sequences(buf, p, st):
        if lp + ll > len(lit):
            raise ZstdError("sequence past its literals")
        out += lit[lp:lp + ll]
        lp += ll
        if off > len(out) - frame_start:
            raise ZstdError("match offset before the frame's start")
        s = len(out) - off
        if off >= ml:
            out += out[s:s + ml]
        else:
            chunk = bytes(out[s:])
            out += (chunk * (ml // off + 1))[:ml]
    out += lit[lp:]
    if len(out) - start > BLOCK_MAX:
        raise ZstdError("block decodes to more than 128 KiB")


# ------------------------------------------------------------- a frame --

def _u(buf, p: int, n: int) -> int:
    if p + n > len(buf):
        raise ZstdError("truncated frame")
    return int.from_bytes(buf[p:p + n], "little")


def _frame(buf, p: int, out: bytearray) -> int:
    fhd = _u(buf, p, 1)
    p += 1
    fcs_flag, single = fhd >> 6, (fhd >> 5) & 1
    if fhd & 8:
        raise ZstdError("reserved bit of the frame header set")
    checksum, did_flag = (fhd >> 2) & 1, fhd & 3
    window = None
    if not single:
        wd = _u(buf, p, 1)
        p += 1
        wlog = 10 + (wd >> 3)
        window = (1 << wlog) + ((1 << wlog) >> 3) * (wd & 7)
    did_size = (0, 1, 2, 4)[did_flag]
    if _u(buf, p, did_size) if did_size else 0:
        raise ZstdError("frame needs a dictionary, which this decoder does not take")
    p += did_size
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    content = None
    if fcs_size:
        content = _u(buf, p, fcs_size) + (256 if fcs_size == 2 else 0)
        p += fcs_size
    if single:
        window = content
    block_max = min(window, BLOCK_MAX)
    start = len(out)
    st = _FrameState()
    while True:
        h = _u(buf, p, 3)
        p += 3
        last, kind, size = h & 1, (h >> 1) & 3, h >> 3
        if kind == 0:
            if p + size > len(buf):
                raise ZstdError("truncated raw block")
            out += buf[p:p + size]
            p += size
        elif kind == 1:
            out += bytes([_u(buf, p, 1)]) * size
            p += 1
        elif kind == 2:
            if size > block_max or p + size > len(buf):
                raise ZstdError("compressed block too large or truncated")
            _compressed_block(buf[p:p + size], out, st, start)
            p += size
        else:
            raise ZstdError("reserved block type")
        if last:
            break
    if content is not None and len(out) - start != content:
        raise ZstdError(f"frame decodes to {len(out) - start} bytes, "
                        f"its header says {content}")
    if checksum:
        stored = _u(buf, p, 4)
        p += 4
        if xxh64(out[start:]) & 0xFFFFFFFF != stored:
            raise ZstdError("content checksum mismatch")
    return p


def _py_decompress(buf) -> bytearray:
    out = bytearray()
    p = 0
    while p < len(buf):
        magic = _u(buf, p, 4)
        if magic == FRAME_MAGIC:
            p = _frame(buf, p + 4, out)
        elif magic & SKIPPABLE_MASK == SKIPPABLE_MAGIC:
            p += 8 + _u(buf, p + 4, 4)
            if p > len(buf):
                raise ZstdError("truncated skippable frame")
        else:
            raise ZstdError(f"not a zstd frame (magic {magic:#010x})")
    return out


# --------------------------------------------------------------- xxHash64 --

_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data) -> int:
    """XXH64 of ``data``, seed 0 (the zstd content checksum's low 32 bits)."""
    data = bytes(data)
    n, p = len(data), 0
    if n >= 32:
        v = [(_P1 + _P2) & _M64, _P2, 0, (-_P1) & _M64]
        while p + 32 <= n:
            for i in range(4):
                v[i] = _round(v[i], int.from_bytes(data[p + 8 * i:p + 8 * i + 8], "little"))
            p += 32
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _M64
        for x in v:
            h = ((h ^ _round(0, x)) * _P1 + _P4) & _M64
    else:
        h = _P5
    h = (h + n) & _M64
    while p + 8 <= n:
        h ^= _round(0, int.from_bytes(data[p:p + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        h ^= (int.from_bytes(data[p:p + 4], "little") * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h ^= (data[p] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


# ------------------------------------------------------ the native decoder --

_lock = threading.Lock()
_state: dict = {"lib": None}


def lib_path() -> Path:
    digest = hashlib.sha1(SRC.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD / f"libzstd_decode-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path. Raises
    ``ZstdError`` naming the compiler where it is missing or fails."""
    out = lib_path()
    if out.exists():
        return out
    if shutil.which(CXX) is None:
        raise ZstdError(f"the zstd decoder needs the C++ compiler {CXX!r}, which "
                        "is not on PATH (decoder='python' is the slow reference)")
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run([CXX, *CXX_FLAGS, "-o", str(tmp), str(SRC)], check=True,
                       capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as exc:
        detail = getattr(exc, "stderr", "") or exc
        raise ZstdError(f"{CXX} failed to build {SRC.name}: {detail}") from None
    os.replace(tmp, out)  # atomic: concurrent processes each write their own tmp
    return out


def load():
    """The bound native library, built on first use."""
    with _lock:
        if _state["lib"] is None:
            path = build()
            lib = ctypes.CDLL(str(path))
            lib.raie_zstd_abi_version.restype = ctypes.c_int
            if lib.raie_zstd_abi_version() != ABI_VERSION:
                raise ZstdError(f"{path}: ABI version {lib.raie_zstd_abi_version()}, "
                                f"expected {ABI_VERSION}")
            lib.raie_zstd_decompress.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                                 ctypes.c_void_p, ctypes.c_size_t]
            lib.raie_zstd_decompress.restype = ctypes.c_int64
            lib.raie_zstd_content_size.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
            lib.raie_zstd_content_size.restype = ctypes.c_int64
            lib.raie_zstd_error_name.argtypes = [ctypes.c_int64]
            lib.raie_zstd_error_name.restype = ctypes.c_char_p
            _state["lib"] = lib
        return _state["lib"]


def _native_decompress(data: bytes, size: int | None) -> bytes:
    """ctypes releases the GIL for the call, so threads decode in parallel."""
    lib = load()
    known = lib.raie_zstd_content_size(data, len(data))
    if size is not None:
        cap = size
    else:
        cap = known if known >= 0 else max(4 * len(data), 1 << 16)
    while True:
        out = np.empty(max(cap, 1), np.uint8)
        n = lib.raie_zstd_decompress(data, len(data), out.ctypes.data, cap)
        if n >= 0:
            return out[:n].tobytes()
        if -n != ERR_DST_TOO_SMALL or known >= 0:
            raise ZstdError(lib.raie_zstd_error_name(n).decode())
        if size is not None:
            raise ZstdError(f"content of more than {size} bytes, {size} expected")
        cap *= 2


if __name__ == "__main__":
    print(f"zstd decoder build ok: {build()}")
