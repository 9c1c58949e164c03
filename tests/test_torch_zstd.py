"""The port's zstd decoders (``utils/zstd.py``): the native one
(``csrc/zstd_decode.cpp``, built with g++) and the plain Python reference,
held to each other byte for byte and, where the ``zstandard`` package is
installed, to its compressor's input. The corpus (levels 1, 3 and 19,
checksums on and off, empty and 1-byte inputs, repetitive and random data,
frames back to back with a skippable one) exercises every literals mode
(raw, RLE, Huffman in 1 and 4 streams, treeless) and every sequence table
mode (predefined, RLE, FSE-compressed, repeat); hand-made frames cover raw
and RLE blocks, the content-size encodings and the refusals without
``zstandard``."""

import collections
import random
import struct
import threading

import pytest

from rethink_acoustic_image_enhancement_tpu_torch.utils import zstd

LEVELS = (1, 3, 19)


def _words(rng: random.Random) -> list[bytes]:
    return [bytes(rng.choice(b"etaoinshrdlu") for _ in range(rng.randrange(2, 9)))
            for _ in range(300)]


def _x_separated() -> bytes:
    """A block of 32-byte tokens, then 'x' + each token again: the second
    block's literals are all 'x' (RLE literals) and its literal and match
    lengths all alike (RLE sequence tables)."""
    rng = random.Random(1)
    alpha = b"0123456789abcdefghijklmnopqrstuvw"
    tokens = [bytes(rng.choice(alpha) for _ in range(32)) for _ in range(4096)]
    perm = tokens[:]
    rng.shuffle(perm)
    return b"".join(tokens) + b"".join(b"x" + t for t in perm[:3000])


def _noise_after_words() -> bytes:
    """A block of words, then a block of 16-symbol noise with a few hundred
    copies from the first: few sequences after many (repeat-mode tables at
    level 19)."""
    rng = random.Random(3)
    words = _words(rng)
    first = b" ".join(rng.choice(words) for _ in range(30000))[:131072]
    parts = []
    while sum(map(len, parts)) < 131072:
        parts.append(bytes(rng.choice(b"ABCDEFGHIJKLMNOP") for _ in range(200)))
        parts.append(first[rng.randrange(0, 100000):][:24])
    return first + b"".join(parts)


def _inputs() -> dict[str, bytes]:
    rng = random.Random(20)
    words = _words(rng)
    return {
        "empty": b"",
        "one-byte": b"a",
        "repetitive": b"abc" * 1000,
        "zeros": bytes(70000),
        "random": bytes(rng.getrandbits(8) for _ in range(3000)),
        "text": bytes(rng.choice(b"etaoin shrdlu\n") for _ in range(40000)),
        "two-symbols": bytes(rng.choice(b"ab") for _ in range(20000)),
        # 1-stream Huffman literals, predefined tables
        "short-words": b" ".join(rng.choice(words[:20]) for _ in range(60))[:400],
        # several blocks: treeless literals
        "words": b" ".join(rng.choice(words) for _ in range(30000)),
        "x-separated": _x_separated(),
        "noise-after-words": _noise_after_words(),
    }


INPUTS = _inputs()


@pytest.fixture(scope="module")
def zstandard():
    return pytest.importorskip("zstandard")


@pytest.fixture(scope="module")
def frames(zstandard):
    out = {}
    for name, data in INPUTS.items():
        for level in LEVELS:
            for checksum in (False, True):
                c = zstandard.ZstdCompressor(level=level, write_checksum=checksum)
                out[name, level, checksum] = c.compress(data)
    return out


@pytest.mark.parametrize("checksum", [False, True], ids=["no-checksum", "checksum"])
@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("name", list(INPUTS))
def test_both_decoders_give_the_input(frames, name, level, checksum):
    frame = frames[name, level, checksum]
    native = zstd.decompress(frame)
    assert native == zstd.decompress(frame, decoder="python")
    assert native == INPUTS[name]


def _census(monkeypatch, frames):
    """(literals kind, streams) and (table, mode) of every block the Python
    decoder reads."""
    seen = collections.Counter()
    literals, sequences = zstd._literals, zstd._sequences

    def lit(buf, st):
        kind, fmt = buf[0] & 3, (buf[0] >> 2) & 3
        seen["literals", kind, 0 if kind < 2 else 1 if fmt == 0 else 4] += 1
        return literals(buf, st)

    def seq(buf, p, st):
        if buf[p]:
            modes = buf[p + (1 if buf[p] < 128 else 2 if buf[p] < 255 else 3)]
            for table, shift in (("LL", 6), ("OF", 4), ("ML", 2)):
                seen["table", table, (modes >> shift) & 3] += 1
        return sequences(buf, p, st)

    monkeypatch.setattr(zstd, "_literals", lit)
    monkeypatch.setattr(zstd, "_sequences", seq)
    for frame in frames.values():
        zstd.decompress(frame, decoder="python")
    return seen


def test_the_corpus_exercises_every_mode(frames, monkeypatch):
    seen = _census(monkeypatch, frames)
    literals = {(k, s) for kind, k, s in seen if kind == "literals"}
    # raw, RLE, Huffman in 1 and in 4 streams, treeless
    assert {(0, 0), (1, 0), (2, 1), (2, 4), (3, 4)} <= literals, literals
    modes = {m for kind, _, m in seen if kind == "table"}
    assert modes == {0, 1, 2, 3}, modes  # predefined, RLE, FSE, repeat
    for table in ("LL", "OF", "ML"):
        assert {0, 2} <= {m for kind, t, m in seen if kind == "table" and t == table}


def test_frames_back_to_back_with_a_skippable_one(frames, zstandard):
    # a frame without a content size (streamed), one with a checksum, a
    # skippable frame between them, and a windowed frame of level 19
    obj = zstandard.ZstdCompressor(level=3).compressobj()
    streamed = obj.compress(INPUTS["text"]) + obj.flush()
    assert zstandard.get_frame_parameters(streamed).content_size == \
        zstandard.CONTENTSIZE_UNKNOWN
    skippable = struct.pack("<II", 0x184D2A53, 5) + b"hello"
    parts = [frames["words", 19, True], skippable, streamed, frames["one-byte", 1, True],
             frames["empty", 1, False]]
    blob = b"".join(parts)
    want = INPUTS["words"] + INPUTS["text"] + b"a"
    assert zstd.decompress(blob) == want
    assert zstd.decompress(blob, decoder="python") == want


def test_output_grows_when_no_frame_says_its_size(zstandard):
    data = bytes(1 << 20)  # compresses ~5000x: the first guess is far too small
    obj = zstandard.ZstdCompressor(level=1).compressobj()
    frame = obj.compress(data) + obj.flush()
    assert len(frame) * 4 < len(data)
    assert zstd.decompress(frame) == data


def test_native_decoder_runs_in_threads(frames):
    cases = [(frames[n, 19, True], INPUTS[n]) for n in ("words", "x-separated", "text")] * 4
    out = [None] * len(cases)

    def work(i):
        out[i] = zstd.decompress(cases[i][0])

    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(cases))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(o == want for o, (_, want) in zip(out, cases))


# ------------------------------------------------ hand-made frames, no oracle --

def _frame(fhd: int, header: bytes, blocks: list[bytes], checksum: bytes = b"") -> bytes:
    return struct.pack("<I", zstd.FRAME_MAGIC) + bytes([fhd]) + header + \
        b"".join(blocks) + checksum


def _block(kind: int, size: int, body: bytes, last: bool) -> bytes:
    return (int(last) | kind << 1 | size << 3).to_bytes(3, "little") + body


def _both(data: bytes) -> bytes:
    native = zstd.decompress(data)
    assert native == zstd.decompress(data, decoder="python")
    return native


@pytest.mark.parametrize("case", ["raw-windowed", "rle-single-1", "rle-single-2",
                                  "raw-and-rle-4", "checksum"])
def test_handmade_frames(case):
    raw = _block(0, 5, b"hello", last=False)
    rle = _block(1, 300, b"z", last=True)
    if case == "raw-windowed":  # window descriptor, no content size
        got, want = _both(_frame(0x00, b"\x00", [_block(0, 5, b"hello", True)])), b"hello"
    elif case == "rle-single-1":  # single segment, 1-byte content size
        got = _both(_frame(0x20, bytes([200]), [_block(1, 200, b"q", True)]))
        want = b"q" * 200
    elif case == "rle-single-2":  # 2-byte content size, stored less 256
        got, want = _both(_frame(0x60, struct.pack("<H", 300 - 256), [rle])), b"z" * 300
    elif case == "raw-and-rle-4":  # 4-byte content size, windowed
        got = _both(_frame(0x80, b"\x08" + struct.pack("<I", 305), [raw, rle]))
        want = b"hello" + b"z" * 300
    else:
        want = b"hello"
        digest = struct.pack("<I", zstd.xxh64(want) & 0xFFFFFFFF)
        got = _both(_frame(0x04, b"\x00", [_block(0, 5, want, True)], digest))
    assert got == want


def test_xxh64_known_values():
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999


def test_empty_input_and_skippable_frames_only():
    assert _both(b"") == b""
    assert _both(struct.pack("<II", 0x184D2A50, 3) + b"abc") == b""


@pytest.mark.parametrize("decoder", ["native", "python"])
@pytest.mark.parametrize("case,match", [
    ("bad-magic", "magic"),
    ("truncated", "truncated"),
    ("checksum", "checksum"),
    ("dictionary", "dictionary"),
    ("content-size", "content size|says"),
    ("reserved-block", "reserved"),
])
def test_refusals(decoder, case, match):
    good = _frame(0x24, bytes([5]), [_block(0, 5, b"hello", True)],
                  struct.pack("<I", zstd.xxh64(b"hello") & 0xFFFFFFFF))
    data = {
        "bad-magic": b"\x00" + good[1:],
        "truncated": good[:-6],
        "checksum": good[:-1] + bytes([good[-1] ^ 1]),
        "dictionary": _frame(0x01, b"\x00\x07", [_block(0, 1, b"a", True)]),
        "content-size": _frame(0x20, bytes([6]), [_block(0, 5, b"hello", True)]),
        "reserved-block": _frame(0x00, b"\x00", [_block(3, 1, b"a", True)]),
    }[case]
    with pytest.raises(zstd.ZstdError, match=match):
        zstd.decompress(data, decoder=decoder)


def test_a_missing_compiler_is_named(monkeypatch, tmp_path):
    monkeypatch.setattr(zstd, "BUILD", tmp_path)
    monkeypatch.setattr(zstd, "CXX", "no-such-cxx")
    monkeypatch.setattr(zstd, "_state", {"lib": None})
    with pytest.raises(zstd.ZstdError, match="no-such-cxx"):
        zstd.decompress(b"")
    with pytest.raises(ValueError, match="'native' or 'python'"):
        zstd.decompress(b"", decoder="fast")


@pytest.mark.parametrize("decoder", ["native", "python"])
def test_a_stated_size_is_held(decoder):
    frame = _frame(0x00, b"\x00", [_block(1, 300, b"z", True)])  # no content size
    assert zstd.decompress(frame, decoder=decoder, size=300) == b"z" * 300
    for size in (299, 301):
        with pytest.raises(zstd.ZstdError, match="expected"):
            zstd.decompress(frame, decoder=decoder, size=size)
