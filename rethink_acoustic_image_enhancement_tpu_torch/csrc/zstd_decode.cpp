// Zstandard (RFC 8878) decompression with a plain C interface, for reading
// orbax/tensorstore checkpoints on a machine without a zstd library.
//
//   int64_t raie_zstd_decompress(src, n, dst, cap)
//       the content of the frames in src[0, n) written to dst; returns its
//       size, or -code (raie_zstd_error_name(-code) says what went wrong;
//       code 2 means dst is too small: grow it and call again).
//   int64_t raie_zstd_content_size(src, n)
//       the sum of the frames' declared content sizes, or -1 where a frame
//       does not declare one (or the header is malformed).
//
// Frames with and without a content size, single-segment or windowed, the
// xxHash64 content checksum (checked), skippable frames; raw, RLE and
// compressed blocks; raw, RLE, Huffman (1 or 4 streams) and treeless
// literals; predefined, RLE, FSE and repeat sequence tables; the three
// repeat offsets. Dictionaries are refused. It follows the plain Python
// decoder of utils/zstd.py step for step.
//
// Build: g++ -O2 -std=c++17 -fPIC -shared -o libzstd_decode.so zstd_decode.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Err : int64_t {
  OK = 0,
  CORRUPT = 1,
  DST_TOO_SMALL = 2,
  TRUNCATED = 3,
  BAD_MAGIC = 4,
  DICTIONARY = 5,
  CHECKSUM = 6,
  CONTENT_SIZE = 7,
  RESERVED = 8,
  OFFSET = 9,
};

const char* kErrNames[] = {
    "ok",
    "corrupt zstd data",
    "output buffer too small",
    "truncated zstd data",
    "not a zstd frame (bad magic number)",
    "frame needs a dictionary, which this decoder does not take",
    "content checksum mismatch",
    "frame content size differs from its header",
    "reserved field set in a frame, block or sequences header",
    "match offset before the frame's start",
};

struct Fail {
  Err code;
};
[[noreturn]] void fail(Err e) { throw Fail{e}; }

constexpr uint32_t kFrameMagic = 0xFD2FB528u;
constexpr uint32_t kSkippableMask = 0xFFFFFFF0u, kSkippableMagic = 0x184D2A50u;
constexpr size_t kBlockMax = 128 * 1024;

inline uint64_t load_le(const uint8_t* p, int n) {
  uint64_t v = 0;
  for (int i = 0; i < n; ++i) v |= uint64_t(p[i]) << (8 * i);
  return v;
}

inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;  // little-endian hosts (x86-64, aarch64)
}

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ------------------------------------------------------------ bit readers --

// A backward bitstream copied between 8 zero bytes on each side, so that any
// read of up to 56 bits at a position >= -64 is one unaligned load: bits
// below the stream's start read as 0, as the format asks.
struct Backward {
  std::vector<uint8_t> buf;
  const uint8_t* base;  // the stream's first byte inside buf
  int64_t pos;          // bits left above the start; < 0 after overflow

  void init(const uint8_t* s, size_t n) {
    if (n == 0 || s[n - 1] == 0) fail(CORRUPT);
    buf.assign(n + 16, 0);
    std::memcpy(buf.data() + 8, s, n);
    base = buf.data() + 8;
    pos = int64_t(8 * (n - 1)) + highbit(s[n - 1]);
  }
  inline uint64_t get(int64_t at, int nb) const {
    if (nb == 0) return 0;
    if (at < -64) return 0;
    const uint8_t* p = base + (at >> 3);  // arithmetic shift: floor
    return (load64(p) >> (at & 7)) & ((uint64_t(1) << nb) - 1);
  }
  inline uint64_t read(int nb) {
    pos -= nb;
    return get(pos, nb);
  }
};

struct Forward {
  const uint8_t* s;
  int64_t bit, end;  // in bits
  uint64_t peek(int nb) const {
    uint64_t v = 0;
    int64_t lo = bit >> 3, hi = std::min((bit + nb + 7) >> 3, end >> 3);
    for (int64_t i = lo; i < hi; ++i) v |= uint64_t(s[i]) << (8 * (i - lo));
    return (v >> (bit & 7)) & ((uint64_t(1) << nb) - 1);
  }
  void skip(int nb) {
    bit += nb;
    if (bit > end) fail(CORRUPT);
  }
  uint64_t read(int nb) {
    uint64_t v = peek(nb);
    skip(nb);
    return v;
  }
};

// ------------------------------------------------------------------ FSE --

struct FseTable {
  int log = 0;
  std::vector<uint16_t> sym, base;
  std::vector<uint8_t> nbits;
  bool set = false;
};

// An FSE table description at s[p, end) -> probabilities and accuracy log;
// returns the offset after it.
size_t read_distribution(const uint8_t* s, size_t p, size_t end, int max_log,
                         int max_symbol, std::vector<int>& probs, int& log) {
  Forward r{s, int64_t(p) * 8, int64_t(end) * 8};
  log = int(r.read(4)) + 5;
  if (log > max_log) fail(CORRUPT);
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  probs.clear();
  while (remaining > 1) {
    if (int(probs.size()) > max_symbol) fail(CORRUPT);
    int most = 2 * threshold - 1 - remaining;
    int v = int(r.peek(nbits)), val;
    if ((v & (threshold - 1)) < most) {
      val = v & (threshold - 1);
      r.skip(nbits - 1);
    } else {
      val = v & (2 * threshold - 1);
      if (val >= threshold) val -= most;
      r.skip(nbits);
    }
    int prob = val - 1;
    remaining -= prob < 0 ? -prob : prob;
    probs.push_back(prob);
    if (prob == 0) {
      for (;;) {
        int rep = int(r.read(2));
        for (int i = 0; i < rep; ++i) probs.push_back(0);
        if (rep != 3) break;
        if (int(probs.size()) > max_symbol + 1) fail(CORRUPT);
      }
    }
    while (remaining < threshold) {
      --nbits;
      threshold >>= 1;
    }
  }
  if (remaining != 1 || int(probs.size()) > max_symbol + 1) fail(CORRUPT);
  return size_t((r.bit + 7) >> 3);
}

void build_fse(const std::vector<int>& probs, int log, FseTable& t) {
  int size = 1 << log;
  t.log = log;
  t.sym.assign(size, 0);
  t.base.assign(size, 0);
  t.nbits.assign(size, 0);
  int high = size - 1;
  std::vector<int> next(probs.size());
  for (size_t s = 0; s < probs.size(); ++s) {
    if (probs[s] == -1) {
      if (high < 0) fail(CORRUPT);
      t.sym[high--] = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = probs[s];
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (size_t s = 0; s < probs.size(); ++s) {
    for (int i = 0; i < probs[s]; ++i) {
      t.sym[pos] = uint16_t(s);
      pos = (pos + step) & mask;
      while (pos > high) pos = (pos + step) & mask;
    }
  }
  if (pos != 0) fail(CORRUPT);
  for (int u = 0; u < size; ++u) {
    int x = next[t.sym[u]]++;
    int nb = log - highbit(uint32_t(x));
    t.nbits[u] = uint8_t(nb);
    t.base[u] = uint16_t((x << nb) - size);
  }
  t.set = true;
}

void rle_table(int symbol, FseTable& t) {
  t.log = 0;
  t.sym.assign(1, uint16_t(symbol));
  t.base.assign(1, 0);
  t.nbits.assign(1, 0);
  t.set = true;
}

const int kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                            2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10,   11,   12,   13,    14,    15,    16,
                              17, 18, 19, 20, 21, 22, 23, 24,   25,   26,   27,    28,    29,    30,
                              31, 32, 33, 34, 35, 37, 39, 41,   43,   47,   51,    59,    67,    83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int kMaxLog[3] = {9, 8, 9};  // LL, OF, ML
const int kMaxSymbol[3] = {35, 31, 52};

struct Predefined {
  FseTable t[3];
  Predefined() {
    std::vector<int> p(kLLDefault, kLLDefault + 36);
    build_fse(p, 6, t[0]);
    p.assign(kOFDefault, kOFDefault + 29);
    build_fse(p, 5, t[1]);
    p.assign(53, 1);
    const int head[9] = {1, 4, 3, 2, 2, 2, 2, 2, 2};
    for (int i = 0; i < 9; ++i) p[i] = head[i];
    for (int i = 46; i < 53; ++i) p[i] = -1;
    build_fse(p, 6, t[2]);
  }
};

const Predefined& predefined() {
  static const Predefined p;  // thread-safe initialisation (C++11)
  return p;
}

// -------------------------------------------------------------- Huffman --

struct Huffman {
  int max_bits = 0;
  std::vector<uint16_t> entry;  // symbol | bits << 8, indexed by max_bits bits
  bool set = false;
};

void huffman_weights_fse(const uint8_t* s, size_t n, std::vector<int>& out) {
  std::vector<int> probs;
  int log;
  size_t p = read_distribution(s, 0, n, 6, 255, probs, log);
  FseTable t;
  build_fse(probs, log, t);
  if (p > n) fail(CORRUPT);
  Backward r;
  r.init(s + p, n - p);
  uint32_t s1 = uint32_t(r.read(log)), s2 = uint32_t(r.read(log));
  out.clear();
  for (;;) {
    if (out.size() > 254) fail(CORRUPT);
    out.push_back(t.sym[s1]);
    s1 = t.base[s1] + uint32_t(r.read(t.nbits[s1]));
    if (r.pos < 0) {
      out.push_back(t.sym[s2]);
      break;
    }
    out.push_back(t.sym[s2]);
    s2 = t.base[s2] + uint32_t(r.read(t.nbits[s2]));
    if (r.pos < 0) {
      out.push_back(t.sym[s1]);
      break;
    }
  }
}

size_t read_huffman(const uint8_t* s, size_t p, size_t end, Huffman& h) {
  if (p >= end) fail(TRUNCATED);
  int head = s[p++];
  std::vector<int> w;
  if (head < 128) {
    if (p + head > end) fail(TRUNCATED);
    huffman_weights_fse(s + p, head, w);
    p += head;
  } else {
    int n = head - 127;
    size_t nbytes = size_t(n + 1) / 2;
    if (p + nbytes > end) fail(TRUNCATED);
    for (int i = 0; i < n; ++i) {
      uint8_t b = s[p + i / 2];
      w.push_back(i % 2 == 0 ? b >> 4 : b & 15);
    }
    p += nbytes;
  }
  uint32_t total = 0;
  for (int x : w) {
    if (x > 11) fail(CORRUPT);
    if (x) total += 1u << (x - 1);
  }
  if (total == 0) fail(CORRUPT);
  int max_bits = highbit(total) + 1;
  uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) fail(CORRUPT);
  w.push_back(highbit(rest) + 1);
  if (max_bits > 11 || w.size() > 256) fail(CORRUPT);
  int size = 1 << max_bits;
  h.max_bits = max_bits;
  h.entry.assign(size, 0);
  int pos = 0;
  for (int wt = 1; wt <= max_bits; ++wt) {
    for (size_t sy = 0; sy < w.size(); ++sy) {
      if (w[sy] != wt) continue;
      int n = 1 << (wt - 1);
      uint16_t e = uint16_t(sy | ((max_bits + 1 - wt) << 8));
      std::fill(h.entry.begin() + pos, h.entry.begin() + pos + n, e);
      pos += n;
    }
  }
  h.set = true;
  return p;
}

// Decodes count[i] symbols from each of k streams into out[i], the streams
// interleaved symbol by symbol (their dependency chains overlap).
void huffman_streams(const Huffman& h, int k, const uint8_t* const* s,
                     const size_t* n, uint8_t* const* out, const size_t* count,
                     Backward* r) {
  const int mb = h.max_bits;
  const uint16_t* entry = h.entry.data();
  int64_t pos[4];
  size_t common = count[0];
  for (int i = 0; i < k; ++i) {
    r[i].init(s[i], n[i]);
    pos[i] = r[i].pos;
    common = std::min(common, count[i]);
  }
  // get() reads nothing below 64 bits under a stream's start, so a corrupt
  // stream only runs its position down; the checks after the loops see it
  for (size_t j = 0; j < common; ++j) {
    for (int i = 0; i < k; ++i) {
      uint16_t e = entry[r[i].get(pos[i] - mb, mb)];
      out[i][j] = uint8_t(e);
      pos[i] -= e >> 8;
    }
  }
  for (int i = 0; i < k; ++i) {
    for (size_t j = common; j < count[i]; ++j) {
      uint16_t e = entry[r[i].get(pos[i] - mb, mb)];
      out[i][j] = uint8_t(e);
      pos[i] -= e >> 8;
    }
    if (pos[i] != 0) fail(CORRUPT);
  }
}

// ------------------------------------------------------------- a block --

struct FrameState {
  uint64_t rep[3] = {1, 4, 8};
  Huffman huffman;
  FseTable tables[3];  // LL, OF, ML
  std::vector<uint8_t> lit;
  Backward scratch, streams[4];
};

struct Out {
  uint8_t* dst;
  size_t cap, n;
  void need(size_t k) const {
    if (n + k > cap) fail(DST_TOO_SMALL);
  }
};

// The literals section at s[0, n) into st.lit; returns the offset after it.
size_t literals(const uint8_t* s, size_t n, FrameState& st) {
  if (n < 1) fail(TRUNCATED);
  int b0 = s[0], kind = b0 & 3, fmt = (b0 >> 2) & 3;
  if (kind < 2) {
    size_t size, p;
    if (fmt == 0 || fmt == 2) {
      size = b0 >> 3;
      p = 1;
    } else if (fmt == 1) {
      if (n < 2) fail(TRUNCATED);
      size = (b0 >> 4) + (size_t(s[1]) << 4);
      p = 2;
    } else {
      if (n < 3) fail(TRUNCATED);
      size = (b0 >> 4) + (size_t(s[1]) << 4) + (size_t(s[2]) << 12);
      p = 3;
    }
    if (kind == 0) {
      if (p + size > n) fail(TRUNCATED);
      st.lit.assign(s + p, s + p + size);
      return p + size;
    }
    if (p >= n) fail(TRUNCATED);
    st.lit.assign(size, s[p]);
    return p + 1;
  }
  static const int kStreams[4] = {1, 4, 4, 4}, kHeader[4] = {3, 3, 4, 5},
                   kBits[4] = {10, 10, 14, 18};
  int streams = kStreams[fmt], hsize = kHeader[fmt], bits = kBits[fmt];
  if (size_t(hsize) > n) fail(TRUNCATED);
  uint64_t hdr = load_le(s, hsize);
  size_t size = (hdr >> 4) & ((1u << bits) - 1);
  size_t csize = (hdr >> (4 + bits)) & ((1u << bits) - 1);
  size_t p = hsize, end = hsize + csize;
  if (end > n) fail(TRUNCATED);
  if (kind == 2) {
    p = read_huffman(s, p, end, st.huffman);
  } else if (!st.huffman.set) {
    fail(CORRUPT);  // treeless literals without a previous table
  }
  st.lit.resize(size);
  if (streams == 1) {
    const uint8_t* src = s + p;
    size_t len = end - p;
    uint8_t* dst = st.lit.data();
    huffman_streams(st.huffman, 1, &src, &len, &dst, &size, st.streams);
    return end;
  }
  if (p + 6 > end) fail(TRUNCATED);
  size_t len[4];
  for (int i = 0; i < 3; ++i) len[i] = s[p + 2 * i] | (size_t(s[p + 2 * i + 1]) << 8);
  p += 6;
  if (len[0] + len[1] + len[2] > end - p) fail(CORRUPT);
  len[3] = end - p - len[0] - len[1] - len[2];
  size_t seg = (size + 3) / 4;
  if (3 * seg > size) fail(CORRUPT);
  const uint8_t* src[4];
  uint8_t* dst[4];
  size_t count[4];
  for (int i = 0; i < 4; ++i) {
    src[i] = s + p;
    p += len[i];
    dst[i] = st.lit.data() + i * seg;
    count[i] = i < 3 ? seg : size - 3 * seg;
  }
  huffman_streams(st.huffman, 4, src, len, dst, count, st.streams);
  return end;
}

// Decodes the sequences at s[p, n) and executes them with st.lit into out.
void sequences(const uint8_t* s, size_t p, size_t n, FrameState& st, Out& out,
               size_t frame_start) {
  const uint8_t* lit = st.lit.data();
  size_t nlit = st.lit.size(), lp = 0;
  if (p >= n) fail(TRUNCATED);
  int b0 = s[p];
  size_t count;
  if (b0 == 0) {
    if (p + 1 != n) fail(CORRUPT);
    count = 0;
  } else {
    if (b0 < 128) {
      count = b0;
      p += 1;
    } else if (b0 < 255) {
      if (p + 2 > n) fail(TRUNCATED);
      count = (size_t(b0 - 128) << 8) + s[p + 1];
      p += 2;
    } else {
      if (p + 3 > n) fail(TRUNCATED);
      count = s[p + 1] + (size_t(s[p + 2]) << 8) + 0x7F00;
      p += 3;
    }
    if (p >= n) fail(TRUNCATED);
    int modes = s[p++];
    if (modes & 3) fail(RESERVED);
    const int mode[3] = {modes >> 6, (modes >> 4) & 3, (modes >> 2) & 3};
    std::vector<int> probs;
    for (int k = 0; k < 3; ++k) {
      FseTable& t = st.tables[k];
      if (mode[k] == 0) {
        t = predefined().t[k];
      } else if (mode[k] == 1) {
        if (p >= n || s[p] > kMaxSymbol[k]) fail(CORRUPT);
        rle_table(s[p++], t);
      } else if (mode[k] == 2) {
        int log;
        p = read_distribution(s, p, n, kMaxLog[k], kMaxSymbol[k], probs, log);
        build_fse(probs, log, t);
      } else if (!t.set) {
        fail(CORRUPT);  // repeat mode without a previous table
      }
    }
    if (p > n) fail(CORRUPT);
    const FseTable &LL = st.tables[0], &OF = st.tables[1], &ML = st.tables[2];
    Backward& r = st.scratch;
    r.init(s + p, n - p);
    uint32_t ll_s = uint32_t(r.read(LL.log)), of_s = uint32_t(r.read(OF.log)),
             ml_s = uint32_t(r.read(ML.log));
    uint64_t* rep = st.rep;
    for (size_t i = 0; i < count; ++i) {
      if (r.pos < -64) fail(CORRUPT);
      int ofc = OF.sym[of_s], mlc = ML.sym[ml_s], llc = LL.sym[ll_s];
      if (ofc > 31 || mlc > 52 || llc > 35) fail(CORRUPT);
      uint64_t ofv = (uint64_t(1) << ofc) + r.read(ofc);
      uint64_t ml = kMLBase[mlc] + r.read(kMLBits[mlc]);
      uint64_t ll = kLLBase[llc] + r.read(kLLBits[llc]);
      uint64_t off;
      if (ofv > 3) {
        off = ofv - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = off;
      } else {
        int idx = int(ofv) - 1 + (ll == 0);
        if (idx == 0) {
          off = rep[0];
        } else if (idx == 3) {
          off = rep[0] - 1;
          rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = off;
        } else {
          off = rep[idx];
          if (idx == 2) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = off;
        }
      }
      if (off == 0) fail(CORRUPT);
      // execute: literals, then the match
      if (ll > nlit - lp) fail(CORRUPT);
      out.need(ll + ml);
      std::memcpy(out.dst + out.n, lit + lp, ll);
      out.n += ll;
      lp += ll;
      if (off > out.n - frame_start) fail(OFFSET);
      uint8_t* d = out.dst + out.n;
      const uint8_t* src = d - off;
      if (off >= ml) {
        std::memcpy(d, src, ml);
      } else {
        for (uint64_t j = 0; j < ml; ++j) d[j] = src[j];
      }
      out.n += ml;
      if (i + 1 != count) {
        ll_s = LL.base[ll_s] + uint32_t(r.read(LL.nbits[ll_s]));
        ml_s = ML.base[ml_s] + uint32_t(r.read(ML.nbits[ml_s]));
        of_s = OF.base[of_s] + uint32_t(r.read(OF.nbits[of_s]));
      }
    }
    if (r.pos != 0) fail(CORRUPT);
  }
  out.need(nlit - lp);
  std::memcpy(out.dst + out.n, lit + lp, nlit - lp);
  out.n += nlit - lp;
}

// ------------------------------------------------------------- a frame --

struct Header {
  size_t size;            // header bytes after the magic
  int64_t content;        // -1 where absent
  uint64_t window;
  bool checksum;
};

Header frame_header(const uint8_t* s, size_t n) {
  if (n < 1) fail(TRUNCATED);
  int fhd = s[0];
  size_t p = 1;
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1;
  if (fhd & 8) fail(RESERVED);
  Header h{0, -1, 0, bool((fhd >> 2) & 1)};
  if (!single) {
    if (p >= n) fail(TRUNCATED);
    int wd = s[p++];
    int wlog = 10 + (wd >> 3);
    h.window = (uint64_t(1) << wlog) + ((uint64_t(1) << wlog) >> 3) * (wd & 7);
  }
  static const int kDid[4] = {0, 1, 2, 4};
  int did = kDid[fhd & 3];
  if (p + did > n) fail(TRUNCATED);
  if (did && load_le(s + p, did) != 0) fail(DICTIONARY);
  p += did;
  static const int kFcs[4] = {0, 2, 4, 8};
  int fcs = fcs_flag == 0 ? single : kFcs[fcs_flag];
  if (p + fcs > n) fail(TRUNCATED);
  if (fcs) h.content = int64_t(load_le(s + p, fcs) + (fcs == 2 ? 256 : 0));
  p += fcs;
  if (single) h.window = uint64_t(h.content);
  h.size = p;
  return h;
}

// xxHash64
constexpr uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
                   P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
                   P5 = 2870177450012600261ull;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t lane) {
  return rotl(acc + lane * P2, 31) * P1;
}

uint64_t xxh64(const uint8_t* d, size_t n) {
  size_t p = 0;
  uint64_t h;
  if (n >= 32) {
    uint64_t v[4] = {P1 + P2, P2, 0, 0 - P1};
    for (; p + 32 <= n; p += 32)
      for (int i = 0; i < 4; ++i) v[i] = xround(v[i], load64(d + p + 8 * i));
    h = rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18);
    for (int i = 0; i < 4; ++i) h = (h ^ xround(0, v[i])) * P1 + P4;
  } else {
    h = P5;
  }
  h += n;
  for (; p + 8 <= n; p += 8) h = rotl(h ^ xround(0, load64(d + p)), 27) * P1 + P4;
  if (p + 4 <= n) {
    h = rotl(h ^ (load_le(d + p, 4) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < n; ++p) h = rotl(h ^ (d[p] * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
}

size_t frame(const uint8_t* s, size_t n, Out& out) {
  Header h = frame_header(s, n);
  size_t p = h.size;
  size_t block_max = h.window < kBlockMax ? size_t(h.window) : kBlockMax;
  size_t start = out.n;
  FrameState st;
  for (;;) {
    if (p + 3 > n) fail(TRUNCATED);
    uint32_t bh = uint32_t(load_le(s + p, 3));
    p += 3;
    int last = bh & 1, kind = (bh >> 1) & 3;
    size_t size = bh >> 3;
    if (kind == 0) {
      if (p + size > n) fail(TRUNCATED);
      out.need(size);
      std::memcpy(out.dst + out.n, s + p, size);
      out.n += size;
      p += size;
    } else if (kind == 1) {
      if (p + 1 > n) fail(TRUNCATED);
      out.need(size);
      std::memset(out.dst + out.n, s[p], size);
      out.n += size;
      p += 1;
    } else if (kind == 2) {
      if (size > block_max) fail(CORRUPT);
      if (p + size > n) fail(TRUNCATED);
      size_t before = out.n;
      size_t q = literals(s + p, size, st);
      sequences(s + p, q, size, st, out, start);
      if (out.n - before > kBlockMax) fail(CORRUPT);
      p += size;
    } else {
      fail(RESERVED);
    }
    if (last) break;
  }
  if (h.content >= 0 && out.n - start != uint64_t(h.content)) fail(CONTENT_SIZE);
  if (h.checksum) {
    if (p + 4 > n) fail(TRUNCATED);
    uint32_t stored = uint32_t(load_le(s + p, 4));
    p += 4;
    if (uint32_t(xxh64(out.dst + start, out.n - start)) != stored) fail(CHECKSUM);
  }
  return p;
}

}  // namespace

extern "C" {

int raie_zstd_abi_version() { return 1; }

const char* raie_zstd_error_name(int64_t code) {
  int64_t c = code < 0 ? -code : code;
  if (c >= int64_t(sizeof(kErrNames) / sizeof(kErrNames[0]))) return "unknown error";
  return kErrNames[c];
}

int64_t raie_zstd_content_size(const uint8_t* src, size_t n) {
  int64_t total = 0;
  size_t p = 0;
  try {
    while (p < n) {
      if (p + 4 > n) return -1;
      uint32_t magic = uint32_t(load_le(src + p, 4));
      if ((magic & kSkippableMask) == kSkippableMagic) {
        if (p + 8 > n) return -1;
        p += 8 + load_le(src + p + 4, 4);
        continue;
      }
      if (magic != kFrameMagic) return -1;
      Header h = frame_header(src + p + 4, n - p - 4);
      if (h.content < 0) return -1;
      total += h.content;
      // walk the blocks to the next frame
      size_t q = p + 4 + h.size;
      for (;;) {
        if (q + 3 > n) return -1;
        uint32_t bh = uint32_t(load_le(src + q, 3));
        int kind = (bh >> 1) & 3;
        q += 3 + (kind == 1 ? 1 : size_t(bh >> 3));
        if (bh & 1) break;
      }
      p = q + (h.checksum ? 4 : 0);
    }
  } catch (const Fail&) {
    return -1;
  }
  return total;
}

int64_t raie_zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  Out out{dst, cap, 0};
  size_t p = 0;
  try {
    while (p < n) {
      if (p + 4 > n) fail(TRUNCATED);
      uint32_t magic = uint32_t(load_le(src + p, 4));
      if (magic == kFrameMagic) {
        p += 4;
        p += frame(src + p, n - p, out);
      } else if ((magic & kSkippableMask) == kSkippableMagic) {
        if (p + 8 > n) fail(TRUNCATED);
        size_t skip = size_t(load_le(src + p + 4, 4));
        if (skip > n - p - 8) fail(TRUNCATED);
        p += 8 + skip;
      } else {
        fail(BAD_MAGIC);
      }
    }
  } catch (const Fail& f) {
    return -int64_t(f.code);
  } catch (const std::bad_alloc&) {
    return -int64_t(CORRUPT);
  }
  return int64_t(out.n);
}

}  // extern "C"
