// Native host-pipeline kernels for the data loader.
//
// The reference corrupts frames with per-pixel Python/numpy loops on the
// host (Train/basicsr/train.py:431-448, paired_image_dataset.py:19-36) —
// a known CPU bottleneck feeding the accelerator. These are the
// multithreaded C++ equivalents, exposed through a plain C ABI and loaded
// from Python via ctypes (see native.py). No external dependencies.
//
// Build: make -C rethink_acoustic_image_enhancement_tpu/native
//    or: python -m rethink_acoustic_image_enhancement_tpu.utils.native

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cmath>
#include <thread>
#include <vector>

namespace {

// xoshiro256** — fast, splittable-by-seed PRNG for mask sampling.
struct Xoshiro256 {
  uint64_t s[4];
  explicit Xoshiro256(uint64_t seed) {
    // splitmix64 seeding
    uint64_t x = seed;
    for (int i = 0; i < 4; ++i) {
      x += 0x9e3779b97f4a7c15ULL;
      uint64_t z = x;
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      s[i] = z ^ (z >> 31);
    }
  }
  static inline uint64_t rotl(uint64_t v, int k) {
    return (v << k) | (v >> (64 - k));
  }
  inline uint64_t next() {
    const uint64_t result = rotl(s[1] * 5, 7) * 9;
    const uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  inline float uniform() {  // [0, 1)
    return (next() >> 40) * (1.0f / 16777216.0f);
  }
};

int resolve_threads(int nthreads, int64_t work) {
  if (nthreads <= 0) {
    nthreads = static_cast<int>(std::thread::hardware_concurrency());
    if (nthreads <= 0) nthreads = 1;
  }
  int64_t max_useful = std::max<int64_t>(1, work / (1 << 16));
  return static_cast<int>(std::min<int64_t>(nthreads, max_useful));
}

template <typename F>
void parallel_for(int64_t n, int nthreads, F&& fn) {
  nthreads = resolve_threads(nthreads, n);
  if (nthreads <= 1) {
    fn(0, n, 0);
    return;
  }
  std::vector<std::thread> workers;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    workers.emplace_back([&fn, lo, hi, t] { fn(lo, hi, t); });
  }
  for (auto& w : workers) w.join();
}

}  // namespace

extern "C" {

// out = img * keep - value + value * keep, keep ~ Bernoulli(1 - prob).
// In-place over n floats. Matches input_mask semantics
// (paired_image_dataset.py:19-36): kept pixels unchanged, dropped
// pixels forced to -value.
void raie_input_mask_f32(float* img, int64_t n, float prob, float value,
                         uint64_t seed, int nthreads) {
  prob = std::min(prob, 1.0f);
  if (prob <= 0.0f) return;
  parallel_for(n, nthreads, [=](int64_t lo, int64_t hi, int tid) {
    Xoshiro256 rng(seed ^ (0x9e3779b97f4a7c15ULL * (tid + 1)));
    for (int64_t k = lo; k < hi; ++k) {
      bool keep = rng.uniform() >= prob;
      img[k] = keep ? img[k] : -value;
    }
  });
}

// Per-frame masking of an (F, HW) stack with per-frame probabilities.
void raie_mask_frames_f32(float* stack, int64_t frames, int64_t hw,
                          const float* probs, float value, uint64_t seed,
                          int nthreads) {
  parallel_for(frames, nthreads, [=](int64_t lo, int64_t hi, int tid) {
    (void)tid;
    for (int64_t f = lo; f < hi; ++f) {
      float p = std::min(probs[f], 1.0f);
      Xoshiro256 rng(seed + 0x517cc1b727220a95ULL * (f + 1));
      float* row = stack + f * hw;
      if (p <= 0.0f) continue;
      for (int64_t k = 0; k < hw; ++k) {
        bool keep = rng.uniform() >= p;
        row[k] = keep ? row[k] : -value;
      }
    }
  });
}

// The 8 flip/rot90 modes of transforms.py:217-268 on an (H, W, C) f32
// image; dst must hold h*w*c floats (transposed dims for modes 2,3,6,7).
void raie_geometric_f32(const float* src, float* dst, int64_t h, int64_t w,
                        int64_t c, int mode, int nthreads) {
  // destination index for source pixel (i, j)
  parallel_for(h, nthreads, [=](int64_t lo, int64_t hi, int tid) {
    (void)tid;
    for (int64_t i = lo; i < hi; ++i) {
      for (int64_t j = 0; j < w; ++j) {
        int64_t di, dj, dw;
        switch (mode) {
          case 0: di = i; dj = j; dw = w; break;                    // id
          case 1: di = h - 1 - i; dj = j; dw = w; break;            // flipud
          case 2: di = w - 1 - j; dj = i; dw = h; break;            // rot90
          case 3: di = j; dj = i; dw = h; break;                    // rot90+flipud
          case 4: di = h - 1 - i; dj = w - 1 - j; dw = w; break;    // rot180
          case 5: di = i; dj = w - 1 - j; dw = w; break;            // rot180+flipud
          case 6: di = j; dj = h - 1 - i; dw = h; break;            // rot270
          case 7: di = w - 1 - j; dj = h - 1 - i; dw = h; break;    // rot270+flipud
          default: di = i; dj = j; dw = w; break;
        }
        std::memcpy(dst + (di * dw + dj) * c, src + (i * w + j) * c,
                    sizeof(float) * c);
      }
    }
  });
}

// uint8 HWC -> float32 [0,1], optional BGR->RGB swap (c==3).
void raie_u8_to_f32_norm(const uint8_t* src, float* dst, int64_t n,
                         int64_t c, int bgr2rgb, int nthreads) {
  const float inv = 1.0f / 255.0f;
  int64_t pixels = n / c;
  parallel_for(pixels, nthreads, [=](int64_t lo, int64_t hi, int tid) {
    (void)tid;
    if (bgr2rgb && c == 3) {
      for (int64_t p = lo; p < hi; ++p) {
        dst[p * 3 + 0] = src[p * 3 + 2] * inv;
        dst[p * 3 + 1] = src[p * 3 + 1] * inv;
        dst[p * 3 + 2] = src[p * 3 + 0] * inv;
      }
    } else {
      for (int64_t k = lo * c; k < hi * c; ++k) dst[k] = src[k] * inv;
    }
  });
}

int raie_native_abi_version() { return 1; }

}  // extern "C"
