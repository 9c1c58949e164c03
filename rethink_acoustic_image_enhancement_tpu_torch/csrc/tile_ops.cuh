// Device code shared by the tile kernels of stage.cu (whole
// TransformerBlocks) and gdfn.cu (LN -> GDFN -> residual): cp.async weight
// and halo loads, bf16 mma.sync products on ldmatrix fragments, the clocks of
// the instrumented build, and the two halves of a tile that ends in the
// GDFN: r_ln_tile (the residual r and LN(r), in registers) and gdfn_chunks
// (the GDFN over chunks of hidden channels). Everything here works on one
// thread block and its shared memory; the kernels that include it lay that
// memory out through FfnSmem.
//
// What bounds these tiles on an H100 is latency, not the tensor-core rate:
// a tile's products are a few thousand mma.sync, each phase is short and ends
// in a barrier, and a warp waits on ldmatrix, cp.async and the barrier far
// longer than it executes. So a block is kept small enough (NTA = 256 threads,
// under half of an SM's shared memory and registers at C = 96) for two blocks
// to be resident on an SM, each filling the other's waits, and what used to
// make round trips through shared memory stays in registers:
//   - r = x + attn-out @ W_proj is never stored: a warp owns 16 halo pixels by
//     up to 96 channels as mma accumulator fragments (48 registers), seeded
//     with x straight from device memory in the fragment's own layout, and
//     takes LN(r)'s two-pass statistics from them with two shuffles over the
//     4 lanes that share a row (above 96 channels several warps share a row
//     and swap partial sums through a few floats of shared memory);
//   - the W_out accumulator (tile pixels x C, fp32) lives in registers over
//     all chunks, seeded once with r on the tile's own pixels, and is written
//     to device memory from registers.
// Buffers alias by lifetime (see FfnSmem): attn^T and W_proj share their
// bytes with the W_in / W_out chunks, attn @ v with LN(r), and v with the
// seed of the W_out accumulator and then with the hidden chunk.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NTA = 256;       // threads of a tile kernel's block
constexpr int NWA = NTA / 32;  // its warps
constexpr int MAXF = 6;        // 16-channel fragments of r a warp holds (96 channels)
constexpr int OUTF = 3;        // 16x16 fragments of the W_out accumulator a warp holds
constexpr int MAXG = 5;        // 16x16 fragments of the Gram a warp holds
constexpr int MAXGW = 9;       // the same in stage.cu's wide layout (8 heads of 48 channels)
constexpr int SMEM_LIMIT = 232448;  // 227 KB a block may opt into
constexpr int ERR_SMEM = 100001;    // tile does not fit in shared memory
constexpr int ERR_SHAPE = 100002;   // shape the kernels do not take
constexpr int MAX_C = 384;          // widest rows the kernels take
// Shared-memory rows are padded by PAD bf16 (16 bytes) so the 8 rows an
// ldmatrix reads fall in different banks; fp32 rows by PADF floats.
constexpr int PAD = 8;
constexpr int PADF = 4;

// fc: GDFN hidden channels per chunk (64 or 32); kp: rows of W_proj that
// stage.cu's kernel (C) holds at once (Cq, or a chunk where Cq x C bf16 does
// not fit beside the tile). C is the width of x and of the block's output;
// Cq that of q, k and v, heads heads of hc = Cq / heads channels: C itself,
// or on a model shard the channels of the shard's heads
// (ops/stage.py::fused_transformer_stage_shards). A tensor holds, per
// sample, H own rows with `halo` rows above and below them (Hs stored rows):
// the band of rows [y_img, y_img + H) of an image of H_img rows, its halo
// rows its neighbours' (ops/stage.py::fused_transformer_stage_bands). A
// whole image is the band with halo 0, y_img 0 and H_img = H.
struct Geo {
  int B, H, W, C, Cq, heads, hc, Fp, fc, th, tw, ntj, ntiles;
  int halo, Hs, y_img, H_img, kp;
};

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ inline size_t align128(size_t n) { return (n + 127) / 128 * 128; }
__host__ __device__ inline size_t max2(size_t a, size_t b) { return a > b ? a : b; }

// dst[K][N] (row stride N + PAD) = B[K][N] (bf16), 16-byte cp.async copies
// by the whole block of NTA threads: the products then read B from shared
// memory. The call returns at once; the data is there after cp_async_wait()
// and a barrier, so the copy overlaps the work between. bptr(k, n) points at
// element (k, n), n a multiple of 8.
template <class BP>
__device__ void load_b_async(bf16* dst, int K, int N, BP bptr) {
  const int n8 = N / 8, ld = N + PAD;
  // copy i is row i / n8, columns 8 (i % n8) and on; a thread's copies are
  // NTA apart, which it carries as rows and columns with no further division
  const int dr = NTA / n8, dc = NTA % n8;
  int r = threadIdx.x / n8, c = threadIdx.x % n8;
  while (r < K) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst + r * ld + c * 8);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(bptr(r, c * 8)));
    r += dr;
    c += dc;
    if (c >= n8) c -= n8, ++r;
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// bytes (a multiple of 16) from src to dst with cp.async, as load_b_async.
__device__ void copy_async(void* dst, const void* src, int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += NTA) {
    const unsigned s = (unsigned)__cvta_generic_to_shared((char*)dst + 16 * i);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"((const char*)src + 16 * i));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// How many 16-column fragments (NF) a warp takes side by side, sharing
// each A fragment: the NF in {1, 2, 3, 4} dividing `unit` (N / 16, or the
// fragments per head where A depends on the head) with the fewest
// fragment products on the busiest of nw warps, the larger NF on a tie.
__device__ __forceinline__ int pick_nf(int M, int N, int unit, int nw) {
  int best = 1, best_cost = 1 << 30;
  for (int nf = 1; nf <= 4; ++nf) {
    if (unit % nf) continue;
    const int items = (M / 16) * (N / (16 * nf));
    const int cost = (items + nw - 1) / nw * nf;
    if (cost <= best_cost) best = nf, best_cost = cost;
  }
  return best;
}

// Abramowitz-Stegun 7.1.26 erf, |error| < 1.5e-7 (the TPU kernel's
// _erf_approx, ops/pallas/gdfn.py:58-65), on the hardware's approximate
// reciprocal and 2^x (1 + 0.33 |x| is never subnormal, and a flushed
// exp(-x^2) is an erf of +-1): much cheaper than erff in the GELU gate.
__device__ __forceinline__ float erf_as(float x) {
  const float ax = fabsf(x);
  float t, e;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(t) : "f"(1.f + 0.3275911f * ax));
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(ax * ax * -1.4426950408889634f));
  const float poly = t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f +
                     t * (-1.453152027f + t * 1.061405429f))));
  return copysignf(1.f - poly * e, x);
}

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.f + erf_as(x * 0.70710678118654752f));
}

// Two adjacent values as float2, and back (bf16 4-byte, float 8-byte
// aligned); a += u * w.
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void st2(bf16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}
__device__ __forceinline__ void st2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void fma2(float2& a, float2 u, float2 w) {
  a.x += u.x * w.x;
  a.y += u.y * w.y;
}

// Two rows' 96 channels of x (fp32 or bf16) at px0 and px1 (a row's first
// channel of this thread) into an m64n96 accumulator layout (v[4j], v[4j+1]
// of row 0 at channels 8j, + 1; v[4j+2], v[4j+3] of row 1), 0 where not rd.
template <class Tin>
__device__ __forceinline__ void load_rows(float (&v)[48], const Tin* px0, const Tin* px1,
                                          bool rd0, bool rd1) {
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const float2 lo = rd0 ? ld2(px0 + 8 * j) : make_float2(0.f, 0.f);
    const float2 hi = rd1 ? ld2(px1 + 8 * j) : make_float2(0.f, 0.f);
    v[4 * j] = lo.x, v[4 * j + 1] = lo.y, v[4 * j + 2] = hi.x, v[4 * j + 3] = hi.y;
  }
}

// ldmatrix: four 8x8 bf16 matrices whose rows the lanes point at (lanes
// 8i..8i+7 give matrix i's rows), transposed with _t.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"((unsigned)__cvta_generic_to_shared(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"((unsigned)__cvta_generic_to_shared(p))
               : "memory");
}

// d[16x8] += a[16x16] b[16x8], bf16 operands, fp32 accumulation. A thread
// holds rows lane/4 and lane/4 + 8 of d at columns 2 (lane%4) and + 1:
// d[0], d[1] of the first row, d[2], d[3] of the second.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// lo, hi += A[16 x 16] B[16 x 16]: the two mma of one 16-column fragment
// (lo its columns 0-7, hi 8-15) on B's 16x16 block as one transposing
// ldmatrix left it in b.
__device__ __forceinline__ void frag_mma(float (&lo)[4], float (&hi)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[4]) {
  mma_bf16(lo, a, b[0], b[1]);
  mma_bf16(hi, a, b[2], b[3]);
}

// out[M][N] (bf16, row stride ldo) = A[M][K] B[K][N], bf16 operands, fp32
// accumulation, with mma.sync m16n8k16 on ldmatrix fragments, by a block of
// NTA threads. Each warp takes a 16 x (16 NF) strip at a time;
// aptr(m0, n0, k0) gives the origin of A's 16x16 fragment (A may depend on
// the output column, as per-head attention does), bptr(k, n) element (k, n)
// of B. Row strides are multiples of 8 elements. A k-step's fragments are all
// loaded before its mma run. (A second register set loaded a step ahead was
// tried and lost to spills at 128 registers a thread.)
template <int NF, class AP, class BP>
__device__ void gemm_nf(int M, int N, int K, AP aptr, int lda, BP bptr, bf16* out, int ldo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q2 = (lane & 3) * 2;  // the accumulator's row and column pair
  const int ng = N / (16 * NF), items = (M / 16) * ng;
  for (int it = warp; it < items; it += NWA) {
    const int m0 = (it / ng) * 16, n0 = (it % ng) * 16 * NF;
    float acc[2 * NF][4];
#pragma unroll
    for (int j = 0; j < 2 * NF; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int k = 0; k < K; k += 16) {
      unsigned a[4], b[NF][4];
      ldsm_x4(a, aptr(m0, n0, k) + (lane & 15) * lda + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NF; ++j)
        ldsm_x4_t(b[j], bptr(k + (lane & 15), n0 + 16 * j + (lane >> 4) * 8));
#pragma unroll
      for (int j = 0; j < NF; ++j) frag_mma(acc[2 * j], acc[2 * j + 1], a, b[j]);
    }
#pragma unroll
    for (int j = 0; j < 2 * NF; ++j) {
      bf16* o = out + (m0 + g) * ldo + n0 + 8 * j + q2;
      st2(o, make_float2(acc[j][0], acc[j][1]));
      st2(o + 8 * ldo, make_float2(acc[j][2], acc[j][3]));
    }
  }
}

// gemm_nf with the NF that pick_nf chooses; `unit` as there.
template <class AP, class BP>
__device__ void gemm(int M, int N, int K, int unit, AP aptr, int lda, BP bptr, bf16* out,
                     int ldo) {
  switch (pick_nf(M, N, unit, NWA)) {
    case 4: gemm_nf<4>(M, N, K, aptr, lda, bptr, out, ldo); break;
    case 3: gemm_nf<3>(M, N, K, aptr, lda, bptr, out, ldo); break;
    case 2: gemm_nf<2>(M, N, K, aptr, lda, bptr, out, ldo); break;
    default: gemm_nf<1>(M, N, K, aptr, lda, bptr, out, ldo);
  }
}

// A pixel of the band's own rows: computed, counted and stored.
__device__ __forceinline__ bool inside(const Geo& g, int yy, int xx) {
  return yy >= 0 && yy < g.H && xx >= 0 && xx < g.W;
}

// A pixel that may be read: a row the tensor holds (own or halo) and that
// lies in the image. Outside the image the convs see zeros, as torch's
// padding gives them; a band's halo rows elsewhere are real rows.
__device__ __forceinline__ bool readable(const Geo& g, int yy, int xx) {
  return yy >= -g.halo && yy < g.H + g.halo && g.y_img + yy >= 0 && g.y_img + yy < g.H_img &&
         xx >= 0 && xx < g.W;
}

// Element offset of pixel (yy, xx) of sample b, yy in [-halo, H + halo),
// in a tensor of ch channels (C by default).
__device__ __forceinline__ size_t pix(const Geo& g, int b, int yy, int xx, int ch) {
  return (((size_t)b * g.Hs + (yy + g.halo)) * g.W + xx) * ch;
}
__device__ __forceinline__ size_t pix(const Geo& g, int b, int yy, int xx) {
  return pix(g, b, yy, xx, g.C);
}

// Copy the (th+2) x (tw+2) pixels around a tile (ch bf16 channels each) into
// shared-memory rows of stride ldd (a multiple of 8) with 16-byte cp.async
// copies by the whole block of NTA threads, as one group: the copy overlaps
// what follows until cp_async_wait() and a barrier. Pixels that are not
// readable and rows n..m are zeroed with plain stores.
__device__ void load_halo_async(const bf16* x, bf16* dst, int ldd, const Geo& g, int b, int y0,
                                int x0, int m, int ch) {
  const int wr = g.tw + 2, n = (g.th + 2) * wr, nv = ch / 8;
  const int dr = NTA / nv, dc = NTA % nv;  // a thread's next copy, with no division
  int p = threadIdx.x / nv, c = threadIdx.x % nv;
  while (p < m) {
    const int yy = y0 - 1 + p / wr, xx = x0 - 1 + p % wr;
    bf16* d = dst + p * ldd + c * 8;
    if (p < n && readable(g, yy, xx)) {
      const unsigned sd = (unsigned)__cvta_generic_to_shared(d);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sd),
                   "l"(x + pix(g, b, yy, xx, ch) + c * 8));
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
    p += dr;
    c += dc;
    if (c >= nv) c -= nv, ++p;
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// ---- cycles per phase (the -DRAIE_PHASE_CLOCKS build only) ---------------

// In the instrumented build thread 0 of a block reads clock64() at each phase
// boundary and adds the difference to that phase's slot, kept in shared
// memory and written at the block's end to its row of a device buffer that
// the host sets beforehand. The normal build compiles all of it away.
constexpr int PHASE_SLOTS = 16;  // per block; the last slot counts tiles
#ifdef RAIE_PHASE_CLOCKS
struct PhaseClock {
  long long* acc;
  long long last;
  __device__ PhaseClock(long long* shared_slots) : acc(shared_slots) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < PHASE_SLOTS; ++i) acc[i] = 0;
      last = clock64();
    }
  }
  __device__ __forceinline__ void mark(int phase) {
    if (threadIdx.x == 0) {
      const long long t = clock64();
      acc[phase] += t - last;
      last = t;
    }
  }
  __device__ __forceinline__ void tile() {
    if (threadIdx.x == 0) acc[PHASE_SLOTS - 1] += 1;
  }
  // a barrier that only the instrumented build needs, to end a phase
  __device__ __forceinline__ void sync() { __syncthreads(); }
  __device__ void flush(long long* buf) {
    if (threadIdx.x == 0 && buf != nullptr) {
      long long* row = buf + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * PHASE_SLOTS;
      for (int i = 0; i < PHASE_SLOTS; ++i) row[i] = acc[i];
    }
  }
};
#define PHASE_CLOCK(pc)                          \
  __shared__ long long pc##_slots[PHASE_SLOTS];  \
  PhaseClock pc(pc##_slots)
#else
struct PhaseClock {
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void tile() {}
  __device__ __forceinline__ void sync() {}
  __device__ __forceinline__ void flush(long long*) {}
};
#define PHASE_CLOCK(pc) PhaseClock pc
#endif

// Phases of a block that ends in gdfn_tile (stage.cu's kernel (C) counts all
// of them, gdfn.cu's kernel from PH_LN2 on).
enum { PH_LOAD, PH_ATTN_V, PH_PROJ, PH_LN2, PH_W_IN, PH_DW_GATE, PH_W_OUT, PH_STORE };

// ---- a tile that ends in the GDFN ----------------------------------------

// Shared memory of such a block (host and device agree through this). With
// `attn`, the layout of stage.cu's kernels (C) and (C'), which first hold
// attn^T, W_proj, v and attn @ v (of Cq channels; Cq < 0 is C); else that of
// gdfn.cu's kernel. Three regions alias by lifetime:
//   w:  attn^T and W_proj side by side, dead after the W_proj product; then
//       one W_in chunk (win) and one W_out chunk (wout).
//   rn: attn @ v (bf16), dead after the W_proj product; then LN(r).
//   x:  v on the halo, dead after the attn @ v product; then the seed of the
//       W_out accumulator (r on the tile's own pixels, fp32), dead once every
//       warp has it in registers; then the hidden chunk t2 and the gate gg.
// Not aliased: two sets of a chunk's depthwise taps (one loads while the
// other is read), the LayerNorm's weight and bias, and the partial row sums
// that warps swap where more than one shares a row of r (C > 96). W_proj is
// held kp rows at a time (kp = C: all of it).
struct FfnSmem {
  size_t w, wproj, win, wout, rn, x, t2, gg, taps, lnw, lnb, stat, total;
  __host__ __device__ FfnSmem(int th, int tw, int C, int hc, int fc, bool attn, int kp,
                              int Cq = -1) {
    const int m1 = round16((th + 2) * (tw + 2)), P = th * tw, LX = C + PAD;
    const int LQ = (Cq < 0 ? C : Cq) + PAD;
    const size_t win_b = align128((size_t)C * (2 * fc + PAD) * 2);
    const size_t wout_b = align128((size_t)fc * LX * 2);
    const size_t attn_b = align128((size_t)hc * LQ * 2), proj_b = align128((size_t)kp * LX * 2);
    const size_t rows_b = align128((size_t)m1 * LX * 2), vrows_b = align128((size_t)m1 * LQ * 2);
    const size_t t2_b = align128((size_t)m1 * (2 * fc + PAD) * 2);
    const size_t gg_b = align128((size_t)P * (fc + PAD) * 2);
    const size_t seed_b = align128((size_t)P * (C + PADF) * 4);
    size_t o = 0;
    w = o;      win = w;  wout = w + win_b;  wproj = w + attn_b;
    o += max2(win_b + wout_b, attn ? attn_b + proj_b : 0);
    rn = o;     o += rows_b;
    x = o;      t2 = x;  gg = x + t2_b;
    o += max2(max2(t2_b + gg_b, seed_b), attn ? vrows_b : 0);
    taps = o;   o += align128((size_t)2 * 18 * fc * 4);
    lnw = o;    o += align128((size_t)C * 4);
    lnb = o;    o += align128((size_t)C * 4);
    stat = o;   o += C > 16 * MAXF ? align128((size_t)2 * m1 * 4 * 4) : 0;
    total = o;
  }
};

struct FfnBufs {
  bf16 *win, *wout, *rn, *t2, *gg;
  float *seed, *taps, *lnw, *lnb, *stat;
  __device__ FfnBufs() {}
  __device__ FfnBufs(unsigned char* smem, const FfnSmem& L)
      : win((bf16*)(smem + L.win)), wout((bf16*)(smem + L.wout)), rn((bf16*)(smem + L.rn)),
        t2((bf16*)(smem + L.t2)), gg((bf16*)(smem + L.gg)), seed((float*)(smem + L.x)),
        taps((float*)(smem + L.taps)), lnw((float*)(smem + L.lnw)),
        lnb((float*)(smem + L.lnb)), stat((float*)(smem + L.stat)) {}
};

// The GDFN's weights in the kernels' layout: W_in (C, 2Fp) with the gate's
// two halves at columns [0, F) and [Fp, Fp + F), depthwise taps (9, 2Fp)
// likewise, W_out (Fp, C); the padding is zero.
struct FfnWeights {
  const bf16* win;
  const float* wdw;
  const bf16* wout;
};

// Start the loads of hidden chunk [f0, f0 + FC): W_in's columns of both
// halves side by side into s.win, and the 18 rows of depthwise taps into
// set `set` (0 or 1) of s.taps. One cp.async group.
template <int FC>
__device__ __forceinline__ void ffn_load_chunk(const FfnBufs& s, const FfnWeights& wt,
                                               const Geo& g, int f0, int set) {
  constexpr int fc = FC, f4 = FC / 4;
  const int Fp = g.Fp, F2 = 2 * Fp;
  float* taps = s.taps + set * 18 * fc;
  for (int i = threadIdx.x; i < 18 * f4; i += NTA) {
    const int row = i / f4, tap = row % 9, half = row / 9;
    const unsigned d = (unsigned)__cvta_generic_to_shared(taps + row * fc + (i % f4) * 4);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(wt.wdw + (size_t)tap * F2 + half * Fp + f0 + (i % f4) * 4));
  }
  const bf16* win = wt.win;
  load_b_async(s.win, g.C, 2 * fc, [=](int k, int n) {
    return win + (size_t)k * F2 + (n < fc ? f0 + n : Fp + f0 + n - fc);
  });
}

// What stage.cu's kernels (C) and (C') give r_ln_tile beyond the tile, in
// shared memory: v on the halo and attn @ v (m1 rows of stride Cq + PAD),
// attn^T (hc rows of the same stride) and W_proj (g.kp rows of stride C +
// PAD); W_proj (Cq x C) in device memory, which the product loads kp rows at
// a time where kp < Cq; and (C') where r goes (fp32, C channels a pixel).
struct AttnIn {
  const bf16* v;
  const bf16* attn_t;
  bf16* wproj;
  bf16* oa;
  const bf16* wproj_dev;
  float* r_out;
};

// r = x [+ (attn @ v) @ W_proj] on the tile's 1-pixel halo, LN(r) (bf16) to
// s.rn, and with Seed r on the tile's own pixels (fp32) to s.seed; r itself
// stays in registers. It reads s.lnw, s.lnb and s.stat besides. A warp owns
// 16 halo rows by nf <= MAXF fragments of 16 channels
// as mma accumulators: a row's channels then lie in the 4 lanes of a quad,
// and where C > 96 in the quads of the ncw warps that share the row. The
// 16-row tiles go round by round where there are more of them than warps.
// With Attn, a warp first takes attn @ v of its rows (per head) and stores
// it as bf16 to a.oa: where one warp owns whole rows (ncw = 1) nobody else
// reads them and the W_proj product follows after a __syncwarp alone.
// LN(r) is zero on the ring outside the image, where torch zero-pads the
// depthwise input (BiasFree gives that by itself, r being 0 there; WithBias
// masks); without apply_ln, bf16(r) stands in for LN(r).
// products_done() runs once every product has read the w region, which the
// caller may then load the first W_in chunk into. On return, s.rn and s.seed
// are written but not yet fenced: gdfn_chunks begins with the barrier.
// NFS > 0 fixes nf at compile time (C = 16 NFS <= 96, one warp to a row), so
// the fragment loops carry no runtime bounds; NFS = 0 is any C.
// Stop (stage.cu's kernel (C'), Attn only) ends after the W_proj product:
// r = [x +] (attn @ v) @ W_proj, attn @ v of g.Cq channels, goes in fp32 to
// a.r_out on the tile's own pixels, x left out where it is null; no
// LayerNorm, and products_done is not called.
template <bool Attn, bool Seed, int NFS, bool Stop, class Tin, class F>
__device__ __forceinline__ void r_ln_tile_n(const FfnBufs& s, const Tin* __restrict__ x,
                                            const AttnIn& a, const Geo& g, int b, int y0, int x0,
                                            float eps, bool apply_ln, bool with_bias,
                                            F products_done, PhaseClock& pc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, q2 = (lane & 3) * 2;        // accumulator row and column pair
  const int lrow = lane & 15, lcol = (lane >> 4) * 8;  // this lane's ldmatrix row, column
  const int C = g.C, NC = C / 16;
  const int ncw = (NC + MAXF - 1) / MAXF, fpw = (NC + ncw - 1) / ncw;
  const int LX = C + PAD, LS = C + PADF;
  const int w1 = g.tw + 2, n1 = (g.th + 2) * w1, mtiles = round16(n1) / 16;
  const int mt_round = NWA / ncw, rounds = (mtiles + mt_round - 1) / mt_round;
  const int cg = warp % ncw, f_lo = cg * fpw;
  int nf_any = NC - f_lo < fpw ? NC - f_lo : fpw;
  if (nf_any < 0 || warp / ncw >= mt_round) nf_any = 0;
  const int nf = NFS > 0 ? NFS : nf_any;
  // attn @ v's width, and this warp's fragments of it: its share of C's
  // fragments where the two widths agree
  const int Cq = Stop ? g.Cq : C, LQ = Cq + PAD;
  int fq_lo = f_lo, nfq = nf;
  if constexpr (Stop) {
    const int NCQ = Cq / 16, fpwq = (NCQ + ncw - 1) / ncw;
    fq_lo = cg * fpwq;
    nfq = NCQ - fq_lo < fpwq ? NCQ - fq_lo : fpwq;
    if (nfq < 0 || nf == 0) nfq = 0;
  }
  const bool has_x = !Stop || x != nullptr;

  if constexpr (Attn) {
    const int hc = g.hc;
    int hoff[MAXF];  // first channel of the head each fragment lies in
#pragma unroll
    for (int j = 0; j < MAXF; ++j) hoff[j] = (fq_lo + j) * 16 / hc * hc;
    // all of this warp's fragments in one head: they share each A fragment
    const bool one_head = nfq == 0 || hoff[0] == (fq_lo + nfq - 1) * 16 / hc * hc;
    for (int rd = 0; rd < rounds; ++rd) {
      const int m0 = (rd * mt_round + warp / ncw) * 16;
      if (nfq == 0 || m0 >= mtiles * 16) continue;
      float acc[2 * MAXF][4];
#pragma unroll
      for (int j = 0; j < 2 * MAXF; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      // oa[p][h*hc + c] = sum_d v[p][h*hc + d] attn[h][c][d]; hc % 16 == 0,
      // so a fragment lies within one head
      // every fragment of a k-step is loaded before its mma run
      for (int k = 0; k < hc; k += 16) {
        unsigned bf[MAXF][4];
#pragma unroll
        for (int j = 0; j < MAXF; ++j)
          if (j < nfq) ldsm_x4_t(bf[j], a.attn_t + (k + lrow) * LQ + (fq_lo + j) * 16 + lcol);
        if (one_head) {
          unsigned af[4];
          ldsm_x4(af, a.v + (m0 + lrow) * LQ + hoff[0] + k + lcol);
#pragma unroll
          for (int j = 0; j < MAXF; ++j)
            if (j < nfq) frag_mma(acc[2 * j], acc[2 * j + 1], af, bf[j]);
        } else {
          unsigned af[MAXF][4];
#pragma unroll
          for (int j = 0; j < MAXF; ++j)
            if (j < nfq) ldsm_x4(af[j], a.v + (m0 + lrow) * LQ + hoff[j] + k + lcol);
#pragma unroll
          for (int j = 0; j < MAXF; ++j)
            if (j < nfq) frag_mma(acc[2 * j], acc[2 * j + 1], af[j], bf[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2 * MAXF; ++j) {
        if (j >= 2 * nfq) continue;
        bf16* o = a.oa + (m0 + gq) * LQ + fq_lo * 16 + 8 * j + q2;
        st2(o, make_float2(acc[j][0], acc[j][1]));
        st2(o + 8 * LQ, make_float2(acc[j][2], acc[j][3]));
      }
    }
    // attn @ v is read along whole rows: by the warp that wrote them where it
    // owns them, else by the row's other warps too
    if (ncw > 1) __syncthreads(); else __syncwarp();
    pc.mark(PH_ATTN_V);
  }

  for (int rd = 0; rd < rounds; ++rd) {
    const int m0 = (rd * mt_round + warp / ncw) * 16;
    const bool active = nf > 0 && m0 < mtiles * 16;
    const int row0 = m0 + gq, row1 = row0 + 8;
    const int hy0 = row0 / w1, hx0 = row0 % w1, hy1 = row1 / w1, hx1 = row1 % w1;
    const int yy0 = y0 - 1 + hy0, xx0 = x0 - 1 + hx0, yy1 = y0 - 1 + hy1, xx1 = x0 - 1 + hx1;
    const bool in0 = active && row0 < n1 && readable(g, yy0, xx0);
    const bool in1 = active && row1 < n1 && readable(g, yy1, xx1);
    const int c0 = f_lo * 16 + q2;  // this lane's first channel
    const Tin* px0 = x + pix(g, b, in0 ? yy0 : 0, in0 ? xx0 : 0) + c0;
    const Tin* px1 = x + pix(g, b, in1 ? yy1 : 0, in1 ? xx1 : 0) + c0;
    // the accumulators start at x, read in their own layout (0 where it is
    // not readable and on the padding rows)
    float acc[2 * MAXF][4];
#pragma unroll
    for (int j = 0; j < 2 * MAXF; ++j) {
      const float2 lo = has_x && in0 && j < 2 * nf ? ld2(px0 + 8 * j) : make_float2(0.f, 0.f);
      const float2 hi = has_x && in1 && j < 2 * nf ? ld2(px1 + 8 * j) : make_float2(0.f, 0.f);
      acc[j][0] = lo.x, acc[j][1] = lo.y, acc[j][2] = hi.x, acc[j][3] = hi.y;
    }
    if constexpr (Attn) {
      // r = x + bf16(attn @ v) @ W_proj, W_proj's rows kc .. kc + kp - 1 at
      // a time (all at once where kp = Cq, loaded by the caller)
      const int kp = g.kp;
      for (int kc = 0; kc < Cq; kc += kp) {
        if (kp < Cq) {
          // every warp is past the last rows' product (at the first chunk:
          // past attn @ v, which does not share W_proj's bytes)
          __syncthreads();
          const bf16* src = a.wproj_dev + (size_t)kc * C;
          load_b_async(a.wproj, kp, C, [=](int k, int n) { return src + (size_t)k * C + n; });
          cp_async_wait();
          __syncthreads();
        }
        if (active) {
          for (int k = kc; k < kc + kp; k += 16) {
            unsigned af[4], bf[MAXF][4];
            ldsm_x4(af, a.oa + (m0 + lrow) * LQ + k + lcol);
#pragma unroll
            for (int j = 0; j < MAXF; ++j)
              if (j < nf)
                ldsm_x4_t(bf[j], a.wproj + (k - kc + lrow) * LX + (f_lo + j) * 16 + lcol);
#pragma unroll
            for (int j = 0; j < MAXF; ++j)
              if (j < nf) frag_mma(acc[2 * j], acc[2 * j + 1], af, bf[j]);
          }
        }
      }
      pc.mark(PH_PROJ);
    }
    if constexpr (Stop) {
      // r on the tile's own pixels of the band, from the registers
      if (!active) continue;
      const bool out0 = hy0 >= 1 && hy0 <= g.th && hx0 >= 1 && hx0 <= g.tw && inside(g, yy0, xx0);
      const bool out1 = hy1 >= 1 && hy1 <= g.th && hx1 >= 1 && hx1 <= g.tw && inside(g, yy1, xx1);
      float* r0 = a.r_out + pix(g, b, out0 ? yy0 : 0, out0 ? xx0 : 0) + c0;
      float* r1 = a.r_out + pix(g, b, out1 ? yy1 : 0, out1 ? xx1 : 0) + c0;
#pragma unroll
      for (int j = 0; j < 2 * MAXF; ++j) {
        if (j >= 2 * nf) continue;
        if (out0) st2(r0 + 8 * j, make_float2(acc[j][0], acc[j][1]));
        if (out1) st2(r1 + 8 * j, make_float2(acc[j][2], acc[j][3]));
      }
      continue;
    }
    // two-pass statistics of rows row0 and row1 over all C channels
    float mean0 = 0.f, mean1 = 0.f, inv0 = 1.f, inv1 = 1.f;
    if (apply_ln) {
      // sums over the quad, then over the row's warps (in a fixed order)
      auto row_sums = [&](float& v0, float& v1, float* st) {
        v0 += __shfl_xor_sync(0xffffffffu, v0, 1);
        v1 += __shfl_xor_sync(0xffffffffu, v1, 1);
        v0 += __shfl_xor_sync(0xffffffffu, v0, 2);
        v1 += __shfl_xor_sync(0xffffffffu, v1, 2);
        if (ncw > 1) {
          if (active && (lane & 3) == 0) st[row0 * 4 + cg] = v0, st[row1 * 4 + cg] = v1;
          __syncthreads();  // every warp's partial sums of this round's rows are written
          if (active) {
            v0 = v1 = 0.f;
            for (int c = 0; c < ncw; ++c) v0 += st[row0 * 4 + c], v1 += st[row1 * 4 + c];
          }
        }
      };
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < 2 * MAXF; ++j) {
        if (j >= 2 * nf) continue;
        s0 += acc[j][0] + acc[j][1];
        s1 += acc[j][2] + acc[j][3];
      }
      row_sums(s0, s1, s.stat);
      mean0 = s0 / C, mean1 = s1 / C;
      float d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int j = 0; j < 2 * MAXF; ++j) {
        if (j >= 2 * nf) continue;
        const float e0 = acc[j][0] - mean0, e1 = acc[j][1] - mean0;
        const float e2 = acc[j][2] - mean1, e3 = acc[j][3] - mean1;
        d0 += e0 * e0 + e1 * e1;
        d1 += e2 * e2 + e3 * e3;
      }
      row_sums(d0, d1, s.stat + 4 * 16 * mtiles);
      inv0 = rsqrtf(d0 / C + eps), inv1 = rsqrtf(d1 / C + eps);
    }
    // Every warp is past this round's products, and the LayerNorm's weights
    // (copied with cp.async) have landed: attn @ v and v are dead, so LN(r)
    // and the seed may overwrite them; after the last round attn^T and
    // W_proj are dead too.
    cp_async_wait();
    __syncthreads();
    if (rd == rounds - 1) products_done();
    if (!active) continue;
    const bool bias = apply_ln && with_bias;
    // the tile's own pixels among the halo rows, at their index in the tile
    const bool own0 = hy0 >= 1 && hy0 <= g.th && hx0 >= 1 && hx0 <= g.tw;
    const bool own1 = hy1 >= 1 && hy1 <= g.th && hx1 >= 1 && hx1 <= g.tw;
    float* seed0 = s.seed + ((hy0 - 1) * g.tw + hx0 - 1) * LS + c0;
    float* seed1 = s.seed + ((hy1 - 1) * g.tw + hx1 - 1) * LS + c0;
    bf16* rn0 = s.rn + row0 * LX + c0;
#pragma unroll
    for (int j = 0; j < 2 * MAXF; ++j) {
      if (j >= 2 * nf) continue;
      float2 lo = make_float2(acc[j][0], acc[j][1]), hi = make_float2(acc[j][2], acc[j][3]);
      if constexpr (Seed) {
        if (own0) st2(seed0 + 8 * j, lo);
        if (own1) st2(seed1 + 8 * j, hi);
      }
      if (apply_ln) {
        const float2 w = *reinterpret_cast<const float2*>(s.lnw + c0 + 8 * j);
        if (bias) {
          const float2 bb = *reinterpret_cast<const float2*>(s.lnb + c0 + 8 * j);
          lo = in0 ? make_float2((lo.x - mean0) * inv0 * w.x + bb.x,
                                 (lo.y - mean0) * inv0 * w.y + bb.y)
                   : make_float2(0.f, 0.f);
          hi = in1 ? make_float2((hi.x - mean1) * inv1 * w.x + bb.x,
                                 (hi.y - mean1) * inv1 * w.y + bb.y)
                   : make_float2(0.f, 0.f);
        } else {
          lo = make_float2(lo.x * inv0 * w.x, lo.y * inv0 * w.y);
          hi = make_float2(hi.x * inv1 * w.x, hi.y * inv1 * w.y);
        }
      }
      st2(rn0 + 8 * j, lo);
      st2(rn0 + 8 * LX + 8 * j, hi);
    }
  }
}

template <bool Attn, bool Seed, bool Stop = false, class Tin, class F>
__device__ __forceinline__ void r_ln_tile(const FfnBufs& s, const Tin* __restrict__ x,
                                          const AttnIn& a, const Geo& g, int b, int y0, int x0,
                                          float eps, bool apply_ln, bool with_bias,
                                          F products_done, PhaseClock& pc) {
  if (g.C == 16 * MAXF)
    r_ln_tile_n<Attn, Seed, MAXF, Stop>(s, x, a, g, b, y0, x0, eps, apply_ln, with_bias,
                                        products_done, pc);
  else
    r_ln_tile_n<Attn, Seed, 0, Stop>(s, x, a, g, b, y0, x0, eps, apply_ln, with_bias,
                                     products_done, pc);
}

// y = r + W_out (gelu(t1) * t2), t = dw3x3(W_in LN(r)), on the tile at
// (y0, x0) of sample b, after r_ln_tile: s.rn holds LN(r) on the tile's
// 1-pixel halo (m1 rows of stride C + PAD) and s.seed r on the tile's own
// pixels (without Seeded, y = W_out (gelu(t1) * t2) alone and s.seed is not
// read: the partial sum of a model shard's hidden channels). The hidden channels go in chunks of FC (= g.fc, a template
// parameter so the depthwise step's strides are constants): W_in chunk,
// dw3x3 over the real halo, GELU gate, W_out accumulated in registers: a warp
// keeps up to OUTF 16x16 fragments of the tile-pixels x C output from the
// seed to the store. The caller has started chunk 0's loads (ffn_load_chunk
// into taps set 0). Weights load a phase ahead: W_in's next chunk and W_out's
// current one while the depthwise step runs. Two barriers a chunk.
template <int FC, class Tout, bool Seeded = true>
__device__ __forceinline__ void gdfn_chunks(const FfnBufs& s, Tout* __restrict__ y,
                                            const FfnWeights& wt, const Geo& g, int b, int y0,
                                            int x0, PhaseClock& pc) {
  constexpr int fc = FC, LT2 = 2 * FC + PAD, LGG = FC + PAD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, q2 = (lane & 3) * 2;
  const int lrow = lane & 15, lcol = (lane >> 4) * 8;
  const int C = g.C, NC = C / 16, Fp = g.Fp, th = g.th, tw = g.tw;
  const int LX = C + PAD, LS = C + PADF;
  const int w1 = tw + 2, m1 = round16((th + 2) * w1), P = th * tw;
  bf16* rn = s.rn;
  bf16* t2 = s.t2;
  bf16* gg = s.gg;
  // this warp's fragments of the output: [lo, lo + nmine) of the P/16 x NC,
  // row-major, so neighbours share gg's rows
  const int total = (P / 16) * NC, fpw = (total + NWA - 1) / NWA;
  const int lo = warp * fpw;
  const int nmine = total - lo < fpw ? (total - lo < 0 ? 0 : total - lo) : fpw;
  int orow[OUTF], ocol[OUTF];  // each fragment's first tile pixel and channel
#pragma unroll
  for (int i = 0; i < OUTF; ++i) orow[i] = (lo + i) / NC * 16, ocol[i] = (lo + i) % NC * 16;
  // all OUTF fragments are this warp's and lie in the same 16 pixels: they
  // share each A fragment, and the product loop needs no bounds
  const bool one_row = nmine == OUTF && orow[0] == orow[OUTF - 1];

  cp_async_wait();
  __syncthreads();  // LN(r), the seed, W_in's chunk 0 and its taps are visible
  float oacc[2 * OUTF][4];
#pragma unroll
  for (int i = 0; i < OUTF; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* sp = s.seed + (orow[i] + gq) * LS + ocol[i] + 8 * h + q2;
      const float2 a0 = Seeded && i < nmine ? ld2(sp) : make_float2(0.f, 0.f);
      const float2 a1 = Seeded && i < nmine ? ld2(sp + 8 * LS) : make_float2(0.f, 0.f);
      oacc[2 * i + h][0] = a0.x, oacc[2 * i + h][1] = a0.y;
      oacc[2 * i + h][2] = a1.x, oacc[2 * i + h][3] = a1.y;
    }
  }
  __syncthreads();  // every warp has its seed: t2 and gg may overwrite it
  pc.mark(PH_LN2);

  int set = 0;
  for (int f0 = 0; f0 < Fp; f0 += fc, set ^= 1) {
    // t2 = bf16(LN(r) @ W_in[:, chunk]) on the halo, both halves side by side
    const bf16* win = s.win;
    gemm_nf<4>(m1, 2 * fc, C, [=](int m, int, int k) { return rn + m * LX + k; }, LX,
                    [=](int k, int n) { return win + k * LT2 + n; }, t2, LT2);
    // t2 is complete; and every warp is past the last chunk's W_out product,
    // so s.win, s.wout and gg are free
    __syncthreads();
    pc.mark(PH_W_IN);
    if (f0 + fc < Fp) ffn_load_chunk<FC>(s, wt, g, f0 + fc, set ^ 1);
    {
      const bf16* wout = wt.wout + (size_t)f0 * C;
      load_b_async(s.wout, fc, C, [=](int k, int n) { return wout + (size_t)k * C + n; });
    }
    // dw3x3 + GELU gate: a thread takes one hidden channel and two adjacent
    // columns of the tile down all its rows, with the channel's 18 taps and
    // three halo rows by four halo columns of each half in registers. The
    // rows' slots rotate by index, three rows to a turn of the loop, so no
    // value moves between registers.
    const float* taps = s.taps + set * 18 * fc;
    for (int idx = threadIdx.x; idx < fc * (tw / 2); idx += NTA) {
      const int f = idx % fc, j = idx / fc * 2;
      float w1k[9], w2k[9], u1[3][4], u2[3][4];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        w1k[tap] = taps[tap * fc + f];
        w2k[tap] = taps[(9 + tap) * fc + f];
      }
#pragma unroll
      for (int row = 0; row < 2; ++row)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bf16* tp = t2 + (row * w1 + j + c) * LT2;
          u1[row][c] = __bfloat162float(tp[f]);
          u2[row][c] = __bfloat162float(tp[fc + f]);
        }
      for (int i0 = 0; i0 < th; i0 += 3) {
#pragma unroll
        for (int sl = 0; sl < 3; ++sl) {
          const int i = i0 + sl;  // output row; halo row i + di lies in slot (sl + di) % 3
          if (i >= th) break;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const bf16* tp = t2 + ((i + 2) * w1 + j + c) * LT2;
            u1[(sl + 2) % 3][c] = __bfloat162float(tp[f]);
            u2[(sl + 2) % 3][c] = __bfloat162float(tp[fc + f]);
          }
          float a1[2] = {0.f, 0.f}, a2[2] = {0.f, 0.f};
#pragma unroll
          for (int dj = 0; dj < 3; ++dj)
#pragma unroll
            for (int di = 0; di < 3; ++di)
#pragma unroll
              for (int o = 0; o < 2; ++o) {
                a1[o] += u1[(sl + di) % 3][o + dj] * w1k[di * 3 + dj];
                a2[o] += u2[(sl + di) % 3][o + dj] * w2k[di * 3 + dj];
              }
          gg[(i * tw + j) * LGG + f] = __float2bfloat16(gelu(a1[0]) * a2[0]);
          gg[(i * tw + j + 1) * LGG + f] = __float2bfloat16(gelu(a1[1]) * a2[1]);
        }
      }
    }
    // gg is complete and t2 free; this chunk's W_out and the next one's W_in
    // and taps have landed
    cp_async_wait();
    __syncthreads();
    pc.mark(PH_DW_GATE);
    // out += gg @ W_out[chunk, :], in registers
    if (one_row) {
#pragma unroll
      for (int k = 0; k < fc; k += 16) {
        unsigned af[4], bf[OUTF][4];
        ldsm_x4(af, gg + (orow[0] + lrow) * LGG + k + lcol);
#pragma unroll
        for (int i = 0; i < OUTF; ++i) ldsm_x4_t(bf[i], s.wout + (k + lrow) * LX + ocol[i] + lcol);
#pragma unroll
        for (int i = 0; i < OUTF; ++i) frag_mma(oacc[2 * i], oacc[2 * i + 1], af, bf[i]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < fc; k += 16) {
        unsigned af[OUTF][4], bf[OUTF][4];
#pragma unroll
        for (int i = 0; i < OUTF; ++i) {
          if (i >= nmine) continue;
          ldsm_x4(af[i], gg + (orow[i] + lrow) * LGG + k + lcol);
          ldsm_x4_t(bf[i], s.wout + (k + lrow) * LX + ocol[i] + lcol);
        }
#pragma unroll
        for (int i = 0; i < OUTF; ++i)
          if (i < nmine) frag_mma(oacc[2 * i], oacc[2 * i + 1], af[i], bf[i]);
      }
    }
    pc.mark(PH_W_OUT);
  }
#pragma unroll
  for (int i = 0; i < OUTF; ++i) {
    if (i >= nmine) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = orow[i] + gq + 8 * r, yy = y0 + p / tw, xx = x0 + p % tw;
      if (!inside(g, yy, xx)) continue;
      Tout* o = y + pix(g, b, yy, xx) + ocol[i] + q2;
      st2(o, make_float2(oacc[2 * i][2 * r], oacc[2 * i][2 * r + 1]));
      st2(o + 8, make_float2(oacc[2 * i + 1][2 * r], oacc[2 * i + 1][2 * r + 1]));
    }
  }
  pc.mark(PH_STORE);
  pc.tile();
}

// ---- host helpers ----------------------------------------------------------

// Cq = C; a model shard's (A) and (C') set Cq and hc after.
inline Geo make_geo(int B, int H, int W, int C, int heads, int Fp, int fc, int th, int tw) {
  Geo g;
  g.B = B; g.H = H; g.W = W; g.C = C; g.Cq = C; g.heads = heads; g.hc = C / heads;
  g.Fp = Fp; g.fc = fc; g.th = th; g.tw = tw;
  g.ntj = (W + tw - 1) / tw;
  g.ntiles = ((H + th - 1) / th) * g.ntj;
  g.halo = 0; g.Hs = H; g.y_img = 0; g.H_img = H; g.kp = C;
  return g;
}

// g as the band of rows [y_img, y_img + H) of an image of H_img rows, held
// with `halo` (0 or 1) rows above and below; false where that is no band
// (halo 0 is the whole image only).
inline bool set_band(Geo& g, int halo, int y_img, int H_img) {
  if (halo < 0 || halo > 1 || y_img < 0 || y_img + g.H > H_img) return false;
  if (halo == 0 && (y_img != 0 || H_img != g.H)) return false;
  g.halo = halo; g.Hs = g.H + 2 * halo; g.y_img = y_img; g.H_img = H_img;
  return true;
}

// What every tile kernel needs: 16-channel fragments up to MAX_C channels
// (4 warps of MAXF fragments to a row), whole 16-row fragments of tile pixels.
inline bool tile_shape_ok(int C, int th, int tw) {
  return C > 0 && C % 16 == 0 && C <= MAX_C && th > 0 && tw > 0 &&
         (th * tw) % 16 == 0;
}

// And a kernel that ends in the GDFN: whole chunks of hidden channels,
// pairs of tile columns for the depthwise step, and an output tile whose
// fragments fit the registers of NWA warps.
inline bool ffn_shape_ok(int C, int Fp, int fc, int th, int tw) {
  return tile_shape_ok(C, th, tw) && (fc == 32 || fc == 64) && Fp > 0 && Fp % fc == 0 &&
         tw % 2 == 0 && (th * tw / 16) * (C / 16) <= OUTF * NWA;
}

// Let a kernel use `bytes` of dynamic shared memory, the SM's memory split
// in favour of shared memory (so that two such blocks fit where they can).
template <class K>
int opt_in(K kernel, size_t bytes) {
  if (bytes > (size_t)SMEM_LIMIT) return ERR_SMEM;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return (int)err;
}

// Thread blocks of `kernel` (threads each, `bytes` of dynamic shared memory)
// that the device keeps resident on one SM; 0 where it cannot launch.
template <class K>
int resident_blocks(K kernel, int threads, size_t bytes) {
  int n = 0;
  if (opt_in(kernel, bytes) != 0) return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, bytes) != cudaSuccess)
    return 0;
  return n;
}

inline const char* tile_error_string(int code) {
  if (code == ERR_SMEM) return "tile needs more than 227 KB of shared memory";
  if (code == ERR_SHAPE)
    return "needs C (and C/heads) a multiple of 16, C <= 384, th*tw a multiple of 16 (with "
           "th*tw*C <= 6144 where the kernel ends in the GDFN), Fp a multiple of the chunk "
           "(32 or 64), and a band inside its image with a halo of 0 (the whole image) or 1 "
           "row";
  return cudaGetErrorString((cudaError_t)code);
}

}  // namespace
