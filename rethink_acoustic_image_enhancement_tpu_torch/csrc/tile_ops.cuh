// Device code shared by the tile kernels of stage.cu (whole
// TransformerBlocks) and gdfn.cu (LN -> GDFN -> residual): LayerNorm of
// pixel rows, cp.async weight loads, bf16 mma.sync products on ldmatrix
// fragments, the halo loader, and gdfn_tile, the GDFN half of a block on one
// spatial tile. Everything here works on one thread block of NT threads and
// its shared memory; the kernels that include it lay that memory out.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NT = 512;        // threads of the tile kernels
constexpr int NW = NT / 32;    // warps
constexpr int SMEM_LIMIT = 232448;  // 227 KB a block may opt into
constexpr int ERR_SMEM = 100001;    // tile does not fit in shared memory
constexpr int ERR_SHAPE = 100002;   // shape the kernels do not take
constexpr int MAX_LN_REGS = 12;     // LayerNorm rows up to 384 channels
// Shared-memory rows are padded by PAD bf16 (16 bytes) so the 8 rows an
// ldmatrix reads fall in different banks; fp32 accumulators by PADF floats.
constexpr int PAD = 8;
constexpr int PADF = 4;

// fc: GDFN hidden channels per chunk (64, or 32 where 64 does not fit).
struct Geo {
  int B, H, W, C, heads, hc, Fp, fc, th, tw, ntj, ntiles;
};

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ inline size_t align128(size_t n) { return (n + 127) / 128 * 128; }
__host__ __device__ inline size_t max2(size_t a, size_t b) { return a > b ? a : b; }

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void st4(bf16* p, float4 v) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y), __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

// Channel LayerNorm (two-pass variance, fp32 statistics) of `rows` pixels' C
// channels, src row stride lds, to bf16 dst row stride ldd. BiasFree where
// b is null, x / sqrt(var + eps) * w (the mean is not subtracted); else
// WithBias, (x - mean) / sqrt(var + eps) * w + b. Rows where keep(p) is
// false are pixels outside the image, which the callers hold as all-zero
// rows; they must come out 0, the zero padding the depthwise step after the
// next product sees there. BiasFree gives that by itself (LN(0) = 0) and
// never asks keep; WithBias, where LN(0) = b, does. LPR lanes take a row
// (C <= LPR * MAX_LN_REGS), so a warp normalises 32 / LPR rows at once. Bias
// says whether b is given (the BiasFree variant then keeps no bias
// registers).
template <int LPR, bool Bias, class S, class Keep>
__device__ void ln_rows_t(const S* src, int lds, const float* w, const float* b, bf16* dst,
                          int ldd, int rows, int C, float eps, Keep keep) {
  constexpr int RPW = 32 / LPR;
  const int lane = threadIdx.x & 31, sub = lane % LPR;
  float wr[MAX_LN_REGS], br[Bias ? MAX_LN_REGS : 1];
#pragma unroll
  for (int i = 0; i < MAX_LN_REGS; ++i) {
    const int c = sub + LPR * i;
    wr[i] = c < C ? w[c] : 0.f;
    if constexpr (Bias) br[i] = c < C ? b[c] : 0.f;
  }
  for (int p0 = (threadIdx.x >> 5) * RPW; p0 < rows; p0 += NW * RPW) {
    const int p = p0 + lane / LPR;
    bool ok = p < rows;
    if constexpr (Bias) ok = ok && keep(p);
    float v[MAX_LN_REGS];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_LN_REGS; ++i) {
      const int c = sub + LPR * i;
      v[i] = ok && c < C ? ldf(src + (size_t)p * lds + c) : 0.f;
      s += v[i];
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mean = s / C;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_LN_REGS; ++i) {
      const float d = v[i] - mean;
      if (sub + LPR * i < C) q += d * d;
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
    const float inv = rsqrtf(q / C + eps);
    if (p < rows) {
#pragma unroll
      for (int i = 0; i < MAX_LN_REGS; ++i) {
        const int c = sub + LPR * i;
        float o = v[i] * inv * wr[i];
        if constexpr (Bias) o = ok ? (v[i] - mean) * inv * wr[i] + br[i] : 0.f;
        if (c < C) dst[(size_t)p * ldd + c] = __float2bfloat16(o);
      }
    }
  }
}

template <class S, class Keep>
__device__ void ln_rows(const S* src, int lds, const float* w, const float* b, bf16* dst,
                        int ldd, int rows, int C, float eps, Keep keep) {
  if (b != nullptr) {
    if (C <= 8 * MAX_LN_REGS)
      ln_rows_t<8, true>(src, lds, w, b, dst, ldd, rows, C, eps, keep);
    else if (C <= 16 * MAX_LN_REGS)
      ln_rows_t<16, true>(src, lds, w, b, dst, ldd, rows, C, eps, keep);
    else
      ln_rows_t<32, true>(src, lds, w, b, dst, ldd, rows, C, eps, keep);
  } else {
    if (C <= 8 * MAX_LN_REGS)
      ln_rows_t<8, false>(src, lds, w, b, dst, ldd, rows, C, eps, keep);
    else if (C <= 16 * MAX_LN_REGS)
      ln_rows_t<16, false>(src, lds, w, b, dst, ldd, rows, C, eps, keep);
    else
      ln_rows_t<32, false>(src, lds, w, b, dst, ldd, rows, C, eps, keep);
  }
}

// dst[K][N] (row stride N + PAD) = B[K][N] (bf16), 16-byte cp.async copies
// by the whole block: the products then read B from shared memory. The
// call returns at once; the data is there after cp_async_wait() and a
// barrier, so the copy overlaps the work between. bptr(k, n) points at
// element (k, n), n a multiple of 8.
template <class BP>
__device__ void load_b_async(bf16* dst, int K, int N, BP bptr) {
  const int n8 = N / 8, ld = N + PAD, total = K * n8;
  for (int i = threadIdx.x; i < total; i += NT) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst + (i / n8) * ld + (i % n8) * 8);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(bptr(i / n8, (i % n8) * 8)));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// bytes (a multiple of 16) from src to dst with cp.async, as load_b_async.
__device__ void copy_async(void* dst, const void* src, int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += NT) {
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
// fragment products on the busiest warp, the larger NF on a tie.
__device__ __forceinline__ int pick_nf(int M, int N, int unit) {
  int best = 1, best_cost = 1 << 30;
  for (int nf = 1; nf <= 4; ++nf) {
    if (unit % nf) continue;
    const int items = (M / 16) * (N / (16 * nf));
    const int cost = (items + NW - 1) / NW * nf;
    if (cost <= best_cost) best = nf, best_cost = cost;
  }
  return best;
}

// Abramowitz-Stegun 7.1.26 erf, |error| < 1.5e-7 (the TPU kernel's
// _erf_approx, ops/pallas/gdfn.py:58-65), with the fast exp and divide:
// much cheaper than erff in the GELU gate.
__device__ __forceinline__ float erf_as(float x) {
  const float ax = fabsf(x);
  const float t = __fdividef(1.f, 1.f + 0.3275911f * ax);
  const float poly = t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f +
                     t * (-1.453152027f + t * 1.061405429f))));
  return copysignf(1.f - poly * __expf(-ax * ax), x);
}

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.f + erf_as(x * 0.70710678118654752f));
}

// Two adjacent bf16 as float2, and back (4-byte aligned); a += u * w.
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st2(bf16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}
__device__ __forceinline__ void fma2(float2& a, float2 u, float2 w) {
  a.x += u.x * w.x;
  a.y += u.y * w.y;
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

// d[16x8] += a[16x16] b[16x8], bf16 operands, fp32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// C[M][N] = A[M][K] B[K][N], bf16 operands, fp32 accumulation, with
// mma.sync m16n8k16 on ldmatrix fragments. With Acc, C is fp32 in shared
// memory at accp (row stride ldc) and C += A B; else C is rounded to bf16
// at out (row stride ldo). Each warp takes a 16 x (16 NF) strip of C at a
// time; aptr(m0, n0, k0) gives the origin of A's 16x16 fragment (A may
// depend on the output column, as per-head attention does), bptr(k, n)
// element (k, n) of B. Row strides are multiples of 8 elements.
template <int NF, bool Acc, class AP, class BP>
__device__ void gemm_nf(int M, int N, int K, AP aptr, int lda, BP bptr, bf16* out, int ldo,
                        float* accp, int ldc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q2 = (lane & 3) * 2;  // the accumulator's row and column pair
  const int ng = N / (16 * NF), items = (M / 16) * ng;
  for (int it = warp; it < items; it += NW) {
    const int m0 = (it / ng) * 16, n0 = (it % ng) * 16 * NF;
    float acc[2 * NF][4];
#pragma unroll
    for (int j = 0; j < 2 * NF; ++j) {
      if constexpr (Acc) {
        const float* c = accp + (m0 + g) * ldc + n0 + 8 * j + q2;
        const float2 lo = *reinterpret_cast<const float2*>(c);
        const float2 hi = *reinterpret_cast<const float2*>(c + 8 * ldc);
        acc[j][0] = lo.x, acc[j][1] = lo.y, acc[j][2] = hi.x, acc[j][3] = hi.y;
      } else {
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      }
    }
    for (int k = 0; k < K; k += 16) {
      unsigned a[4];
      ldsm_x4(a, aptr(m0, n0, k) + (lane & 15) * lda + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        unsigned b[4];
        ldsm_x4_t(b, bptr(k + (lane & 15), n0 + 16 * j + (lane >> 4) * 8));
        mma_bf16(acc[2 * j], a, b[0], b[1]);
        mma_bf16(acc[2 * j + 1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2 * NF; ++j) {
      if constexpr (Acc) {
        float* c = accp + (m0 + g) * ldc + n0 + 8 * j + q2;
        *reinterpret_cast<float2*>(c) = make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(c + 8 * ldc) = make_float2(acc[j][2], acc[j][3]);
      } else {
        bf16* o = out + (m0 + g) * ldo + n0 + 8 * j + q2;
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(acc[j][0], acc[j][1]);
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * ldo) = __floats2bfloat162_rn(acc[j][2], acc[j][3]);
      }
    }
  }
}

template <bool Acc, class AP, class BP>
__device__ void gemm_any(int M, int N, int K, int unit, AP aptr, int lda, BP bptr, bf16* out,
                         int ldo, float* accp, int ldc) {
  switch (pick_nf(M, N, unit)) {
    case 4: gemm_nf<4, Acc>(M, N, K, aptr, lda, bptr, out, ldo, accp, ldc); break;
    case 3: gemm_nf<3, Acc>(M, N, K, aptr, lda, bptr, out, ldo, accp, ldc); break;
    case 2: gemm_nf<2, Acc>(M, N, K, aptr, lda, bptr, out, ldo, accp, ldc); break;
    default: gemm_nf<1, Acc>(M, N, K, aptr, lda, bptr, out, ldo, accp, ldc);
  }
}

// out[M][N] = bf16(A[M][K] B[K][N]); `unit` as in pick_nf.
template <class AP, class BP>
__device__ void gemm(int M, int N, int K, int unit, AP aptr, int lda, BP bptr, bf16* out,
                     int ldo) {
  gemm_any<false>(M, N, K, unit, aptr, lda, bptr, out, ldo, nullptr, 0);
}

// acc[M][N] (fp32, shared, row-major, ldc) += A[M][K] B[K][N].
template <class AP, class BP>
__device__ void gemm_acc(int M, int N, int K, AP aptr, int lda, BP bptr, float* accp, int ldc) {
  gemm_any<true>(M, N, K, N / 16, aptr, lda, bptr, nullptr, 0, accp, ldc);
}

__device__ __forceinline__ bool inside(const Geo& g, int yy, int xx) {
  return yy >= 0 && yy < g.H && xx >= 0 && xx < g.W;
}

// Copy the (th+2R) x (tw+2R) pixels around a tile (C channels each) into
// shared-memory rows of stride ldd (a multiple of 4 floats or 8 bf16), with
// 16-byte loads by the whole block, U in flight per thread; pixels outside
// the image and rows n..m are zero. bf16 x may go to a float dst.
template <class T, class D>
__device__ void load_region(const T* x, D* dst, int ldd, const Geo& g, int b, int y0,
                            int x0, int R, int m) {
  constexpr int VE = 16 / sizeof(T), U = 4;
  const int wr = g.tw + 2 * R, n = (g.th + 2 * R) * wr, nv = g.C / VE, total = m * nv;
  for (int i0 = threadIdx.x; i0 < total; i0 += NT * U) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * NT, p = i / nv;
      const int yy = y0 - R + p / wr, xx = x0 - R + p % wr;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < total && p < n && inside(g, yy, xx))
        v[u] = *reinterpret_cast<const uint4*>(
            x + (((size_t)b * g.H + yy) * g.W + xx) * g.C + (i % nv) * VE);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * NT;
      if (i >= total) continue;
      D* d = dst + (i / nv) * ldd + (i % nv) * VE;
      if constexpr (std::is_same<T, D>::value) {
        *reinterpret_cast<uint4*>(d) = v[u];
      } else {
        static_assert(std::is_same<T, bf16>::value && std::is_same<D, float>::value, "");
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v[u]);
        const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
        const float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
        reinterpret_cast<float4*>(d)[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
        reinterpret_cast<float4*>(d)[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
      }
    }
  }
}

// ---- the GDFN half of a block on one tile --------------------------------

// Shared memory of a block that ends in gdfn_tile (host and device agree
// through this). With `attn`, the layout of stage.cu's kernel (C), whose
// weight buffers also hold attn^T and W_proj and which keeps v and attn@v;
// else that of gdfn.cu's kernel. With `dbl`, two weight buffers (one is read
// while the other loads, where they fit); else one.
struct FfnSmem {
  size_t wb0, wb1, rn, oa, r, t2, gg, acc, taps, lnw, lnb, total;
  __host__ __device__ FfnSmem(int th, int tw, int C, int fc, bool dbl, bool attn) {
    const int m1 = round16((th + 2) * (tw + 2)), P = th * tw, LX = C + PAD, LA = C + PADF;
    size_t wb_elems = max2((size_t)C * (2 * fc + PAD), (size_t)fc * (C + PAD));
    if (attn) wb_elems = max2(wb_elems, (size_t)C * (C + PAD));
    const size_t wb_bytes = align128(wb_elems * 2);
    size_t o = 0;
    wb0 = o;   o += wb_bytes;
    wb1 = dbl ? o : wb0;  o += dbl ? wb_bytes : 0;
    rn = o;    o += align128((size_t)m1 * LX * 2);  // (v, then) LN(r)
    oa = o;    o += attn ? align128((size_t)m1 * LX * 2) : 0;  // attn@v
    r = o;     o += align128((size_t)m1 * LA * 4);
    t2 = o;    o += align128((size_t)m1 * (2 * fc + PAD) * 2);
    gg = o;    o += align128((size_t)P * (fc + PAD) * 2);
    acc = o;   o += align128((size_t)P * LA * 4);
    taps = o;  o += align128((size_t)18 * fc * 4);  // one chunk's dw taps
    lnw = o;   o += align128((size_t)C * 4);        // the LayerNorm's weight
    lnb = o;   o += align128((size_t)C * 4);        // and bias
    total = o;
  }
};

struct FfnBufs {
  bf16 *wb0, *wb1, *rn, *t2, *gg;
  float *r, *acc, *taps, *lnw, *lnb;
  __device__ FfnBufs(unsigned char* smem, const FfnSmem& L)
      : wb0((bf16*)(smem + L.wb0)), wb1((bf16*)(smem + L.wb1)), rn((bf16*)(smem + L.rn)),
        t2((bf16*)(smem + L.t2)), gg((bf16*)(smem + L.gg)), r((float*)(smem + L.r)),
        acc((float*)(smem + L.acc)), taps((float*)(smem + L.taps)),
        lnw((float*)(smem + L.lnw)), lnb((float*)(smem + L.lnb)) {}
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
// halves side by side into wb0, and the 18 rows of depthwise taps.
template <int FC>
__device__ __forceinline__ void ffn_load_chunk(const FfnBufs& s, const FfnWeights& wt, const Geo& g, int f0) {
  constexpr int fc = FC, f4 = FC / 4;
  const int Fp = g.Fp, F2 = 2 * Fp;
  for (int i = threadIdx.x; i < 18 * f4; i += NT) {
    const int row = i / f4, tap = row % 9, half = row / 9;
    const unsigned d = (unsigned)__cvta_generic_to_shared(s.taps + row * fc + (i % f4) * 4);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(wt.wdw + (size_t)tap * F2 + half * Fp + f0 + (i % f4) * 4));
  }
  const bf16* win = wt.win;
  load_b_async(s.wb0, g.C, 2 * fc, [=](int k, int n) {
    return win + (size_t)k * F2 + (n < fc ? f0 + n : Fp + f0 + n - fc);
  });
}

// y = r + W_out (gelu(t1) * t2), t = dw3x3(W_in LN(r)), on the tile at
// (y0, x0) of sample b. s.r holds r in fp32 on the tile's 1-pixel halo (m1
// rows of stride C + PADF, 0 outside the image). LN(r) is zero on the ring
// outside the image, where torch zero-pads the depthwise input; without
// apply_ln, bf16(r) stands in for it. The hidden channels go in chunks of
// FC (= g.fc, a template parameter so the depthwise step's strides are
// constants): W_in chunk, dw3x3 over the real halo, GELU gate, W_out accumulated
// onto r in s.acc. With two weight buffers W_out's chunk loads during the
// W_in product and W_in's next chunk during the W_out product; with one,
// each loads while the depthwise step runs. The caller has started chunk
// 0's load (ffn_load_chunk) and its copies into s.lnw / s.lnb have landed.
template <int FC, class Tout>
__device__ __forceinline__ void gdfn_tile(const FfnBufs& s, Tout* __restrict__ y, const FfnWeights& wt,
                          const Geo& g, int b, int y0, int x0, float eps, bool dbl,
                          bool apply_ln, bool with_bias) {
  constexpr int fc = FC, LT2 = 2 * FC + PAD, LGG = FC + PAD;
  const int C = g.C, Fp = g.Fp, th = g.th, tw = g.tw;
  const int LX = C + PAD, LB = C + PAD, LA = C + PADF;
  const int w1 = tw + 2, n1 = (th + 2) * w1, m1 = round16(n1), P = th * tw;
  bf16* rn = s.rn;
  bf16* t2 = s.t2;
  bf16* gg = s.gg;
  float* acc = s.acc;
  const float* taps = s.taps;
  auto at_ld = [](const bf16* base, int ld) {
    return [=](int k, int n) { return base + k * ld + n; };
  };
  const int C4 = C / 4;
  if (apply_ln) {
    ln_rows(s.r, LA, s.lnw, with_bias ? s.lnb : nullptr, rn, LX, m1, C, eps,
            [&](int p) { return p < n1 && inside(g, y0 - 1 + p / w1, x0 - 1 + p % w1); });
  } else {
    for (int idx = threadIdx.x; idx < m1 * C4; idx += NT) {
      const int p = idx / C4, c = idx % C4 * 4;
      st4(rn + p * LX + c, *reinterpret_cast<const float4*>(s.r + p * LA + c));
    }
  }
  // the output accumulator starts at r
  for (int idx = threadIdx.x; idx < P * C4; idx += NT) {
    const int p = idx / C4, c = idx % C4 * 4;
    *reinterpret_cast<float4*>(acc + p * LA + c) =
        *reinterpret_cast<const float4*>(s.r + ((p / tw + 1) * w1 + p % tw + 1) * LA + c);
  }
  cp_async_wait();
  __syncthreads();
  for (int f0 = 0; f0 < Fp; f0 += fc) {
    const bool more = f0 + fc < Fp;
    auto wout_chunk = [&] {
      const bf16* wout = wt.wout;
      load_b_async(s.wb1, fc, C, [=](int k, int n) { return wout + (size_t)(f0 + k) * C + n; });
    };
    if (dbl) wout_chunk();
    gemm(m1, 2 * fc, C, 2 * fc / 16, [&](int m, int, int k) { return rn + m * LX + k; }, LX,
         at_ld(s.wb0, LT2), t2, LT2);
    __syncthreads();
    if (!dbl) wout_chunk();
    // dw3x3 + GELU gate down each column of the tile; a thread keeps one
    // (hidden channel, column)'s 18 taps and two 3x3 windows in registers
    for (int idx = threadIdx.x; idx < fc * tw; idx += NT) {
      const int f = idx % fc, j = idx / fc;
      float w1k[9], w2k[9], u1[3][3], u2[3][3];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        w1k[tap] = taps[tap * fc + f];
        w2k[tap] = taps[(9 + tap) * fc + f];
      }
#pragma unroll
      for (int di = 0; di < 2; ++di)
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          const bf16* tp = t2 + (di * w1 + j + dj) * LT2;
          u1[di + 1][dj] = __bfloat162float(tp[f]);
          u2[di + 1][dj] = __bfloat162float(tp[fc + f]);
        }
#pragma unroll 2
      for (int i = 0; i < th; ++i) {
        float a1 = 0.f, a2 = 0.f;
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          const bf16* tp = t2 + ((i + 2) * w1 + j + dj) * LT2;
          u1[0][dj] = u1[1][dj]; u1[1][dj] = u1[2][dj]; u1[2][dj] = __bfloat162float(tp[f]);
          u2[0][dj] = u2[1][dj]; u2[1][dj] = u2[2][dj]; u2[2][dj] = __bfloat162float(tp[fc + f]);
#pragma unroll
          for (int di = 0; di < 3; ++di) {
            a1 += u1[di][dj] * w1k[di * 3 + dj];
            a2 += u2[di][dj] * w2k[di * 3 + dj];
          }
        }
        gg[(i * tw + j) * LGG + f] = __float2bfloat16(gelu(a1) * a2);
      }
    }
    cp_async_wait();
    __syncthreads();
    if (dbl && more) ffn_load_chunk<FC>(s, wt, g, f0 + fc);
    gemm_acc(P, C, fc, [&](int m, int, int k) { return gg + m * LGG + k; }, LGG,
             at_ld(s.wb1, LB), acc, LA);
    if (!dbl) {
      __syncthreads();
      if (more) ffn_load_chunk<FC>(s, wt, g, f0 + fc);
    }
    cp_async_wait();
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < P * C4; idx += NT) {
    const int p = idx / C4, c = idx % C4 * 4;
    const int yy = y0 + p / tw, xx = x0 + p % tw;
    if (inside(g, yy, xx))
      st4(y + (((size_t)b * g.H + yy) * g.W + xx) * C + c,
          *reinterpret_cast<const float4*>(acc + p * LA + c));
  }
}

// ---- host helpers ----------------------------------------------------------

inline Geo make_geo(int B, int H, int W, int C, int heads, int Fp, int fc, int th, int tw) {
  Geo g;
  g.B = B; g.H = H; g.W = W; g.C = C; g.heads = heads; g.hc = C / heads;
  g.Fp = Fp; g.fc = fc; g.th = th; g.tw = tw;
  g.ntj = (W + tw - 1) / tw;
  g.ntiles = ((H + th - 1) / th) * g.ntj;
  return g;
}

// What every tile kernel needs: 16-channel fragments, LayerNorm rows that
// fit the registers, whole chunks of hidden channels, whole 16-row
// fragments of tile pixels.
inline bool ffn_shape_ok(int C, int Fp, int fc, int th, int tw) {
  return C > 0 && C % 16 == 0 && C <= 32 * MAX_LN_REGS && (fc == 32 || fc == 64) &&
         Fp > 0 && Fp % fc == 0 && th > 0 && tw > 0 && (th * tw) % 16 == 0;
}

template <class K>
int opt_in(K kernel, size_t bytes) {
  if (bytes > (size_t)SMEM_LIMIT) return ERR_SMEM;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

inline const char* tile_error_string(int code) {
  if (code == ERR_SMEM) return "tile needs more than 227 KB of shared memory";
  if (code == ERR_SHAPE)
    return "needs C (and C/heads) a multiple of 16, C <= 384, th*tw a multiple of 16, "
           "Fp a multiple of the chunk (32 or 64)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // namespace
