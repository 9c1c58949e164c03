// Transformer stage kernel for Hopper (sm_90a): N consecutive BiasFree
// Restormer TransformerBlocks, y = r + GDFN(LN2(r)), r = x + W_p MDTA(LN1(x)).
//
// Replaces: rethink_acoustic_image_enhancement_tpu/ops/pallas/stage.py
//           ::fused_transformer_stage (its pallas_call at stage.py:324).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM). One block
// at 512x512x96, one head, F = int(2.66*96) = 255, counts ~272 kFLOP per
// pixel (qkv 2*C*3C, Gram 2*C*hc, attn@v 2*C*hc, proj 2*C*C, W_in 2*C*2F,
// W_out 2*F*C, the two depthwise 3x3s 2*9*(3C+2F)): 71 GFLOP, 72 us.
// It must read x and write y once: 2 * 512*512*96 * 2 B = 101 MB in bf16,
// 30 us. At 256x256x96 with two heads: 16.6 GFLOP (17 us) against 25 MB
// (7.5 us). Both are bound by the tensor-core rate, not by memory.
//
// Design. Everything that grows with the 2F = 510 hidden channels stays in
// shared memory, so device memory sees x, y, v (bf16) and a small
// per-sample Gram. The TPU kernel carried the Gram and the q/k norms across
// a sequential grid; blocks here run in no order, so one TransformerBlock
// is three launches, all deterministic (no atomics):
//   (A) k_gram, one block per SM walking a group of 8x8 tiles: LN1 -> qkv
//       1x1 on the tile's 1-pixel halo (W_qkv stays in shared memory for
//       the group) -> dw3x3; v goes to device memory, and the per-head Gram
//       q^T k and the squared q/k norms over the tile's true pixels add up
//       over the group's tiles in shared memory, written once per group.
//   (B) k_softmax, per (sample, head, query channel): sum the groups,
//       divide by max(||q||, 1e-12) max(||k||, 1e-12), times the per-head
//       temperature, softmax within the head, store attn^T in bf16.
//   (C) k_apply, per 8x8 output tile: attn @ v, W_proj + residual r on the
//       1-pixel halo, LN2 (zero on the ring outside the image, where torch
//       zero-pads the GDFN depthwise input), then the GDFN in chunks of 64
//       hidden channels: W_in chunk, dw3x3 over the real halo, GELU gate
//       (the Abramowitz-Stegun erf of the TPU kernel), and W_out
//       accumulated onto r in shared memory. The tile is written to the
//       other of two float32 ping-pong buffers (the last block writes the
//       stage's dtype); the block loop runs in the wrapper. Weight slices
//       and attn^T are copied to shared memory with cp.async into two
//       buffers, each loading while the other feeds a product.
// Products are bf16 mma.sync m16n8k16 on ldmatrix fragments with fp32
// accumulation (each warp a 16 x 16NF strip sharing its A fragments; the
// Gram q^T k, whose A is column-major, through WMMA); the
// qkv and W_in outputs round to bf16 before the depthwise step and the
// depthwise taps are fp32, as in the TPU kernel. LayerNorm uses the
// two-pass variance of ops/norm.py (the TPU kernel's is one-pass
// E[x^2] - mean^2), 8 lanes to a row at C = 96. Depthwise steps slide a
// 3x3 window down a tile column in registers. Rows in shared memory are
// padded (PAD) so fragment loads are free of bank conflicts.
//
// Against the bound: one 227 KB block per SM and 16 warps, whose phases
// (loads, LayerNorm, products, depthwise steps) are separated by barriers,
// so the tensor cores idle through every phase but the products; the halo
// costs (10*10)/(8*8) on the qkv, attn@v, W_proj and W_in products. The
// next steps are wgmma with TMA and overlapping phases across warps.
//
// Kernel (C) with an LN bias and n_blocks = 1 is the per-block kernel
// (ops/pallas/block.py::fused_transformer_block); the C entry points take
// one block's weights each for that reason.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int NT = 512;        // threads of kernels A and C
constexpr int NW = NT / 32;    // warps
constexpr int FC = 64;         // GDFN hidden channels per chunk
constexpr int NT_SOFTMAX = 128;
constexpr int SMEM_LIMIT = 232448;  // 227 KB a block may opt into
constexpr int ERR_SMEM = 100001;    // tile does not fit in shared memory
constexpr int ERR_SHAPE = 100002;   // channels/heads not multiples of 16
constexpr int MAX_LN_REGS = 12;     // LayerNorm rows up to 384 channels
// Shared-memory rows are padded by PAD bf16 (16 bytes) so the 8 rows an
// ldmatrix reads fall in different banks; fp32 accumulators by PADF floats.
constexpr int PAD = 8;
constexpr int PADF = 4;
constexpr int NCH = 64;             // W_qkv columns staged at a time in (A)

struct Geo {
  int B, H, W, C, heads, hc, Fp, th, tw, ntj, ntiles;
};

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ inline size_t align128(size_t n) { return (n + 127) / 128 * 128; }

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void st4(bf16* p, float4 v) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y), __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

// BiasFree LayerNorm, x / sqrt(var + eps) * w (two-pass variance, fp32
// statistics), of `rows` pixels' C channels, src row stride lds, to bf16
// dst row stride ldd; rows where keep(p) is false become 0. LPR lanes take
// a row (C <= LPR * MAX_LN_REGS), so a warp normalises 32 / LPR rows at once.
template <int LPR, class S, class Keep>
__device__ void ln_rows_t(const S* src, int lds, const float* w, bf16* dst, int ldd,
                          int rows, int C, float eps, Keep keep) {
  constexpr int RPW = 32 / LPR;
  const int lane = threadIdx.x & 31, sub = lane % LPR;
  float wr[MAX_LN_REGS];
#pragma unroll
  for (int i = 0; i < MAX_LN_REGS; ++i) wr[i] = sub + LPR * i < C ? w[sub + LPR * i] : 0.f;
  for (int p0 = (threadIdx.x >> 5) * RPW; p0 < rows; p0 += NW * RPW) {
    const int p = p0 + lane / LPR;
    const bool ok = p < rows && keep(p);
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
        if (c < C) dst[(size_t)p * ldd + c] = __float2bfloat16(v[i] * inv * wr[i]);
      }
    }
  }
}

template <class S, class Keep>
__device__ void ln_rows(const S* src, int lds, const float* w, bf16* dst, int ldd, int rows,
                        int C, float eps, Keep keep) {
  if (C <= 8 * MAX_LN_REGS)
    ln_rows_t<8>(src, lds, w, dst, ldd, rows, C, eps, keep);
  else if (C <= 16 * MAX_LN_REGS)
    ln_rows_t<16>(src, lds, w, dst, ldd, rows, C, eps, keep);
  else
    ln_rows_t<32>(src, lds, w, dst, ldd, rows, C, eps, keep);
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
// much cheaper than erff in kernel (C)'s GELU gate.
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

// ---- shared-memory layouts (host and device agree through these) --------

// With `resident`, all of W_qkv stays in shared memory (where it fits);
// else NCH columns are staged at a time.
struct GramSmem {
  size_t wb, xq, t, gram, nrm, taps, lnw, total;
  __host__ __device__ GramSmem(int th, int tw, int C, int heads, bool resident) {
    const int m1 = round16((th + 2) * (tw + 2)), P = th * tw, hc = C / heads;
    const size_t xn_bytes = (size_t)m1 * (C + PAD) * 2, qk_bytes = (size_t)P * (2 * C + PAD) * 2;
    size_t o = 0;
    wb = o;    o += align128((size_t)C * ((resident ? 3 * C : NCH) + PAD) * 2);
    xq = o;    o += align128(xn_bytes > qk_bytes ? xn_bytes : qk_bytes);  // LN1(x), then q|k
    t = o;     o += align128((size_t)m1 * (3 * C + PAD) * 2);           // x, then qkv
    gram = o;  o += align128((size_t)heads * hc * (hc + PADF) * 4);
    nrm = o;   o += align128((size_t)2 * C * tw * 4);                   // [2C][tw]
    taps = o;  o += align128((size_t)9 * 3 * C * 4);                    // dw_qkv
    lnw = o;   o += align128((size_t)C * 4);                            // LN1's weight
    total = o;
  }
};

// With `dbl`, two weight buffers (one is read while the other loads, where
// they fit); else one.
struct ApplySmem {
  size_t wb0, wb1, v, oa, r, t2, gg, acc, taps, lnw, total;
  __host__ __device__ ApplySmem(int th, int tw, int C, int Fp, bool dbl) {
    const int m1 = round16((th + 2) * (tw + 2)), P = th * tw, LX = C + PAD, LA = C + PADF;
    const size_t wb_bytes = align128((size_t)C * ((C > 2 * FC ? C : 2 * FC) + PAD) * 2);
    size_t o = 0;
    wb0 = o;   o += wb_bytes;
    wb1 = dbl ? o : wb0;  o += dbl ? wb_bytes : 0;
    v = o;     o += align128((size_t)m1 * LX * 2);  // v, then LN2(r)
    oa = o;    o += align128((size_t)m1 * LX * 2);  // attn@v
    r = o;     o += align128((size_t)m1 * LA * 4);
    t2 = o;    o += align128((size_t)m1 * (2 * FC + PAD) * 2);
    gg = o;    o += align128((size_t)P * (FC + PAD) * 2);
    acc = o;   o += align128((size_t)P * LA * 4);
    taps = o;  o += align128((size_t)9 * 2 * Fp * 4);  // the GDFN's dw taps
    lnw = o;   o += align128((size_t)C * 4);            // LN2's weight
    total = o;
  }
};

// ---- (A) q, k, v; Gram and squared norms over groups of tiles ------------

template <class T>
__global__ void __launch_bounds__(NT)
k_gram(const T* __restrict__ x, const float* __restrict__ ln1,
       const bf16* __restrict__ wqkv, const float* __restrict__ dwqkv,
       float* __restrict__ part, bf16* __restrict__ vout, Geo g, int groups, float eps,
       bool resident) {
  extern __shared__ __align__(128) unsigned char smem[];
  const GramSmem L(g.th, g.tw, g.C, g.heads, resident);
  bf16* wb = (bf16*)(smem + L.wb);
  bf16* xn = (bf16*)(smem + L.xq);
  bf16* qk = xn;
  bf16* t = (bf16*)(smem + L.t);
  T* xs = (T*)(smem + L.t);
  float* gram = (float*)(smem + L.gram);
  float* nrm = (float*)(smem + L.nrm);
  float* taps = (float*)(smem + L.taps);
  float* lnw = (float*)(smem + L.lnw);

  const int b = blockIdx.y, grp = blockIdx.x;
  const int C = g.C, C2 = 2 * C, C3 = 3 * C, hc = g.hc, th = g.th, tw = g.tw;
  const int LX = C + PAD, LT = C3 + PAD, LQ = C2 + PAD, LG = hc + PADF;
  const int w1 = tw + 2, m1 = round16((th + 2) * w1), P = th * tw;
  const int gsize = g.heads * hc * LG;
  for (int i = threadIdx.x; i < gsize; i += NT) gram[i] = 0.f;
  for (int i = threadIdx.x; i < C2 * tw; i += NT) nrm[i] = 0.f;
  // W_qkv, nch columns at a time (all of it once, for all of the group's
  // tiles, where it fits)
  const int nch = resident ? C3 : NCH;
  if (resident) load_b_async(wb, C, C3, [&](int k, int n) { return wqkv + (size_t)k * C3 + n; });
  for (int i = threadIdx.x; i < 9 * C3; i += NT) taps[i] = dwqkv[i];
  for (int i = threadIdx.x; i < C; i += NT) lnw[i] = ln1[i];

  for (int tile = grp; tile < g.ntiles; tile += groups) {
    const int y0 = (tile / g.ntj) * th, x0 = (tile % g.ntj) * tw;
    __syncthreads();
    load_region(x, xs, C, g, b, y0, x0, 1, m1);
    __syncthreads();
    // LN1 on the 1-pixel halo (zero rows stay zero: LN1(0) = 0)
    ln_rows(xs, C, lnw, xn, LX, m1, C, eps, [](int) { return true; });
    // t = bf16(LN1(x) @ W_qkv) on the 1-pixel halo
    for (int n0 = 0; n0 < C3; n0 += nch) {
      const int nc = C3 - n0 < nch ? C3 - n0 : nch;
      if (!resident)
        load_b_async(wb, C, nc, [&](int k, int n) { return wqkv + (size_t)k * C3 + n0 + n; });
      cp_async_wait();
      __syncthreads();
      gemm(m1, nc, C, nc / 16, [&](int m, int, int k) { return xn + m * LX + k; }, LX,
           [&](int k, int n) { return wb + k * (nc + PAD) + n; }, t + n0, LT);
      __syncthreads();
    }
    // depthwise 3x3 (fp32 taps) of q, k and v down each column of the tile,
    // two channels at a time: a thread keeps one (channel pair, column)'s
    // taps and 3x3 windows in registers for the whole kernel, so the q/k
    // squared norms sum without atomics, in a fixed order; v goes to device
    // memory (bf16) for (C)
    const int C3h = C3 / 2;
    for (int idx = threadIdx.x; idx < C3h * tw; idx += NT) {
      const int ch = idx % C3h * 2, j = idx / C3h;
      auto at = [&](int row, int col) { return ld2(t + (row * w1 + col) * LT + ch); };
      float2 wk[9], win[3][3];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) wk[tap] = *reinterpret_cast<const float2*>(taps + tap * C3 + ch);
#pragma unroll
      for (int di = 0; di < 2; ++di)
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) win[di + 1][dj] = at(di, j + dj);
      float2 nacc = make_float2(0.f, 0.f);
#pragma unroll 2
      for (int i = 0; i < th; ++i) {
        float2 a = make_float2(0.f, 0.f);
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          win[0][dj] = win[1][dj];
          win[1][dj] = win[2][dj];
          win[2][dj] = at(i + 2, j + dj);
#pragma unroll
          for (int di = 0; di < 3; ++di) fma2(a, win[di][dj], wk[di * 3 + dj]);
        }
        const int yy = y0 + i, xx = x0 + j;
        const bool in = inside(g, yy, xx);
        if (ch < C2) {
          if (!in) a = make_float2(0.f, 0.f);
          st2(qk + (i * tw + j) * LQ + ch, a);
          nacc.x += a.x * a.x;
          nacc.y += a.y * a.y;
        } else if (in) {
          st2(vout + (((size_t)b * g.H + yy) * g.W + xx) * C + ch - C2, a);
        }
      }
      if (ch < C2) {
        nrm[ch * tw + j] += nacc.x;
        nrm[(ch + 1) * tw + j] += nacc.y;
      }
    }
    __syncthreads();
    // per-head Gram[c][d] += sum_p q[p][c] k[p][d]; A = q^T (column-major)
    const int nh = hc / 16, per_head = nh * nh;
    const int warp = threadIdx.x >> 5;
    for (int f = warp; f < g.heads * per_head; f += NW) {
      const int h = f / per_head, m0 = (f % per_head) / nh * 16, n0 = (f % nh) * 16;
      float* accp = gram + h * hc * LG;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, accp + m0 * LG + n0, LG, wmma::mem_row_major);
      for (int k = 0; k < P; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bb;
        wmma::load_matrix_sync(a, qk + k * LQ + h * hc + m0, LQ);
        wmma::load_matrix_sync(bb, qk + k * LQ + C + h * hc + n0, LQ);
        wmma::mma_sync(acc, a, bb, acc);
      }
      wmma::store_matrix_sync(accp + m0 * LG + n0, acc, LG, wmma::mem_row_major);
    }
  }
  __syncthreads();
  // part[b][grp] = (Gram [heads][hc][hc], norms [2C]) unpadded
  const int gout = g.heads * hc * hc;
  float* out = part + ((size_t)b * groups + grp) * (gout + C2);
  for (int i = threadIdx.x; i < gout; i += NT) out[i] = gram[(i / hc) * LG + i % hc];
  for (int i = threadIdx.x; i < C2; i += NT) {
    float sq = 0.f;
    for (int j = 0; j < tw; ++j) sq += nrm[i * tw + j];
    out[gout + i] = sq;
  }
}

// ---- (B) normalised, tempered softmax per query channel ------------------

__device__ float block_reduce(float v, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, u) : v + u;
  }
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int i = 1; i < NT_SOFTMAX / 32; ++i) v = is_max ? fmaxf(v, red[i]) : v + red[i];
  return v;
}

__global__ void __launch_bounds__(NT_SOFTMAX)
k_softmax(const float* __restrict__ part, const float* __restrict__ temp,
          bf16* __restrict__ attn_t, int C, int heads, int groups) {
  extern __shared__ float logit[];  // [hc]
  __shared__ float red[NT_SOFTMAX / 32];
  const int hc = C / heads, b = blockIdx.y;
  const int h = blockIdx.x / hc, c = blockIdx.x % hc;
  const int gsize = heads * hc * hc, stride = gsize + 2 * C;
  const float* base = part + (size_t)b * groups * stride;
  float qn = 0.f;
  for (int gi = 0; gi < groups; ++gi) qn += base[(size_t)gi * stride + gsize + h * hc + c];
  const float qnorm = fmaxf(sqrtf(qn), 1e-12f);
  const float tau = temp[h];
  float mx = -3.0e38f;
  for (int d = threadIdx.x; d < hc; d += NT_SOFTMAX) {
    float gs = 0.f, kn = 0.f;
    for (int gi = 0; gi < groups; ++gi) {
      const float* pg = base + (size_t)gi * stride;
      gs += pg[h * hc * hc + c * hc + d];
      kn += pg[gsize + C + h * hc + d];
    }
    const float l = gs / qnorm / fmaxf(sqrtf(kn), 1e-12f) * tau;
    logit[d] = l;
    mx = fmaxf(mx, l);
  }
  mx = block_reduce(mx, red, true);
  float s = 0.f;
  for (int d = threadIdx.x; d < hc; d += NT_SOFTMAX) {
    const float e = expf(logit[d] - mx);
    logit[d] = e;
    s += e;
  }
  s = block_reduce(s, red, false);
  // attn_t[b][h][d][c] = attn[c][d]: the B operand of (C)'s v @ attn^T
  bf16* out = attn_t + ((size_t)b * heads + h) * hc * hc;
  for (int d = threadIdx.x; d < hc; d += NT_SOFTMAX)
    out[d * hc + c] = __float2bfloat16(logit[d] / s);
}

// ---- (C) attention apply, projection, LN2, GDFN, residuals ---------------

template <class Tin, class Tout>
__global__ void __launch_bounds__(NT)
k_apply(const Tin* __restrict__ x, Tout* __restrict__ y, const bf16* __restrict__ vin,
        const bf16* __restrict__ attn_t, const bf16* __restrict__ wproj,
        const float* __restrict__ ln2, const bf16* __restrict__ win,
        const float* __restrict__ wdw, const bf16* __restrict__ wout, Geo g,
        float eps, bool dbl) {
  extern __shared__ __align__(128) unsigned char smem[];
  const ApplySmem L(g.th, g.tw, g.C, g.Fp, dbl);
  bf16* wb0 = (bf16*)(smem + L.wb0);
  bf16* wb1 = (bf16*)(smem + L.wb1);
  bf16* v = (bf16*)(smem + L.v);
  bf16* rn = v;
  bf16* oa = (bf16*)(smem + L.oa);
  float* r = (float*)(smem + L.r);
  bf16* t2 = (bf16*)(smem + L.t2);
  bf16* gg = (bf16*)(smem + L.gg);
  float* acc = (float*)(smem + L.acc);
  float* taps = (float*)(smem + L.taps);
  float* lnw = (float*)(smem + L.lnw);

  const int b = blockIdx.y, tile = blockIdx.x;
  const int y0 = (tile / g.ntj) * g.th, x0 = (tile % g.ntj) * g.tw;
  const int C = g.C, hc = g.hc, Fp = g.Fp, F2 = 2 * Fp, th = g.th, tw = g.tw;
  const int LX = C + PAD, LB = C + PAD, LT2 = 2 * FC + PAD, LGG = FC + PAD;
  const int LA = C + PADF;
  const int w1 = tw + 2;
  const int n1 = (th + 2) * w1, m1 = round16(n1), P = th * tw;
  auto at_ld = [](const bf16* base, int ld) {
    return [=](int k, int n) { return base + k * ld + n; };
  };
  auto win_chunk = [&](int f0) {  // x1 columns [f0, f0+FC), x2 [Fp+f0, Fp+f0+FC)
    load_b_async(wb0, C, 2 * FC, [&](int k, int n) {
      return win + (size_t)k * F2 + (n < FC ? f0 + n : Fp + f0 + n - FC);
    });
  };

  // attn^T of every head side by side: wb0[d][h*hc + c] = attn[h][c][d];
  // W_proj; v and x on the 1-pixel halo (0 outside the image)
  const bf16* at = attn_t + (size_t)b * g.heads * hc * hc;
  load_b_async(wb0, hc, C, [&](int k, int n) { return at + (size_t)(n / hc) * hc * hc + k * hc + n % hc; });
  copy_async(taps, wdw, 9 * F2 * 4);
  copy_async(lnw, ln2, C * 4);
  auto proj = [&] { load_b_async(wb1, C, C, [&](int k, int n) { return wproj + (size_t)k * C + n; }); };
  if (dbl) proj();
  load_region(vin, v, LX, g, b, y0, x0, 1, m1);
  load_region(x, r, LA, g, b, y0, x0, 1, m1);
  cp_async_wait();
  __syncthreads();
  // oa[p][h*hc + c] = sum_d v[p][h*hc + d] attn[h][c][d]  (hc % 16 == 0, so
  // every 16-column fragment lies within one head)
  gemm(m1, C, hc, hc / 16, [&](int m, int n, int k) { return v + m * LX + (n / hc) * hc + k; },
       LX, at_ld(wb0, LB), oa, LX);
  __syncthreads();
  if (dbl) {
    win_chunk(0);
  } else {
    proj();
    cp_async_wait();
    __syncthreads();
  }
  // r += bf16(oa) @ W_proj on the 1-pixel halo
  gemm_acc(m1, C, C, [&](int m, int, int k) { return oa + m * LX + k; }, LX, at_ld(wb1, LB), r,
           LA);
  __syncthreads();
  if (!dbl) win_chunk(0);
  // LN2(r), zero outside the image; the output accumulator starts at r
  ln_rows(r, LA, lnw, rn, LX, m1, C, eps,
          [&](int p) { return p < n1 && inside(g, y0 - 1 + p / w1, x0 - 1 + p % w1); });
  const int C4 = C / 4;
  for (int idx = threadIdx.x; idx < P * C4; idx += NT) {
    const int p = idx / C4, c = idx % C4 * 4;
    *reinterpret_cast<float4*>(acc + p * LA + c) =
        *reinterpret_cast<const float4*>(r + ((p / tw + 1) * w1 + p % tw + 1) * LA + c);
  }
  cp_async_wait();
  __syncthreads();
  // GDFN, FC hidden channels at a time. With two buffers, W_out's chunk
  // loads during the W_in product and W_in's next chunk during the W_out
  // product; with one, each loads while the depthwise step runs.
  for (int f0 = 0; f0 < Fp; f0 += FC) {
    const bool more = f0 + FC < Fp;
    auto wout_chunk = [&] {
      load_b_async(wb1, FC, C, [&](int k, int n) { return wout + (size_t)(f0 + k) * C + n; });
    };
    if (dbl) wout_chunk();
    gemm(m1, 2 * FC, C, 2 * FC / 16, [&](int m, int, int k) { return rn + m * LX + k; }, LX,
         at_ld(wb0, LT2), t2, LT2);
    __syncthreads();
    if (!dbl) wout_chunk();
    // dw3x3 + GELU gate down each column of the tile; a thread keeps one
    // (hidden channel, column)'s 18 taps and two 3x3 windows in registers
    for (int idx = threadIdx.x; idx < FC * tw; idx += NT) {
      const int f = idx % FC, j = idx / FC;
      float w1k[9], w2k[9], u1[3][3], u2[3][3];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        w1k[tap] = taps[tap * F2 + f0 + f];
        w2k[tap] = taps[tap * F2 + Fp + f0 + f];
      }
#pragma unroll
      for (int di = 0; di < 2; ++di)
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          const bf16* tp = t2 + (di * w1 + j + dj) * LT2;
          u1[di + 1][dj] = __bfloat162float(tp[f]);
          u2[di + 1][dj] = __bfloat162float(tp[FC + f]);
        }
#pragma unroll 2
      for (int i = 0; i < th; ++i) {
        float a1 = 0.f, a2 = 0.f;
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          const bf16* tp = t2 + ((i + 2) * w1 + j + dj) * LT2;
          u1[0][dj] = u1[1][dj]; u1[1][dj] = u1[2][dj]; u1[2][dj] = __bfloat162float(tp[f]);
          u2[0][dj] = u2[1][dj]; u2[1][dj] = u2[2][dj]; u2[2][dj] = __bfloat162float(tp[FC + f]);
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
    if (dbl && more) win_chunk(f0 + FC);
    gemm_acc(P, C, FC, [&](int m, int, int k) { return gg + m * LGG + k; }, LGG,
             at_ld(wb1, LB), acc, LA);
    if (!dbl) {
      __syncthreads();
      if (more) win_chunk(f0 + FC);
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

Geo make_geo(int B, int H, int W, int C, int heads, int Fp, int th, int tw) {
  Geo g;
  g.B = B; g.H = H; g.W = W; g.C = C; g.heads = heads; g.hc = C / heads;
  g.Fp = Fp; g.th = th; g.tw = tw;
  g.ntj = (W + tw - 1) / tw;
  g.ntiles = ((H + th - 1) / th) * g.ntj;
  return g;
}

bool shape_ok(int C, int heads, int Fp, int th, int tw) {
  return heads > 0 && C % heads == 0 && (C / heads) % 16 == 0 && Fp % FC == 0 &&
         (th * tw) % 16 == 0 && C <= 32 * MAX_LN_REGS;
}

template <class K>
int opt_in(K kernel, size_t bytes) {
  if (bytes > (size_t)SMEM_LIMIT) return ERR_SMEM;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

struct ApplyArgs {
  const void* x;
  void* y;
  const bf16* vin;
  const bf16* attn_t;
  const bf16* wproj;
  const float* ln2;
  const bf16* win;
  const float* wdw;
  const bf16* wout;
  Geo g;
  float eps;
  size_t bytes;
  bool dbl;
  cudaStream_t stream;
};

template <class Tin, class Tout>
int launch_apply(const ApplyArgs& a) {
  int err = opt_in(k_apply<Tin, Tout>, a.bytes);
  if (err) return err;
  k_apply<Tin, Tout><<<dim3(a.g.ntiles, a.g.B), NT, a.bytes, a.stream>>>(
      (const Tin*)a.x, (Tout*)a.y, a.vin, a.attn_t, a.wproj, a.ln2, a.win, a.wdw,
      a.wout, a.g, a.eps, a.dbl);
  return (int)cudaGetLastError();
}

}  // namespace

// ---- C interface (ctypes). Pointers are device pointers of contiguous
// tensors; each call launches on `stream` and returns cudaGetLastError()
// (or ERR_SMEM / ERR_SHAPE without launching). ---------------------------

extern "C" {

int raie_stage_smem_bytes(int kind, int th, int tw, int C, int heads, int Fp) {
  // the smaller layouts (W_qkv staged in chunks, one weight buffer)
  return kind == 0 ? (int)GramSmem(th, tw, C, heads, false).total
                   : (int)ApplySmem(th, tw, C, Fp, false).total;
}

const char* raie_stage_error_string(int code) {
  if (code == ERR_SMEM) return "tile needs more than 227 KB of shared memory";
  if (code == ERR_SHAPE) return "C/heads and th*tw must be multiples of 16, C <= 384";
  return cudaGetErrorString((cudaError_t)code);
}

int raie_stage_gram(const void* x, int x_is_bf16, const void* ln1, const void* wqkv,
                    const void* dwqkv, void* part, void* vout, int B, int H, int W, int C,
                    int heads, int Fp, int th, int tw, int groups, float eps,
                    void* stream) {
  if (!shape_ok(C, heads, Fp, th, tw)) return ERR_SHAPE;
  const Geo g = make_geo(B, H, W, C, heads, Fp, th, tw);
  const bool resident = GramSmem(th, tw, C, heads, true).total <= (size_t)SMEM_LIMIT;
  const size_t bytes = GramSmem(th, tw, C, heads, resident).total;
  const dim3 grid(groups, B);
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  if (x_is_bf16) {
    if ((err = opt_in(k_gram<bf16>, bytes))) return err;
    k_gram<bf16><<<grid, NT, bytes, s>>>((const bf16*)x, (const float*)ln1,
                                         (const bf16*)wqkv, (const float*)dwqkv,
                                         (float*)part, (bf16*)vout, g, groups, eps, resident);
  } else {
    if ((err = opt_in(k_gram<float>, bytes))) return err;
    k_gram<float><<<grid, NT, bytes, s>>>((const float*)x, (const float*)ln1,
                                          (const bf16*)wqkv, (const float*)dwqkv,
                                          (float*)part, (bf16*)vout, g, groups, eps, resident);
  }
  return (int)cudaGetLastError();
}

int raie_stage_softmax(const void* part, const void* temp, void* attn_t, int B, int C,
                       int heads, int groups, void* stream) {
  if (heads <= 0 || C % heads) return ERR_SHAPE;
  const int hc = C / heads;
  k_softmax<<<dim3(heads * hc, B), NT_SOFTMAX, hc * sizeof(float), (cudaStream_t)stream>>>(
      (const float*)part, (const float*)temp, (bf16*)attn_t, C, heads, groups);
  return (int)cudaGetLastError();
}

int raie_stage_apply(const void* x, int x_is_bf16, void* y, int y_is_bf16,
                     const void* vin, const void* attn_t, const void* wproj, const void* ln2,
                     const void* win, const void* wdw, const void* wout, int B, int H,
                     int W, int C, int heads, int Fp, int th, int tw, float eps,
                     void* stream) {
  if (!shape_ok(C, heads, Fp, th, tw)) return ERR_SHAPE;
  const Geo g = make_geo(B, H, W, C, heads, Fp, th, tw);
  const bool dbl = ApplySmem(th, tw, C, Fp, true).total <= (size_t)SMEM_LIMIT;
  const ApplyArgs a{x, y, (const bf16*)vin, (const bf16*)attn_t, (const bf16*)wproj,
                    (const float*)ln2, (const bf16*)win, (const float*)wdw,
                    (const bf16*)wout, g, eps, ApplySmem(th, tw, C, Fp, dbl).total, dbl,
                    (cudaStream_t)stream};
  if (x_is_bf16) return y_is_bf16 ? launch_apply<bf16, bf16>(a) : launch_apply<bf16, float>(a);
  return y_is_bf16 ? launch_apply<float, bf16>(a) : launch_apply<float, float>(a);
}

}  // extern "C"
