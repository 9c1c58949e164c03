// Transformer block kernels for Hopper (sm_90a): one Restormer
// TransformerBlock, y = r + GDFN(LN2(r)), r = x + W_p MDTA(LN1(x)), per
// call of the three entry points below, with either LayerNorm (BiasFree, or
// WithBias where the bias pointers are given).
//
// Replaces: rethink_acoustic_image_enhancement_tpu/ops/pallas/stage.py
//           ::fused_transformer_stage (its pallas_call at stage.py:324), N
//           BiasFree blocks, the block loop in ops/stage.py; and
//           ops/pallas/block.py::fused_transformer_block (block.py:338), one
//           block of either LayerNorm and any head count, from ops/block.py.
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
//   (A) k_gram, one block per SM walking a group of 8x8 tiles: LN1 (zero
//       on the ring outside the image, where torch zero-pads the qkv
//       depthwise input) -> qkv 1x1 on the tile's 1-pixel halo (W_qkv stays
//       in shared memory for the group) -> dw3x3; v goes to device memory,
//       and the per-head Gram q^T k and the squared q/k norms over the
//       tile's true pixels add up over the group's tiles in shared memory,
//       written once per group.
//   (B) k_softmax, per (sample, head, query channel): sum the groups,
//       divide by max(||q||, 1e-12) max(||k||, 1e-12), times the per-head
//       temperature, softmax within the head, store attn^T in bf16. Where
//       C/heads is not a multiple of 16, (A) and (C) run as one head over
//       the full C x C Gram and (B) takes the softmax within each true head,
//       leaving zeros between heads: attn is block-diagonal and attn @ v
//       stays one C x C product.
//   (C) k_apply, per 8x8 output tile: attn @ v, W_proj + residual r on the
//       1-pixel halo, LN2 (zero on the ring outside the image, where torch
//       zero-pads the GDFN depthwise input), then the GDFN in chunks of 64
//       hidden channels (tile_ops.cuh::gdfn_tile, shared with gdfn.cu):
//       W_in chunk, dw3x3 over the real halo, GELU gate (the
//       Abramowitz-Stegun erf of the TPU kernel), and W_out accumulated
//       onto r in shared memory. In a stage the tile is written to the
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

#include <mma.h>

#include "tile_ops.cuh"

using namespace nvcuda;

namespace {

constexpr int NT_SOFTMAX = 128;
constexpr int NCH = 64;             // W_qkv columns staged at a time in (A)

// ---- shared-memory layouts (host and device agree through these) --------

// With `resident`, all of W_qkv stays in shared memory (where it fits);
// else NCH columns are staged at a time.
struct GramSmem {
  size_t wb, xq, t, gram, nrm, taps, lnw, lnb, total;
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
    lnb = o;   o += align128((size_t)C * 4);                            // and bias
    total = o;
  }
};

// ---- (A) q, k, v; Gram and squared norms over groups of tiles ------------

template <class T>
__global__ void __launch_bounds__(NT)
k_gram(const T* __restrict__ x, const float* __restrict__ ln1,
       const float* __restrict__ ln1b, const bf16* __restrict__ wqkv,
       const float* __restrict__ dwqkv, float* __restrict__ part, bf16* __restrict__ vout, Geo g, int groups, float eps,
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
  float* lnb = (float*)(smem + L.lnb);

  const int b = blockIdx.y, grp = blockIdx.x;
  const int C = g.C, C2 = 2 * C, C3 = 3 * C, hc = g.hc, th = g.th, tw = g.tw;
  const int LX = C + PAD, LT = C3 + PAD, LQ = C2 + PAD, LG = hc + PADF;
  const int w1 = tw + 2, n1 = (th + 2) * w1, m1 = round16(n1), P = th * tw;
  const int gsize = g.heads * hc * LG;
  for (int i = threadIdx.x; i < gsize; i += NT) gram[i] = 0.f;
  for (int i = threadIdx.x; i < C2 * tw; i += NT) nrm[i] = 0.f;
  // W_qkv, nch columns at a time (all of it once, for all of the group's
  // tiles, where it fits)
  const int nch = resident ? C3 : NCH;
  if (resident) load_b_async(wb, C, C3, [&](int k, int n) { return wqkv + (size_t)k * C3 + n; });
  for (int i = threadIdx.x; i < 9 * C3; i += NT) taps[i] = dwqkv[i];
  for (int i = threadIdx.x; i < C; i += NT) {
    lnw[i] = ln1[i];
    if (ln1b != nullptr) lnb[i] = ln1b[i];
  }

  for (int tile = grp; tile < g.ntiles; tile += groups) {
    const int y0 = (tile / g.ntj) * th, x0 = (tile % g.ntj) * tw;
    __syncthreads();
    load_region(x, xs, C, g, b, y0, x0, 1, m1);
    __syncthreads();
    // LN1 on the 1-pixel halo, zero outside the image (x is 0 there, but
    // with a bias LN1(0) is not, and the depthwise step must see 0)
    ln_rows(xs, C, lnw, ln1b != nullptr ? lnb : nullptr, xn, LX, m1, C, eps,
            [&](int p) { return p < n1 && inside(g, y0 - 1 + p / w1, x0 - 1 + p % w1); });
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

// Sum over the groups of entry idx of each group's partials, in group order,
// the loads started GB at a time ahead of the adds (one load's latency apiece
// would otherwise make up most of this kernel's time).
__device__ __forceinline__ float sum_groups(const float* __restrict__ base, int stride,
                                            int groups, int idx) {
  constexpr int GB = 12;
  float acc = 0.f;
  int gi = 0;
  for (; gi + GB <= groups; gi += GB) {
    float a[GB];
#pragma unroll
    for (int u = 0; u < GB; ++u) a[u] = base[(size_t)(gi + u) * stride + idx];
#pragma unroll
    for (int u = 0; u < GB; ++u) acc += a[u];
  }
  for (; gi < groups; ++gi) acc += base[(size_t)gi * stride + idx];
  return acc;
}

// One block per (sample, query channel). (A) laid its Gram out for gheads
// heads of hcg channels; the softmax runs over the `heads` true heads of hct
// channels, gheads being either `heads` or 1 (the full C x C Gram, whose
// entries between true heads become zeros of attn^T).
__global__ void __launch_bounds__(NT_SOFTMAX)
k_softmax(const float* __restrict__ part, const float* __restrict__ temp,
          bf16* __restrict__ attn_t, int C, int gheads, int heads, int groups) {
  extern __shared__ float logit[];  // [hct]
  __shared__ float red[NT_SOFTMAX / 32];
  const int hcg = C / gheads, hct = C / heads, b = blockIdx.y;
  const int cq = blockIdx.x, gh = cq / hcg, cl = cq % hcg, h = cq / hct;
  const int d0 = h * hct - gh * hcg;  // the true head's first key channel in the Gram's head
  const int gsize = gheads * hcg * hcg, stride = gsize + 2 * C;
  const float* base = part + (size_t)b * groups * stride;
  const float qnorm = fmaxf(sqrtf(sum_groups(base, stride, groups, gsize + cq)), 1e-12f);
  const float tau = temp[h];
  float mx = -3.0e38f;
  for (int d = threadIdx.x; d < hct; d += NT_SOFTMAX) {
    const float gs = sum_groups(base, stride, groups, gh * hcg * hcg + cl * hcg + d0 + d);
    const float kn = sum_groups(base, stride, groups, gsize + C + h * hct + d);
    const float l = gs / qnorm / fmaxf(sqrtf(kn), 1e-12f) * tau;
    logit[d] = l;
    mx = fmaxf(mx, l);
  }
  mx = block_reduce(mx, red, true);
  float s = 0.f;
  for (int d = threadIdx.x; d < hct; d += NT_SOFTMAX) {
    const float e = expf(logit[d] - mx);
    logit[d] = e;
    s += e;
  }
  s = block_reduce(s, red, false);
  // attn_t[b][gh][d][cl] = attn[cq][d]: the B operand of (C)'s v @ attn^T
  bf16* out = attn_t + ((size_t)b * gheads + gh) * hcg * hcg;
  for (int d = threadIdx.x; d < hcg; d += NT_SOFTMAX) {
    const bool same_head = d >= d0 && d < d0 + hct;
    out[d * hcg + cl] = __float2bfloat16(same_head ? logit[d - d0] / s : 0.f);
  }
}

// ---- (C) attention apply, projection, LN2, GDFN, residuals ---------------

template <int FC, class Tin, class Tout>
__global__ void __launch_bounds__(NT)
k_apply(const Tin* __restrict__ x, Tout* __restrict__ y, const bf16* __restrict__ vin,
        const bf16* __restrict__ attn_t, const bf16* __restrict__ wproj,
        const float* __restrict__ ln2, const float* __restrict__ ln2b, FfnWeights wt, Geo g,
        float eps, bool dbl) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FfnSmem L(g.th, g.tw, g.C, g.fc, dbl, true);
  const FfnBufs s(smem, L);
  bf16* v = s.rn;  // v first, LN2(r) later
  bf16* oa = (bf16*)(smem + L.oa);
  float* r = s.r;

  const int b = blockIdx.y, tile = blockIdx.x;
  const int y0 = (tile / g.ntj) * g.th, x0 = (tile % g.ntj) * g.tw;
  const int C = g.C, hc = g.hc;
  const int LX = C + PAD, LB = C + PAD, LA = C + PADF;
  const int m1 = round16((g.th + 2) * (g.tw + 2));
  auto at_ld = [](const bf16* base, int ld) {
    return [=](int k, int n) { return base + k * ld + n; };
  };

  // attn^T of every head side by side: wb0[d][h*hc + c] = attn[h][c][d];
  // W_proj; v and x on the 1-pixel halo (0 outside the image)
  const bf16* at = attn_t + (size_t)b * g.heads * hc * hc;
  load_b_async(s.wb0, hc, C, [&](int k, int n) { return at + (size_t)(n / hc) * hc * hc + k * hc + n % hc; });
  copy_async(s.lnw, ln2, C * 4);
  if (ln2b != nullptr) copy_async(s.lnb, ln2b, C * 4);
  auto proj = [&] { load_b_async(s.wb1, C, C, [&](int k, int n) { return wproj + (size_t)k * C + n; }); };
  if (dbl) proj();
  load_region(vin, v, LX, g, b, y0, x0, 1, m1);
  load_region(x, r, LA, g, b, y0, x0, 1, m1);
  cp_async_wait();
  __syncthreads();
  // oa[p][h*hc + c] = sum_d v[p][h*hc + d] attn[h][c][d]  (hc % 16 == 0, so
  // every 16-column fragment lies within one head)
  gemm(m1, C, hc, hc / 16, [&](int m, int n, int k) { return v + m * LX + (n / hc) * hc + k; },
       LX, at_ld(s.wb0, LB), oa, LX);
  __syncthreads();
  if (dbl) {
    ffn_load_chunk<FC>(s, wt, g, 0);
  } else {
    proj();
    cp_async_wait();
    __syncthreads();
  }
  // r += bf16(oa) @ W_proj on the 1-pixel halo
  gemm_acc(m1, C, C, [&](int m, int, int k) { return oa + m * LX + k; }, LX, at_ld(s.wb1, LB), r,
           LA);
  __syncthreads();
  if (!dbl) ffn_load_chunk<FC>(s, wt, g, 0);
  gdfn_tile<FC>(s, y, wt, g, b, y0, x0, eps, dbl, true, ln2b != nullptr);
}

// C/heads a multiple of 16 on top of what every tile kernel needs.
bool shape_ok(int C, int heads, int Fp, int fc, int th, int tw) {
  return heads > 0 && C % heads == 0 && (C / heads) % 16 == 0 &&
         ffn_shape_ok(C, Fp, fc, th, tw);
}

struct ApplyArgs {
  const void* x;
  void* y;
  const bf16* vin;
  const bf16* attn_t;
  const bf16* wproj;
  const float* ln2;
  const float* ln2b;
  FfnWeights wt;
  Geo g;
  float eps;
  size_t bytes;
  bool dbl;
  cudaStream_t stream;
};

template <int FC, class Tin, class Tout>
int launch_apply_fc(const ApplyArgs& a) {
  int err = opt_in(k_apply<FC, Tin, Tout>, a.bytes);
  if (err) return err;
  k_apply<FC, Tin, Tout><<<dim3(a.g.ntiles, a.g.B), NT, a.bytes, a.stream>>>(
      (const Tin*)a.x, (Tout*)a.y, a.vin, a.attn_t, a.wproj, a.ln2, a.ln2b, a.wt, a.g, a.eps,
      a.dbl);
  return (int)cudaGetLastError();
}

template <class Tin, class Tout>
int launch_apply(const ApplyArgs& a) {
  return a.g.fc == 64 ? launch_apply_fc<64, Tin, Tout>(a) : launch_apply_fc<32, Tin, Tout>(a);
}

}  // namespace

// ---- C interface (ctypes). Pointers are device pointers of contiguous
// tensors; each call launches on `stream` and returns cudaGetLastError()
// (or ERR_SMEM / ERR_SHAPE without launching). `heads` is the head count of
// the Gram's layout: the block's own where C/heads is a multiple of 16, else
// 1, with the true count given to the softmax alone. A null LayerNorm bias
// selects the BiasFree variant. ---------------------------------------------

extern "C" {

int raie_stage_smem_bytes(int kind, int th, int tw, int C, int heads, int fc) {
  // the smaller layouts (W_qkv staged in chunks, one weight buffer)
  return kind == 0 ? (int)GramSmem(th, tw, C, heads, false).total
                   : (int)FfnSmem(th, tw, C, fc, false, true).total;
}

const char* raie_stage_error_string(int code) { return tile_error_string(code); }

int raie_stage_gram(const void* x, int x_is_bf16, const void* ln1, const void* ln1b,
                    const void* wqkv, const void* dwqkv, void* part, void* vout, int B, int H,
                    int W, int C, int heads, int th, int tw, int groups, float eps,
                    void* stream) {
  if (!shape_ok(C, heads, 64, 64, th, tw)) return ERR_SHAPE;
  const Geo g = make_geo(B, H, W, C, heads, 0, 0, th, tw);
  const bool resident = GramSmem(th, tw, C, heads, true).total <= (size_t)SMEM_LIMIT;
  const size_t bytes = GramSmem(th, tw, C, heads, resident).total;
  const dim3 grid(groups, B);
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  if (x_is_bf16) {
    if ((err = opt_in(k_gram<bf16>, bytes))) return err;
    k_gram<bf16><<<grid, NT, bytes, s>>>((const bf16*)x, (const float*)ln1, (const float*)ln1b,
                                         (const bf16*)wqkv, (const float*)dwqkv,
                                         (float*)part, (bf16*)vout, g, groups, eps, resident);
  } else {
    if ((err = opt_in(k_gram<float>, bytes))) return err;
    k_gram<float><<<grid, NT, bytes, s>>>((const float*)x, (const float*)ln1, (const float*)ln1b,
                                          (const bf16*)wqkv, (const float*)dwqkv,
                                          (float*)part, (bf16*)vout, g, groups, eps, resident);
  }
  return (int)cudaGetLastError();
}

int raie_stage_softmax(const void* part, const void* temp, void* attn_t, int B, int C,
                       int gram_heads, int heads, int groups, void* stream) {
  if (heads <= 0 || C % heads || (gram_heads != heads && gram_heads != 1)) return ERR_SHAPE;
  k_softmax<<<dim3(C, B), NT_SOFTMAX, C / heads * sizeof(float), (cudaStream_t)stream>>>(
      (const float*)part, (const float*)temp, (bf16*)attn_t, C, gram_heads, heads, groups);
  return (int)cudaGetLastError();
}

int raie_stage_apply(const void* x, int x_is_bf16, void* y, int y_is_bf16,
                     const void* vin, const void* attn_t, const void* wproj, const void* ln2,
                     const void* ln2b, const void* win, const void* wdw, const void* wout,
                     int B, int H, int W, int C, int heads, int Fp, int fc, int th, int tw,
                     float eps, void* stream) {
  if (!shape_ok(C, heads, Fp, fc, th, tw)) return ERR_SHAPE;
  const Geo g = make_geo(B, H, W, C, heads, Fp, fc, th, tw);
  const bool dbl = FfnSmem(th, tw, C, fc, true, true).total <= (size_t)SMEM_LIMIT;
  const ApplyArgs a{x, y, (const bf16*)vin, (const bf16*)attn_t, (const bf16*)wproj,
                    (const float*)ln2, (const float*)ln2b,
                    FfnWeights{(const bf16*)win, (const float*)wdw, (const bf16*)wout}, g, eps,
                    FfnSmem(th, tw, C, fc, dbl, true).total, dbl, (cudaStream_t)stream};
  if (x_is_bf16) return y_is_bf16 ? launch_apply<bf16, bf16>(a) : launch_apply<bf16, float>(a);
  return y_is_bf16 ? launch_apply<float, bf16>(a) : launch_apply<float, float>(a);
}

}  // extern "C"
