// The Transformer block's tile kernels for Hopper (sm_90a) at C = 192 (4
// heads) and C = 384 (8 heads), the widths of the deeper stages of 1024^2
// and 2048^2 teacher frames (encoder_level3 and decoder_level3 at 192, the
// latent at 384), built on hopper.cuh's wgmma, TMA, bulk copies and
// mbarriers. One Restormer TransformerBlock, y = r + GDFN(LN2(r)), r = x +
// W_p MDTA(LN1(x)), is four launches here: (A) k_gram_wide (LN1, the qkv
// product, its depthwise 3x3, v to device memory, the per-head Gram and
// squared norms as partials over groups of tiles), stage.cu's (B) k_softmax
// (attn^T), and kernel (C) split in two: (P) k_proj_wide (r = x + bf16(attn
// @ v) @ W_proj, written in fp32) and (F) k_ffn_wide (LN2, the GDFN and the
// second residual). The host takes these at C = 192 and 384 with 48
// channels a head (ops/block.py::apply_route); off a model shard C = 96
// keeps stage_sm90.cu's.
//
// Model shards (ops/stage.py::fused_transformer_stage_shards), at C = 96,
// 192 and 384 with 48 channels a head: (A) runs on the shard's 1, 2 or 4
// heads (Geo's heads, Cq = 48 heads; LN1 over all C channels of x; q, k, v,
// the Gram and the norms of those heads alone), (P) on their v, attn^T and rows of
// W_proj, x added only where it is given (else the partial alone); a shard
// that holds every head at C = 96 takes stage_sm90.cu's (A), which ran in
// 0.94x the time of this file's instance with both heads. The C = 96
// instances (tiles of 6 x 30 on an 8 x 32 halo, (P)'s of 8 x 32) exist for
// the shards and for the GDFN kernel.
//
// The LN+GDFN kernel (ops/gdfn.py::ffn_route) is (F) itself at C = 96, 192
// and 384: x and y both fp32 or both bf16, BiasFree, WithBias
// or no LayerNorm (W_in reads x itself, zero outside the image), the
// residual on or off (a model shard's part of the hidden channels), any
// batch and any hidden width padded to a multiple of 32. At C = 96 its
// LayerNorm puts two pixels on a warp's lanes at once (12 groups of 8
// channels fill half of them). W_in keeps its A operand in shared memory:
// held in registers (wgmma's RS form, 24 more a thread beside y's 48) the
// tile spilled 64-80 B and ran 12% slower; and W_in is not overlapped with
// the depthwise step: the ring's warpgroup, which holds no y at C = 96,
// taking the next chunk's W_in into its idle y registers during the step
// (a second W_in slot, the taps on barriers of their own) spilled 4 B and
// ran 5-7% slower (PERF.md §6).
//
// Replaces, at these widths: rethink_acoustic_image_enhancement_tpu/ops/
// pallas/stage.py::fused_transformer_stage (its pallas_call at stage.py:324),
// ops/pallas/block.py::fused_transformer_block (block.py:338) and
// ops/pallas/gdfn.py::fused_ln_gdfn (gdfn.py:277).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s). Per pixel and
// block at C = 384, F = 1021: the qkv product 2 C 3C, the Gram and attn @ v
// 2 C 48 each, W_proj 2 C C, W_in 2 C 2F, W_out 2 F C and the two depthwise
// 3x3s 2 9 (3C + 2F): 3.60 MFLOP, 236 GFLOP at 256x256 (0.239 ms) against
// 50 MB of x and y in bf16 (15 us); at C = 192, F = 510: 0.95 MFLOP, 249
// GFLOP at 512x512 (0.251 ms). Both are bound by the tensor-core rate.
//
// Why stage_sm90.cu's layout (6 x 30 outputs on an 8 x 32 halo, four m64
// operands, r in the accumulator of the own rows) does not carry over:
//   - Registers. r's own-row accumulator is m64 x C fp32 a warpgroup: C/2
//     registers a thread, 96 at C = 192 and 192 at C = 384, against 128 at
//     512 threads. The tile's 192 own rows at C = 384 are 73,728 fp32
//     registers, more than the SM's 65,536.
//   - Shared memory. v's (or LN's) 256 halo rows take C x 512 B: 98,304 B
//     at 192 and 196,608 B at 384, of 232,448.
//   - Weights. W_proj is 73,728 or 294,912 B, W_qkv 221,184 or 884,736 B.
// This design:
//   - Tiles of TH x 30 outputs on a (TH + 2) x 32 halo, TH = 4 at C = 192
//     and 2 at C = 384: the own rows (TH x 32, halo columns included) are
//     TH/2 full m64 operands and the ring (the rows above and below) one
//     more. Registers decide TH: a warpgroup holds 64 own rows by 96 of the
//     output's columns (48 registers, as at C = 96), C/96 warpgroups share
//     an own operand, and the four warpgroups hold TH/2 of them. The W_in
//     and qkv products recompute the halo 1.6x (C = 192) and 2.13x (384).
//   - (C) split in two, as stage.cu's (C') and the GDFN kernel split it on
//     model shards: r's round trip in fp32 costs 8 C bytes a pixel (0.06 ms
//     a block at (1,256,256,384) against a 0.239 ms bound), and in exchange
//     attn @ v and W_proj run once a pixel (no halo: (P)'s tiles are TH x 32
//     pixels of the band's readable rows, halo rows included, so that (F)
//     finds r on its ring), and (F) holds only y's accumulator.
//   - The MDTA head by head: hc = 48 at both widths. (A) takes q, k and v in
//     chunks of one head's 48 channels (a B operand of N = 48 streamed
//     through two slots with its taps, the product of the next chunk
//     running while the CUDA cores take this chunk's depthwise step), in the
//     order q_0, k_0, q_1, k_1, ..., v_0, v_1, ...: after k_h, q_h and k_h
//     of the tile's own rows give head h's Gram (mma.sync, its fragments in
//     registers over the group's tiles, the heads' 9 H fragments spread over
//     the 16 warps), so q | k holds two heads' width, not 2C. (P) takes
//     attn_h @ v_h (m64n48) into bf16 o, which W_proj's rows 48h..48h+47
//     (streamed through two slots) then multiply.
//   - Products: wgmma m64nNk16, bf16 in, fp32 accumulate, A and B from
//     shared memory (hopper.cuh's K-major layout); the LayerNorms and the
//     depthwise steps on the CUDA cores; the LayerNorms a warp a few
//     pixels at a time, their loads in flight together, the next tile's
//     rows prefetched into L2 (two-pass over the warp's lanes).
//   - Copies: (P)'s v box by TMA (the tensor map cut to the band's readable
//     rows, a box a plane of 8 channels, landing in the operand layout);
//     weights and taps by bulk copies under mbarriers, pre-packed on the
//     host (ops/block.py::pack_wgmma); x and r straight into registers.
//   - Grids: (P) and (F) one persistent block of 512 threads per SM; (A) one
//     block per SM too, each a group of one sample's tiles, one wave.
//
// Shared memory (bytes), C = 192 / C = 384:
//   (A) LN1(x) on the halo, planes of 8 channels     74,112 / 99,072
//       W_qkv chunk + taps, 2 slots                   40,448 / 77,312
//       t = bf16(chunk) on the halo                   21,504 / 14,336
//       q_h | k_h on the own rows                     26,624 / 13,312
//       total                                        162,720 / 204,064
//   (P) v and o of the tile, W_proj rows of a head (2 slots), attn^T
//       total                                        153,632 / 208,928
//   (F) LN2(r) on the halo                            74,112 / 99,072
//       W_in chunk (one slot), its taps (two)         29,184 / 53,760
//       W_out chunks, 2 slots                         24,576 / 49,152
//       t2, gg (2 slots)                              44,288 / 26,880
//       total                                        172,192 / 228,896
//   C = 96 (model shards and the LN+GDFN kernel): TH = 6, tiles of 6 x 30
//   on an 8 x 32 halo as stage_sm90.cu's, three own operands whose y
//   warpgroups 0-2 hold (the ring's warpgroup only its W_in), (P)'s tiles
//   8 x 32 (one operand a warpgroup): (A) 140,064, (P) 125,984, (F) 140,320.
// What bounds the tiles (PERF.md, PR 18: the phase clocks give the same
// cycles a tile on all, half and a quarter of the SMs, so it is not L2's
// weight traffic): inside the SM, W_in's products read A (LN2 of the halo)
// and B from shared memory for every 32-channel chunk, two or three
// warpgroups at once, near the SM's shared-memory rate; the depthwise steps
// and two barriers a chunk. Deeper weight rings at C = 192 (three W_qkv
// slots, two W_in slots) changed nothing measurable, so both widths keep
// the rings above.
//
// Numerics are stage.cu's: the products bf16 x bf16 -> fp32; qkv, attn @ v
// and W_in rounded to bf16 before their next use; depthwise taps in fp32;
// the two-pass LayerNorm variance; the Abramowitz-Stegun erf; LN1 and LN2
// zero outside the image; q/k norms from the fp32 depthwise outputs; r in
// fp32; y in fp32 or bf16. No atomics: a launch gives the same bits every
// time, and a band's rows the whole image's.

#include "tile_ops.cuh"
#include "hopper.cuh"

namespace {

constexpr int NTW = 512;       // threads: four warpgroups
constexpr int NWW = NTW / 32;  // warps
constexpr int XTW = 30;        // output columns of a tile of (A) and (F)
constexpr int XHW = 32;        // halo columns; (P)'s tile width
constexpr int HC = 48;         // channels a head; (A)'s chunk of q, k or v
constexpr int FCH = 32;        // (F)'s hidden channels a chunk
constexpr int NSUB = 96;       // output columns a warpgroup holds (r in (P), y in (F))
constexpr int NDP = XTW / 3;   // (A)'s depthwise column groups (partial norms a channel)
constexpr int NDW = HC * NDP;  // (A)'s depthwise threads

template <int C>
struct WideGeo {
  static constexpr int TH = C == 96 ? 6 : C == 192 ? 4 : 2;  // output rows a tile
  static constexpr int NOWN = TH / 2;          // m64 operands of the own rows (TH x 32)
  static constexpr int NOP = NOWN + 1;         // and the ring's
  static constexpr int ROWS = NOP * 64;        // halo pixels
  static constexpr int OWN = NOWN * 64;
  static constexpr int NSPLIT = C / NSUB;      // warpgroups sharing an own operand's columns
  static constexpr int NHOLD = NOWN * NSPLIT;  // warpgroups holding (F)'s y (3 of 4 at C = 96)
  static constexpr int PTH = C == 96 ? 8 : TH;  // (P)'s tile rows: one own operand a warpgroup
  static constexpr int PNOWN = PTH / 2;
  static constexpr int H = C / HC;             // heads (a model shard holds 1..H of them)
  static constexpr int NG = C / 8;             // planes of 8 channels
  static_assert(C == 96 || C == 192 || C == 384, "the wide kernels take 96, 192 or 384 channels");
  static_assert(C % NSUB == 0 && NHOLD <= 4 && PNOWN * NSPLIT == 4,
                "a warpgroup holds 96 columns of one own operand");
};

// Halo row and column of operand row p: the own rows (halo rows 1..TH)
// first, 32 a halo row, then the ring (halo rows 0 and TH + 1).
template <int TH>
__device__ __forceinline__ void halo_of(int p, int& hy, int& hx) {
  hx = p & 31;
  const int q = p >> 5;
  hy = q < TH ? q + 1 : (q == TH ? 0 : TH + 1);
}

__device__ __forceinline__ void load8(float (&v)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(float (&v)[8], const bf16* p) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}

// LayerNorm of a warp's pixels (C channels, fp32 or bf16) into bf16 rows of
// an operand of planes of 8 channels `plane` bytes apart, their loads in
// flight together. A pixel takes LPP lanes (16 where its C / 8 groups of 8
// channels fit them, C = 96: two pixels side by side; else the warp), lane l
// its groups l % LPP, + LPP; so the warp holds S = 32 / LPP pixels a slot,
// NP slots: src[i] is this lane's pixel of slot i (null: a pixel that is not
// readable, written as zeros, where torch zero-pads the depthwise input),
// written to row row0 + i S + lane / LPP. Two-pass variance over the pixel's
// lanes. BiasFree where lnb is null: v / sqrt(var + eps) * w; without `norm`
// the pixels themselves, rounded to bf16.
template <int C>
struct LnLanes {
  static constexpr int NG = C / 8, LPP = NG <= 16 ? 16 : 32, S = 32 / LPP;
  static constexpr int PER = (NG + LPP - 1) / LPP;
};

template <int C, int NP, class T>
__device__ __forceinline__ void ln_pixels(const T* const (&src)[NP],
                                          const float* __restrict__ lnw,
                                          const float* __restrict__ lnb, float eps, bool norm,
                                          unsigned char* op, int plane, int row0, int lane) {
  using LL = LnLanes<C>;
  constexpr int NG = LL::NG, LPP = LL::LPP, PER = LL::PER;
  const int gl = lane % LPP, row1 = row0 + lane / LPP;
  float v[NP][PER][8];
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int gi = gl + LPP * k;
      if (src[i] != nullptr && gi < NG) {
        load8(v[i][k], src[i] + 8 * gi);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[i][k][e] = 0.f;
      }
    }
  float mean[NP], inv[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    mean[i] = 0.f;
#pragma unroll
    for (int k = 0; k < PER; ++k)
#pragma unroll
      for (int e = 0; e < 8; ++e) mean[i] += v[i][k][e];
  }
#pragma unroll
  for (int o = LPP / 2; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < NP; ++i) mean[i] += __shfl_xor_sync(0xffffffffu, mean[i], o);
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    mean[i] /= C;
    inv[i] = 0.f;
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (gl + LPP * k < NG)
#pragma unroll
        for (int e = 0; e < 8; ++e) inv[i] += (v[i][k][e] - mean[i]) * (v[i][k][e] - mean[i]);
  }
#pragma unroll
  for (int o = LPP / 2; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < NP; ++i) inv[i] += __shfl_xor_sync(0xffffffffu, inv[i], o);
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int gi = gl + LPP * k;
    if (gi >= NG) continue;
    float w[8], bb[8];
    if (norm) {
      load8(w, lnw + 8 * gi);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) w[e] = 1.f;
    }
    if (norm && lnb != nullptr) {
      load8(bb, lnb + 8 * gi);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) bb[e] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const float is = rsqrtf(inv[i] / C + eps), m = lnb != nullptr ? mean[i] : 0.f;
      unsigned o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[e] = src[i] == nullptr ? 0u
               : norm ? pack_bf16((v[i][k][2 * e] - m) * is * w[2 * e] + bb[2 * e],
                                  (v[i][k][2 * e + 1] - m) * is * w[2 * e + 1] + bb[2 * e + 1])
                      : pack_bf16(v[i][k][2 * e], v[i][k][2 * e + 1]);
      *reinterpret_cast<uint4*>(op + gi * plane + (row1 + i * LL::S) * 16) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

// LN of the halo's ROWS pixels around the tile at (y0, x0) of sample b (x
// of C channels) into operand rows (own rows first, then the ring), a warp
// NP slots of LnLanes<C>::S consecutive pixels at a time (8 NP C / 256
// registers of loads a lane at S = 1).
template <int C, int TH, int NP, class T>
__device__ __forceinline__ void ln_halo(const T* x, const Geo& g, int b, int y0, int x0,
                                        const float* lnw, const float* lnb, float eps, bool norm,
                                        unsigned char* op, int plane, int warp, int lane) {
  constexpr int ROWS = (TH + 2) * XHW, S = LnLanes<C>::S;
  static_assert(ROWS % (S * NP) == 0, "a warp's slots stay inside the halo");
  for (int p0 = warp * NP * S; p0 < ROWS; p0 += NWW * NP * S) {
    const T* src[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      int hy, hx;
      halo_of<TH>(p0 + i * S + lane / LnLanes<C>::LPP, hy, hx);
      const int yy = y0 - 1 + hy, xx = x0 - 1 + hx;
      src[i] = readable(g, yy, xx) ? x + pix(g, b, yy, xx) : nullptr;
    }
    ln_pixels<C, NP>(src, lnw, lnb, eps, norm, op, plane, p0, lane);
  }
}

// Threads first..first+nrows-1: the readable part of rows y0 - 1 + i,
// columns x0 - 1 .. x0 - 2 + ncols of x (C channels) into L2, so that the
// next tile's loads of x (straight into registers) find it there.
template <class T>
__device__ __forceinline__ void prefetch_rows(const T* x, const Geo& g, int b, int y0, int x0,
                                              int nrows, int ncols, int first = 0) {
  const int row = (int)threadIdx.x - first, yy = y0 - 1 + row;
  if (row < 0) return;
  if (row >= nrows || !readable(g, yy, 0)) return;
  const int xa = x0 - 1 < 0 ? 0 : x0 - 1, xb = x0 - 1 + ncols > g.W ? g.W : x0 - 1 + ncols;
  if (xb > xa) prefetch_l2(x + pix(g, b, yy, xa), (uint32_t)((xb - xa) * g.C * sizeof(T)));
}

// The copies of a tile kernel are issued by the first thread of its last
// warp, which takes no part in the depthwise steps (480 of the 512 threads
// do) and no Gram fragment: issuing a bulk copy of tens of KB stalls the
// issuing thread (~1.2K cycles a W_in and W_out chunk in (F), phase
// clocks), which from thread 0 held back its warpgroup's products (a few
// percent of a tile; the same copies split over a warp's 32 lanes were
// slower).
constexpr int ISSUER = (NWW - 1) * 32;

// ---- (A) LN1, q, k, v; Gram and squared norms ---------------------------

template <int C>
struct GramWide {
  using G = WideGeo<C>;
  static constexpr int LNP = G::ROWS * 16 + 16;  // a plane of LN1(x), padded (other banks)
  static constexpr int WQB = C * HC * 2;         // a W_qkv chunk (N = 48, K = C)
  static constexpr int WQ_LBO = (HC / 8) * 128;
  static constexpr int TAPB = 9 * HC * 4;        // its taps [tap][48]
  static constexpr int SLOT = (WQB + TAPB + 127) / 128 * 128;
  static constexpr int LT = HC + 8;              // t's row (bf16), padded
  static constexpr int LQK = 2 * HC + 8;         // q_h | k_h's row (bf16), padded
  static constexpr int S_LN = 0;
  static constexpr int S_W = (S_LN + G::NG * LNP + 127) / 128 * 128;
  static constexpr int S_T = S_W + 2 * SLOT;
  static constexpr int S_QK = (S_T + G::ROWS * LT * 2 + 127) / 128 * 128;
  static constexpr int S_BARS = (S_QK + G::OWN * LQK * 2 + 127) / 128 * 128;
  static constexpr int TOTAL = S_BARS + 4 * 8;
  static_assert(TOTAL <= SMEM_LIMIT - 256, "kernel (A)'s tile must fit one SM");
  static_assert(2 * C * NDP * 4 <= G::NG * LNP, "the norms' reduction fits LN1's buffer");
};

enum { PA_LN1, PA_PROD, PA_DW, PA_GRAM, PA_REST, PA_WAIT, PA_ISSUE, PA_PWAIT };
enum { PP_WAIT, PP_ATTN, PP_PROJ, PP_STORE };
enum { PF_LN2, PF_W_IN, PF_DW, PF_STORE, PF_WAIT, PF_ISSUE, PF_PWAIT };
#ifdef RAIE_PHASE_CLOCKS
__device__ long long* phase_buf_gram_wide = nullptr;
__device__ long long* phase_buf_proj_wide = nullptr;
__device__ long long* phase_buf_ffn_wide = nullptr;
#define PHASE_BUF_WIDE(name) name
#else
#define PHASE_BUF_WIDE(name) nullptr
#endif

// Block (grp, b) walks tiles grp, grp + groups, ... of sample b (one wave)
// and writes part[b][grp] = (Gram [HS][48][48], squared norms [2 Cq]) once,
// as stage.cu's kernel (A), for the HS heads it holds (all H off a model
// shard; a shard's 1, 2 or 4; Cq = 48 HS). Warpgroup w < NOP takes operand
// w's products (64 halo rows); every thread the LayerNorm and the depthwise
// steps. The head count is a constant (a runtime one spilled and slowed the
// whole image's tile at C = 384 by 32%), and a shard's Gram fragments and
// norms take only its heads' registers.
template <int C, class Tin, int HS>
__global__ void __launch_bounds__(NTW, 1)
k_gram_wide(const Tin* __restrict__ x, const float* __restrict__ ln1,
            const float* __restrict__ ln1b, const bf16* __restrict__ wq_p,
            const float* __restrict__ qtaps_p, float* __restrict__ part,
            bf16* __restrict__ vout, Geo g, int groups, float eps) {
  using G = WideGeo<C>;
  using L = GramWide<C>;
  constexpr int TH = G::TH, NF = 9 * HS;
  static_assert(HS >= 1 && HS <= G::H, "the heads held are some of the tile's");
  constexpr int NGW = NWW - 1;                // warps holding the Gram (all but the issuer)
  constexpr int GMAX = (NF + NGW - 1) / NGW;  // Gram fragments a warp holds
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* t = (bf16*)(smem + L::S_T);
  bf16* qk = (bf16*)(smem + L::S_QK);
  uint64_t* wbar = (uint64_t*)(smem + L::S_BARS);  // [2] W_qkv chunk slots

  const int tid = threadIdx.x, wg = tid >> 7, wi = (tid >> 5) & 3, warp = tid >> 5;
  const int lane = tid & 31, gq = lane >> 2, q2 = (lane & 3) * 2;
  const int b = blockIdx.y, grp = blockIdx.x;
  const int my_tiles = grp < g.ntiles ? (g.ntiles - grp + groups - 1) / groups : 0;
  constexpr int hs = HS, nqc = 3 * hs, cq = HS * HC;  // heads held, q, k, v chunks, channels
  const int my_chunks = my_tiles * nqc;
  const bool prod = wg < G::NOP;
  PHASE_CLOCK(pc);

  // the issuing thread: chunk gc into slot gc & 1
  auto issue_w = [&](int gc) {
    const int s = gc & 1;
    mbar_expect_tx(wbar + s, L::WQB + L::TAPB);
    bulk_load(smem + L::S_W + s * L::SLOT, wq_p + (size_t)(gc % nqc) * (L::WQB / 2), L::WQB,
              wbar + s);
    bulk_load(smem + L::S_W + s * L::SLOT + L::WQB, qtaps_p + (size_t)(gc % nqc) * 9 * HC,
              L::TAPB, wbar + s);
  };
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) mbar_init(wbar + i, 1);
    mbar_fence_init();
  }
  // q | k's halo columns 0 and 31 stay zero (the depthwise step writes 1..30)
  for (int i = tid; i < G::OWN * L::LQK * 2 / 16; i += NTW)
    reinterpret_cast<uint4*>(qk)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  if (tid == ISSUER)
    for (int gc = 0; gc < 2 && gc < my_chunks; ++gc) issue_w(gc);

  // this thread's two accumulator rows of operand wg and their halo pixels
  const int r0 = 16 * wi + gq;
  int hy, hx0;
  halo_of<TH>(64 * wg + r0, hy, hx0);
  bf16* t_0 = t + (hy * XHW + hx0) * L::LT + q2;
  bf16* t_1 = t_0 + 8 * L::LT;
  // the depthwise step's thread: channel df of each chunk, output columns
  // dj..dj+2, all rows (threads NDW.. take none)
  const int df = tid % HC, dg = tid / HC, dj = dg * 3;

  // this warp's 16x16 fragments of the Gram, F = warp, warp + NGW, ... (head
  // F / 9, fragment F % 9), as mma accumulators; q's and k's squared norms
  // of this thread's channel and columns, chunk by chunk (q_0, k_0, q_1, ...)
  float gacc[GMAX][2][4];
#pragma unroll
  for (int i = 0; i < GMAX; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) gacc[i][0][e] = gacc[i][1][e] = 0.f;
  float nq[2 * HS];
#pragma unroll
  for (int k = 0; k < 2 * HS; ++k) nq[k] = 0.f;
  // acc += q_h^T k_h of fragment f (rows f / 3, columns f % 3 of 16) over
  // the tile's own rows
  auto gram_frag = [&](float (&acc)[2][4], int f) {
    const int m0 = f / 3 * 16, n0 = f % 3 * 16;
    const bf16* qa = qk + ((lane & 7) + (lane >> 4) * 8) * L::LQK + m0 + ((lane >> 3) & 1) * 8;
    const bf16* kb = qk + (lane & 15) * L::LQK + HC + n0 + (lane >> 4) * 8;
#pragma unroll
    for (int k = 0; k < G::OWN; k += 16) {
      unsigned af[4], bfr[4];
      ldsm_x4_t(af, qa + k * L::LQK);
      ldsm_x4_t(bfr, kb + k * L::LQK);
      frag_mma(acc[0], acc[1], af, bfr);
    }
  };
  // every thread waits for chunk gc (its taps); warpgroups w < NOP issue
  // t = LN1(x) @ W_qkv[:, chunk gc] on their rows, left running into acc
  auto product = [&](int gc, float (&acc)[24]) {
    const int s = gc & 1;
    pc.mark(PA_ISSUE);
    mbar_wait(wbar + s, (gc >> 1) & 1);
    pc.mark(PA_WAIT);
    if (!prod) return;
    const unsigned char* wb = smem + L::S_W + s * L::SLOT;
    const unsigned char* ab = smem + L::S_LN + wg * 1024;
    wg_fence();
#pragma unroll
    for (int k = 0; k < C / 16; ++k)
      wgmma_ss_n48(acc, wg_desc(ab + 2 * k * L::LNP, L::LNP, 128),
                   wg_desc(wb + 2 * k * L::WQ_LBO, L::WQ_LBO, 128), k > 0);
    wg_commit();
  };
  auto store_t = [&](const float (&acc)[24]) {
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      st2(t_0 + 8 * j, make_float2(acc[4 * j], acc[4 * j + 1]));
      st2(t_1 + 8 * j, make_float2(acc[4 * j + 2], acc[4 * j + 3]));
    }
  };

  for (int it = 0; it < my_tiles; ++it) {
    const int tile = grp + it * groups;
    const int y0 = (tile / g.ntj) * TH, x0 = (tile % g.ntj) * XTW;
    if (it + 1 < my_tiles) {
      const int next = tile + groups;
      prefetch_rows(x, g, b, (next / g.ntj) * TH, (next % g.ntj) * XTW, TH + 2, XHW);
    }
    // LN1(x) on the halo, zero where x is not readable
    // two pixels at a time at C = 192, one at 384: the Gram's and the norms'
    // registers stay live across the tile
    ln_halo<C, TH, 384 / C>(x, g, b, y0, x0, ln1, ln1b, eps, true, smem + L::S_LN, L::LNP, warp,
                            lane);
    fence_proxy_async();
    __syncthreads();  // LN1(x) is complete
    pc.mark(PA_LN1);
    const int gc0 = it * nqc;
    {
      float acc[24];
      product(gc0, acc);
      if (prod) {
        wg_wait<0>();
        reg_fence(acc);
        store_t(acc);  // the last tile's depthwise step is done with t (the barrier above)
      }
    }
    __syncthreads();  // t of chunk 0 is complete
    pc.mark(PA_PROD);
#pragma unroll 1
    for (int c = 0; c < nqc; ++c) {
      const int gc = gc0 + c;
      // chunk c: q_h (c = 2h), k_h (2h + 1) for c < 2 hs, then v_(c - 2 hs)
      const bool is_v = c >= 2 * hs;
      const int kind = is_v ? 2 : c & 1, head = is_v ? c - 2 * hs : c >> 1;
      float nx[24];
      if (c + 1 < nqc) product(gc + 1, nx);
      // depthwise 3x3 (fp32 taps) of the chunk's channel df on output
      // columns dj..dj+2, three halo rows by five columns in registers
      if (tid < NDW) {
        const float* taps = (const float*)(smem + L::S_W + (gc & 1) * L::SLOT + L::WQB);
        const bf16* tf = t + dj * L::LT + df;
        float wk[9], u[3][5], nacc = 0.f;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) wk[tap] = taps[tap * HC + df];
#pragma unroll
        for (int row = 0; row < 2; ++row)
#pragma unroll
          for (int cc = 0; cc < 5; ++cc) u[row][cc] = __bfloat162float(tf[(row * XHW + cc) * L::LT]);
#pragma unroll
        for (int i = 0; i < TH; ++i) {  // output row; halo row i + di lies in slot (i + di) % 3
#pragma unroll
          for (int cc = 0; cc < 5; ++cc)
            u[(i + 2) % 3][cc] = __bfloat162float(tf[((i + 2) * XHW + cc) * L::LT]);
          float a[3] = {0.f, 0.f, 0.f};
#pragma unroll
          for (int dj2 = 0; dj2 < 3; ++dj2)
#pragma unroll
            for (int di = 0; di < 3; ++di)
#pragma unroll
              for (int o = 0; o < 3; ++o) a[o] += u[(i + di) % 3][o + dj2] * wk[di * 3 + dj2];
#pragma unroll
          for (int o = 0; o < 3; ++o) {
            const int yo = y0 + i, xo = x0 + dj + o;
            const bool in = inside(g, yo, xo);
            if (!is_v) {
              const float q = in ? a[o] : 0.f;
              qk[(i * XHW + dj + o + 1) * L::LQK + kind * HC + df] = __float2bfloat16(q);
              nacc += q * q;
            } else if (in) {
              vout[pix(g, b, yo, xo, cq) + head * HC + df] = __float2bfloat16(a[o]);
            }
          }
        }
#pragma unroll
        for (int k = 0; k < 2 * HS; ++k) nq[k] += c == k ? nacc : 0.f;
      }
      __syncwarp();
      pc.mark(PA_DW);
      if (c + 1 < nqc && prod) {
        wg_wait<0>();
        reg_fence(nx);
      }
      pc.mark(PA_PWAIT);
      // chunk c's depthwise step is done with t and its taps (the slot takes
      // chunk gc + 2)
      __syncthreads();
      pc.mark(PA_DW);
      if (tid == ISSUER && gc + 2 < my_chunks) issue_w(gc + 2);
      if (c + 1 < nqc && prod) store_t(nx);
      if (kind == 1) {  // q_h and k_h are complete: head h's Gram
#pragma unroll
        for (int i = 0; i < GMAX; ++i) {
          const int f = warp + i * NGW;
          if (warp < NGW && f < NF && f / 9 == head) gram_frag(gacc[i], f % 9);
        }
        pc.mark(PA_GRAM);
      }
      if (c + 1 < nqc) __syncthreads();  // t of chunk c + 1 is complete, the Gram done with q | k
    }
    pc.tile();
  }
  // part[b][grp] = (Gram [hs][48][48], norms [2 Cq]) unpadded
  const int gout = hs * HC * HC;
  float* out = part + ((size_t)b * groups + grp) * (gout + 2 * cq);
#pragma unroll
  for (int i = 0; i < GMAX; ++i) {
    const int f = warp + i * NGW;
    if (warp >= NGW || f >= NF) continue;
    const int h = f / 9, m0 = f % 9 / 3 * 16, n0 = f % 3 * 16;
    float* at = out + (h * HC + m0 + gq) * HC + n0 + q2;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      st2(at + 8 * e, make_float2(gacc[i][e][0], gacc[i][e][1]));
      st2(at + 8 * HC + 8 * e, make_float2(gacc[i][e][2], gacc[i][e][3]));
    }
  }
  // the norms: LN1's buffer is free once every thread is past its last
  // product; each channel's column groups summed in order
  __syncthreads();
  float* nrm = (float*)(smem + L::S_LN);
  if (tid < NDW) {
#pragma unroll
    for (int k = 0; k < 2 * HS; ++k) nrm[((k & 1) * cq + (k >> 1) * HC + df) * NDP + dg] = nq[k];
  }
  __syncthreads();
  for (int i = tid; i < 2 * cq; i += NTW) {
    float sq = 0.f;
    for (int j = 0; j < NDP; ++j) sq += nrm[i * NDP + j];
    out[gout + i] = sq;
  }
  pc.mark(PA_REST);
  pc.flush(PHASE_BUF_WIDE(phase_buf_gram_wide));
}

// ---- (P) r = x + bf16(attn @ v) @ W_proj, in fp32 --------------------------

template <int C>
struct ProjWide {
  using G = WideGeo<C>;
  static constexpr int VP = G::PNOWN * 64 * 16;  // a plane of the tile's v or o (PTH x 32 rows)
  static constexpr int AT_B = HC * HC * 2;  // a head's attn^T as a B operand
  static constexpr int AT_LBO = (HC / 8) * 128;
  static constexpr int WP_B = HC * C * 2;   // W_proj's rows of a head (K = 48, N = C)
  static constexpr int WP_LBO = (C / 8) * 128;
  static constexpr int S_V = 0;
  static constexpr int S_O = S_V + G::NG * VP;
  static constexpr int S_AT = S_O + G::NG * VP;
  static constexpr int S_W = S_AT + G::H * AT_B;
  static constexpr int S_BARS = S_W + 2 * WP_B;
  static constexpr int TOTAL = S_BARS + 4 * 8;
  static_assert(TOTAL <= SMEM_LIMIT - 256, "kernel (P)'s tile must fit one SM");
  static_assert(S_W % 128 == 0 && WP_B % 128 == 0, "copy targets 128-byte aligned");
};

// One persistent block of NTW threads per SM walks the tiles of every sample
// (tile t = blockIdx.x + k gridDim.x): PTH x 32 pixels of the band's readable
// rows [rows_lo, rows_hi), halo rows included. Warpgroup w holds own operand
// w / NSPLIT's columns (w % NSPLIT) * 96 of r; the heads' attn @ v are
// shared out over the warpgroups. On a model shard v, attn^T and W_proj's
// rows are those of its hs = g.heads heads (Cq = 48 hs channels of v), and a
// null x leaves the partial alone in r.
template <int C, class Tin>
__global__ void __launch_bounds__(NTW, 1)
k_proj_wide(const Tin* __restrict__ x, float* __restrict__ r,
            const __grid_constant__ CUtensorMap vmap, const bf16* __restrict__ attn_t,
            const bf16* __restrict__ wproj_p, Geo g, int rows_lo, int rows_hi, int ntj1,
            int ntiles1) {
  using G = WideGeo<C>;
  using L = ProjWide<C>;
  constexpr int TH = G::PTH;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* bars = (uint64_t*)(smem + L::S_BARS);
  uint64_t* vbar = bars;      // v's box, once a tile
  uint64_t* wbar = bars + 1;  // [2] W_proj slots

  const int tid = threadIdx.x, wg = tid >> 7, wi = (tid >> 5) & 3, lane = tid & 31;
  const int gq = lane >> 2, q2 = (lane & 3) * 2;
  const int total = g.B * ntiles1, first = blockIdx.x, step = gridDim.x;
  const int my_tiles = first < total ? (total - first + step - 1) / step : 0;
  const int hs = g.heads, nv = g.Cq / 8;  // heads held, planes of v
  const int my_chunks = my_tiles * hs;
  PHASE_CLOCK(pc);

  auto origin = [&](int t, int& b, int& y0, int& x0) {
    const int tt = t % ntiles1;
    b = t / ntiles1;
    y0 = rows_lo + (tt / ntj1) * TH;
    x0 = (tt % ntj1) * XHW;
  };
  // the issuing thread: v's box of tile t, a plane of 8 channels a box
  auto issue_v = [&](int t) {
    int b, y0, x0;
    origin(t, b, y0, x0);
    mbar_expect_tx(vbar, nv * L::VP);
    for (int c = 0; c < nv; ++c)
      tma_load_5d(smem + L::S_V + c * L::VP, &vmap, vbar, 0, c, x0, y0 - rows_lo, b);
  };
  auto issue_w = [&](int gc) {
    const int s = gc & 1;
    mbar_expect_tx(wbar + s, L::WP_B);
    bulk_load(smem + L::S_W + s * L::WP_B, wproj_p + (size_t)(gc % hs) * (L::WP_B / 2), L::WP_B,
              wbar + s);
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == ISSUER && my_tiles > 0) {
    issue_v(first);
    for (int gc = 0; gc < 2 && gc < my_chunks; ++gc) issue_w(gc);
  }

  // this warpgroup's own operand and columns; this thread's two rows, at
  // tile pixels (i, j0) and (i, j0 + 8)
  const int om = wg / G::NSPLIT, n0 = (wg % G::NSPLIT) * NSUB;
  const int r0 = 16 * wi + gq, p0 = 64 * om + r0;
  const int i = p0 >> 5, j0 = p0 & 31;
  float acc[48];
  int prev_b = -1;
  for (int it = 0; it < my_tiles; ++it) {
    int b, y0, x0;
    origin(first + it * step, b, y0, x0);
    if (b != prev_b) {
      // attn^T of sample b as each head's B operand: B_h[k = d][n = c] =
      // attn_h[c][d] = attn_t[b][h][d][c]
      __syncthreads();  // every warpgroup is past the last sample's attn @ v
      const bf16* at = attn_t + (size_t)b * hs * HC * HC;
      bf16* as = (bf16*)(smem + L::S_AT);
      for (int e = tid; e < hs * HC * HC; e += NTW) {
        const int h = e / (HC * HC), k = e / HC % HC, n = e % HC;
        as[h * (L::AT_B / 2) + (k / 8) * (HC * 8) + (n / 8) * 64 + (n % 8) * 8 + k % 8] = at[e];
      }
      fence_proxy_async();
      __syncthreads();
      prev_b = b;
    }
    if (x != nullptr && it + 1 < my_tiles) {
      int nb, ny0, nx0;
      origin(first + (it + 1) * step, nb, ny0, nx0);
      prefetch_rows(x, g, nb, ny0 + 1, nx0 + 1, TH, XHW);
    }
    const int yy = y0 + i, xx0 = x0 + j0, xx1 = xx0 + 8;
    const bool ok0 = yy < rows_hi && xx0 < g.W, ok1 = yy < rows_hi && xx1 < g.W;
    // x (or zeros) into r's accumulator before the products are issued
    const bool has_x = x != nullptr;
    load_rows(acc, x + pix(g, b, ok0 ? yy : 0, ok0 ? xx0 : 0) + n0 + q2,
              x + pix(g, b, ok1 ? yy : 0, ok1 ? xx1 : 0) + n0 + q2, has_x && ok0, has_x && ok1);
    mbar_wait(vbar, it & 1);
    pc.mark(PP_WAIT);
    // o = bf16(v_h @ attn_h^T) of each (own operand, head), into o's planes
#pragma unroll 1
    for (int q = wg; q < G::PNOWN * hs; q += 4) {
      const int m = q / hs, h = q % hs;
      float o[24];
      wg_fence();
#pragma unroll
      for (int s = 0; s < HC / 16; ++s)
        wgmma_ss_n48(o, wg_desc(smem + L::S_V + (6 * h + 2 * s) * L::VP + m * 1024, L::VP, 128),
                     wg_desc(smem + L::S_AT + h * L::AT_B + 2 * s * L::AT_LBO, L::AT_LBO, 128),
                     s > 0);
      wg_commit();
      wg_wait<0>();
      reg_fence(o);
      unsigned char* ob = smem + L::S_O + 6 * h * L::VP + (64 * m + r0) * 16 + q2 * 2;
#pragma unroll
      for (int jj = 0; jj < 6; ++jj) {
        st2((bf16*)(ob + jj * L::VP), make_float2(o[4 * jj], o[4 * jj + 1]));
        st2((bf16*)(ob + jj * L::VP + 128), make_float2(o[4 * jj + 2], o[4 * jj + 3]));
      }
    }
    fence_proxy_async();
    __syncthreads();  // o is complete and v free: the next tile's v loads
    pc.mark(PP_ATTN);
    if (tid == ISSUER && it + 1 < my_tiles) issue_v(first + (it + 1) * step);
    // r += o @ W_proj, W_proj's rows streamed a head at a time
#pragma unroll 1
    for (int h = 0; h < hs; ++h) {
      const int gc = it * hs + h, s = gc & 1;
      mbar_wait(wbar + s, (gc >> 1) & 1);
      const unsigned char* wb = smem + L::S_W + s * L::WP_B + n0 * 16;
      wg_fence();
#pragma unroll
      for (int k = 0; k < HC / 16; ++k)
        wgmma_ss_n96(acc, wg_desc(smem + L::S_O + (6 * h + 2 * k) * L::VP + om * 1024, L::VP, 128),
                     wg_desc(wb + 2 * k * L::WP_LBO, L::WP_LBO, 128), 1);
      wg_commit();
      wg_wait<0>();
      reg_fence(acc);
      __syncthreads();  // every warpgroup is done with slot s
      if (tid == ISSUER && gc + 2 < my_chunks) issue_w(gc + 2);
    }
    pc.mark(PP_PROJ);
    float* pr0 = r + pix(g, b, ok0 ? yy : 0, ok0 ? xx0 : 0) + n0 + q2;
    float* pr1 = r + pix(g, b, ok1 ? yy : 0, ok1 ? xx1 : 0) + n0 + q2;
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      if (ok0) st2(pr0 + 8 * j, make_float2(acc[4 * j], acc[4 * j + 1]));
      if (ok1) st2(pr1 + 8 * j, make_float2(acc[4 * j + 2], acc[4 * j + 3]));
    }
    pc.mark(PP_STORE);
    pc.tile();
  }
  pc.flush(PHASE_BUF_WIDE(phase_buf_proj_wide));
}

// ---- (F) y = r + W_out(GELU(dw3x3(W_in LN2(r)))_1 * (...)_2) ----------------

template <int C>
struct FfnWide {
  using G = WideGeo<C>;
  static constexpr int LNP = G::ROWS * 16 + 16;  // a plane of LN2(r), padded
  static constexpr int WIN_B = C * 2 * FCH * 2;  // W_in chunk (N = 2 fc as [f][half], K = C)
  static constexpr int WIN_LBO = (2 * FCH / 8) * 128;
  static constexpr int TAPS_B = 18 * FCH * 4;    // its taps, [tap][f][half]
  static constexpr int WOUT_B = FCH * C * 2;     // W_out chunk (N = C, K = fc)
  static constexpr int WOUT_LBO = (C / 8) * 128;
  static constexpr int LT2 = 2 * FCH + 8;        // t2's row (bf16), padded
  static constexpr int GGP = G::OWN * 16 + 16;   // a plane of the gated chunk, padded
  static constexpr int GG_B = (4 * GGP + 127) / 128 * 128;
  static constexpr int S_LN = 0;
  static constexpr int S_WIN = (S_LN + G::NG * LNP + 127) / 128 * 128;
  static constexpr int S_TAPS = S_WIN + WIN_B;
  static constexpr int S_WOUT = S_TAPS + 2 * TAPS_B;
  static constexpr int S_T2 = S_WOUT + 2 * WOUT_B;
  static constexpr int S_GG = (S_T2 + G::ROWS * LT2 * 2 + 127) / 128 * 128;
  static constexpr int S_BARS = S_GG + 2 * GG_B;
  static constexpr int TOTAL = S_BARS + 4 * 8;
  static_assert(TOTAL <= SMEM_LIMIT - 256, "kernel (F)'s tile must fit one SM");
  static_assert(S_WIN % 128 == 0 && S_TAPS % 128 == 0 && S_WOUT % 128 == 0 && S_T2 % 128 == 0,
                "copy targets 128-byte aligned");
};

enum { FFN_LN = 1, FFN_RESIDUAL = 2 };  // (F)'s flags

// One persistent block of NTW threads per SM walks the tiles of every
// sample. Per tile: LN2(r) on the halo (ln_halo, r from device memory, zero
// where not readable; r itself without FFN_LN), y's accumulator seeded with
// r (zeros without FFN_RESIDUAL); then per hidden chunk: W_in on the halo by
// warpgroups w < NOP (operand w; its A from registers at C = 96), the
// depthwise step and GELU gate by every thread, and W_out onto y by the
// warpgroups w < NHOLD (own operand w / NSPLIT, columns (w % NSPLIT) * 96),
// issued and left running through the next chunk's depthwise step. In a
// stage r is (P)'s fp32 output; as the LN+GDFN kernel (GDFN true) r is its
// input x and `flags` are read; the stage's instance has them as constants.
template <int C, class Tin, class Tout, bool GDFN>
__global__ void __launch_bounds__(NTW, 1)
k_ffn_wide(const Tin* __restrict__ r, Tout* __restrict__ y, const float* __restrict__ ln2,
           const float* __restrict__ ln2b, const bf16* __restrict__ win_p,
           const float* __restrict__ wtaps_p, const bf16* __restrict__ wout_p, Geo g,
           float eps, int flags) {
  using G = WideGeo<C>;
  using L = FfnWide<C>;
  constexpr int TH = G::TH;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* t2 = (bf16*)(smem + L::S_T2);
  uint64_t* bars = (uint64_t*)(smem + L::S_BARS);
  uint64_t* woutbar = bars;      // [2] W_out slots
  uint64_t* winbar = bars + 2;   // the W_in chunk and its taps

  const int tid = threadIdx.x, wg = tid >> 7, wi = (tid >> 5) & 3, warp = tid >> 5;
  const int lane = tid & 31, gq = lane >> 2, q2 = (lane & 3) * 2;
  const int nch = g.Fp / FCH, total = g.B * g.ntiles;
  const int first = blockIdx.x, step = gridDim.x;
  const int my_tiles = first < total ? (total - first + step - 1) / step : 0;
  const int my_chunks = my_tiles * nch;
  const bool prod = wg < G::NOP, yown = G::NHOLD == 4 || wg < G::NHOLD;
  const bool norm = !GDFN || (flags & FFN_LN), residual = !GDFN || (flags & FFN_RESIDUAL);
  PHASE_CLOCK(pc);

  // (by the issuing thread) W_in chunk gc into its one slot, its taps into
  // slot gc & 1: the taps of chunk gc - 1 are still read after W_in's slot
  // is free
  auto issue_win = [&](int gc) {
    mbar_expect_tx(winbar, L::WIN_B + L::TAPS_B);
    bulk_load(smem + L::S_WIN, win_p + (size_t)(gc % nch) * (L::WIN_B / 2), L::WIN_B, winbar);
    bulk_load(smem + L::S_TAPS + (gc & 1) * L::TAPS_B,
              wtaps_p + (size_t)(gc % nch) * (L::TAPS_B / 4), L::TAPS_B, winbar);
  };
  auto issue_wout = [&](int gc) {
    const int s = gc & 1;
    mbar_expect_tx(woutbar + s, L::WOUT_B);
    bulk_load(smem + L::S_WOUT + s * L::WOUT_B, wout_p + (size_t)(gc % nch) * (L::WOUT_B / 2),
              L::WOUT_B, woutbar + s);
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == ISSUER)
    for (int gc = 0; gc < 2 && gc < my_chunks; ++gc) {
      if (gc == 0) issue_win(gc);
      issue_wout(gc);
    }

  // W_in's rows (operand wg) and t2's pixels of this thread
  const int r0 = 16 * wi + gq;
  int hy, hx0;
  halo_of<TH>(64 * wg + r0, hy, hx0);
  bf16* t2_0 = t2 + (hy * XHW + hx0) * L::LT2 + q2;
  bf16* t2_1 = t2_0 + 8 * L::LT2;
  // y's own operand and columns of this warpgroup, and this thread's rows
  const int om = wg / G::NSPLIT, n0 = (wg % G::NSPLIT) * NSUB;
  int yhy, yhx0;
  halo_of<TH>(64 * om + r0, yhy, yhx0);
  const int yhx1 = yhx0 + 8;

  // t2 = bf16(LN2(r) @ W_in[:, chunk gc]) on the halo, the two halves of
  // each hidden channel side by side
  auto w_in = [&](int gc) {
    pc.mark(PF_ISSUE);
    mbar_wait(winbar, gc & 1);
    pc.mark(PF_WAIT);
    if (!prod) return;
    const unsigned char* wb = smem + L::S_WIN;
    float tacc[32];
    wg_fence();
#pragma unroll
    for (int k = 0; k < C / 16; ++k)
      wgmma_ss_n64(tacc, wg_desc(smem + L::S_LN + wg * 1024 + 2 * k * L::LNP, L::LNP, 128),
                   wg_desc(wb + 2 * k * L::WIN_LBO, L::WIN_LBO, 128), k > 0);
    wg_commit();
    wg_wait<0>();
    reg_fence(tacc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      st2(t2_0 + 8 * j, make_float2(tacc[4 * j], tacc[4 * j + 1]));
      st2(t2_1 + 8 * j, make_float2(tacc[4 * j + 2], tacc[4 * j + 3]));
    }
  };
  float yacc[48];  // y = r + W_out(...) on this warpgroup's own rows and columns
  // yacc += gg(gc) @ W_out[chunk gc, n0..n0+95], issued and left running
  auto w_out = [&](int gc) {
    if (!yown) return;
    const int s = gc & 1;
    pc.mark(PF_ISSUE);
    mbar_wait(woutbar + s, (gc >> 1) & 1);
    pc.mark(PF_WAIT);
    const unsigned char* ga = smem + L::S_GG + (gc & 1) * L::GG_B + om * 1024;
    const unsigned char* wb = smem + L::S_WOUT + s * L::WOUT_B + n0 * 16;
    wg_fence();
#pragma unroll
    for (int k = 0; k < FCH / 16; ++k)
      wgmma_ss_n96(yacc, wg_desc(ga + 2 * k * L::GGP, L::GGP, 128),
                   wg_desc(wb + 2 * k * L::WOUT_LBO, L::WOUT_LBO, 128), 1);
    wg_commit();
  };
  // depthwise 3x3 (fp32 taps) and GELU gate of chunk gc: a thread takes one
  // hidden channel and two adjacent output columns down the tile's rows,
  // each value a float2 of the GELU half (.x) and the gate half (.y); gg
  // goes to W_out's operand layout, own row (i, column + 1)
  auto dw_gate = [&](int gc) {
    const float2* taps = (const float2*)(smem + L::S_TAPS + (gc & 1) * L::TAPS_B);
    bf16* gg = (bf16*)(smem + L::S_GG + (gc & 1) * L::GG_B);
    for (int idx = tid; idx < FCH * (XTW / 2); idx += NTW) {
      const int f = idx % FCH, j = idx / FCH * 2;
      bf16* gf = gg + (f / 8) * (L::GGP / 2) + f % 8;
      const bf16* tf = t2 + j * L::LT2 + 2 * f;
      float2 wk[9], u[3][4];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) wk[tap] = taps[tap * FCH + f];
#pragma unroll
      for (int row = 0; row < 2; ++row)
#pragma unroll
        for (int c = 0; c < 4; ++c) u[row][c] = ld2(tf + (row * XHW + c) * L::LT2);
#pragma unroll
      for (int i = 0; i < TH; ++i) {  // output row; halo row i + di lies in slot (i + di) % 3
#pragma unroll
        for (int c = 0; c < 4; ++c) u[(i + 2) % 3][c] = ld2(tf + ((i + 2) * XHW + c) * L::LT2);
        float2 a[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
#pragma unroll
        for (int dj = 0; dj < 3; ++dj)
#pragma unroll
          for (int di = 0; di < 3; ++di)
#pragma unroll
            for (int o = 0; o < 2; ++o) fma2(a[o], u[(i + di) % 3][o + dj], wk[di * 3 + dj]);
#pragma unroll
        for (int o = 0; o < 2; ++o)
          gf[(i * XHW + j + o + 1) * 8] = __float2bfloat16(gelu(a[o].x) * a[o].y);
      }
    }
  };

  for (int it = 0; it < my_tiles; ++it) {
    const int t = first + it * step, tt = t % g.ntiles, b = t / g.ntiles;
    const int y0 = (tt / g.ntj) * TH, x0 = (tt % g.ntj) * XTW;
    if (!GDFN && it + 1 < my_tiles) {
      const int nt = (t + step) % g.ntiles;
      prefetch_rows(r, g, (t + step) / g.ntiles, (nt / g.ntj) * TH, (nt % g.ntj) * XTW, TH + 2,
                    XHW);
    }
    // LN2(r) on the halo, zero where r is not readable
    ln_halo<C, TH, C == 96 ? 4 : 768 / C>(r, g, b, y0, x0, ln2, ln2b, eps, norm, smem + L::S_LN,
                                          L::LNP, warp, lane);
    // y's accumulator seeded with r (or zeros)
    const int yy = y0 - 1 + yhy, xx0 = x0 - 1 + yhx0, xx1 = x0 - 1 + yhx1;
    const bool rd0 = residual && readable(g, yy, xx0), rd1 = residual && readable(g, yy, xx1);
    if (yown)
      load_rows(yacc, r + pix(g, b, rd0 ? yy : 0, rd0 ? xx0 : 0) + n0 + q2,
                r + pix(g, b, rd1 ? yy : 0, rd1 ? xx1 : 0) + n0 + q2, rd0, rd1);
    fence_proxy_async();
    __syncthreads();  // LN2(r) is complete
    pc.mark(PF_LN2);
    const int gc0 = it * nch;
#pragma unroll 1
    for (int j = 0; j < nch; ++j) {
      const int gc = gc0 + j;
      w_in(gc);
      __syncthreads();  // t2 of chunk gc is complete, the W_in slot free
      pc.mark(PF_W_IN);
      if (tid == ISSUER && gc + 1 < my_chunks) issue_win(gc + 1);
      if (GDFN && j == 0 && it + 1 < my_tiles && warp == NWW - 1) {
        // the next tile's rows into L2 by lanes 1.. of the warp that takes
        // no depthwise work, off the LayerNorm's path
        const int nt = (t + step) % g.ntiles;
        prefetch_rows(r, g, (t + step) / g.ntiles, (nt / g.ntj) * TH, (nt % g.ntj) * XTW, TH + 2,
                      XHW, ISSUER + 1);
      }
      if (j > 0) w_out(gc - 1);
      dw_gate(gc);
      __syncwarp();
      pc.mark(PF_DW);
      wg_wait<0>();
      reg_fence(yacc);
      pc.mark(PF_PWAIT);
      fence_proxy_async();
      // gg of chunk gc is complete and t2 free; W_out of chunk gc - 1 is
      // done: its slot takes chunk gc + 1
      __syncthreads();
      pc.mark(PF_DW);
      if (tid == ISSUER && gc >= 1 && gc + 1 < my_chunks) issue_wout(gc + 1);
    }
    w_out(gc0 + nch - 1);
    wg_wait<0>();
    reg_fence(yacc);
    // y on the tile's own pixels: halo columns 1..30, inside the band
    const bool out0 = yown && yhx0 >= 1 && yhx0 <= XTW && inside(g, yy, xx0);
    const bool out1 = yown && yhx1 >= 1 && yhx1 <= XTW && inside(g, yy, xx1);
    Tout* py0 = y + pix(g, b, out0 ? yy : 0, out0 ? xx0 : 0) + n0 + q2;
    Tout* py1 = y + pix(g, b, out1 ? yy : 0, out1 ? xx1 : 0) + n0 + q2;
#pragma unroll
    for (int jj = 0; jj < 12; ++jj) {
      if (out0) st2(py0 + 8 * jj, make_float2(yacc[4 * jj], yacc[4 * jj + 1]));
      if (out1) st2(py1 + 8 * jj, make_float2(yacc[4 * jj + 2], yacc[4 * jj + 3]));
    }
    pc.mark(PF_STORE);
    pc.tile();
  }
  pc.flush(PHASE_BUF_WIDE(phase_buf_ffn_wide));
}

// ---- host -----------------------------------------------------------------

constexpr int ERR_TMAP = 100003;  // the driver refused v's tensor map

// v (B, Hs, W, Cq) bf16 as the 5-D view (8, Cq/8, W, rows, B), rows the
// readable ones [rows_lo, rows_hi) of the band; a box of one plane of 8
// channels, 32 columns and (P)'s PTH rows.
template <int C>
int v_map(CUtensorMap* map, const void* v, const Geo& g, int rows_lo, int rows_hi) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return ERR_TMAP;
  const size_t row = (size_t)g.W * g.Cq;
  const cuuint64_t dims[5] = {8, (cuuint64_t)(g.Cq / 8), (cuuint64_t)g.W,
                              (cuuint64_t)(rows_hi - rows_lo), (cuuint64_t)g.B};
  const cuuint64_t strides[4] = {16, (cuuint64_t)g.Cq * 2, (cuuint64_t)row * 2,
                                 (cuuint64_t)g.Hs * row * 2};
  const cuuint32_t box[5] = {8, 1, (cuuint32_t)XHW, (cuuint32_t)WideGeo<C>::PTH, 1};
  const cuuint32_t es[5] = {1, 1, 1, 1, 1};
  void* base = (void*)((const bf16*)v + (size_t)(rows_lo + g.halo) * row);
  const CUresult res = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, base, dims, strides, box, es,
                           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_TMAP;
}

int n_sms(int* n) {
  int dev = 0, err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

bool wide_width(int C) { return C == 96 || C == 192 || C == 384; }

// A whole band (halo 0 or 1) and the `heads` of 48 channels the kernels
// hold: all C / 48 of them, or a model shard's 1..C / 48 (Geo's heads, Cq).
bool wide_geo(Geo& g, int C, int B, int H, int W, int heads, int Fp, int tw, int halo, int y_img,
              int H_img) {
  if (!wide_width(C) || heads < 1 || heads * HC > C || B <= 0 || H <= 0 || W <= 0 || Fp < 0 ||
      Fp % FCH)
    return false;
  const int th = C == 96 ? WideGeo<96>::TH : C == 192 ? WideGeo<192>::TH : WideGeo<384>::TH;
  g = make_geo(B, H, W, C, C / HC, Fp, FCH, th, tw);
  g.heads = heads, g.Cq = heads * HC;
  return set_band(g, halo, y_img, H_img);
}

// f<96>(...), f<192>(...) or f<384>(...) by C (a width wide_geo took)
#define BY_WIDTH(C, f, ...) \
  ((C) == 96 ? f<96>(__VA_ARGS__) : (C) == 192 ? f<192>(__VA_ARGS__) : f<384>(__VA_ARGS__))

template <int C, class Tin, int HS>
int gram_launch(const void* x, const void* ln1, const void* ln1b, const void* wq_p,
                const void* qtaps_p, void* part, void* vout, const Geo& g, int groups, float eps,
                cudaStream_t s) {
  const int bytes = GramWide<C>::TOTAL;
  auto k = k_gram_wide<C, Tin, HS>;
  const int err = opt_in(k, bytes);
  if (err) return err;
  k<<<dim3(groups, g.B), NTW, bytes, s>>>((const Tin*)x, (const float*)ln1, (const float*)ln1b,
                                          (const bf16*)wq_p, (const float*)qtaps_p, (float*)part,
                                          (bf16*)vout, g, groups, eps);
  return (int)cudaGetLastError();
}

template <int C, int HS>
int gram_heads(const void* x, int x_is_bf16, const void* ln1, const void* ln1b, const void* wq_p,
               const void* qtaps_p, void* part, void* vout, const Geo& g, int groups, float eps,
               cudaStream_t s) {
  return x_is_bf16 ? gram_launch<C, bf16, HS>(x, ln1, ln1b, wq_p, qtaps_p, part, vout, g, groups,
                                              eps, s)
                   : gram_launch<C, float, HS>(x, ln1, ln1b, wq_p, qtaps_p, part, vout, g,
                                               groups, eps, s);
}

// (A) on every head (the whole image), or on a model shard's 1, 2 or 4
template <int C>
int gram_c(const void* x, int x_is_bf16, const void* ln1, const void* ln1b, const void* wq_p,
           const void* qtaps_p, void* part, void* vout, const Geo& g, int groups, float eps,
           cudaStream_t s) {
  constexpr int H = C / HC;
  switch (g.heads) {
    case 1: return gram_heads<C, 1>(x, x_is_bf16, ln1, ln1b, wq_p, qtaps_p, part, vout, g, groups,
                                    eps, s);
    case 2: return gram_heads<C, 2>(x, x_is_bf16, ln1, ln1b, wq_p, qtaps_p, part, vout, g, groups,
                                    eps, s);
    case 4: return gram_heads<C, H < 4 ? H : 4>(x, x_is_bf16, ln1, ln1b, wq_p, qtaps_p, part, vout,
                                                g, groups, eps, s);
    case 8: return gram_heads<C, H>(x, x_is_bf16, ln1, ln1b, wq_p, qtaps_p, part, vout, g, groups,
                                    eps, s);
  }
  return ERR_SHAPE;
}

template <int C>
int proj_c(const void* x, int x_is_bf16, void* r, const void* vin, const void* attn_t,
           const void* wproj_p, const Geo& g, int grid, cudaStream_t s) {
  constexpr int PTH = WideGeo<C>::PTH;
  const int rows_lo = -g.halo > -g.y_img ? -g.halo : -g.y_img;
  const int rows_hi = g.H + g.halo < g.H_img - g.y_img ? g.H + g.halo : g.H_img - g.y_img;
  const int ntj1 = (g.W + XHW - 1) / XHW;
  const int ntiles1 = (rows_hi - rows_lo + PTH - 1) / PTH * ntj1;
  CUtensorMap vm;
  int err = v_map<C>(&vm, vin, g, rows_lo, rows_hi);
  if (err) return err;
  if (grid <= 0 && (err = n_sms(&grid))) return err;
  if (grid > g.B * ntiles1) grid = g.B * ntiles1;
  const int bytes = ProjWide<C>::TOTAL;
  if (x_is_bf16) {
    auto k = k_proj_wide<C, bf16>;
    if ((err = opt_in(k, bytes))) return err;
    k<<<grid, NTW, bytes, s>>>((const bf16*)x, (float*)r, vm, (const bf16*)attn_t,
                               (const bf16*)wproj_p, g, rows_lo, rows_hi, ntj1, ntiles1);
  } else {
    auto k = k_proj_wide<C, float>;
    if ((err = opt_in(k, bytes))) return err;
    k<<<grid, NTW, bytes, s>>>((const float*)x, (float*)r, vm, (const bf16*)attn_t,
                               (const bf16*)wproj_p, g, rows_lo, rows_hi, ntj1, ntiles1);
  }
  return (int)cudaGetLastError();
}

template <int C, class Tin, class Tout, bool GDFN>
int ffn_launch(const void* r, void* y, const void* ln2, const void* ln2b, const void* win_p,
               const void* wtaps_p, const void* wout_p, const Geo& g, float eps, int flags,
               int grid, cudaStream_t s) {
  const int bytes = FfnWide<C>::TOTAL;
  auto k = k_ffn_wide<C, Tin, Tout, GDFN>;
  const int err = opt_in(k, bytes);
  if (err) return err;
  k<<<grid, NTW, bytes, s>>>((const Tin*)r, (Tout*)y, (const float*)ln2, (const float*)ln2b,
                             (const bf16*)win_p, (const float*)wtaps_p, (const bf16*)wout_p, g,
                             eps, flags);
  return (int)cudaGetLastError();
}

// (F) in a stage (r fp32, y fp32 or bf16), or as the LN+GDFN kernel (gdfn:
// x and y both fp32 or both bf16, `flags` read)
template <int C>
int ffn_c(const void* r, int r_is_bf16, void* y, int y_is_bf16, const void* ln2,
          const void* ln2b, const void* win_p, const void* wtaps_p, const void* wout_p,
          const Geo& g, float eps, int flags, bool gdfn, int grid, cudaStream_t s) {
  int err;
  if (grid <= 0 && (err = n_sms(&grid))) return err;
  if (grid > g.B * g.ntiles) grid = g.B * g.ntiles;
  if (!gdfn)
    return y_is_bf16 ? ffn_launch<C, float, bf16, false>(r, y, ln2, ln2b, win_p, wtaps_p, wout_p,
                                                         g, eps, flags, grid, s)
                     : ffn_launch<C, float, float, false>(r, y, ln2, ln2b, win_p, wtaps_p,
                                                          wout_p, g, eps, flags, grid, s);
  if (r_is_bf16 != y_is_bf16) return ERR_SHAPE;
  return r_is_bf16 ? ffn_launch<C, bf16, bf16, true>(r, y, ln2, ln2b, win_p, wtaps_p, wout_p, g,
                                                     eps, flags, grid, s)
                   : ffn_launch<C, float, float, true>(r, y, ln2, ln2b, win_p, wtaps_p, wout_p,
                                                       g, eps, flags, grid, s);
}

template <int C>
int blocks_c(int kind) {
  if (kind == 0) return resident_blocks(k_gram_wide<C, float, C / HC>, NTW, GramWide<C>::TOTAL);
  if (kind == 1) return resident_blocks(k_proj_wide<C, float>, NTW, ProjWide<C>::TOTAL);
  return resident_blocks(k_ffn_wide<C, float, float, false>, NTW, FfnWide<C>::TOTAL);
}

}  // namespace

// ---- C interface (ctypes); see stage.cu's for the conventions -------------

extern "C" {

// Thread blocks of kernel (A) (kind 0), (P) (1) or (F) (2) at C (96, 192 or
// 384) the device keeps resident on one SM (one, by design); 0 for another C.
int raie_stage_wide_blocks_per_sm(int kind, int C) {
  return wide_width(C) ? BY_WIDTH(C, blocks_c, kind) : 0;
}

// The tile at C: rows and columns of outputs of (A) and (F) ((P)'s tiles are
// th x 32 pixels, 8 x 32 at C = 96), (F)'s hidden channels a chunk, threads
// a block.
int raie_stage_wide_geometry(int C, int* th, int* tw, int* fc, int* threads) {
  if (!wide_width(C)) return ERR_SHAPE;
  *th = C == 96 ? WideGeo<96>::TH : C == 192 ? WideGeo<192>::TH : WideGeo<384>::TH;
  *tw = XTW, *fc = FCH, *threads = NTW;
  return 0;
}

const char* raie_stage_sm90_wide_error_string(int code) {
  if (code == ERR_TMAP) return "the driver refused the TMA descriptor of v";
  if (code == ERR_SHAPE)
    return "the wide kernels take C = 96, 192 or 384 with 1, 2, 4 or 8 (at most C/48) heads of "
           "48 channels, Fp a multiple of 32, x and y of one dtype for the LN+GDFN kernel, and "
           "a band inside its image with a halo of 0 (the whole image) or 1 row";
  return tile_error_string(code);
}

#ifdef RAIE_PHASE_CLOCKS
// Where kernels (A), (P) and (F) write their cycles per phase (null: nowhere).
int raie_stage_sm90_wide_phase_buffers(void* gram_rows, void* proj_rows, void* ffn_rows) {
  cudaError_t err = cudaMemcpyToSymbol(phase_buf_gram_wide, &gram_rows, sizeof(void*));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(phase_buf_proj_wide, &proj_rows, sizeof(void*));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(phase_buf_ffn_wide, &ffn_rows, sizeof(void*));
  return (int)err;
}
#endif

// Kernel (A): v (B, Hs, W, Cq) bf16 on the band's own pixels and part (B,
// groups, heads 48 48 + 2 Cq) fp32 from x (B, Hs, W, C), LN1's weight and
// bias (null: BiasFree), W_qkv (C, 3 Cq) and its taps packed in head chunks
// (ops/block.py::pack_wgmma); Cq = 48 heads: C / 48 heads, or a model
// shard's.
int raie_stage_wide_gram(const void* x, int x_is_bf16, const void* ln1, const void* ln1b,
                         const void* wq_p, const void* qtaps_p, void* part, void* vout, int B,
                         int H, int W, int C, int heads, int groups, int halo, int y_img,
                         int H_img, float eps, void* stream) {
  Geo g;
  if (groups <= 0 || !wide_geo(g, C, B, H, W, heads, 0, XTW, halo, y_img, H_img))
    return ERR_SHAPE;
  return BY_WIDTH(C, gram_c, x, x_is_bf16, ln1, ln1b, wq_p, qtaps_p, part, vout, g, groups, eps,
                  (cudaStream_t)stream);
}

// Kernel (P): r (B, Hs, W, C) fp32 = x + bf16(attn @ v) @ W_proj on every
// readable row the band holds (its halo rows too), from x (B, Hs, W, C; null:
// the product alone) and v (B, Hs, W, Cq), attn_t (B, heads, 48, 48) of
// kernel (B); W_proj (Cq, C) packed as a B operand; `grid` persistent blocks
// (0: one an SM).
int raie_stage_wide_project(const void* x, int x_is_bf16, void* r, const void* vin,
                            const void* attn_t, int heads, const void* wproj_p, int B, int H,
                            int W, int C, int halo, int y_img, int H_img, int grid,
                            void* stream) {
  Geo g;
  if (!wide_geo(g, C, B, H, W, heads, 0, XHW, halo, y_img, H_img)) return ERR_SHAPE;
  return BY_WIDTH(C, proj_c, x, x_is_bf16, r, vin, attn_t, wproj_p, g, grid,
                  (cudaStream_t)stream);
}

// Kernel (F): y (B, Hs, W, C) = r + GDFN(LN2(r)) on the band's own pixels,
// r from kernel (P); LN2's weight and bias (null: BiasFree); W_in, its taps
// and W_out packed in chunks of 32 hidden channels; `grid` as (P)'s.
int raie_stage_wide_ffn(const void* r, void* y, int y_is_bf16, const void* ln2, const void* ln2b,
                        const void* win_p, const void* wtaps_p, const void* wout_p, int B, int H,
                        int W, int C, int Fp, int halo, int y_img, int H_img, float eps, int grid,
                        void* stream) {
  Geo g;
  if (Fp <= 0 || !wide_geo(g, C, B, H, W, C / HC, Fp, XTW, halo, y_img, H_img)) return ERR_SHAPE;
  return BY_WIDTH(C, ffn_c, r, 0, y, y_is_bf16, ln2, ln2b, win_p, wtaps_p, wout_p, g, eps,
                  FFN_LN | FFN_RESIDUAL, false, grid, (cudaStream_t)stream);
}

// The LN+GDFN kernel (ops/gdfn.py): y (B, H, W, C) = [x +] W_out (gelu(t1) *
// t2), t = dwconv3x3(W_in LN(x)), on a whole image; x and y both fp32 or
// both bf16, LN's weight and bias (null: BiasFree; apply_ln
// 0: none), W_in, its taps and W_out packed as for (F) over Fp hidden
// channels (a multiple of 32: all of them, or a model shard's range),
// residual 0: the product alone; `grid` as (P)'s.
int raie_gdfn_sm90(const void* x, int x_is_bf16, void* y, int y_is_bf16, const void* ln_w,
                   const void* ln_b, int apply_ln, const void* win_p, const void* wtaps_p,
                   const void* wout_p, int B, int H, int W, int C, int Fp, int residual,
                   float eps, int grid, void* stream) {
  Geo g;
  if (Fp <= 0 || x_is_bf16 != y_is_bf16 || !wide_geo(g, C, B, H, W, C / HC, Fp, XTW, 0, 0, H))
    return ERR_SHAPE;
  const int flags = (apply_ln ? FFN_LN : 0) | (residual ? FFN_RESIDUAL : 0);
  return BY_WIDTH(C, ffn_c, x, x_is_bf16, y, y_is_bf16, ln_w, ln_b, win_p, wtaps_p, wout_p, g,
                  eps, flags, true, grid, (cudaStream_t)stream);
}

}  // extern "C"
