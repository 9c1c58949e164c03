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
// What holds the kernels back on this card is neither: a tile's products
// are a few thousand mma.sync in short phases that each end in a barrier,
// and measured phase by phase (the -DRAIE_PHASE_CLOCKS build) a tile spends
// its cycles waiting on ldmatrix -> mma chains, cp.async and barriers, with
// only the depthwise steps near an instruction-rate bound. So the design keeps two
// thread blocks of 256 threads resident on every SM at C = 96 (each under
// half of the SM's shared memory, 128 registers a thread), one block's waits
// filled by the other's work, and keeps in registers what would otherwise
// bounce through shared memory; tile_ops.cuh says how.
//
// Design. Everything that grows with the 2F = 510 hidden channels stays in
// shared memory, so device memory sees x, y, v (bf16) and a small
// per-sample Gram. The TPU kernel carried the Gram and the q/k norms across
// a sequential grid; blocks here run in no order, so one TransformerBlock
// is three launches, all deterministic (no atomics):
//   (A) k_gram, two blocks per SM each walking a group of 8x8 tiles (one
//       wave: groups * batch <= 2 * SMs): x on the tile's 1-pixel halo read
//       straight into accumulator fragments, LN1 from those registers (zero
//       on the ring outside the image, where torch zero-pads the qkv
//       depthwise input), then q, k and v a third at a time: the 1x1 product
//       on the halo against one third of W_qkv in shared memory, then the
//       dw3x3, while the next third loads. v goes to device memory; the
//       per-head Gram q^T k adds up over the group's tiles in mma
//       accumulator fragments that never leave the registers (up to 5 a
//       warp; a wider Gram accumulates in shared memory), the squared q/k
//       norms over the tile's true pixels in shared memory; both are written
//       once per group.
//   (B) k_softmax, per (sample, head, query channel): sum the groups,
//       divide by max(||q||, 1e-12) max(||k||, 1e-12), times the per-head
//       temperature, softmax within the head, store attn^T in bf16. Where
//       C/heads is not a multiple of 16, (A) and (C) run as one head over
//       the full C x C Gram and (B) takes the softmax within each true head,
//       leaving zeros between heads: attn is block-diagonal and attn @ v
//       stays one C x C product.
//   (C) k_apply, per 8x8 output tile, two blocks per SM: attn @ v and
//       W_proj + residual r on the 1-pixel halo with r in accumulator
//       fragments, LN2 from those registers (zero on the ring outside the
//       image, where torch zero-pads the GDFN depthwise input), then the
//       GDFN in chunks of 64 hidden channels (tile_ops.cuh::r_ln_tile and
//       gdfn_chunks, shared with gdfn.cu): W_in chunk, dw3x3 over the real
//       halo, GELU gate (the Abramowitz-Stegun erf of the TPU kernel), and
//       W_out accumulated onto r in registers. In a stage the tile is
//       written to the other of two float32 ping-pong buffers (the last
//       block writes the stage's dtype); the block loop runs in the wrapper.
//       attn^T, W_proj and the weight chunks are copied to shared memory
//       with cp.async, each chunk a phase ahead of its use.
// Row bands (ops/stage.py::fused_transformer_stage_bands): an image split by
// rows over devices runs the same three launches on each band, x, v and y
// held with one halo row above and one below the band's own rows (Geo). (A)
// counts only the band's own rows in its Gram and norms and writes v there;
// each band's partials, summed over its groups, are added across bands in
// band order on every band's device, and (B), unchanged, takes that one
// group, so that every band gets the same attn^T; (C) reads x and v on the
// halo rows its neighbours filled in. The zero ring stays at the image's
// own edges (readable()). A whole image is the one band with no halo, and
// runs the same arithmetic as before bands existed.
// Model shards (ops/stage.py::fused_transformer_stage_shards): a block split
// by heads over N shards, Megatron-style. (A) reads x of C channels and takes
// LN1 over all of them, but holds only the shard's columns of each W_qkv
// third, Cq = C heads_s / heads of them (Geo's Cq), and gives q, k, v, the
// Gram and the norms of the shard's heads alone; (B) runs unchanged on Cq
// channels; (C') (k_project) is (C) stopped after the W_proj product on the
// shard's Cq rows of W_proj: it writes r = x + partial (the shard that adds
// the residual; x null: the partial alone) in fp32, and the host adds the
// shards' partials. The GDFN half is then gdfn.cu's kernel on the shard's
// range of hidden channels, without the residual but on one shard. Where
// the shards do not divide the heads, every shard runs (A) and (B) whole
// (Cq = C) and (C') with the residual: r whole, no sum. Everything up to
// (C') is the same code as the whole image's, whose bits it keeps.
// The wide layout (C = 384: the latent of a 2048^2 frame on a model shard,
// or with heads of other than 48 channels): a C x C bf16
// weight is 301 KB, more than a thread block's 227 KB of shared memory, so
// (A) holds a third of W_qkv nq columns at a time (its product and depthwise
// step run per chunk, the next chunk loading during the depthwise step) and
// keeps up to MAXGW Gram fragments a warp in registers, one block an SM; (C)
// holds W_proj kp rows at a time, loaded between the product's k-steps
// (r_ln_tile). The host takes it only where no layout holds the weights
// whole (ops/block.py::plan_tiles), so every narrower width runs the
// layouts and bits it ran before.
// Products are bf16 mma.sync m16n8k16 on ldmatrix fragments with fp32
// accumulation (the Gram's A = q^T through a transposing ldmatrix), a k-step's
// fragments loaded before its mma run and, where registers allow, a step
// ahead; the
// qkv and W_in outputs round to bf16 before the depthwise step and the
// depthwise taps are fp32, as in the TPU kernel. LayerNorm uses the
// two-pass variance of ops/norm.py (the TPU kernel's is one-pass
// E[x^2] - mean^2), over the 4 lanes that hold a row's fragments. Depthwise
// steps slide a 3-row window down two tile columns in registers. Rows in
// shared memory are padded (PAD) so fragment loads are free of bank
// conflicts. Where a width does not fit twice on an SM (C > 96) the same
// code runs one block per SM; the host asks the occupancy calculator.
//
// Against the bound: ~15x at C = 96 (PERF.md, PR 4's phase clocks). The
// halo costs (10*10)/(8*8) on the qkv, attn@v, W_proj and W_in products
// (1.75x with the padding to 112 rows); the mma.sync chains are bound by
// latency; every phase ends in a barrier, so the depthwise steps never
// overlap a product; a third resident block needs under 76 KB and 85
// registers a thread; wgmma needs 64-row operand tiles that an 8x8 tile's
// 112 halo rows do not fill. So at C = 96, the width of every stage of a
// 512^2 teacher request, kernels (A) and (C) are stage_sm90.cu's Hopper
// redesign (6x30 tiles on an 8x32 halo of four full m64 operands, wgmma
// products overlapped with the depthwise steps, TMA and bulk copies under
// mbarriers, a persistent (C); see its note), chosen by width
// (ops/block.py::apply_route), and at C = 192 and 384 with 48 channels a
// head stage_sm90_wide.cu's. The kernels here serve every other width (48,
// and 192 or 384 with other heads: the wide layout at 384) and every model
// shard ((A) on a head range, (C')), with (B) for all.

#include <climits>

#include "tile_ops.cuh"

namespace {

constexpr int NT_SOFTMAX = 128;

// Phases of kernel (A) in the instrumented build (kernel (C)'s are in
// tile_ops.cuh); PH_G_REST is the set-up and the write of the partials.
enum { PH_G_LN1, PH_G_QKV, PH_G_DW, PH_G_GRAM, PH_G_REST };
#ifdef RAIE_PHASE_CLOCKS
__device__ long long* phase_buf_gram = nullptr;
__device__ long long* phase_buf_apply = nullptr;
#define PHASE_BUF(name) name
#else
#define PHASE_BUF(name) nullptr
#endif

// ---- shared-memory layout of kernel (A) (host and device agree through it)

// q, k and v go through the product and the depthwise step a third at a
// time, so one third of W_qkv (w) and of qkv on the halo (t) is held: all
// nq = Cq of its columns, or (the wide layout, where a C x Cq third does not
// fit beside the tile) nq columns at a time. The Gram accumulates in
// registers where a warp's share of its 16x16 fragments is at most MAXG
// (MAXGW in the wide layout) (`regs`), else in `gram` as fp32. x and LN1 have
// C channels, q, k and v Cq (Geo).
struct GramSmem {
  size_t xn, w, t, qk, nrm, taps, lnw, lnb, stat, gram, total;
  bool regs;
  __host__ __device__ GramSmem(int th, int tw, int C, int Cq, int heads, int nq) {
    const int m1 = round16((th + 2) * (tw + 2)), P = th * tw, hc = Cq / heads, LX = C + PAD;
    const int LW = nq + PAD;
    regs = heads * (hc / 16) * (hc / 16) <= (nq < Cq ? MAXGW : MAXG) * NWA;
    size_t o = 0;
    xn = o;    o += align128((size_t)m1 * LX * 2);             // LN1(x) on the halo
    w = o;     o += align128((size_t)C * LW * 2);              // W_q, W_k or W_v (nq columns)
    t = o;     o += align128((size_t)m1 * LW * 2);             // q, k or v before the dw3x3
    qk = o;    o += align128((size_t)P * (2 * Cq + PAD) * 2);  // q | k on the tile
    nrm = o;   o += align128((size_t)2 * Cq * tw * 4);         // [2Cq][tw]
    taps = o;  o += align128((size_t)9 * 3 * Cq * 4);          // dw_qkv
    lnw = o;   o += align128((size_t)C * 4);                   // LN1's weight
    lnb = o;   o += align128((size_t)C * 4);                   // and bias
    stat = o;  o += C > 16 * MAXF ? align128((size_t)2 * m1 * 4 * 4) : 0;
    gram = o;  o += regs ? 0 : align128((size_t)heads * hc * (hc + PADF) * 4);
    total = o;
  }
};

// ---- (A) q, k, v; Gram and squared norms over groups of tiles ------------

// One block of NTA threads walks a group of tiles, two blocks resident on an
// SM at C = 96. Per tile: x on the halo straight into accumulator fragments
// and LN1 from them (r_ln_tile), then for q, k and v in turn the 1x1 product
// on the halo and the dw3x3 on the tile, the next third of W_qkv loading
// while the depthwise step runs; the Gram product of the tile shares v's
// product phase. Seven barriers a tile. In the wide layout (nq < C, G =
// MAXGW Gram fragments a warp, one block an SM) each third goes nq columns
// at a time through the same product and depthwise step, the next columns
// loading during the depthwise step; two barriers a chunk.
template <class T, int G>
__global__ void __launch_bounds__(NTA, G > MAXG ? 1 : 2)
k_gram(const T* __restrict__ x, const float* __restrict__ ln1,
       const float* __restrict__ ln1b, const bf16* __restrict__ wqkv,
       const float* __restrict__ dwqkv, float* __restrict__ part, bf16* __restrict__ vout, Geo g,
       int groups, int nq_wide, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool wide = G > MAXG;
  const int nq = wide ? nq_wide : g.Cq;  // the narrow instance holds whole thirds
  const GramSmem L(g.th, g.tw, g.C, g.Cq, g.heads, nq);
  bf16* xn = (bf16*)(smem + L.xn);
  bf16* wb = (bf16*)(smem + L.w);
  bf16* t = (bf16*)(smem + L.t);
  bf16* qk = (bf16*)(smem + L.qk);
  float* gram = (float*)(smem + L.gram);
  float* nrm = (float*)(smem + L.nrm);
  float* taps = (float*)(smem + L.taps);
  FfnBufs s;  // what r_ln_tile uses of it
  s.rn = xn;
  s.seed = nullptr;
  s.lnw = (float*)(smem + L.lnw);
  s.lnb = (float*)(smem + L.lnb);
  s.stat = (float*)(smem + L.stat);

  const int b = blockIdx.y, grp = blockIdx.x, warp = threadIdx.x >> 5;
  // C: x's channels (LN1, the product's depth); Cq: q's, k's and v's
  const int C = g.C, Cq = g.Cq, C2 = 2 * Cq, C3 = 3 * Cq, hc = g.hc, th = g.th, tw = g.tw;
  const int LX = C + PAD, LQ = C2 + PAD, LG = hc + PADF, LW = nq + PAD;
  const int w1 = tw + 2, m1 = round16((th + 2) * w1), P = th * tw;
  const int nh = hc / 16, per_head = nh * nh, nfrags = g.heads * per_head;
  PHASE_CLOCK(pc);
  if (!L.regs)
    for (int i = threadIdx.x; i < g.heads * hc * LG; i += NTA) gram[i] = 0.f;
  for (int i = threadIdx.x; i < C2 * tw; i += NTA) nrm[i] = 0.f;
  for (int i = threadIdx.x; i < 9 * C3; i += NTA) taps[i] = dwqkv[i];
  for (int i = threadIdx.x; i < C; i += NTA) {
    s.lnw[i] = ln1[i];
    if (ln1b != nullptr) s.lnb[i] = ln1b[i];
  }
  // this warp's 16x16 fragments of the per-head Gram, f = warp, warp + NWA,
  // ..., as mma accumulators (columns 0-7 and 8-15)
  const int lane = threadIdx.x & 31, gq = lane >> 2, q2 = (lane & 3) * 2;
  float gacc[G][2][4];
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) gacc[i][0][e] = gacc[i][1][e] = 0.f;
  // acc += q^T k of fragment f over the tile: Gram[h][c][d] += sum_p
  // q[p][c] k[p][d]. A = q^T is q | k's rows read down a column: a
  // transposing ldmatrix whose lanes point at pixel (lane % 8) + 8 (lane /
  // 16) and channel half (lane / 8) % 2; B = k is read as every other B.
  auto gram_frag = [&](float (&acc)[2][4], int f) {
    const int h = f / per_head, m0 = (f % per_head) / nh * 16, n0 = (f % nh) * 16;
    const bf16* qa = qk + ((lane & 7) + (lane >> 4) * 8) * LQ + h * hc + m0 + ((lane >> 3) & 1) * 8;
    const bf16* kb = qk + (lane & 15) * LQ + Cq + h * hc + n0 + (lane >> 4) * 8;
    for (int k = 0; k < P; k += 16) {
      unsigned af[4], bf[4];
      ldsm_x4_t(af, qa + k * LQ);
      ldsm_x4_t(bf, kb + k * LQ);
      frag_mma(acc[0], acc[1], af, bf);
    }
  };
  // where fragment f's accumulator rows gq and gq + 8 begin in a row-major
  // Gram of row stride ld
  auto frag_at = [&](float* base, int ld, int f) {
    return base + ((f / per_head) * hc + (f % per_head) / nh * 16 + gq) * ld + (f % nh) * 16 + q2;
  };
  // columns [n0, n0 + nq) of third s3 of W_qkv (q, k or v) into wb
  auto load_w = [&](int s3, int n0) {
    const bf16* src = wqkv + s3 * Cq + n0;
    load_b_async(wb, C, nq, [=](int k, int n) { return src + (size_t)k * C3 + n; });
  };
  // t = bf16(LN1(x) @ those columns) on the 1-pixel halo
  auto qkv_product = [&] {
    gemm(m1, nq, C, nq / 16, [&](int m, int, int k) { return xn + m * LX + k; }, LX,
         [&](int k, int n) { return wb + k * LW + n; }, t, LW);
  };
  // the tile's Gram product, q and k being complete
  auto gram_product = [&] {
    if (L.regs) {
#pragma unroll
      for (int i = 0; i < G; ++i)
        if (warp + i * NWA < nfrags) gram_frag(gacc[i], warp + i * NWA);
    } else {
      for (int f = warp; f < nfrags; f += NWA) {
        float* at = frag_at(gram, LG, f);
        float acc[2][4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float2 lo = ld2(at + 8 * e), hi = ld2(at + 8 * LG + 8 * e);
          acc[e][0] = lo.x, acc[e][1] = lo.y, acc[e][2] = hi.x, acc[e][3] = hi.y;
        }
        gram_frag(acc, f);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          st2(at + 8 * e, make_float2(acc[e][0], acc[e][1]));
          st2(at + 8 * LG + 8 * e, make_float2(acc[e][2], acc[e][3]));
        }
      }
    }
  };
  // depthwise 3x3 (fp32 taps) of channels [c0, c0 + nch) of third s3, t
  // holding them: a thread takes two channels and two adjacent columns of
  // the tile down all its rows, its taps and three halo rows by four halo
  // columns in registers, the rows' slots rotating by index. A thread meets
  // the same (channels, columns) in every tile, so the q/k squared norms sum
  // without atomics, in a fixed order; v goes to device memory (bf16) for
  // (C).
  auto dw_step = [&](int s3, int c0, int nch, int y0, int x0) {
    const int Ch = nch / 2;
    for (int idx = threadIdx.x; idx < Ch * (tw / 2); idx += NTA) {
      const int ch = idx % Ch * 2, j = idx / Ch * 2, cq = s3 * Cq + c0 + ch;
      auto at = [&](int row, int col) { return ld2(t + (row * w1 + col) * LW + ch); };
      float2 wk[9], u[3][4];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        wk[tap] = *reinterpret_cast<const float2*>(taps + tap * C3 + cq);
#pragma unroll
      for (int row = 0; row < 2; ++row)
#pragma unroll
        for (int c = 0; c < 4; ++c) u[row][c] = at(row, j + c);
      float2 nacc[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
      for (int i0 = 0; i0 < th; i0 += 3) {
#pragma unroll
        for (int sl = 0; sl < 3; ++sl) {
          const int i = i0 + sl;  // output row; halo row i + di lies in slot (sl + di) % 3
          if (i >= th) break;
#pragma unroll
          for (int c = 0; c < 4; ++c) u[(sl + 2) % 3][c] = at(i + 2, j + c);
          float2 a[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
#pragma unroll
          for (int dj = 0; dj < 3; ++dj)
#pragma unroll
            for (int di = 0; di < 3; ++di)
#pragma unroll
              for (int o = 0; o < 2; ++o) fma2(a[o], u[(sl + di) % 3][o + dj], wk[di * 3 + dj]);
#pragma unroll
          for (int o = 0; o < 2; ++o) {
            const int yy = y0 + i, xx = x0 + j + o;
            const bool in = inside(g, yy, xx);
            if (s3 < 2) {
              if (!in) a[o] = make_float2(0.f, 0.f);
              st2(qk + (i * tw + j + o) * LQ + cq, a[o]);
              nacc[o].x += a[o].x * a[o].x;
              nacc[o].y += a[o].y * a[o].y;
            } else if (in) {
              st2(vout + pix(g, b, yy, xx, Cq) + c0 + ch, a[o]);
            }
          }
        }
      }
      if (s3 < 2) {
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          nrm[cq * tw + j + o] += nacc[o].x;
          nrm[(cq + 1) * tw + j + o] += nacc[o].y;
        }
      }
    }
  };
  load_w(0, 0);

  for (int tile = grp; tile < g.ntiles; tile += groups) {
    const int y0 = (tile / g.ntj) * th, x0 = (tile % g.ntj) * tw;
    pc.mark(tile == grp ? PH_G_REST : PH_G_DW);
    // LN1 on the 1-pixel halo, zero outside the image (x is 0 there, but
    // with a bias LN1(0) is not, and the depthwise step must see 0). Its
    // barrier follows the last tile's depthwise step (t is free) and waits
    // for W_q.
    r_ln_tile<false, false>(s, x, AttnIn{}, g, b, y0, x0, eps, true, ln1b != nullptr, [] {}, pc);
    __syncthreads();  // LN1(x) is complete
    pc.mark(PH_G_LN1);
    if constexpr (!wide) {
      for (int s3 = 0; s3 < 3; ++s3) {
        qkv_product();
        if (s3 == 2) {
          pc.mark(PH_G_QKV);
          // q and k of this tile are complete (the barrier after k's
          // depthwise step): the tile's Gram product shares v's product phase
          gram_product();
        }
        // t is complete and wb free (after v's product: LN1(x) and q | k
        // too, for the next tile)
        __syncthreads();
        pc.mark(s3 == 2 ? PH_G_GRAM : PH_G_QKV);
        if (s3 < 2) load_w(s3 + 1, 0);
        else if (tile + groups < g.ntiles) load_w(0, 0);  // W_q for the next tile
        dw_step(s3, 0, Cq, y0, x0);
        if (s3 < 2) {
          // this third of q | k is complete, t is free, the next third of
          // W_qkv has landed
          cp_async_wait();
          __syncthreads();
          pc.mark(PH_G_DW);
        }
      }
    } else {
      // the wide layout: nq columns of a third at a time
      const int nck = Cq / nq;
      for (int ci = 0; ci < 3 * nck; ++ci) {
        const int s3 = ci / nck, c0 = ci % nck * nq;
        // these columns of W_qkv have landed; the last depthwise step is
        // done with t (and q | k complete for the Gram)
        cp_async_wait();
        __syncthreads();
        pc.mark(PH_G_DW);
        qkv_product();
        if (ci == 2 * nck) gram_product();
        // t is complete and wb free
        __syncthreads();
        pc.mark(PH_G_QKV);
        if (ci + 1 < 3 * nck) load_w((ci + 1) / nck, (ci + 1) % nck * nq);
        else if (tile + groups < g.ntiles) load_w(0, 0);  // for the next tile
        dw_step(s3, c0, nq, y0, x0);
      }
    }
    pc.tile();
  }
  __syncthreads();  // the last tile's norms (and Gram) are complete
  pc.mark(PH_G_DW);
  // part[b][grp] = (Gram [heads][hc][hc], norms [2C]) unpadded
  const int gout = g.heads * hc * hc;
  float* out = part + ((size_t)b * groups + grp) * (gout + C2);
  if (L.regs) {
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int f = warp + i * NWA;
      if (f >= nfrags) continue;
      float* at = frag_at(out, hc, f);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        st2(at + 8 * e, make_float2(gacc[i][e][0], gacc[i][e][1]));
        st2(at + 8 * hc + 8 * e, make_float2(gacc[i][e][2], gacc[i][e][3]));
      }
    }
  } else {
    for (int i = threadIdx.x; i < gout; i += NTA) out[i] = gram[(i / hc) * LG + i % hc];
  }
  for (int i = threadIdx.x; i < C2; i += NTA) {
    float sq = 0.f;
    for (int j = 0; j < tw; ++j) sq += nrm[i * tw + j];
    out[gout + i] = sq;
  }
  pc.mark(PH_G_REST);
  pc.flush(PHASE_BUF(phase_buf_gram));
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

// One block of NTA threads per output tile, two resident on an SM where the
// layout allows (C = 96).
template <int FC, class Tin, class Tout>
__global__ void __launch_bounds__(NTA, 2)
k_apply(const Tin* __restrict__ x, Tout* __restrict__ y, const bf16* __restrict__ vin,
        const bf16* __restrict__ attn_t, const bf16* __restrict__ wproj,
        const float* __restrict__ ln2, const float* __restrict__ ln2b, FfnWeights wt, Geo g,
        float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FfnSmem L(g.th, g.tw, g.C, g.hc, g.fc, true, g.kp);
  const FfnBufs s(smem, L);
  bf16* at_s = (bf16*)(smem + L.w);
  bf16* wp_s = (bf16*)(smem + L.wproj);
  bf16* v = (bf16*)(smem + L.x);

  PHASE_CLOCK(pc);
  const int b = blockIdx.y, tile = blockIdx.x;
  const int y0 = (tile / g.ntj) * g.th, x0 = (tile % g.ntj) * g.tw;
  const int C = g.C, hc = g.hc;
  const int m1 = round16((g.th + 2) * (g.tw + 2));

  // attn^T of every head side by side: at_s[d][h*hc + c] = attn[h][c][d];
  // W_proj; v on the 1-pixel halo (0 outside the image)
  const bf16* at = attn_t + (size_t)b * g.heads * hc * hc;
  load_b_async(at_s, hc, C, [&](int k, int n) {
    return at + (size_t)(n / hc) * hc * hc + k * hc + n % hc;
  });
  if (g.kp == C)  // else r_ln_tile loads it kp rows at a time
    load_b_async(wp_s, C, C, [&](int k, int n) { return wproj + (size_t)k * C + n; });
  copy_async(s.lnw, ln2, C * 4);
  if (ln2b != nullptr) copy_async(s.lnb, ln2b, C * 4);
  load_halo_async(vin, v, C + PAD, g, b, y0, x0, m1, C);
  cp_async_wait();
  __syncthreads();  // attn^T, W_proj, v and the LayerNorm's weights are visible
  pc.mark(PH_LOAD);
  // r = x + (attn @ v) @ W_proj and LN2(r), r in registers; W_in's first
  // chunk loads over attn^T and W_proj once the products are done
  const AttnIn a{v, at_s, wp_s, s.rn, wproj, nullptr};
  r_ln_tile<true, true>(s, x, a, g, b, y0, x0, eps, true, ln2b != nullptr,
                  [&] { ffn_load_chunk<FC>(s, wt, g, 0, 0); }, pc);
  gdfn_chunks<FC>(s, y, wt, g, b, y0, x0, pc);
  pc.flush(PHASE_BUF(phase_buf_apply));
}

// ---- (C') a model shard's attention apply and projection, then stop ------

// (C) up to r: attn @ v of the shard's Cq channels (its heads) and its Cq
// rows of W_proj, on the 1-pixel halo as (C) computes them, r = x + that
// (x null: the product alone) written in fp32 on the tile's own pixels. The
// shared-memory layout is (C)'s with the smallest hidden chunk (unused).
constexpr int PROJ_FC = 32;

template <class Tin>
__global__ void __launch_bounds__(NTA, 2)
k_project(const Tin* __restrict__ x, float* __restrict__ r, const bf16* __restrict__ vin,
          const bf16* __restrict__ attn_t, const bf16* __restrict__ wproj, Geo g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FfnSmem L(g.th, g.tw, g.C, g.hc, PROJ_FC, true, g.kp, g.Cq);
  const FfnBufs s(smem, L);
  bf16* at_s = (bf16*)(smem + L.w);
  bf16* wp_s = (bf16*)(smem + L.wproj);
  bf16* v = (bf16*)(smem + L.x);

  PHASE_CLOCK(pc);
  const int b = blockIdx.y, tile = blockIdx.x;
  const int y0 = (tile / g.ntj) * g.th, x0 = (tile % g.ntj) * g.tw;
  const int C = g.C, Cq = g.Cq, hc = g.hc;
  const int m1 = round16((g.th + 2) * (g.tw + 2));
  const bf16* at = attn_t + (size_t)b * g.heads * hc * hc;
  load_b_async(at_s, hc, Cq, [&](int k, int n) {
    return at + (size_t)(n / hc) * hc * hc + k * hc + n % hc;
  });
  if (g.kp == Cq)
    load_b_async(wp_s, Cq, C, [&](int k, int n) { return wproj + (size_t)k * C + n; });
  load_halo_async(vin, v, Cq + PAD, g, b, y0, x0, m1, Cq);
  cp_async_wait();
  __syncthreads();  // attn^T, W_proj and v are visible
  const AttnIn a{v, at_s, wp_s, s.rn, wproj, r};
  r_ln_tile<true, false, true>(s, x, a, g, b, y0, x0, 0.f, false, false, [] {}, pc);
}

// C/heads a multiple of 16 on top of what the tile kernels need: (A) with
// kind 0, (C) with kind 1, (C') with kind 2; and `chunk` (nq of (A), kp of
// (C) and (C')) Cq or a multiple of 16 dividing Cq, the heads' channels
// (C, or a model shard's: a multiple of 16 up to C).
bool shape_ok(int kind, int C, int Cq, int heads, int Fp, int fc, int th, int tw, int chunk) {
  // (C) runs whole blocks only; (A) and (C') a shard's heads too
  const bool tiles = kind == 1 ? Cq == C && ffn_shape_ok(C, Fp, fc, th, tw)
                               : tile_shape_ok(C, th, tw);
  return heads > 0 && Cq % heads == 0 && (Cq / heads) % 16 == 0 && Cq <= C && chunk >= 16 &&
         chunk % 16 == 0 && Cq % chunk == 0 && tiles;
}

// Kernel (A)'s instance: the wide layout's where a third goes in chunks.
template <class T>
decltype(&k_gram<T, MAXG>) gram_kernel(int Cq, int nq) {
  return nq < Cq ? k_gram<T, MAXGW> : k_gram<T, MAXG>;
}

size_t project_bytes(int th, int tw, int C, int Cq, int heads, int kp) {
  return FfnSmem(th, tw, C, Cq / heads, PROJ_FC, true, kp, Cq).total;
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
  cudaStream_t stream;
};

template <int FC, class Tin, class Tout>
int launch_apply_fc(const ApplyArgs& a) {
  int err = opt_in(k_apply<FC, Tin, Tout>, a.bytes);
  if (err) return err;
  k_apply<FC, Tin, Tout><<<dim3(a.g.ntiles, a.g.B), NTA, a.bytes, a.stream>>>(
      (const Tin*)a.x, (Tout*)a.y, a.vin, a.attn_t, a.wproj, a.ln2, a.ln2b, a.wt, a.g, a.eps);
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
// selects the BiasFree variant. (halo, y_img, H_img) place H own rows as
// Geo says: (0, 0, H) for a whole image, halo 1 for a band. `chunk` is (A)'s
// columns of a W_qkv third held at once (nq) or (C)'s and (C')'s rows of
// W_proj (kp): 0 for all Cq, the layout of every width up to 192; a chunk
// where Cq x C does not fit beside the tile (C = 384). `Cq` is the channels
// of q, k and v (0: C): a model shard's heads'; (A) then takes the shard's
// W_qkv (C, 3 Cq) and dw_qkv (9, 3 Cq), writes v (B, Hs, W, Cq) and partials
// of 2 Cq norms, (B) is called with Cq as its C, and (C') takes W_proj's
// rows (Cq, C). -------------------------------------------------------------

extern "C" {

// Dynamic shared memory of kernel (A) (kind 0), (C) (kind 1) or (C') (kind
// 2, fc unused) on th x tw tiles, q, k and v of Cq channels; INT_MAX for a
// shape the kernel does not take.
int raie_stage_shard_smem_bytes(int kind, int th, int tw, int C, int Cq, int heads, int fc,
                                int chunk) {
  if (Cq == 0) Cq = C;
  if (chunk == 0) chunk = Cq;
  if (!shape_ok(kind, C, Cq, heads, fc, fc, th, tw, chunk)) return INT_MAX;
  if (kind == 2) return (int)project_bytes(th, tw, C, Cq, heads, chunk);
  return kind == 0 ? (int)GramSmem(th, tw, C, Cq, heads, chunk).total
                   : (int)FfnSmem(th, tw, C, C / heads, fc, true, chunk).total;
}

// Thread blocks of that kernel the device keeps resident on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), with the layout a launch
// would take; 0 where it cannot launch.
int raie_stage_shard_blocks_per_sm(int kind, int th, int tw, int C, int Cq, int heads, int fc,
                                   int chunk) {
  if (Cq == 0) Cq = C;
  if (chunk == 0) chunk = Cq;
  if (!shape_ok(kind, C, Cq, heads, fc, fc, th, tw, chunk)) return 0;
  if (kind == 0)
    return resident_blocks(gram_kernel<float>(Cq, chunk), NTA,
                           GramSmem(th, tw, C, Cq, heads, chunk).total);
  if (kind == 2)
    return resident_blocks(k_project<float>, NTA, project_bytes(th, tw, C, Cq, heads, chunk));
  const size_t bytes = FfnSmem(th, tw, C, C / heads, fc, true, chunk).total;
  return fc == 64 ? resident_blocks(k_apply<64, float, float>, NTA, bytes)
                  : resident_blocks(k_apply<32, float, float>, NTA, bytes);
}

// The same for a whole block (q, k and v of C channels).
int raie_stage_smem_bytes(int kind, int th, int tw, int C, int heads, int fc, int chunk) {
  return raie_stage_shard_smem_bytes(kind, th, tw, C, C, heads, fc, chunk);
}

int raie_stage_blocks_per_sm(int kind, int th, int tw, int C, int heads, int fc, int chunk) {
  return raie_stage_shard_blocks_per_sm(kind, th, tw, C, C, heads, fc, chunk);
}

const char* raie_stage_error_string(int code) { return tile_error_string(code); }

#ifdef RAIE_PHASE_CLOCKS
// Where kernels (A) and (C) write their cycles per phase: one row of
// PHASE_SLOTS int64 for each thread block of a launch (null: nowhere).
int raie_stage_phase_buffers(void* gram_rows, void* apply_rows) {
  cudaError_t err = cudaMemcpyToSymbol(phase_buf_gram, &gram_rows, sizeof(void*));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(phase_buf_apply, &apply_rows, sizeof(void*));
  return (int)err;
}
#endif

int raie_stage_gram(const void* x, int x_is_bf16, const void* ln1, const void* ln1b,
                    const void* wqkv, const void* dwqkv, void* part, void* vout, int B, int H,
                    int W, int C, int Cq, int heads, int th, int tw, int groups, int chunk,
                    int halo, int y_img, int H_img, float eps, void* stream) {
  if (Cq == 0) Cq = C;
  const int nq = chunk == 0 ? Cq : chunk;
  if (!shape_ok(0, C, Cq, heads, 0, 0, th, tw, nq)) return ERR_SHAPE;
  Geo g = make_geo(B, H, W, C, heads, 0, 0, th, tw);
  if (!set_band(g, halo, y_img, H_img)) return ERR_SHAPE;
  g.Cq = Cq;
  g.hc = Cq / heads;
  const size_t bytes = GramSmem(th, tw, C, Cq, heads, nq).total;
  const dim3 grid(groups, B);
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  if (x_is_bf16) {
    auto k = gram_kernel<bf16>(Cq, nq);
    if ((err = opt_in(k, bytes))) return err;
    k<<<grid, NTA, bytes, s>>>((const bf16*)x, (const float*)ln1, (const float*)ln1b,
                               (const bf16*)wqkv, (const float*)dwqkv, (float*)part,
                               (bf16*)vout, g, groups, nq, eps);
  } else {
    auto k = gram_kernel<float>(Cq, nq);
    if ((err = opt_in(k, bytes))) return err;
    k<<<grid, NTA, bytes, s>>>((const float*)x, (const float*)ln1, (const float*)ln1b,
                               (const bf16*)wqkv, (const float*)dwqkv, (float*)part,
                               (bf16*)vout, g, groups, nq, eps);
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
                     int chunk, int halo, int y_img, int H_img, float eps, void* stream) {
  const int kp = chunk == 0 ? C : chunk;
  if (!shape_ok(1, C, C, heads, Fp, fc, th, tw, kp)) return ERR_SHAPE;
  Geo g = make_geo(B, H, W, C, heads, Fp, fc, th, tw);
  if (!set_band(g, halo, y_img, H_img)) return ERR_SHAPE;
  g.kp = kp;
  const ApplyArgs a{x, y, (const bf16*)vin, (const bf16*)attn_t, (const bf16*)wproj,
                    (const float*)ln2, (const float*)ln2b,
                    FfnWeights{(const bf16*)win, (const float*)wdw, (const bf16*)wout}, g, eps,
                    FfnSmem(th, tw, C, g.hc, fc, true, kp).total, (cudaStream_t)stream};
  if (x_is_bf16) return y_is_bf16 ? launch_apply<bf16, bf16>(a) : launch_apply<bf16, float>(a);
  return y_is_bf16 ? launch_apply<float, bf16>(a) : launch_apply<float, float>(a);
}

// (C'): r (B, Hs, W, C) fp32 = x + (attn @ v) @ W_proj on a model shard (x
// null: without x), v (B, Hs, W, Cq), attn_t (B, heads, hc, hc), W_proj
// (Cq, C); th x tw tiles and kp = chunk as (C)'s layout query gave them.
int raie_stage_project(const void* x, int x_is_bf16, void* r, const void* vin,
                       const void* attn_t, const void* wproj, int B, int H, int W, int C, int Cq,
                       int heads, int th, int tw, int chunk, int halo, int y_img, int H_img,
                       void* stream) {
  if (Cq == 0) Cq = C;
  const int kp = chunk == 0 ? Cq : chunk;
  if (!shape_ok(2, C, Cq, heads, 0, 0, th, tw, kp)) return ERR_SHAPE;
  Geo g = make_geo(B, H, W, C, heads, 0, 0, th, tw);
  if (!set_band(g, halo, y_img, H_img)) return ERR_SHAPE;
  g.Cq = Cq;
  g.hc = Cq / heads;
  g.kp = kp;
  const size_t bytes = project_bytes(th, tw, C, Cq, heads, kp);
  const dim3 grid(g.ntiles, B);
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  if (x_is_bf16) {
    if ((err = opt_in(k_project<bf16>, bytes))) return err;
    k_project<bf16><<<grid, NTA, bytes, s>>>((const bf16*)x, (float*)r, (const bf16*)vin,
                                             (const bf16*)attn_t, (const bf16*)wproj, g);
  } else {
    if ((err = opt_in(k_project<float>, bytes))) return err;
    k_project<float><<<grid, NTA, bytes, s>>>((const float*)x, (float*)r, (const bf16*)vin,
                                              (const bf16*)attn_t, (const bf16*)wproj, g);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
