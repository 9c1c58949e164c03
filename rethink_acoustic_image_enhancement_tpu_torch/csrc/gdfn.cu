// LayerNorm -> GDFN -> residual kernel for Hopper (sm_90a):
//   out = x + W_out (gelu(t1) * t2),  t = dwconv3x3(W_in LN(x)),
// with either LayerNorm (BiasFree, or WithBias where a bias is given) or
// none, on NHWC x of any batch, height and width.
//
// Replaces: rethink_acoustic_image_enhancement_tpu/ops/pallas/gdfn.py
//           ::fused_ln_gdfn (its pallas_call at gdfn.py:277).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM). Per pixel
// 2*C*2F + 2*9*2F + 2*F*C operations, F = int(2.66*C): 156,060 at C = 96,
// so 40.9 GFLOP and 41 us at 512x512, against 101 MB (x read once, out
// written once, bf16) and 30 us: bound by the tensor-core rate.
//
// Design. One thread block of 256 threads per spatial tile (8x8 at C <= 96,
// smaller above) reads x once on the tile's 1-pixel halo, straight into mma
// accumulator fragments, takes LN(x) from those registers, and the 2F hidden
// channels never leave shared memory: tile_ops.cuh's r_ln_tile and
// gdfn_chunks, the same device code as stage.cu's kernel (C) less its
// attention half, run them in chunks of 64 or 32 with the W_out product
// accumulated in registers onto x. Two blocks are resident on an SM at
// C = 96 (see the note in tile_ops.cuh). The TPU kernel zero-padded x, so its
// LayerNorm gave the bias, not 0, on the ring outside the image; here LN(x)
// is masked to 0 there, which is what torch's padding=1 of the depthwise
// input means. Partial tiles at the right and bottom edges are masked on
// load and store.
//
// A model shard (ops/stage.py::fused_transformer_stage_shards) runs it on its
// range of the hidden channels: W_in's columns and the taps of that range in
// both halves, W_out's rows, padded to HIDDEN_PAD as ever, on float32 r, LN
// taken over all C channels; with residual = 0 (every shard but one) it
// writes W_out (gelu(t1) * t2) alone, and the host adds the shards' parts.
//
// Against the bound: as kernel (C) of stage.cu, latency between short phases
// rather than the tensor cores, and (10*10)/(8*8) of the W_in product spent
// on the halo.

#include <climits>

#include "tile_ops.cuh"

namespace {

template <int FC, class T, bool Residual>
__global__ void __launch_bounds__(NTA, 2)
k_gdfn(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ lnw,
       const float* __restrict__ lnb, FfnWeights wt, Geo g, float eps, bool apply_ln) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FfnSmem L(g.th, g.tw, g.C, g.C, g.fc, false, g.C);
  const FfnBufs s(smem, L);
  PHASE_CLOCK(pc);
  const int b = blockIdx.y, tile = blockIdx.x;
  const int y0 = (tile / g.ntj) * g.th, x0 = (tile % g.ntj) * g.tw;
  if (apply_ln) {
    copy_async(s.lnw, lnw, g.C * 4);
    if (lnb != nullptr) copy_async(s.lnb, lnb, g.C * 4);
  }
  ffn_load_chunk<FC>(s, wt, g, 0, 0);
  r_ln_tile<false, Residual>(s, x, AttnIn{}, g, b, y0, x0, eps, apply_ln, lnb != nullptr, [] {},
                             pc);
  gdfn_chunks<FC, T, Residual>(s, y, wt, g, b, y0, x0, pc);
}

size_t gdfn_bytes(int th, int tw, int C, int fc) {
  return FfnSmem(th, tw, C, C, fc, false, C).total;
}

template <int FC, class T, bool Residual>
int launch_fc(const void* x, void* y, const float* lnw, const float* lnb, FfnWeights wt,
           const Geo& g, float eps, int apply_ln, cudaStream_t stream) {
  const size_t bytes = gdfn_bytes(g.th, g.tw, g.C, g.fc);
  const int err = opt_in(k_gdfn<FC, T, Residual>, bytes);
  if (err) return err;
  k_gdfn<FC, T, Residual><<<dim3(g.ntiles, g.B), NTA, bytes, stream>>>(
      (const T*)x, (T*)y, lnw, lnb, wt, g, eps, apply_ln != 0);
  return (int)cudaGetLastError();
}

template <class T, bool Residual>
int launch(const void* x, void* y, const float* lnw, const float* lnb, FfnWeights wt,
           const Geo& g, float eps, int apply_ln, cudaStream_t stream) {
  return g.fc == 64 ? launch_fc<64, T, Residual>(x, y, lnw, lnb, wt, g, eps, apply_ln, stream)
                    : launch_fc<32, T, Residual>(x, y, lnw, lnb, wt, g, eps, apply_ln, stream);
}

}  // namespace

// ---- C interface (ctypes). Pointers are device pointers of contiguous
// tensors; the call launches on `stream` and returns cudaGetLastError() (or
// ERR_SMEM / ERR_SHAPE without launching). x and y have one dtype; the
// weights are laid out as tile_ops.cuh::FfnWeights says; a null ln_b selects
// the BiasFree LayerNorm, apply_ln = 0 none; residual = 0 leaves x out of y
// (float32 x and y only: a model shard's partial). ---------------------------

extern "C" {

// Dynamic shared memory of the kernel on th x tw tiles with chunks of fc
// hidden channels; INT_MAX for a shape it does not take.
int raie_gdfn_smem_bytes(int th, int tw, int C, int fc) {
  return ffn_shape_ok(C, fc, fc, th, tw) ? (int)gdfn_bytes(th, tw, C, fc) : INT_MAX;
}

// Thread blocks of it the device keeps resident on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); 0 where it cannot launch.
int raie_gdfn_blocks_per_sm(int th, int tw, int C, int fc) {
  if (!ffn_shape_ok(C, fc, fc, th, tw)) return 0;
  const size_t bytes = gdfn_bytes(th, tw, C, fc);
  return fc == 64 ? resident_blocks(k_gdfn<64, float, true>, NTA, bytes)
                  : resident_blocks(k_gdfn<32, float, true>, NTA, bytes);
}

const char* raie_gdfn_error_string(int code) { return tile_error_string(code); }

int raie_gdfn(const void* x, void* y, int is_bf16, const void* ln_w, const void* ln_b,
              int apply_ln, const void* win, const void* wdw, const void* wout, int B, int H,
              int W, int C, int Fp, int fc, int th, int tw, float eps, int residual,
              void* stream) {
  if (!ffn_shape_ok(C, Fp, fc, th, tw) || (!residual && is_bf16)) return ERR_SHAPE;
  const Geo g = make_geo(B, H, W, C, 1, Fp, fc, th, tw);
  const FfnWeights wt{(const bf16*)win, (const float*)wdw, (const bf16*)wout};
  const float *lw = (const float*)ln_w, *lb = (const float*)ln_b;
  cudaStream_t s = (cudaStream_t)stream;
  if (!residual) return launch<float, false>(x, y, lw, lb, wt, g, eps, apply_ln, s);
  if (is_bf16) return launch<bf16, true>(x, y, lw, lb, wt, g, eps, apply_ln, s);
  return launch<float, true>(x, y, lw, lb, wt, g, eps, apply_ln, s);
}

}  // extern "C"
