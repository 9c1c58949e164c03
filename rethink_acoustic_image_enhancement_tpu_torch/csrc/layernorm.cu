// Channel LayerNorm kernel for Hopper (sm_90a): rows of C channels,
// BiasFree x / sqrt(var + eps) * w (variance about the mean, mean not
// subtracted) or WithBias (x - mean) / sqrt(var + eps) * w + b, two-pass
// variance in fp32, output in x's dtype.
//
// Replaces: rethink_acoustic_image_enhancement_tpu/ops/pallas/layernorm.py
//           ::fused_channel_layernorm (its pallas_call at layernorm.py:58).
//
// Bound on an H100 SXM (3.35 TB/s HBM): bytes. x is read once and y written
// once, 2 * 512*512*96 * 2 B = 100.7 MB in bf16, 30 us; the ~8 operations
// per element are far below the fp32 rate.
//
// Design. A row stays in registers between its one load and its one store:
// LPR lanes of a warp share a row, each holding up to MAXV 16-byte vectors
// (lane s takes vectors s, s + LPR, ...: neighbouring lanes, neighbouring
// addresses), and the two sums go across the LPR lanes by shuffles. LPR is
// the smallest power of two that covers the row (4 lanes at C = 96 in bf16,
// so a warp normalises 8 rows at once), which keeps every lane loading.
// Any number of rows (the TPU kernel's power-of-two row tile is its own
// affair); C a multiple of 8 (bf16) or 4 (fp32), up to 1024 / 512.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NT = 256;           // threads a block
constexpr int MAXV = 4;           // 16-byte vectors a lane holds
constexpr int ERR_SHAPE = 100002; // C not a multiple of the vector, or too wide or tall

template <class T> struct Vec;
template <> struct Vec<float> {
  static constexpr int VE = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(&u);
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  }
  __device__ static uint4 pack(const float* f) {
    const float4 v = make_float4(f[0], f[1], f[2], f[3]);
    return *reinterpret_cast<const uint4*>(&v);
  }
};
template <> struct Vec<bf16> {
  static constexpr int VE = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x, f[2 * i + 1] = v.y;
    }
  }
  __device__ static uint4 pack(const float* f) {
    __nv_bfloat162 h[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return *reinterpret_cast<const uint4*>(h);
  }
};

template <class T, int LPR>
__global__ void __launch_bounds__(NT)
k_layernorm(const T* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b,
            T* __restrict__ y, long long P, int C, float eps) {
  constexpr int VE = Vec<T>::VE, RPW = 32 / LPR;
  const int lane = threadIdx.x & 31, sub = lane % LPR, nv = C / VE;
  const long long row =
      ((long long)blockIdx.x * (NT / 32) + (threadIdx.x >> 5)) * RPW + lane / LPR;
  const bool ok = row < P;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * C);
  float v[MAXV][VE];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int vi = sub + LPR * i;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (ok && vi < nv) u = xr[vi];
    Vec<T>::unpack(u, v[i]);
#pragma unroll
    for (int e = 0; e < VE; ++e) s += v[i][e];
  }
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float mean = s / C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    if (sub + LPR * i < nv) {
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        const float d = v[i][e] - mean;
        q += d * d;
      }
    }
  }
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
  const float inv = rsqrtf(q / C + eps);
  const float shift = b != nullptr ? mean : 0.f;
  uint4* yr = reinterpret_cast<uint4*>(y + row * C);
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int vi = sub + LPR * i;
    if (!ok || vi >= nv) continue;
    float o[VE];
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      const int c = vi * VE + e;
      o[e] = (v[i][e] - shift) * inv * w[c] + (b != nullptr ? b[c] : 0.f);
    }
    yr[vi] = Vec<T>::pack(o);
  }
}

template <class T, int LPR>
int launch(const void* x, const float* w, const float* b, void* y, long long P, int C, float eps,
           cudaStream_t stream) {
  const long long rows_per_block = (NT / 32) * (32 / LPR);
  const long long blocks = (P + rows_per_block - 1) / rows_per_block;
  if (blocks > 2147483647ll) return ERR_SHAPE;
  if (blocks > 0)
    k_layernorm<T, LPR><<<(unsigned)blocks, NT, 0, stream>>>((const T*)x, w, b, (T*)y, P, C, eps);
  return (int)cudaGetLastError();
}

template <class T>
int dispatch(const void* x, const float* w, const float* b, void* y, long long P, int C,
             float eps, cudaStream_t stream) {
  constexpr int VE = Vec<T>::VE;
  if (C <= 0 || C % VE || C / VE > 32 * MAXV) return ERR_SHAPE;
  const int nv = C / VE;
  if (nv <= MAXV) return launch<T, 1>(x, w, b, y, P, C, eps, stream);
  if (nv <= 2 * MAXV) return launch<T, 2>(x, w, b, y, P, C, eps, stream);
  if (nv <= 4 * MAXV) return launch<T, 4>(x, w, b, y, P, C, eps, stream);
  if (nv <= 8 * MAXV) return launch<T, 8>(x, w, b, y, P, C, eps, stream);
  if (nv <= 16 * MAXV) return launch<T, 16>(x, w, b, y, P, C, eps, stream);
  return launch<T, 32>(x, w, b, y, P, C, eps, stream);
}

}  // namespace

// ---- C interface (ctypes). x and y are contiguous (P, C) device tensors of
// one dtype, w and b float32 (C,), b null for the BiasFree variant. Launches
// on `stream`; returns cudaGetLastError(), or ERR_SHAPE without launching. --

extern "C" {

const char* raie_layernorm_error_string(int code) {
  if (code == ERR_SHAPE)
    return "C must be a multiple of 8 (bf16) or 4 (fp32), at most 1024 (bf16) or 512 (fp32)";
  return cudaGetErrorString((cudaError_t)code);
}

int raie_layernorm(const void* x, int is_bf16, const void* w, const void* b, void* y,
                   long long P, int C, float eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) return dispatch<bf16>(x, (const float*)w, (const float*)b, y, P, C, eps, s);
  return dispatch<float>(x, (const float*)w, (const float*)b, y, P, C, eps, s);
}

}  // extern "C"
