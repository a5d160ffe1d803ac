// Fused GroupNorm + per-channel affine + SiLU, NCHW (the SD-VAE block
// prologue).
//
// Replaces the TPU kernel hifidiff_tpu/ops/pallas/groupnorm_silu.py
// (`group_norm_silu_pallas`). Per (sample, group):
//
//   mean = E[x], var = E[(x - mean)^2]          (two passes, f32)
//   y    = (x - mean) * rsqrt(var + eps) * w[c] + b[c]
//   out  = y * sigmoid(y)
//
// The variance is the centred two-pass form: the one-pass E[x^2] - mean^2
// cancels for a near-constant group with a large mean and can go negative.
//
// What bounds it on the card: bytes (one read and one write of the map; a
// dozen flops per element). In NCHW one (sample, group) is one contiguous
// run of L = (C / G) * H * W elements, 4,096 (512 ch x 16^2) to 131,072
// (256 ch x 128^2) on the VAE's path, so one block of 512 threads takes one
// run and reduces it with warp shuffles and a small shared-memory step; at
// batch 128 that is 4,096 blocks, enough for every shape. The run is read
// three times (mean, variance, normalise): the first read comes from device
// memory, the second and third are served by L1/L2 (a run is at most
// 512 KB in f32, the 50 MB L2 holds the runs in flight); it is not staged in
// shared memory, since the largest run does not fit there. Loads and stores
// are 16 bytes per thread when H * W is a multiple of the vector width,
// element-wise otherwise.
#include "common.cuh"

namespace hifidiff {
namespace {

constexpr int kThreads = 512;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
};

// One 16-byte load as f32 registers.
__device__ __forceinline__ void load_vec(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 t = __bfloat1622float2(h[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}
__device__ __forceinline__ void store_vec(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

// Sum over the block; every thread gets the result. All threads call it.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = lane < kThreads / 32 ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) r += __shfl_xor_sync(0xffffffffu, r, o);
  __syncthreads();  // the next call overwrites `red`
  return r;
}

__device__ __forceinline__ float silu(float y) {
  return y / (1.f + expf(-y));
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    gn_silu_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ b, T* __restrict__ out, int cpg,
                   int HW, int G, float eps) {
  __shared__ float red[kThreads / 32];
  constexpr int V = VEC ? Vec<T>::n : 1;
  const long long L = (long long)cpg * HW;
  const long long base = (long long)blockIdx.x * L;  // run (n, g)
  const int c0 = (blockIdx.x % G) * cpg;
  const T* xr = x + base;
  T* outr = out + base;
  const long long start = (long long)threadIdx.x * V;
  const long long step = (long long)kThreads * V;

  float s = 0.f;
  for (long long i = start; i < L; i += step) {
    if (VEC) {
      float f[Vec<T>::n];
      load_vec(xr + i, f);
#pragma unroll
      for (int j = 0; j < Vec<T>::n; ++j) s += f[j];
    } else {
      s += to_f32(xr[i]);
    }
  }
  const float mean = block_sum(s, red) / (float)L;

  float q = 0.f;
  for (long long i = start; i < L; i += step) {
    if (VEC) {
      float f[Vec<T>::n];
      load_vec(xr + i, f);
#pragma unroll
      for (int j = 0; j < Vec<T>::n; ++j) q += (f[j] - mean) * (f[j] - mean);
    } else {
      const float d = to_f32(xr[i]) - mean;
      q += d * d;
    }
  }
  const float rstd = rsqrtf(block_sum(q, red) / (float)L + eps);

  for (long long i = start; i < L; i += step) {
    const int c = c0 + (int)(i / HW);  // a vector never straddles a channel
    const float wc = to_f32(w[c]), bc = to_f32(b[c]);
    if (VEC) {
      float f[Vec<T>::n];
      load_vec(xr + i, f);
#pragma unroll
      for (int j = 0; j < Vec<T>::n; ++j)
        f[j] = silu((f[j] - mean) * rstd * wc + bc);
      store_vec(outr + i, f);
    } else {
      outr[i] = from_f32<T>(silu((to_f32(xr[i]) - mean) * rstd * wc + bc));
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, const void* b, void* out, int B,
            int C, int HW, int G, float eps, cudaStream_t stream) {
  const bool vec = HW % Vec<T>::n == 0;
  auto kern = vec ? gn_silu_kernel<T, true> : gn_silu_kernel<T, false>;
  kern<<<B * G, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(out), C / G, HW, G, eps);
}

}  // namespace
}  // namespace hifidiff

// x, out: (B, C, H, W) contiguous, 16-byte aligned; w, b: (C,); one dtype,
// bf16 (is_bf16) or f32; C % G == 0. Returns cudaGetLastError() after the
// launch.
extern "C" int hifidiff_gn_silu(const void* x, const void* w, const void* b,
                                void* out, int B, int C, int HW, int G,
                                float eps, int is_bf16, void* stream) {
  using hifidiff::launch;
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<__nv_bfloat16>(x, w, b, out, B, C, HW, G, eps, st);
  else
    launch<float>(x, w, b, out, B, C, HW, G, eps, st);
  return static_cast<int>(cudaGetLastError());
}
