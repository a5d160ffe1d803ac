// Fused LayerNorm2d + FiLM backward, NCHW.
//
// Replaces the TPU kernel hifidiff_tpu/ops/pallas/ln_film.py
// (`_ln_film_bwd` / `_bwd_kernel`). From x and the output's gradient g alone
// (mean, rstd and y are recomputed, nothing else was saved), per pixel (n, p):
//
//   y   = (x - mean_C) * rstd
//   g1  = g * (1 + scale[n]),  gw = g1 * w
//   dx  = rstd * (gw - y * mean_C(gw * y) - mean_C(gw))
//
// and, summed over the pixels of sample n, the float32 partials
//
//   dw[n] += g1 * y,  db[n] += g1,  dscale[n] += g * (y * w + b),
//   dshift[n] += g
//
// (dw and db are summed over the batch outside, as the TPU kernel's caller
// does; a FiLM shared by the batch sums dscale and dshift there too).
//
// What bounds it on the card: bytes (x and g read, dx written; a few dozen
// flops per element). The layout is the forward's (ln_film.cu): a block of
// 256 threads takes P pixels x 256/P channel lanes, so that both the 16x16
// maps with 128 channels and the 1x1 maps with 2048 channels fill a block
// and every warp reads contiguous memory. Four passes over the tile: mean,
// centred variance, the two column sums of dx, then dx and the partials;
// all but the first read of x and g come from L1/L2.
//
// The TPU kernel carries the per-sample partials across its sequential grid
// in a revisited (B, C) block. Blocks of a GPU grid run in no order, so here
// the P pixels of a channel are summed by warp shuffles (the P threads of a
// channel lane are neighbours in a warp) and each block adds its sums to
// the zeroed (B, C) buffers with one float32 atomicAdd per channel and
// partial. A sample's map spans up to HW/P blocks, whose atomics land in an
// order that changes from run to run: the partials are not bit-reproducible
// where HW > P.
#include "common.cuh"

namespace hifidiff {
namespace {

constexpr int kThreads = 256;

// Sums of `a` and `b` over the channel lanes of each pixel column; every
// thread gets its column's sums. All threads of the block must call it.
__device__ __forceinline__ void column_sum2(float* red, float& a, float& b,
                                            int tx, int ty, int P,
                                            int lanes) {
  float* ra = red;
  float* rb = red + kThreads;
  ra[ty * P + tx] = a;
  rb[ty * P + tx] = b;
  __syncthreads();
  for (int s = lanes / 2; s > 0; s >>= 1) {
    if (ty < s) {
      ra[ty * P + tx] += ra[(ty + s) * P + tx];
      rb[ty * P + tx] += rb[(ty + s) * P + tx];
    }
    __syncthreads();
  }
  a = ra[tx];
  b = rb[tx];
  __syncthreads();  // the next call overwrites `red`
}

// Sum over the P pixel threads of one channel lane: they are P neighbouring
// lanes of a warp (threadIdx.x = ty * P + tx, P a power of two <= 32).
__device__ __forceinline__ float pixel_sum(float v, int P) {
  for (int s = P / 2; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_film_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       const T* __restrict__ w, const T* __restrict__ b,
                       const T* __restrict__ scale, T* __restrict__ dx,
                       float* __restrict__ dw, float* __restrict__ db,
                       float* __restrict__ dscale, float* __restrict__ dshift,
                       int C, int HW, int P, long long film_stride, float eps,
                       int need_wb) {
  __shared__ float red[2 * kThreads];
  const int lanes = kThreads / P;
  const int tx = threadIdx.x % P;
  const int ty = threadIdx.x / P;
  const int n = blockIdx.y;
  const int p = blockIdx.x * P + tx;
  const bool valid = p < HW;
  const long long base = (long long)n * C * HW + p;
  const T* sc = scale + n * film_stride;

  float s = 0.f, unused = 0.f;
  if (valid)
    for (int c = ty; c < C; c += lanes) s += to_f32(x[base + (long long)c * HW]);
  column_sum2(red, s, unused, tx, ty, P, lanes);
  const float mean = s / C;

  float v = 0.f;
  if (valid)
    for (int c = ty; c < C; c += lanes) {
      const float d = to_f32(x[base + (long long)c * HW]) - mean;
      v += d * d;
    }
  column_sum2(red, v, unused, tx, ty, P, lanes);
  const float rstd = rsqrtf(v / C + eps);

  float sum_gw = 0.f, sum_gwy = 0.f;
  if (valid)
    for (int c = ty; c < C; c += lanes) {
      const long long i = base + (long long)c * HW;
      const float y = (to_f32(x[i]) - mean) * rstd;
      const float gw = to_f32(g[i]) * (1.f + to_f32(sc[c])) * to_f32(w[c]);
      sum_gw += gw;
      sum_gwy += gw * y;
    }
  column_sum2(red, sum_gw, sum_gwy, tx, ty, P, lanes);
  const float mean_g = sum_gw / C;
  const float mean_gy = sum_gwy / C;

  // every thread walks the same channels, so the shuffles meet whole warps;
  // a pixel beyond the map adds zeros
  float* dwn = dw + (long long)n * C;
  float* dbn = db + (long long)n * C;
  float* dsn = dscale + (long long)n * C;
  float* dtn = dshift + (long long)n * C;
  for (int c0 = 0; c0 < C; c0 += lanes) {
    const int c = c0 + ty;
    float g1y = 0.f, g1 = 0.f, ga = 0.f, gv = 0.f;
    if (valid && c < C) {
      const long long i = base + (long long)c * HW;
      const float wc = to_f32(w[c]);
      const float y = (to_f32(x[i]) - mean) * rstd;
      gv = to_f32(g[i]);
      g1 = gv * (1.f + to_f32(sc[c]));
      g1y = g1 * y;
      ga = gv * (y * wc + to_f32(b[c]));
      dx[i] = from_f32<T>(rstd * (g1 * wc - y * mean_gy - mean_g));
    }
    ga = pixel_sum(ga, P);
    gv = pixel_sum(gv, P);
    if (need_wb) {
      g1y = pixel_sum(g1y, P);
      g1 = pixel_sum(g1, P);
    }
    if (tx == 0 && c < C) {
      atomicAdd(dsn + c, ga);
      atomicAdd(dtn + c, gv);
      if (need_wb) {
        atomicAdd(dwn + c, g1y);
        atomicAdd(dbn + c, g1);
      }
    }
  }
}

template <typename T>
void launch(const void* x, const void* g, const void* w, const void* b,
            const void* scale, void* dx, float* partials, int B, int C,
            int HW, long long film_stride, float eps, int need_wb,
            cudaStream_t stream) {
  int P = 1;
  while (P * 2 <= HW && P * 2 <= 32) P *= 2;
  const dim3 grid((HW + P - 1) / P, B);
  const long long bc = (long long)B * C;
  ln_film_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<const T*>(scale), static_cast<T*>(dx), partials,
      partials + bc, partials + 2 * bc, partials + 3 * bc, C, HW, P,
      film_stride, eps, need_wb);
}

}  // namespace
}  // namespace hifidiff

// x, g, dx: (B, C, H, W) contiguous; w, b: (C,); scale: rows of C contiguous
// values `film_stride` elements apart (0: one row for the whole batch); all
// bf16 (is_bf16) or all f32. partials: zeroed float32 (4, B, C): dw, db,
// dscale, dshift per sample; dw and db are left untouched when need_wb is 0.
// Returns cudaGetLastError() after the launch.
extern "C" int hifidiff_ln_film_bwd(const void* x, const void* g,
                                    const void* w, const void* b,
                                    const void* scale, void* dx,
                                    void* partials, int B, int C, int HW,
                                    long long film_stride, float eps,
                                    int is_bf16, int need_wb, void* stream) {
  using hifidiff::launch;
  auto st = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<float*>(partials);
  if (is_bf16)
    launch<__nv_bfloat16>(x, g, w, b, scale, dx, part, B, C, HW, film_stride,
                          eps, need_wb, st);
  else
    launch<float>(x, g, w, b, scale, dx, part, B, C, HW, film_stride, eps,
                  need_wb, st);
  return static_cast<int>(cudaGetLastError());
}
