// Bilinear affine warp backward, NCHW: the gradients of csrc/warp.cu's
// forward with respect to the map and to the six pixel-space coefficients.
//
// The TPU has no kernel here: hifidiff_tpu/ops/warp.py (`_warp_fast_bwd`)
// takes `jax.vjp` of the gather formulation. On the card the forward is a
// hand-written kernel, so the backward is one too. With the forward's
//
//   sx = ax*j + bx*i + cx,  sy = ay*j + by*i + cy,  x0 = floor(sx), fx = sx - x0
//   out[n, c, i, j] = sum over the 4 corners of w_corner * x[n, c, corner]
//
// (corners outside the image count as zero), for the output gradient g:
//
//   dx[n, c, corner] += g[n, c, i, j] * w_corner          (inside corners)
//   d out / d sx = (v01 - v00) * (1 - fy) + (v11 - v10) * fy
//   d out / d sy = (v10 - v00) * (1 - fx) + (v11 - v01) * fx
//   dcoef[n] = sum over c, i, j of g * [dsx*j, dsx*i, dsx, dsy*j, dsy*i, dsy]
//
// `floor` has derivative zero, so at an integer sx (fx = 0, the identity
// warp the STNs start from) the slope is the one of the cell to the right
// of x0: the convention of JAX's autodiff and of F.grid_sample.
//
// What bounds it on the card: bytes and atomics. g and x are read once, dx
// is written through float32 atomicAdd (four per output element; for warps
// near the identity neighbouring threads hit neighbouring addresses). The
// thread map is the forward's: one output pixel x a chunk of 4 channels,
// corner offsets and weights computed once per thread. dx is accumulated in
// a float32 buffer whatever the map's type (the caller rounds it once); the
// six coefficient sums are reduced by warp shuffles and shared memory, then
// one atomicAdd per block and coefficient. Atomics land in an order that
// changes from run to run: the backward is not bit-reproducible.
#include "common.cuh"

namespace hifidiff {
namespace {

constexpr int kThreads = 256;
constexpr int kChansPerThread = 4;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    affine_warp_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x,
                           const float* __restrict__ coef,
                           float* __restrict__ dx, float* __restrict__ dcoef,
                           int C, int H, int W, int chunks, int need_dx,
                           int need_dcoef) {
  __shared__ float red[6][kThreads / 32];
  const long long HW = (long long)H * W;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool active = idx < HW * chunks;
  const int n = blockIdx.y;
  float acc_x = 0.f, acc_y = 0.f, fi = 0.f, fj = 0.f;

  if (active) {
    const int p = (int)(idx % HW);
    const int c0 = (int)(idx / HW) * kChansPerThread;
    fi = (float)(p / W);
    fj = (float)(p % W);

    const float* cf = coef + n * 6;
    const float sx = __fadd_rn(__fadd_rn(__fmul_rn(cf[0], fj), __fmul_rn(cf[1], fi)), cf[2]);
    const float sy = __fadd_rn(__fadd_rn(__fmul_rn(cf[3], fj), __fmul_rn(cf[4], fi)), cf[5]);
    const float x0 = floorf(sx);
    const float y0 = floorf(sy);
    const float fx = __fsub_rn(sx, x0);
    const float fy = __fsub_rn(sy, y0);
    const float gx = __fsub_rn(1.f, fx);
    const float gy = __fsub_rn(1.f, fy);

    // corners in the order (y0,x0), (y0,x1), (y1,x0), (y1,x1)
    int off[4];
    float wt[4];
    bool in[4];
    const float ys[2] = {y0, __fadd_rn(y0, 1.f)};
    const float xs[2] = {x0, __fadd_rn(x0, 1.f)};
    const float wy[2] = {gy, fy};
    const float wx[2] = {gx, fx};
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float yy = ys[a], xx = xs[e];
        const bool inside = yy >= 0.f && yy <= (float)(H - 1) && xx >= 0.f &&
                            xx <= (float)(W - 1);
        const int yc = (int)fminf(fmaxf(yy, 0.f), (float)(H - 1));
        const int xc = (int)fminf(fmaxf(xx, 0.f), (float)(W - 1));
        off[2 * a + e] = yc * W + xc;
        in[2 * a + e] = inside;
        wt[2 * a + e] = inside ? __fmul_rn(wx[e], wy[a]) : 0.f;
      }

    const long long plane = (long long)n * C * HW;
    const int c1 = min(C, c0 + kChansPerThread);
    for (int c = c0; c < c1; ++c) {
      const long long cbase = plane + (long long)c * HW;
      const float gv = to_f32(g[cbase + p]);
      if (need_dx) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (in[k]) atomicAdd(dx + cbase + off[k], gv * wt[k]);
      }
      if (need_dcoef) {
        const T* xc = x + cbase;
        const float v00 = in[0] ? to_f32(xc[off[0]]) : 0.f;
        const float v01 = in[1] ? to_f32(xc[off[1]]) : 0.f;
        const float v10 = in[2] ? to_f32(xc[off[2]]) : 0.f;
        const float v11 = in[3] ? to_f32(xc[off[3]]) : 0.f;
        acc_x += gv * ((v01 - v00) * gy + (v11 - v10) * fy);
        acc_y += gv * ((v10 - v00) * gx + (v11 - v01) * fx);
      }
    }
  }
  if (!need_dcoef) return;

  // the block's six sums: warp shuffles, then one row per warp in shared
  // memory; every thread of the block gets here
  float vals[6] = {acc_x * fj, acc_x * fi, acc_x, acc_y * fj, acc_y * fi, acc_y};
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    float v = vals[k];
    for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
    if (lane == 0) red[k][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    float v = 0.f;
    for (int wi = 0; wi < kThreads / 32; ++wi) v += red[threadIdx.x][wi];
    atomicAdd(dcoef + n * 6 + threadIdx.x, v);
  }
}

template <typename T>
void launch(const void* g, const void* x, const void* coef, void* dx,
            void* dcoef, int B, int C, int H, int W, int need_dx,
            int need_dcoef, cudaStream_t stream) {
  const int chunks = (C + kChansPerThread - 1) / kChansPerThread;
  const long long work = (long long)H * W * chunks;
  const dim3 grid((unsigned)((work + kThreads - 1) / kThreads), B);
  affine_warp_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x),
      static_cast<const float*>(coef), static_cast<float*>(dx),
      static_cast<float*>(dcoef), C, H, W, chunks, need_dx, need_dcoef);
}

}  // namespace
}  // namespace hifidiff

// g, x: (B, C, H, W) contiguous, f32 or bf16 (x_bf16); coef: (B, 6) f32.
// dx: zeroed float32 (B, C, H, W), dcoef: zeroed float32 (B, 6); each is
// left untouched (and may be null) when its need_ flag is 0.
// Returns cudaGetLastError() after the launch.
extern "C" int hifidiff_affine_warp_bwd(const void* g, const void* x,
                                        const void* coef, void* dx,
                                        void* dcoef, int B, int C, int H,
                                        int W, int x_bf16, int need_dx,
                                        int need_dcoef, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    hifidiff::launch<__nv_bfloat16>(g, x, coef, dx, dcoef, B, C, H, W,
                                    need_dx, need_dcoef, st);
  else
    hifidiff::launch<float>(g, x, coef, dx, dcoef, B, C, H, W, need_dx,
                            need_dcoef, st);
  return static_cast<int>(cudaGetLastError());
}
