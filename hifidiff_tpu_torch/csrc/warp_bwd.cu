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
//   dx[n, c, y, x] = sum over the output pixels (i, j) one of whose corners
//                    is (y, x) of g[n, c, i, j] * w_corner(i, j)
//   d out / d sx = (v01 - v00) * (1 - fy) + (v11 - v10) * fy
//   d out / d sy = (v10 - v00) * (1 - fx) + (v11 - v01) * fx
//   dcoef[n] = sum over c, i, j of g * [dsx*j, dsx*i, dsx, dsy*j, dsy*i, dsy]
//
// `floor` has derivative zero, so at an integer sx (fx = 0, the identity
// warp the STNs start from) the slope is the one of the cell to the right
// of x0: the convention of JAX's autodiff and of F.grid_sample.
//
// What bounds it on the card: bytes (g and x read, dx written; some forty
// operations per element). Every sum is taken in a fixed order, without
// atomics and without a memset: two calls on the same inputs give the same
// bits. One kernel has two kinds of blocks:
//
// * dx in the gather form. A thread owns one source pixel (y, x) and up to
//   eight channels. The output pixels whose corners include it are those
//   with floor(sx) in {x - 1, x} and floor(sy) in {y - 1, y}: the preimage of
//   a 2 x 2 square under the affine map, a parallelogram. The thread inverts
//   the 2 x 2 part of the coefficients (in double), takes the integer
//   bounding box of that parallelogram, widened by a margin that covers the
//   rounding of the forward's coordinates, and for each candidate recomputes
//   sx, sy with the forward's own rounded operations: it keeps the
//   candidate only if one of its four corners really is (y, x), with that
//   corner's weight, so membership is decided exactly as the forward decides
//   it. The products g * w are added in candidate order (rows, then
//   columns) in float32, and dx is rounded once to x's dtype. A singular or
//   near-singular matrix (no finite box) takes the whole output as its box:
//   slow, and right.
// * dcoef. A thread owns one output pixel and up to eight channels, as the
//   forward's map: the four corners, then the two slopes times g summed
//   over its channels. Each block sums its threads' six products in a fixed
//   order (warp shuffles, then the warps in order) into one row of partial
//   sums; a second kernel, launched with programmatic dependent launch,
//   adds a sample's rows in a fixed order.
//
// A call is one launch (dx alone) or two (dcoef, with or without dx).
#include "common.cuh"

namespace hifidiff {
namespace {

constexpr int kMaxThreads = 256;
constexpr int kPixels = 64;       // pixels a block
constexpr int kMaxChans = 8;      // channels a thread
constexpr int kSumThreads = 192;  // a warp per coefficient

// A launch's shape: threads per pixel (`lanes`), channels a block (lanes
// times up to kMaxChans), and the blocks of each kind per sample.
struct BwdPlan {
  int pixels, lanes, chans, blocks;
};

BwdPlan plan_of(int B, int C, int H, int W) {
  BwdPlan p;
  const int HW = H * W;
  p.pixels = HW < kPixels ? HW : kPixels;
  p.lanes = kMaxThreads / p.pixels;
  if (p.lanes > 32) p.lanes = 32;
  const int tiles = (HW + p.pixels - 1) / p.pixels;
  const long long want = 2LL * multiprocessors();
  int k = kMaxChans;
  auto groups = [&](int chans) { return (C + chans - 1) / chans; };
  while (k > 1 && (long long)B * tiles * groups(p.lanes * k) < want) k /= 2;
  p.chans = p.lanes * k;
  p.blocks = tiles * groups(p.chans);
  return p;
}

__device__ __forceinline__ float coord(float a, float fj, float b, float fi,
                                       float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, fj), __fmul_rn(b, fi)), c);
}

// dx at source pixel q = (y, x) of the plane, for the cn channels whose
// planes start at `plane` and lie `lanes` planes apart.
template <typename T>
__device__ __forceinline__ void dx_pixel(const T* __restrict__ g,
                                         const float* cf, T* __restrict__ dx,
                                         int H, int W, int q, long long plane,
                                         int lanes, int cn) {
  const int y = q / W, x = q - (q / W) * W;
  const float ax = cf[0], bx = cf[1], cx = cf[2];
  const float ay = cf[3], by = cf[4], cy = cf[5];
  const long long HW = (long long)H * W;

  // the candidates' box: (j, i) = A^-1 (sx - cx, sy - cy) over the square
  // sx in [x - 1, x + 1], sy in [y - 1, y + 1] (its centre plus or minus
  // the half-widths), widened by the forward's rounding (at most 2^-22 of
  // `mag` in source pixels, times the inverse's norm in output pixels) and
  // by 2^-10
  int jlo = 0, jhi = W - 1, ilo = 0, ihi = H - 1;
  const double a = ax, b = bx, c = ay, d = by;
  const double det = a * d - b * c;
  if (fabs(det) > 0.0) {
    const double inv = 1.0 / det;
    const double pj = d * inv, qj = -b * inv, pi = -c * inv, qi = a * inv;
    const double hj = fabs(pj) + fabs(qj), hi = fabs(pi) + fabs(qi);
    const double mag =
        fmax(fabs(a) * W + fabs(b) * H + fabs((double)cx),
             fabs(c) * W + fabs(d) * H + fabs((double)cy));
    const double m = ldexp(mag * (hj + hi), -20) + ldexp(1.0, -10);
    const double u = x - (double)cx, v = y - (double)cy;
    const double jc = pj * u + qj * v, ic = pi * u + qi * v;
    const double j0 = ceil(jc - hj - m), j1 = floor(jc + hj + m);
    const double i0 = ceil(ic - hi - m), i1 = floor(ic + hi + m);
    if (isfinite(j0) && isfinite(j1) && isfinite(i0) && isfinite(i1)) {
      jlo = (int)fmin(fmax(j0, 0.0), (double)W);
      jhi = (int)fmin(fmax(j1, -1.0), (double)(W - 1));
      ilo = (int)fmin(fmax(i0, 0.0), (double)H);
      ihi = (int)fmin(fmax(i1, -1.0), (double)(H - 1));
    }
  }

  const float fxs = (float)x, fys = (float)y;
  float acc[kMaxChans];
#pragma unroll
  for (int k = 0; k < kMaxChans; ++k) acc[k] = 0.f;
  for (int i = ilo; i <= ihi; ++i) {
    const float fi = (float)i;
    for (int j = jlo; j <= jhi; ++j) {
      const float fj = (float)j;
      const float sx = coord(ax, fj, bx, fi, cx);
      const float sy = coord(ay, fj, by, fi, cy);
      const float x0 = floorf(sx), y0 = floorf(sy);
      const bool xl = x0 == fxs, xr = __fadd_rn(x0, 1.f) == fxs;
      const bool yt = y0 == fys, yb = __fadd_rn(y0, 1.f) == fys;
      if (!((xl || xr) && (yt || yb))) continue;
      const float fx = __fsub_rn(sx, x0), fy = __fsub_rn(sy, y0);
      const float wx = xl ? __fsub_rn(1.f, fx) : fx;
      const float wy = yt ? __fsub_rn(1.f, fy) : fy;
      const float w = __fmul_rn(wx, wy);
      const T* gp = g + plane + (long long)i * W + j;
#pragma unroll
      for (int k = 0; k < kMaxChans; ++k)
        if (k < cn) acc[k] += to_f32(gp[k * lanes * HW]) * w;
    }
  }
  T* dp = dx + plane + q;
#pragma unroll
  for (int k = 0; k < kMaxChans; ++k)
    if (k < cn) dp[k * lanes * HW] = from_f32<T>(acc[k]);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    affine_warp_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x,
                           const float* __restrict__ coef, T* __restrict__ dx,
                           float* __restrict__ part, int C, int H, int W,
                           BwdPlan p, int dx_blocks) {
  griddep_launch_dependents();  // the sums may start their prologue
  __shared__ float red[6][kMaxThreads / 32];
  const int n = blockIdx.y;
  const bool for_dx = (int)blockIdx.x < dx_blocks;
  const int blk = for_dx ? blockIdx.x : blockIdx.x - dx_blocks;
  const int HW = H * W;
  const int tiles = (HW + p.pixels - 1) / p.pixels;
  const int grp = blk / tiles, tile = blk - grp * tiles;
  const int px = threadIdx.x % p.pixels, lane = threadIdx.x / p.pixels;
  const int q = tile * p.pixels + px;             // pixel in the plane
  const int c0 = grp * p.chans + lane;            // this thread's first channel
  // this thread's channels: c0, c0 + lanes, ... below C and the group's end
  const int c_end = min(C, (grp + 1) * p.chans);
  const int cn = c0 < c_end ? (c_end - c0 + p.lanes - 1) / p.lanes : 0;
  const long long plane = ((long long)n * C + c0) * HW;
  const float* cf = coef + n * 6;

  if (for_dx) {
    if (q < HW && cn > 0) dx_pixel(g, cf, dx, H, W, q, plane, p.lanes, cn);
    return;
  }

  float acc_x = 0.f, acc_y = 0.f, fi = 0.f, fj = 0.f;
  if (q < HW && cn > 0) {
    const int i = q / W, j = q - (q / W) * W;
    fi = (float)i;
    fj = (float)j;
    const float sx = coord(cf[0], fj, cf[1], fi, cf[2]);
    const float sy = coord(cf[3], fj, cf[4], fi, cf[5]);
    const float x0 = floorf(sx);
    const float y0 = floorf(sy);
    const float fx = __fsub_rn(sx, x0);
    const float fy = __fsub_rn(sy, y0);
    const float gx = __fsub_rn(1.f, fx);
    const float gy = __fsub_rn(1.f, fy);
    // corners in the order (y0,x0), (y0,x1), (y1,x0), (y1,x1)
    int off[4];
    bool in[4];
    const float ys[2] = {y0, __fadd_rn(y0, 1.f)};
    const float xs[2] = {x0, __fadd_rn(x0, 1.f)};
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float yy = ys[a], xx = xs[e];
        in[2 * a + e] = yy >= 0.f && yy <= (float)(H - 1) && xx >= 0.f &&
                        xx <= (float)(W - 1);
        const int yc = (int)fminf(fmaxf(yy, 0.f), (float)(H - 1));
        const int xc = (int)fminf(fmaxf(xx, 0.f), (float)(W - 1));
        off[2 * a + e] = yc * W + xc;
      }
    const long long step = (long long)p.lanes * HW;
#pragma unroll
    for (int k = 0; k < kMaxChans; ++k) {
      if (k >= cn) break;
      const T* xc = x + plane + k * step;
      const float gv = to_f32(g[plane + k * step + q]);
      const float v00 = in[0] ? to_f32(xc[off[0]]) : 0.f;
      const float v01 = in[1] ? to_f32(xc[off[1]]) : 0.f;
      const float v10 = in[2] ? to_f32(xc[off[2]]) : 0.f;
      const float v11 = in[3] ? to_f32(xc[off[3]]) : 0.f;
      acc_x += gv * ((v01 - v00) * gy + (v11 - v10) * fy);
      acc_y += gv * ((v10 - v00) * gx + (v11 - v01) * fx);
    }
  }

  // the block's six sums in a fixed order: warp shuffles, then the warps
  float vals[6] = {acc_x * fj, acc_x * fi, acc_x, acc_y * fj, acc_y * fi, acc_y};
  const int lane32 = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    float v = vals[k];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
    if (lane32 == 0) red[k][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    float v = 0.f;
    for (int wi = 0; wi < warps; ++wi) v += red[threadIdx.x][wi];
    part[((long long)n * p.blocks + blk) * 6 + threadIdx.x] = v;
  }
}

// dcoef[n, k]: the `rows` partial rows of sample n, added in a fixed order
// (lane r takes rows r, r + 32, ..., then the lanes by shuffles). One block
// per sample, a warp per coefficient.
__global__ void __launch_bounds__(kSumThreads)
    affine_warp_bwd_sums(const float* __restrict__ part,
                         float* __restrict__ dcoef, int rows) {
  griddep_wait();  // the partial rows are written
  const int n = blockIdx.x, k = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float s = 0.f;
  for (int r = lane; r < rows; r += 32)
    s += part[((long long)n * rows + r) * 6 + k];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) dcoef[n * 6 + k] = s;
}

template <typename T>
void launch(const void* g, const void* x, const void* coef, void* dx,
            float* dcoef, float* scratch, int B, int C, int H, int W,
            int need_dx, int need_dcoef, cudaStream_t stream) {
  const BwdPlan p = plan_of(B, C, H, W);
  const int dx_blocks = need_dx ? p.blocks : 0;
  const int blocks = dx_blocks + (need_dcoef ? p.blocks : 0);
  if (blocks == 0) return;
  affine_warp_bwd_kernel<T>
      <<<dim3(blocks, B), p.pixels * p.lanes, 0, stream>>>(
          static_cast<const T*>(g), static_cast<const T*>(x),
          static_cast<const float*>(coef), static_cast<T*>(dx), scratch, C,
          H, W, p, dx_blocks);
  if (!need_dcoef) return;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B);
  cfg.blockDim = dim3(kSumThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, affine_warp_bwd_sums,
                     static_cast<const float*>(scratch), dcoef, p.blocks);
}

}  // namespace
}  // namespace hifidiff

// The float32 scratch `hifidiff_affine_warp_bwd` takes for these sizes: the
// partial rows of dcoef.
extern "C" long long hifidiff_affine_warp_bwd_scratch(int B, int C, int H,
                                                      int W) {
  return (long long)B * hifidiff::plan_of(B, C, H, W).blocks * 6;
}

// g, x, dx: (B, C, H, W) contiguous, f32 or bf16 (x_bf16); coef: (B, 6) f32.
// dcoef: float32 (B, 6); scratch: float32 of the size
// hifidiff_affine_warp_bwd_scratch gives. dx (or dcoef and scratch) is left
// untouched, and may be null, when its need_ flag is 0. One or two launches
// on `stream`, no memset. Returns cudaGetLastError() after the launches.
extern "C" int hifidiff_affine_warp_bwd(const void* g, const void* x,
                                        const void* coef, void* dx,
                                        void* dcoef, void* scratch, int B,
                                        int C, int H, int W, int x_bf16,
                                        int need_dx, int need_dcoef,
                                        void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto f = [](void* p) { return static_cast<float*>(p); };
  if (x_bf16)
    hifidiff::launch<__nv_bfloat16>(g, x, coef, dx, f(dcoef), f(scratch), B,
                                    C, H, W, need_dx, need_dcoef, st);
  else
    hifidiff::launch<float>(g, x, coef, dx, f(dcoef), f(scratch), B, C, H,
                            W, need_dx, need_dcoef, st);
  return static_cast<int>(cudaGetLastError());
}
