// Exact bilinear affine warp forward, NCHW, zero padding,
// align_corners=False (F.affine_grid + F.grid_sample semantics).
//
// Replaces the TPU kernel hifidiff_tpu/ops/pallas/warp.py
// (`warp_rowwin_pallas` / `_warp_kernel`), and with it the TPU's two other
// branches of the same warp (the dense interpolation-matrix einsum for maps
// of <= 16x16 and the gather fallback for strong shears,
// hifidiff_tpu/ops/warp.py). The TPU had no fast gather, so it recast the
// warp as hat-matrix matmuls over a window of K source rows, valid only
// while the shear fits the window. A GPU gathers well, so this is the warp
// written directly, one kernel exact for every theta and every map size:
//
//   sx = ax*j + bx*i + cx,  sy = ay*j + by*i + cy     (pixel space, f32)
//   out[n, c, i, j] = sum over the 4 corners of w_corner * x[n, c, corner]
//
// with the coefficients of `pixel_coef` and zero weight for corners outside
// the image. Each mul and add is rounded on its own (__fmul_rn / __fadd_rn,
// no FMA contraction) in the order of the plain PyTorch version, so in f32
// the kernel gives the plain version's bits.
//
// What bounds it on the card: bytes (one read and one write of the map, a
// dozen operations per output element). What holds a gather kernel back on
// an H100 is the rate of its loads: every output element needs four
// scattered 2- or 4-byte reads, and through L1 each one costs as much as a
// coalesced 16-byte read. The design (`plan_of`, the kernel):
//
// * A block takes one sample, one output tile (32 columns, and 32 rows in
//   bf16, 16 in f32, or fewer on a smaller map) and a group of channels. Its
//   coordinates come from blockIdx: no 64-bit division. A thread takes 8
//   bytes of one output row (4 bf16 or 2 f32 pixels), computes their
//   corners' offsets and weights once (on integers, as the forward's float
//   clamps decide them), then walks up to 16 channels of the group,
//   gathering the four corners from shared memory and writing its 8 bytes
//   with one store. (16 bytes a thread, 8 bf16 pixels, needs twice the
//   registers for the offsets and weights: measured slower.)
// * The block maps the tile's four corner pixels through the affine map and
//   takes the bounding box of the source pixels they reach, one pixel wider
//   on each side (rounding) and clamped to the image: every corner the
//   tile's pixels read, clamped as the forward clamps it, lies in that
//   window. The windows are staged in shared memory by `cp.async` in
//   coalesced 16-byte copies (element by element where a row is not whole
//   vectors), four channels a stage, in a ring of three 16 KB buffers: the
//   copies of the next two stages are in flight while a stage is gathered.
// * Where one channel's window exceeds a buffer (a strong zoom-out or shear
//   over a large map), or the coefficients are so large that the rounding
//   of the window's corners could exceed its margin, the same kernel
//   gathers that tile's corners from device memory instead.
// * The grid holds at least four blocks an SM where it can (fewer channels
//   a block at small batches), and a block at least 128 threads (several
//   channels at once on the deep maps, 16^2 and 8^2).
#include "common.cuh"

namespace hifidiff {
namespace {

constexpr int kMaxThreads = 256;
constexpr int kMinThreads = 128;       // a block's threads, where it can
constexpr int kGroups = 256;           // pixel groups a tile
constexpr int kTileCols = 32;          // pixels a tile row
constexpr int kMaxK = 16;              // channels a thread
constexpr int kPerLane = 4;            // channels a lane takes in a stage
constexpr int kStages = 3;             // staging buffers: two stages ahead
constexpr int kStageBytes = 16 * 1024; // one staging buffer
constexpr int kItems = 4;              // 16-byte copies a thread makes a stage
// pixels a thread: 8 bytes of one output row
template <typename T>
constexpr int kPx = 8 / (int)sizeof(T);

// A launch's shape: tile rows and columns, threads per pixel group
// (`lanes`), channels a block (lanes times up to kMaxK).
struct WarpPlan {
  int th, tw, lanes, chans;
};

// The tile: 32 columns (or the map's width) and as many rows as make 256
// groups of px pixels. One thread a group, more (`lanes`, each its own
// channels) where the tile has fewer than 128 groups. The channels a block
// takes: up to 16 a lane, fewer where the grid would not hold four blocks
// an SM; then fewer lanes, down to one, where it would not hold two.
WarpPlan plan_of(int B, int C, int H, int W, int px) {
  WarpPlan p;
  p.tw = W < kTileCols ? W : kTileCols;
  const int groups_row = (p.tw + px - 1) / px;
  p.th = kGroups / groups_row;
  if (p.th > H) p.th = H;
  const int groups = p.th * groups_row;
  p.lanes = groups >= kMinThreads ? 1 : (kMinThreads + groups - 1) / groups;
  const long long tiles =
      (long long)((H + p.th - 1) / p.th) * ((W + p.tw - 1) / p.tw);
  const long long want = 4LL * multiprocessors();
  auto blocks = [&](int chans) {
    return B * tiles * ((C + chans - 1) / chans);
  };
  int k = kMaxK;
  while (k > 1 && blocks(p.lanes * k) < want) k /= 2;
  while (k == 1 && p.lanes > 1 && blocks(p.lanes) < want / 2) p.lanes /= 2;
  p.chans = p.lanes * k;
  return p;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A corner coordinate as the forward's float clamps decide it: `x0` =
// floor(s) and x0 + 1, each inside [0, n - 1] or not, clamped into it.
// Computed on integers: x0 is first clamped into [-2, n] (which keeps the
// decisions: -2 and -1 are both outside, n and n + 1 too; NaN becomes -2).
struct Corner {
  int c0, c1;      // clamped coordinates of x0 and x0 + 1
  bool in0, in1;   // inside the image
};
__device__ __forceinline__ Corner corner(float x0, int n) {
  const int i = (int)fminf(fmaxf(x0, -2.f), (float)n);
  Corner k;
  k.in0 = (unsigned)i < (unsigned)n;
  k.in1 = (unsigned)(i + 1) < (unsigned)n;
  k.c0 = min(max(i, 0), n - 1);
  k.c1 = min(max(i + 1, 0), n - 1);
  return k;
}

__host__ __device__ __forceinline__ int groups_of(const WarpPlan& p, int px) {
  return p.th * ((p.tw + px - 1) / px);
}

// A thread's pixels as one 8-byte store.
__device__ __forceinline__ void store_px(float* dst, const float* acc) {
  *reinterpret_cast<float2*>(dst) = make_float2(acc[0], acc[1]);
}
__device__ __forceinline__ void store_px(__nv_bfloat16* dst,
                                         const float* acc) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(acc[0], acc[1]),
                         __floats2bfloat162_rn(acc[2], acc[3])};
  *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(h);
}

// The PX pixels' bilinear sums of one channel plane `src` (shared memory, or
// device memory read through the read-only path with GLOBAL), each product
// and sum rounded on its own in the plain version's order.
template <bool GLOBAL, typename T, int PX>
__device__ __forceinline__ void gather(const T* __restrict__ src,
                                       const int (&off)[PX][4],
                                       const float (&wt)[PX][4], float* acc) {
  auto ld = [&](int o) {
    if constexpr (GLOBAL) return to_f32(__ldg(src + o));
    else return to_f32(src[o]);
  };
#pragma unroll
  for (int e = 0; e < PX; ++e) {
    float v = __fmul_rn(ld(off[e][0]), wt[e][0]);
    v = __fadd_rn(v, __fmul_rn(ld(off[e][1]), wt[e][1]));
    v = __fadd_rn(v, __fmul_rn(ld(off[e][2]), wt[e][2]));
    v = __fadd_rn(v, __fmul_rn(ld(off[e][3]), wt[e][3]));
    acc[e] = v;
  }
}

// VEC: rows are whole 16-byte vectors (W a multiple of 16 bytes' pixels,
// the tensors 16-byte aligned): vector staging and 8-byte stores.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kMaxThreads, 3)
    affine_warp_kernel(const T* __restrict__ x, const float* __restrict__ coef,
                       T* __restrict__ out, int C, int H, int W, WarpPlan p,
                       int tiles_w) {
  constexpr int PX = kPx<T>;          // pixels a thread
  constexpr int V = 16 / sizeof(T);  // pixels a 16-byte copy
  __shared__ __align__(16) unsigned char smem[kStages][kStageBytes];
  const int n = blockIdx.z;
  const int c_begin = blockIdx.y * p.chans;
  const int nch = min(p.chans, C - c_begin);
  const int ti = blockIdx.x / tiles_w, tj = blockIdx.x - ti * tiles_w;
  const int i0 = ti * p.th, j0 = tj * p.tw;
  const int i1 = min(i0 + p.th, H) - 1, j1 = min(j0 + p.tw, W) - 1;
  const float* cf = coef + n * 6;
  const float ax = cf[0], bx = cf[1], cx = cf[2];
  const float ay = cf[3], by = cf[4], cy = cf[5];
  const long long HW = (long long)H * W;
  const long long plane0 = ((long long)n * C + c_begin) * HW;

  // The source window of the tile. Each rounded operation of a coordinate
  // is off by at most 2^-24 of |ax| W + |bx| H + |cx| (or the y row's):
  // below 2^20 that is far under the window's one-pixel margin.
  const float mag = fmaxf(fabsf(ax) * W + fabsf(bx) * H + fabsf(cx),
                          fabsf(ay) * W + fabsf(by) * H + fabsf(cy));
  int y_lo = 0, x_lo = 0, rows = H, pitch = W;
  bool staged = mag < 1048576.f;  // false for NaN
  if (staged) {
    const float fi0 = (float)i0, fi1 = (float)i1;
    const float fj0 = (float)j0, fj1 = (float)j1;
    const float bx0 = __fmul_rn(bx, fi0), bx1 = __fmul_rn(bx, fi1);
    const float by0 = __fmul_rn(by, fi0), by1 = __fmul_rn(by, fi1);
    const float axa = __fmul_rn(ax, fj0), axb = __fmul_rn(ax, fj1);
    const float aya = __fmul_rn(ay, fj0), ayb = __fmul_rn(ay, fj1);
    const float sx0 = __fadd_rn(__fadd_rn(axa, bx0), cx),
                sx1 = __fadd_rn(__fadd_rn(axb, bx0), cx),
                sx2 = __fadd_rn(__fadd_rn(axa, bx1), cx),
                sx3 = __fadd_rn(__fadd_rn(axb, bx1), cx);
    const float sy0 = __fadd_rn(__fadd_rn(aya, by0), cy),
                sy1 = __fadd_rn(__fadd_rn(ayb, by0), cy),
                sy2 = __fadd_rn(__fadd_rn(aya, by1), cy),
                sy3 = __fadd_rn(__fadd_rn(ayb, by1), cy);
    const int xa = (int)floorf(fminf(fminf(sx0, sx1), fminf(sx2, sx3))) - 1;
    const int xb = (int)floorf(fmaxf(fmaxf(sx0, sx1), fmaxf(sx2, sx3))) + 2;
    const int ya = (int)floorf(fminf(fminf(sy0, sy1), fminf(sy2, sy3))) - 1;
    const int yb = (int)floorf(fmaxf(fmaxf(sy0, sy1), fmaxf(sy2, sy3))) + 2;
    y_lo = min(max(ya, 0), H - 1);
    const int y_hi = min(max(yb, 0), H - 1);
    x_lo = min(max(xa, 0), W - 1);
    int x_hi = min(max(xb, 0), W - 1);
    if (VEC) {  // whole vectors: W is a multiple of V
      x_lo &= ~(V - 1);
      x_hi |= V - 1;
    }
    rows = y_hi - y_lo + 1;
    pitch = x_hi - x_lo + 1;
    staged = (long long)rows * pitch * sizeof(T) <= kStageBytes;
    if (!staged) y_lo = x_lo = 0, rows = H, pitch = W;
  }
  const int per = rows * pitch;
  // channels a stage: kPerLane a lane, fewer where their windows do not fit
  const int cs =
      staged ? min(p.lanes * kPerLane, kStageBytes / (int)(per * sizeof(T)))
             : p.lanes * kPerLane;
  const int stages = (nch + cs - 1) / cs;

  // Stage s: the windows of channels [s cs, + cs) into buffer s % kStages,
  // one cp.async group (element by element, at once, where rows are not
  // whole vectors). Every thread commits a group for every stage, empty or
  // not.
  // With VEC, a stage is cs * rows * (pitch / V) 16-byte copies, the same
  // for every stage but the channel planes' base: where they are at most
  // kItems a thread, their offsets are worked out once.
  const int vpr = pitch / V, copies = cs * rows * vpr;
  const bool few = VEC && copies <= kItems * (int)blockDim.x &&
                   (long long)cs * HW < (1LL << 31);
  int it_src[kItems], it_dst[kItems], it_c[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int q = threadIdx.x + k * blockDim.x;
    it_c[k] = 1 << 30;
    it_src[k] = it_dst[k] = 0;
    if (few && staged && q < copies) {
      const int row = q / vpr, v = q - row * vpr;
      const int c = row / rows;
      it_c[k] = c;
      it_dst[k] = row * pitch + v * V;
      it_src[k] = c * (int)HW + (row - c * rows) * W + v * V;
    }
  }
  auto issue = [&](int s) {
    const int c0 = s * cs, m = s < stages ? min(cs, nch - c0) : 0;
    const T* base = x + plane0 + c0 * HW + (long long)y_lo * W + x_lo;
    T* win = reinterpret_cast<T*>(smem[s % kStages]);
    if (few) {
#pragma unroll
      for (int k = 0; k < kItems; ++k)
        if (it_c[k] < m) cp_async16(win + it_dst[k], base + it_src[k]);
    } else if (VEC) {
      for (int q = threadIdx.x; q < m * rows * vpr; q += blockDim.x) {
        const int row = q / vpr, v = q - row * vpr;
        const int c = row / rows;
        cp_async16(win + row * pitch + v * V,
                   base + c * HW + (long long)(row - c * rows) * W + v * V);
      }
    } else {
      for (int q = threadIdx.x; q < m * per; q += blockDim.x) {
        const int c = q / per, e = q - c * per;
        const int row = e / pitch;
        win[q] = base[c * HW + (long long)row * W + (e - row * pitch)];
      }
    }
    cp_async_commit();
  };
  // the first kStages - 1 stages in flight while the corners are computed
  if (staged)
    for (int s = 0; s + 1 < kStages; ++s) issue(s);

  // this thread's PX pixels of one output row: tile row r, pixel group q
  const int groups_row = (p.tw + PX - 1) / PX;
  const int groups = groups_of(p, PX);
  const int g = threadIdx.x % groups, lane = threadIdx.x / groups;
  const int r = g / groups_row;
  const int i = i0 + r, jb = j0 + (g - r * groups_row) * PX;
  const bool row_ok = i <= i1;
  const float fi = (float)i;
  const float bxi = __fmul_rn(bx, fi), byi = __fmul_rn(by, fi);
  int off[PX][4];
  float wt[PX][4];
#pragma unroll
  for (int e = 0; e < PX; ++e) {
    const float fj = (float)(jb + e);
    const float sx = __fadd_rn(__fadd_rn(__fmul_rn(ax, fj), bxi), cx);
    const float sy = __fadd_rn(__fadd_rn(__fmul_rn(ay, fj), byi), cy);
    const float x0 = floorf(sx);
    const float y0 = floorf(sy);
    const float fx = __fsub_rn(sx, x0);
    const float fy = __fsub_rn(sy, y0);
    const float gx = __fsub_rn(1.f, fx);
    const float gy = __fsub_rn(1.f, fy);
    const Corner kx = corner(x0, W), ky = corner(y0, H);
    // corners in the order (y0,x0), (y0,x1), (y1,x0), (y1,x1)
    const bool ok = row_ok && jb + e <= j1;
    const int r0 = (ky.c0 - y_lo) * pitch - x_lo;
    const int r1 = (ky.c1 - y_lo) * pitch - x_lo;
    off[e][0] = ok ? r0 + kx.c0 : 0;
    off[e][1] = ok ? r0 + kx.c1 : 0;
    off[e][2] = ok ? r1 + kx.c0 : 0;
    off[e][3] = ok ? r1 + kx.c1 : 0;
    wt[e][0] = ky.in0 && kx.in0 ? __fmul_rn(gx, gy) : 0.f;
    wt[e][1] = ky.in0 && kx.in1 ? __fmul_rn(fx, gy) : 0.f;
    wt[e][2] = ky.in1 && kx.in0 ? __fmul_rn(gx, fy) : 0.f;
    wt[e][3] = ky.in1 && kx.in1 ? __fmul_rn(fx, fy) : 0.f;
  }

  for (int s = 0; s < stages; ++s) {
    if (staged) {
      issue(s + kStages - 1);
      cp_async_wait<kStages - 1>();  // stage s has landed
      __syncthreads();
    }
    const int m = min(cs, nch - s * cs);
    for (int cc = lane; cc < m; cc += p.lanes) {
      const int c = s * cs + cc;
      float acc[PX];
      if (staged)
        gather<false, T, PX>(
            reinterpret_cast<const T*>(smem[s % kStages]) + cc * per, off, wt,
            acc);
      else
        gather<true, T, PX>(x + plane0 + c * HW, off, wt, acc);
      if (!row_ok) continue;
      T* dst = out + plane0 + c * HW + (long long)i * W + jb;
      if (VEC && jb + PX - 1 <= j1) {
        store_px(dst, acc);
      } else {
#pragma unroll
        for (int e = 0; e < PX; ++e)
          if (jb + e <= j1) dst[e] = from_f32<T>(acc[e]);
      }
    }
    if (staged) __syncthreads();  // buffer s % kStages is free again
  }
}

template <typename T>
void launch(const void* x, const void* coef, void* out, int B, int C, int H,
            int W, cudaStream_t stream) {
  constexpr int PX = kPx<T>;
  constexpr int V = 16 / sizeof(T);
  const WarpPlan p = plan_of(B, C, H, W, PX);
  const int tiles_w = (W + p.tw - 1) / p.tw;
  const int tiles = tiles_w * ((H + p.th - 1) / p.th);
  const int groups = groups_of(p, PX);
  const dim3 grid(tiles, (C + p.chans - 1) / p.chans, B);
  const bool vec = W % V == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  auto kern = vec ? affine_warp_kernel<T, true> : affine_warp_kernel<T, false>;
  kern<<<grid, groups * p.lanes, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(coef),
      static_cast<T*>(out), C, H, W, p, tiles_w);
}

}  // namespace
}  // namespace hifidiff

// x, out: (B, C, H, W) contiguous, f32 or bf16 (x_bf16); coef: (B, 6) f32
// [ax, bx, cx, ay, by, cy]. Returns cudaGetLastError() after the launch.
extern "C" int hifidiff_affine_warp(const void* x, const void* coef, void* out,
                                    int B, int C, int H, int W, int x_bf16,
                                    void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    hifidiff::launch<__nv_bfloat16>(x, coef, out, B, C, H, W, st);
  else
    hifidiff::launch<float>(x, coef, out, B, C, H, W, st);
  return static_cast<int>(cudaGetLastError());
}
