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
// and the float32 sums over the pixels
//
//   dw += g1 * y,  db += g1      (also over the batch)
//   dscale[n] += g * (y * w + b),  dshift[n] += g
//                                (also over the batch for a (1, C) FiLM).
//
// What bounds it on the card: bytes (x and g read, dx written; a few dozen
// flops per element), and at the refiner step's batch of 32 a launch and
// one trip to device memory: the five maps move 2.1 to 12.6 MB in f32,
// 0.6 to 3.8 us at 3.35 TB/s.
//
// The design: the forward's layout (ln_tile.cuh). Each thread loads its
// vectors of x and g, and the table entries of their channels, before the
// first sum and keeps them in registers; the mean, then in one sum over C
// the centred variance and the two sums of dx (of gw and of gw * (x - mean),
// which is rstd^-1 times the sum of gw * y), then dx are passes over
// registers, each sum over C warp shuffles and at most one shared-memory
// step. The sums over the pixels are taken in registers over a vector's
// pixels, then by shuffles over the block's pixel groups (lanes of one
// warp), and each block writes one row of partial sums per quantity: no
// atomics. A second kernel, launched with programmatic dependent launch so
// that it waits on the device and not on the host, sums those rows in a
// fixed order, over a sample's blocks and over the batch. Where a sample is
// one block and the FiLM is per sample (the three deepest maps of the
// refiner step), dscale and dshift are written in place by the first
// kernel. A call is one or two launches and no memset, and gives the same
// bits run to run.
#include "ln_tile.cuh"

namespace hifidiff {
namespace {

// rows of partial sums: a block's row is blockIdx.y * J + blockIdx.x
template <typename T, int V, int PPV>
__global__ void __launch_bounds__(ln::kMaxThreads)
    ln_film_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       const T* __restrict__ w, const T* __restrict__ b,
                       const T* __restrict__ scale, T* __restrict__ dx,
                       float* __restrict__ pw, float* __restrict__ pb,
                       float* __restrict__ ps, float* __restrict__ pt,
                       ln::Layout L, long long film_stride, float eps,
                       int tab_vec, int need_wb) {
  griddep_launch_dependents();  // the sums may start their prologue
  constexpr int CPV = V / PPV;
  __shared__ __align__(16) float red[2 * ln::kRedSlot];
  const ln::Tile<T, V, PPV, 2, 3> t(
      L, {x, g}, {w, b, scale + blockIdx.y * film_stride}, tab_vec);

  float mean[PPV] = {};
  t.each([&](const auto& v, const auto&, int, long long, bool ok) {
    if (!ok) return;
#pragma unroll
    for (int j = 0; j < V; ++j) mean[j % PPV] += v[0][j];
  });
  ln::column_sum(mean, red, L);
#pragma unroll
  for (int i = 0; i < PPV; ++i) mean[i] /= L.C;
  // one sum over C of the centred variance (first PPV), of gw (next PPV)
  // and of gw * (x - mean) (last PPV); t: w, b, scale of the channels
  float m[3 * PPV] = {};
  t.each([&](const auto& v, const auto& tb, int, long long, bool ok) {
    if (!ok) return;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int i = j % PPV, c = j / PPV;
      const float d = v[0][j] - mean[i];
      const float gw = v[1][j] * (1.f + tb[2][c]) * tb[0][c];
      m[i] += d * d;
      m[PPV + i] += gw;
      m[2 * PPV + i] += gw * d;
    }
  });
  ln::column_sum(m, red + ln::kRedSlot, L);
  // rstd, then the means over C of gw and of gw * y
  float rstd[PPV];
#pragma unroll
  for (int i = 0; i < PPV; ++i) {
    rstd[i] = rsqrtf(m[i] / L.C + eps);
    m[PPV + i] /= L.C;
    m[2 * PPV + i] *= rstd[i] / L.C;
  }

  const long long row =
      ((long long)blockIdx.y * L.J + blockIdx.x) * L.C;
  const int gb = 1 << L.gb_log;
  t.each([&](const auto& v, const auto& tb, int k, long long off, bool ok) {
    float part[4][CPV] = {};  // g1 * y, g1, g * (y * w + b), g
    if (ok) {
      float d[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int i = j % PPV, c = j / PPV;
        const float y = (v[0][j] - mean[i]) * rstd[i];
        const float gv = v[1][j];
        const float g1 = gv * (1.f + tb[2][c]);
        d[j] = rstd[i] * (g1 * tb[0][c] - y * m[2 * PPV + i] - m[PPV + i]);
        part[0][c] += g1 * y;
        part[1][c] += g1;
        part[2][c] += gv * (y * tb[0][c] + tb[1][c]);
        part[3][c] += gv;
      }
      ln::Pack<T, V>::store(dx + off, d);
    }
    // the block's pixel groups of one channel are neighbouring lanes
    for (int o = 1; o < gb; o <<= 1)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < CPV; ++c)
          part[q][c] += __shfl_xor_sync(0xffffffffu, part[q][c], o);
    if (ok && t.gl == 0) {
      const long long at = row + k * CPV;
      if (need_wb) {
        ln::store_f32<CPV>(pw + at, part[0]);
        ln::store_f32<CPV>(pb + at, part[1]);
      }
      ln::store_f32<CPV>(ps + at, part[2]);
      ln::store_f32<CPV>(pt + at, part[3]);
    }
  });
}

constexpr int kSumThreads = 512;
constexpr int kSumLanes = 16;  // row lanes of a long sum, 32 channels each
constexpr int kShortRows = 16;

// out[o][c] = the sum of in[o * rows + r][c] over r < rows, for o < outs.
// A long task (rows > kShortRows: dw and db over the batch) takes blocks of
// 32 channels of one output row, its rows split over 16 lanes; a short one
// (a sample's J rows) one thread an output entry.
struct SumTask {
  const float* in;
  float* out;
  int rows, outs;
};
// up to four tasks; task i takes the blocks [first[i], first[i + 1])
struct SumTasks {
  SumTask t[4];
  int first[5];
};

inline int sum_blocks(const SumTask& t, int C) {
  return t.rows > kShortRows ? t.outs * ((C + 31) / 32)
                             : (int)(((long long)t.outs * C + kSumThreads - 1)
                                     / kSumThreads);
}

// The fixed-order sums of the partial rows.
__global__ void __launch_bounds__(kSumThreads)
    ln_film_bwd_sums(SumTasks tasks, int C) {
  __shared__ float red[kSumLanes][33];
  int i = 0;
  while ((int)blockIdx.x >= tasks.first[i + 1]) ++i;
  const SumTask t = tasks.t[i];
  const int blk = blockIdx.x - tasks.first[i];
  griddep_wait();  // the partial rows are written
  if (t.rows <= kShortRows) {
    const long long e = (long long)blk * kSumThreads + threadIdx.x;
    if (e >= (long long)t.outs * C) return;
    const long long o = e / C, c = e % C;
    const float* in = t.in + o * t.rows * C + c;
    float s = 0.f;
    for (int r = 0; r < t.rows; ++r) s += in[(long long)r * C];
    t.out[e] = s;
    return;
  }
  const int chunks = (C + 31) / 32;
  const int lane = threadIdx.x & 31, y = threadIdx.x >> 5;
  const int o = blk / chunks, c = (blk % chunks) * 32 + lane;
  const float* in = t.in + (long long)o * t.rows * C + c;
  float s = 0.f;
  if (c < C)
#pragma unroll 4
    for (int r = y; r < t.rows; r += kSumLanes) s += in[(long long)r * C];
  red[y][lane] = s;
  __syncthreads();
  if (y == 0 && c < C) {
    float a = 0.f;
#pragma unroll
    for (int l = 0; l < kSumLanes; ++l) a += red[l][lane];
    t.out[(long long)o * C + c] = a;
  }
}

// Where the partial rows go: dscale and dshift in place where a sample is
// one block and the FiLM is per sample, else rows of the scratch buffer;
// and the floats of scratch that takes.
struct Rows {
  long long rows;   // B * J
  bool in_place;
  long long scratch_floats(int C, int need_wb) const {
    return ((need_wb ? 2 : 0) + (in_place ? 0 : 2)) * rows * C;
  }
};

Rows rows_of(const ln::Plan& p, int B, int film_rows) {
  return Rows{(long long)B * p.L.J, p.L.J == 1 && film_rows == B};
}

template <typename T>
struct Backward {
  const ln::Plan& p;
  const void *x, *g, *w, *b, *scale;
  void* dx;
  float *pw, *pb, *ps, *pt;
  int B;
  long long film_stride;
  float eps;
  int need_wb;
  cudaStream_t stream;

  template <int V, int PPV>
  void run() const {
    const int tab_vec =
        ln::rows_aligned(V / PPV, sizeof(T), film_stride, {w, b, scale});
    ln_film_bwd_kernel<T, V, PPV>
        <<<dim3(p.L.J, B), p.threads(), 0, stream>>>(
            static_cast<const T*>(x), static_cast<const T*>(g),
            static_cast<const T*>(w), static_cast<const T*>(b),
            static_cast<const T*>(scale), static_cast<T*>(dx), pw, pb, ps,
            pt, p.L, film_stride, eps, tab_vec, need_wb);
  }
};

template <typename T>
void launch(const void* x, const void* g, const void* w, const void* b,
            const void* scale, void* dx, float* dw, float* db, float* dscale,
            float* dshift, float* scratch, int B, int C, int HW,
            long long film_stride, int film_rows, float eps, int need_wb,
            cudaStream_t stream) {
  const ln::Plan p = ln::make_plan(C, HW, 16 / sizeof(T));
  const Rows r = rows_of(p, B, film_rows);
  const long long n = r.rows * C;
  float* pw = scratch;
  float* pb = scratch + n;
  float* ps = r.in_place ? dscale : scratch + (need_wb ? 2 : 0) * n;
  float* pt = r.in_place ? dshift : ps + n;
  ln::dispatch<T>(p, Backward<T>{p, x, g, w, b, scale, dx, pw, pb, ps, pt,
                                 B, film_stride, eps, need_wb, stream});
  SumTasks tasks = {};
  int count = 0;
  if (need_wb) {
    tasks.t[count++] = {pw, dw, (int)r.rows, 1};
    tasks.t[count++] = {pb, db, (int)r.rows, 1};
  }
  if (!r.in_place) {
    const int per = (int)(r.rows / film_rows);
    tasks.t[count++] = {ps, dscale, per, film_rows};
    tasks.t[count++] = {pt, dshift, per, film_rows};
  }
  if (count == 0) return;
  for (int i = 0; i < 4; ++i)
    tasks.first[i + 1] =
        tasks.first[i] + (i < count ? sum_blocks(tasks.t[i], C) : 0);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tasks.first[count]);
  cfg.blockDim = dim3(kSumThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, ln_film_bwd_sums, tasks, C);
}

template <typename T>
long long scratch_floats(int B, int C, int HW, int need_wb, int film_rows) {
  const ln::Plan p = ln::make_plan(C, HW, 16 / sizeof(T));
  return rows_of(p, B, film_rows).scratch_floats(C, need_wb);
}

}  // namespace
}  // namespace hifidiff

// The float32 scratch `hifidiff_ln_film_bwd` takes for these arguments (0
// where it needs none).
extern "C" long long hifidiff_ln_film_bwd_scratch(int B, int C, int HW,
                                                  int is_bf16, int need_wb,
                                                  int film_rows) {
  using hifidiff::scratch_floats;
  return is_bf16 ? scratch_floats<__nv_bfloat16>(B, C, HW, need_wb, film_rows)
                 : scratch_floats<float>(B, C, HW, need_wb, film_rows);
}

// x, g, dx: (B, C, H, W) contiguous, 16-byte aligned; w, b: (C,); scale:
// `film_rows` (B or 1) rows of C contiguous values `film_stride` elements
// apart (0: one row for the whole batch); all bf16 (is_bf16) or all f32.
// Outputs, float32: dw, db (C,) (unused without need_wb), dscale, dshift
// (film_rows, C); scratch: float32 of the size hifidiff_ln_film_bwd_scratch
// gives. One or two launches on `stream`, no memset. Returns
// cudaGetLastError() after the launches.
extern "C" int hifidiff_ln_film_bwd(const void* x, const void* g,
                                    const void* w, const void* b,
                                    const void* scale, void* dx, void* dw,
                                    void* db, void* dscale, void* dshift,
                                    void* scratch, int B, int C, int HW,
                                    long long film_stride, int film_rows,
                                    float eps, int is_bf16, int need_wb,
                                    void* stream) {
  using hifidiff::launch;
  auto st = static_cast<cudaStream_t>(stream);
  auto f = [](void* p) { return static_cast<float*>(p); };
  if (is_bf16)
    launch<__nv_bfloat16>(x, g, w, b, scale, dx, f(dw), f(db), f(dscale),
                          f(dshift), f(scratch), B, C, HW, film_stride,
                          film_rows, eps, need_wb, st);
  else
    launch<float>(x, g, w, b, scale, dx, f(dw), f(db), f(dscale), f(dshift),
                  f(scratch), B, C, HW, film_stride, film_rows, eps, need_wb,
                  st);
  return static_cast<int>(cudaGetLastError());
}
