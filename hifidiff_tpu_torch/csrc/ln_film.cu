// Fused LayerNorm2d + FiLM forward, NCHW.
//
// Replaces the TPU kernel hifidiff_tpu/ops/pallas/ln_film.py
// (`ln_film_pallas`, forward `_fwd` / `_fwd_kernel`). Per pixel (n, p):
//
//   y   = (x[n, :, p] - mean_C) * rsqrt(var_C + eps)      (f32 statistics)
//   out = (y * w + b) * (1 + scale[n]) + shift[n]
//
// with the centred variance (mean first, as `_fwd_kernel` computes it), and
// a per-sample (B, C) FiLM or a (1, C) FiLM broadcast over the batch
// (film_stride == 0) without materialising it.
//
// What bounds it on the card: bytes. Every element is read and written once
// from device memory; the arithmetic is a few flops per element. On the
// default path the maps run from 16x16 x 128 channels (16.8 MB a call at
// batch 128 in bf16, 5.0 us at 3.35 TB/s) to 1x1 x 2048 (1.05 MB, 0.31 us),
// so the deep maps are set by a launch and one trip to device memory, and
// what counts is the bytes in flight: the whole 1x1 map is.
//
// The design (ln_tile.cuh): each thread loads its 4 16-byte vectors of the
// tile, and the (C,) tables' and FiLM rows' entries of their channels, before
// the first sum and keeps them in registers, so the tables' latency hides
// behind the map's; the mean, the centred variance and the output are
// passes over registers, each sum over C a butterfly of warp shuffles and,
// where a pixel group spans several warps, one shared-memory step with one
// or two barriers; the output goes out 16 bytes a thread. Blocks of at most
// 256 threads take up to 8 pixel groups of one sample: the 16x16 maps start
// 4 blocks a sample in bf16 and 8 in f32, the 8x8 maps 2 and 4, and every
// map at least one.
#include "ln_tile.cuh"

namespace hifidiff {
namespace {

template <typename T, int V, int PPV>
__global__ void __launch_bounds__(ln::kMaxThreads)
    ln_film_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ b, const T* __restrict__ scale,
                   const T* __restrict__ shift, T* __restrict__ out,
                   ln::Layout L, long long film_stride, float eps,
                   int tab_vec) {
  __shared__ __align__(16) float red[2 * ln::kRedSlot];
  const long long film = blockIdx.y * film_stride;
  const ln::Tile<T, V, PPV, 1, 4> t(
      L, {x}, {w, b, scale + film, shift + film}, tab_vec);

  float mean[PPV] = {}, rstd[PPV] = {};
  t.each([&](const auto& v, const auto&, int, long long, bool ok) {
    if (!ok) return;
#pragma unroll
    for (int j = 0; j < V; ++j) mean[j % PPV] += v[0][j];
  });
  ln::column_sum(mean, red, L);
#pragma unroll
  for (int i = 0; i < PPV; ++i) mean[i] /= L.C;
  t.each([&](const auto& v, const auto&, int, long long, bool ok) {
    if (!ok) return;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = v[0][j] - mean[j % PPV];
      rstd[j % PPV] += d * d;
    }
  });
  ln::column_sum(rstd, red + ln::kRedSlot, L);
#pragma unroll
  for (int i = 0; i < PPV; ++i) rstd[i] = rsqrtf(rstd[i] / L.C + eps);

  // t: w, b, scale, shift of the vector's channels
  t.each([&](const auto& v, const auto& tb, int, long long off, bool ok) {
    if (!ok) return;
    float o[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int i = j % PPV, c = j / PPV;
      const float y = (v[0][j] - mean[i]) * rstd[i];
      o[j] = (y * tb[0][c] + tb[1][c]) * (1.f + tb[2][c]) + tb[3][c];
    }
    ln::Pack<T, V>::store(out + off, o);
  });
}

template <typename T>
struct Forward {
  const ln::Plan& p;
  const void *x, *w, *b, *scale, *shift;
  void* out;
  int B;
  long long film_stride;
  float eps;
  cudaStream_t stream;

  template <int V, int PPV>
  void run() const {
    const int tab_vec = ln::rows_aligned(V / PPV, sizeof(T), film_stride,
                                         {w, b, scale, shift});
    ln_film_kernel<T, V, PPV>
        <<<dim3(p.L.J, B), p.threads(), 0, stream>>>(
            static_cast<const T*>(x), static_cast<const T*>(w),
            static_cast<const T*>(b), static_cast<const T*>(scale),
            static_cast<const T*>(shift), static_cast<T*>(out), p.L,
            film_stride, eps, tab_vec);
  }
};

template <typename T>
void launch(const void* x, const void* w, const void* b, const void* scale,
            const void* shift, void* out, int B, int C, int HW,
            long long film_stride, float eps, cudaStream_t stream) {
  const ln::Plan p = ln::make_plan(C, HW, 16 / sizeof(T));
  ln::dispatch<T>(p, Forward<T>{p, x, w, b, scale, shift, out, B,
                                film_stride, eps, stream});
}

}  // namespace
}  // namespace hifidiff

// x, out: (B, C, H, W) contiguous, 16-byte aligned; w, b: (C,); scale,
// shift: rows of C contiguous values, `film_stride` elements apart (0
// broadcasts one row over the batch). All six share one dtype: bf16
// (is_bf16) or f32. Returns cudaGetLastError() after the launch.
extern "C" int hifidiff_ln_film(const void* x, const void* w, const void* b,
                                const void* scale, const void* shift,
                                void* out, int B, int C, int HW,
                                long long film_stride, float eps, int is_bf16,
                                void* stream) {
  using hifidiff::launch;
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<__nv_bfloat16>(x, w, b, scale, shift, out, B, C, HW, film_stride,
                          eps, st);
  else
    launch<float>(x, w, b, scale, shift, out, B, C, HW, film_stride, eps, st);
  return static_cast<int>(cudaGetLastError());
}
