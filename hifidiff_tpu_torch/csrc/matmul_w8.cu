// Matrix product with int8-resident weights (w8: int8 weights, bf16
// activations):
//
//   out[M, N] = bf16((x[M, K] @ w_q[N, K]^T) * scale[N])
//
// Replaces the TPU kernel hifidiff_tpu/ops/pallas/int8_matmul.py
// (`matmul_w8`): f32 accumulation, the per-output-channel scale applied to
// the accumulator (no bf16 rounding of `w_q * scale`), and the int8 -> bf16
// cast done on the weight tile in shared memory, so device memory only ever
// sees int8 weight bytes. The bias stays outside, as there.
//
// What bounds it on the card: at the denoiser's shapes (M 50-512, K 256-2048,
// N 1024-8192) a launch reads 1-8 MB of int8 weights and does 0.1-2 GFLOP;
// by the card's peaks the small-M calls are bound by the weight bytes (0.3-3
// us at 3.35 TB/s) and the M = 512 ones by the tensor cores (1-2 us at 989
// TFLOP/s). What a launch waits for in fact is what one SM can take in from
// L2 (its TMA unit delivers a box row every 3.75 clocks, and every column
// tile reads A again) and the sum of the K ranges' partial tiles across SMs;
// gemm_tile.cuh says how the tile meets both: a TMA ring of int8 weights and
// bf16 rows, each weight converted to bf16 once in shared memory, `wgmma`
// from shared memory, the whole of M <= 128 in one 128x128 tile and K split
// over a cluster while the clusters fit the card, the partial sums reduced in
// shared memory before the scale.
// Rows beyond M (the hoisted FiLM projections have M = 50) are read as zero
// and not stored. The launch may start while the kernel before it in the
// stream drains (programmatic dependent launch): it reads x and writes out
// only after that kernel has ended.
#include "gemm_tile.cuh"

namespace hifidiff {
namespace {

struct ScaleOut {
  __nv_bfloat16* out;
  const float* scale;
  int N;
  int M;
  __device__ __forceinline__ void prefetch(int, int, int, int) const {}
  __device__ __forceinline__ void operator()(const float* tile, int lr0,
                                             int lr1, int row0,
                                             int bx) const {
    const int c = bx * kBN + pair_col();
    const float2 s = ldg2(scale + c);
    for_each_row<4>(
        tile, lr0, lr1, row0, M, [](int) { return Nothing{}; },
        [&](int row, float v0, float v1, Nothing) {
          store2(out + (long long)row * N + c, v0 * s.x, v1 * s.y);
        });
  }
};

}  // namespace
}  // namespace hifidiff

// x: (M, K) bf16 row-major; w_q: (N, K) int8 row-major; scale: (N,) f32;
// out: (M, N) bf16. K % 16 == 0, N % 128 == 0, pointers 16-byte aligned.
// Returns cudaGetLastError() after the launch.
extern "C" int hifidiff_matmul_w8(const void* x, const void* w_q,
                                  const void* scale, void* out, int M, int K,
                                  int N, void* stream) {
  using namespace hifidiff;
  const ScaleOut ep{static_cast<__nv_bfloat16*>(out),
                    static_cast<const float*>(scale), N, M};
  launch_gemm(static_cast<const __nv_bfloat16*>(x), M,
              static_cast<const int8_t*>(w_q), N, K, false, ep,
              static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The grid a call of these sizes runs: plan[0..3] = column tiles, row tiles,
// K ranges (blocks per cluster), and how many clusters of that size the card
// holds at once.
extern "C" void hifidiff_matmul_w8_plan(int M, int K, int N, int* plan) {
  using namespace hifidiff;
  const int* resident = resident_clusters<int8_t, ScaleOut>();
  plan[0] = N / kBN;
  plan[1] = (M + kBM - 1) / kBM;
  plan[2] = pick_split(plan[0] * plan[1], K, resident);
  plan[3] = resident[plan[2]];
}
