// Matrix product with int8-resident weights (w8: int8 weights, bf16
// activations):
//
//   out[M, N] = bf16((x[M, K] @ w_q[N, K]^T) * scale[N])
//
// Replaces the TPU kernel hifidiff_tpu/ops/pallas/int8_matmul.py
// (`matmul_w8`): f32 accumulation, the per-output-channel scale applied to
// the accumulator (no bf16 rounding of `w_q * scale`), and the int8 -> bf16
// cast done on the weight tile on its way into shared memory, so device
// memory only ever sees int8 weight bytes. The bias stays outside, as there.
//
// What bounds it on the card: at the denoiser's shapes (M 50-512, K and N
// 1024-8192) a launch reads 1-8 MB of int8 weights and does 0.1-17 GFLOP;
// with M <= 512 every weight byte is used for at most 1024 operations, so the
// small-M calls are bound by the weight bytes and the M = 512 ones by the
// tensor cores. The tile (gemm_tile.cuh) is a plain 64x64x32 wmma tile with
// register prefetch: it spreads N over N/64 blocks per row tile, so M = 128
// still starts 2 x N/64 blocks. Rows beyond M (the hoisted FiLM projections
// have M = 50) are read as zero and not stored.
#include "gemm_tile.cuh"

namespace hifidiff {
namespace {

struct ScaleOut {
  __nv_bfloat16* out;
  const float* scale;
  int N;
  int M;
  __device__ __forceinline__ void operator()(int row, int col,
                                             float acc) const {
    out[(long long)row * N + col] = __float2bfloat16(acc * scale[col]);
  }
};

}  // namespace
}  // namespace hifidiff

// x: (M, K) bf16 row-major; w_q: (N, K) int8 row-major; scale: (N,) f32;
// out: (M, N) bf16. K % 32 == 0, N % 64 == 0, pointers 16-byte aligned.
// Returns cudaGetLastError() after the launch.
extern "C" int hifidiff_matmul_w8(const void* x, const void* w_q,
                                  const void* scale, void* out, int M, int K,
                                  int N, void* stream) {
  using namespace hifidiff;
  const ADirect al{static_cast<const __nv_bfloat16*>(x), K, M};
  const ScaleOut ep{static_cast<__nv_bfloat16*>(out),
                    static_cast<const float*>(scale), N, M};
  const dim3 grid(N / kBN, (M + kBM - 1) / kBM);
  gemm_kernel<ADirect, int8_t, ScaleOut>
      <<<grid, kGemmThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          al, static_cast<const int8_t*>(w_q), K, ep);
  return static_cast<int>(cudaGetLastError());
}
