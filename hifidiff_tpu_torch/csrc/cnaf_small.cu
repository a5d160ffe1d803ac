// One whole ConditionalNAFBlock on a 1x1 or 2x2 map, as (M = B * sp, C) rows
// (sp = H * W positions per sample, rows sample-major).
//
// Replaces the TPU kernel hifidiff_tpu/ops/pallas/naf_block.py
// (`cnaf_small_stack_pallas`, bodies `_cnaf_kernel` / `_cnaf_kernel_whole`):
//
//   h   = bf16(LN(x) * w1a + b1a)            LN affine and FiLM folded
//   t1  = (h @ W1) * s1 + bias1              s* = int8 scales (1 for bf16)
//   t1  = mix(t1) + dw_bias                  3x3 depthwise = (sp, sp) mix
//   u   = t1[:, :C] * t1[:, C:]              SimpleGate
//   g   = (bf16(mean_sp u) @ Wsca) * s_sca + b_sca       SCA
//   y1  = x + ((bf16(u * g) @ W3) * s3 + b3) * beta
//   h2  = bf16(LN(y1) * w2a + b2a)
//   t4  = (h2 @ W4) * s4 + b4
//   out = bf16(y1 + ((bf16(t4[:, :C] * t4[:, C:]) @ W5) * s5 + b5) * gamma)
//
// with f32 accumulation and the activations rounded to bf16 only where they
// enter a product, as in the TPU kernel. The folded LN rows are computed
// here from the LN weights and the step's FiLM row (w * (1 + scale),
// b * (1 + scale) + shift), so nothing is packed per step on the host.
//
// What bounds it on the card: the five products stream 7 C^2 weights (29 MB
// int8, 59 MB bf16 at C = 2048) and do 2 M 7 C^2 operations (7.5 GFLOP at
// both of the denoiser's shapes): bytes at M = 128, the tensor cores at
// M = 512. Everything between the products is a few bytes per row.
//
// Design: a fixed chain of five kernels launched by one call, each a product
// on the shared tensor-core tile (gemm_tile.cuh) with its prologue and
// epilogue fused. Each LayerNorm and the SCA pool need whole rows that the
// column-split product before them wrote, so the chain has a kernel boundary
// at exactly those points (a cooperative single kernel would need a
// grid-wide barrier there and would cap the grid at the resident blocks).
// The intermediates (u, g, y1 in f32; the pooled rows and the gated FFN rows
// in bf16) go through a scratch buffer of at most 10.6 MB that stays in L2.
//   1. LN1+FiLM prologue, C -> 2C product with columns n and n + C in one
//      tile, epilogue: scale, bias, position mix, SimpleGate, pool
//   2. pooled rows, C -> C, epilogue: scale, bias (the SCA gate g)
//   3. gate prologue (u * g), C -> C, epilogue: scale, bias, beta residual
//   4. LN2+FiLM prologue on y1, C -> 2C, epilogue: scale, bias, SimpleGate
//   5. C -> C, epilogue: scale, bias, gamma residual, round to bf16
// Both weight types (bf16, int8 with scales) go through the same bodies.
#include "gemm_tile.cuh"

namespace hifidiff {
namespace {

constexpr int kMaxC = 2048;  // the folded LN rows live in shared memory

// LayerNorm parameters and the FiLM row of one norm, in the I/O dtype.
struct LnParams {
  const __nv_bfloat16* w;
  const __nv_bfloat16* b;
  const __nv_bfloat16* scale;
  const __nv_bfloat16* shift;
};

// Per-column vectors of a (C -> 2C) product, all f32 of length 2C.
struct GateVecs {
  const float* s;     // int8 scales (ones for bf16 weights)
  const float* b;     // conv bias
  const float* dw;    // (sp * sp, 2C) position-mix taps   (kernel 1 only)
  const float* dwb;   // depthwise bias                    (kernel 1 only)
};

__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(h[0]), c = __bfloat1622float2(h[1]);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = c.x;
  f[3] = c.y;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Kernels 1 and 4: LN+FiLM prologue, (C -> 2C) product, gate epilogue.
// MIX: kernel 1 (position mix, f32 u and bf16 pooled rows out); otherwise
// kernel 4 (bf16 gated rows out). Grid: (C / 32, ceil(M / 64)); C % 128 == 0.
template <typename S, typename WT, bool MIX>
__global__ void __launch_bounds__(kGemmThreads)
    ln_gemm_gate_kernel(const S* __restrict__ x, LnParams ln,
                        const WT* __restrict__ w, GateVecs v,
                        float* __restrict__ u_out,
                        __nv_bfloat16* __restrict__ h_out, int M, int C,
                        int sp, float eps) {
  __shared__ GemmSmem sm;
  __shared__ float wa[kMaxC], ba[kMaxC];
  __shared__ float mean[kBM], rstd[kBM];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * (kBN / 2);
  const int row0 = blockIdx.y * kBM;

  for (int k = tid; k < C; k += kGemmThreads) {
    const float sc = 1.f + __bfloat162float(ln.scale[k]);
    wa[k] = __bfloat162float(ln.w[k]) * sc;
    ba[k] = __bfloat162float(ln.b[k]) * sc + __bfloat162float(ln.shift[k]);
  }
  // row statistics: one warp per row, two passes (mean, centred variance)
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < kBM; r += kGemmThreads / 32) {
    const int row = row0 + r;
    float m = 0.f, rs = 0.f;
    if (row < M) {
      const S* xr = x + (long long)row * C;
      float s = 0.f;
      for (int k = lane * 4; k < C; k += 128) {
        float f[4];
        load4(xr + k, f);
        s += (f[0] + f[1]) + (f[2] + f[3]);
      }
      m = warp_sum(s) / C;
      float q = 0.f;
      for (int k = lane * 4; k < C; k += 128) {
        float f[4];
        load4(xr + k, f);
#pragma unroll
        for (int j = 0; j < 4; ++j) q += (f[j] - m) * (f[j] - m);
      }
      rs = rsqrtf(warp_sum(q) / C + eps);
    }
    if (lane == 0) {
      mean[r] = m;
      rstd[r] = rs;
    }
  }
  __syncthreads();

  const ALayerNorm<S> al{x, C, M, mean, rstd, wa, ba};
  gemm_mainloop(al, w, C, row0, n0, C + n0, sm);

  // tile column j < 32 is output column n0 + j, column 32 + j is C + n0 + j
  const float* ct = sm.c();
  constexpr int H = kBN / 2;
  if (MIX) {
    const int twoC = 2 * C;
    for (int idx = tid; idx < (kBM / sp) * H; idx += kGemmThreads) {
      const int j = idx % H;
      const int r0 = (idx / H) * sp;   // first tile row of the sample
      if (row0 + r0 >= M) continue;
      const int ca = n0 + j, cb = C + n0 + j;
      float ta[4], tb[4];
      for (int q = 0; q < sp; ++q) {
        ta[q] = ct[(r0 + q) * kLdC + j] * v.s[ca] + v.b[ca];
        tb[q] = ct[(r0 + q) * kLdC + H + j] * v.s[cb] + v.b[cb];
      }
      float pool = 0.f;
      for (int p = 0; p < sp; ++p) {
        const float* dwp = v.dw + (long long)(p * sp) * twoC;
        float ma = dwp[ca] * ta[0], mb = dwp[cb] * tb[0];
        for (int q = 1; q < sp; ++q) {
          ma += dwp[q * twoC + ca] * ta[q];
          mb += dwp[q * twoC + cb] * tb[q];
        }
        const float uu = (ma + v.dwb[ca]) * (mb + v.dwb[cb]);
        u_out[(long long)(row0 + r0 + p) * C + ca] = uu;
        pool += uu;
      }
      h_out[(long long)((row0 + r0) / sp) * C + ca] =
          __float2bfloat16(pool / sp);
    }
  } else {
    for (int idx = tid; idx < kBM * H; idx += kGemmThreads) {
      const int j = idx % H, r = idx / H;
      if (row0 + r >= M) continue;
      const int ca = n0 + j, cb = C + n0 + j;
      const float ta = ct[r * kLdC + j] * v.s[ca] + v.b[ca];
      const float tb = ct[r * kLdC + H + j] * v.s[cb] + v.b[cb];
      h_out[(long long)(row0 + r) * C + ca] = __float2bfloat16(ta * tb);
    }
  }
}

// out_f32[row, n] = acc * s[n] + b[n]
struct AffineOut {
  float* out;
  const float* s;
  const float* b;
  int N;
  int M;
  __device__ __forceinline__ void operator()(int row, int col,
                                             float acc) const {
    out[(long long)row * N + col] = acc * s[col] + b[col];
  }
};

// out[row, n] = res[row, n] + (acc * s[n] + b[n]) * g[n]
template <typename ResT, typename OutT>
struct ResidualOut {
  OutT* out;
  const ResT* res;
  const float* s;
  const float* b;
  const float* g;
  int N;
  int M;
  __device__ __forceinline__ void operator()(int row, int col,
                                             float acc) const {
    const long long i = (long long)row * N + col;
    out[i] = from_f32<OutT>(to_f32(res[i]) + (acc * s[col] + b[col]) * g[col]);
  }
};

// Rows of the packed per-channel vectors `vec_c` (8, C).
enum { kBeta, kGamma, kSsca, kBsca, kS3, kB3, kS5, kB5 };

template <typename WT>
void launch_block(const __nv_bfloat16* x, __nv_bfloat16* out,
                  const __nv_bfloat16* ln, const __nv_bfloat16* film,
                  const float* vec_c, const float* vec_2c,
                  const float* vec_dw, const void* const* weights,
                  float* scratch, int M, int C, int sp, float eps,
                  cudaStream_t st) {
  const WT* w1 = static_cast<const WT*>(weights[0]);
  const WT* wsca = static_cast<const WT*>(weights[1]);
  const WT* w3 = static_cast<const WT*>(weights[2]);
  const WT* w4 = static_cast<const WT*>(weights[3]);
  const WT* w5 = static_cast<const WT*>(weights[4]);
  const int B = M / sp;
  const long long mc = (long long)M * C, bc = (long long)B * C;
  // scratch (f32 units): u (M, C) f32 | y1 (M, C) f32 | g (B, C) f32 |
  // pooled (B, C) bf16 | gated FFN rows (M, C) bf16
  float* u = scratch;
  float* y1 = u + mc;
  float* g = y1 + mc;
  __nv_bfloat16* pooled = reinterpret_cast<__nv_bfloat16*>(g + bc);
  __nv_bfloat16* u2 = pooled + bc;
  // film row: [shift_att, scale_att, shift_ffn, scale_ffn]; ln: [w1, b1, w2, b2]
  const LnParams ln1{ln, ln + C, film + C, film};
  const LnParams ln2{ln + 2 * C, ln + 3 * C, film + 3 * C, film + 2 * C};
  const int twoC = 2 * C;
  const GateVecs v1{vec_2c, vec_2c + twoC, vec_dw, vec_2c + 4 * twoC};
  const GateVecs v4{vec_2c + 2 * twoC, vec_2c + 3 * twoC, nullptr, nullptr};
  const float* vc = vec_c;
  const int mt = (M + kBM - 1) / kBM, bt = (B + kBM - 1) / kBM;
  const dim3 gate_grid(C / (kBN / 2), mt), sca_grid(C / kBN, bt),
      cc_grid(C / kBN, mt);

  ln_gemm_gate_kernel<__nv_bfloat16, WT, true>
      <<<gate_grid, kGemmThreads, 0, st>>>(x, ln1, w1, v1, u, pooled, M, C,
                                           sp, eps);
  gemm_kernel<ADirect, WT, AffineOut><<<sca_grid, kGemmThreads, 0, st>>>(
      ADirect{pooled, C, B}, wsca, C,
      AffineOut{g, vc + kSsca * C, vc + kBsca * C, C, B});
  gemm_kernel<AGate, WT, ResidualOut<__nv_bfloat16, float>>
      <<<cc_grid, kGemmThreads, 0, st>>>(
          AGate{u, g, C, M, sp}, w3, C,
          ResidualOut<__nv_bfloat16, float>{y1, x, vc + kS3 * C, vc + kB3 * C,
                                            vc + kBeta * C, C, M});
  ln_gemm_gate_kernel<float, WT, false>
      <<<gate_grid, kGemmThreads, 0, st>>>(y1, ln2, w4, v4, nullptr, u2, M, C,
                                           sp, eps);
  gemm_kernel<ADirect, WT, ResidualOut<float, __nv_bfloat16>>
      <<<cc_grid, kGemmThreads, 0, st>>>(
          ADirect{u2, C, M}, w5, C,
          ResidualOut<float, __nv_bfloat16>{out, y1, vc + kS5 * C,
                                            vc + kB5 * C, vc + kGamma * C, C,
                                            M});
}

}  // namespace
}  // namespace hifidiff

// x, out: (M, C) bf16 rows, M = B * sp, sp in {1, 4}; ln: (4, C) bf16
// [norm1.weight, norm1.bias, norm2.weight, norm2.bias]; film: (4C,) bf16
// [shift_att, scale_att, shift_ffn, scale_ffn]; vec_c: (8, C) f32 [beta,
// gamma, s_sca, b_sca, s3, b3, s5, b5]; vec_2c: (5, 2C) f32 [s1, b1, s4, b4,
// dw_bias]; vec_dw: (sp * sp, 2C) f32; w1, w4: (2C, C), wsca, w3, w5: (C, C),
// all bf16 or all int8 (w_int8); scratch: (5 M C + 3 B C) / 2 floats.
// C % 128 == 0, C <= 2048, pointers 16-byte aligned. Returns
// cudaGetLastError() after the five launches.
extern "C" int hifidiff_cnaf_small(const void* x, void* out, const void* ln,
                                   const void* film, const void* vec_c,
                                   const void* vec_2c, const void* vec_dw,
                                   const void* w1, const void* wsca,
                                   const void* w3, const void* w4,
                                   const void* w5, void* scratch, int M,
                                   int C, int sp, int w_int8, float eps,
                                   void* stream) {
  using namespace hifidiff;
  const void* weights[5] = {w1, wsca, w3, w4, w5};
  auto st = static_cast<cudaStream_t>(stream);
  auto call = w_int8 ? launch_block<int8_t> : launch_block<__nv_bfloat16>;
  call(static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
       static_cast<const __nv_bfloat16*>(ln),
       static_cast<const __nv_bfloat16*>(film),
       static_cast<const float*>(vec_c), static_cast<const float*>(vec_2c),
       static_cast<const float*>(vec_dw), weights,
       static_cast<float*>(scratch), M, C, sp, eps, st);
  return static_cast<int>(cudaGetLastError());
}
