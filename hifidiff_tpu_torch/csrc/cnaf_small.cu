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
// int8, 59 MB bf16 at C = 2048; 9 / 18 us at 3.35 TB/s) and do
// 2 C^2 (6 M + B) operations (7.5 GFLOP at C 2048 x 1^2, 6.7 at C 1024 x 2^2;
// 7-8 us at 989 TFLOP/s): bytes at M = 128, the tensor cores at M = 512.
// Everything between the products is a few bytes per row. What is left is a
// chain of dependent launches, each of which waits for its first bytes, for
// what an SM can take in from L2 (gemm_tile.cuh) and for the sum of its K
// ranges' partial tiles.
//
// Design: a fixed chain of seven kernels launched by one call. Each
// LayerNorm and the SCA pool need whole rows that the column-split product
// before them wrote, so the chain has a kernel boundary at exactly those
// points. The five products run on the shared tensor-core tile
// (gemm_tile.cuh: a TMA ring per block, `wgmma` from shared memory, K split
// over a cluster, the partial sums reduced in shared memory before the
// epilogue) with plain bf16 rows as A and everything else in their
// epilogues; each LayerNorm + FiLM is one small pass that computes the row
// statistics and the folded affine once and writes the bf16 rows the product
// after it reads (not once per column block inside that product). The
// intermediates (u, y1 in f32; the normed, pooled and gated rows in bf16) go
// through a scratch buffer of at most 6.6 MB that stays in L2.
//   0. h  = bf16(LN1(x) * w1a + b1a)
//   1. h @ W1 (C -> 2C, columns n and n + C in one tile), epilogue: scale,
//      bias, position mix, SimpleGate -> u, pooled rows
//   2. pooled @ Wsca, epilogue: scale, bias (the SCA gate g), bf16(u * g)
//   3. (u * g) @ W3, epilogue: scale, bias, beta residual -> y1
//   3b. h2 = bf16(LN2(y1) * w2a + b2a)
//   4. h2 @ W4 (C -> 2C), epilogue: scale, bias, SimpleGate
//   5. @ W5, epilogue: scale, bias, gamma residual, round to bf16
// All seven are launched with programmatic dependent launch: each starts
// while the one before it drains, asks for what depends on no kernel (the
// first ring stages of weights, the LayerNorm tables), and only then waits
// for the kernel before it. Epilogues 2, 3 and 5 read rows an earlier kernel
// wrote (u, x, y1): they ask for those lines during their K loop.
// Both weight types (bf16, int8 with scales) go through the same bodies; the
// map size (1 or 4 positions a sample) is a template parameter, so the
// position mix keeps its taps in registers.
#include "gemm_tile.cuh"

namespace hifidiff {
namespace {

constexpr int kMaxC = 2048;  // a block of the LayerNorm pass holds a row

// LayerNorm parameters and the FiLM row of one norm, in the I/O dtype.
struct LnParams {
  const __nv_bfloat16* w;
  const __nv_bfloat16* b;
  const __nv_bfloat16* scale;
  const __nv_bfloat16* shift;
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

// Kernels 0 and 3b: h[row] = bf16((x[row] - mean) * rstd * wa + ba) with
// wa = w * (1 + scale), ba = b * (1 + scale) + shift. One block of 256
// threads per row, the row held in registers (8 values a thread): mean, then
// the centred variance, then the affine; the sums go through warp shuffles
// and shared memory in a fixed order. Grid: M blocks; C % 128 == 0,
// C <= kMaxC.
constexpr int kLnThreads = 256;
constexpr int kLnIters = kMaxC / (4 * kLnThreads);

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kLnThreads / 32; ++w) total += red[w];
  __syncthreads();   // `red` is free again
  return total;
}

template <typename S>
__global__ void __launch_bounds__(kLnThreads)
    ln_rows_kernel(const S* __restrict__ x, LnParams ln,
                   __nv_bfloat16* __restrict__ h, int C, float eps) {
  __shared__ float red[kLnThreads / 32];
  griddep_launch_dependents();
  // the tables do not depend on the kernel before this one
  float w[kLnIters][4], b[kLnIters][4], sc[kLnIters][4], sh[kLnIters][4];
#pragma unroll
  for (int i = 0; i < kLnIters; ++i) {
    const int k = threadIdx.x * 4 + 4 * kLnThreads * i;
    if (k < C) {
      load4(ln.w + k, w[i]);
      load4(ln.b + k, b[i]);
      load4(ln.scale + k, sc[i]);
      load4(ln.shift + k, sh[i]);
    }
  }
  griddep_wait();   // x may be what the kernel before this one wrote
  const long long row = blockIdx.x;
  const S* xr = x + row * C;
  float v[kLnIters][4];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kLnIters; ++i) {
    const int k = threadIdx.x * 4 + 4 * kLnThreads * i;
    if (k < C) {
      load4(xr + k, v[i]);
      s += (v[i][0] + v[i][1]) + (v[i][2] + v[i][3]);
    }
  }
  const float m = block_sum(s, red) / C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kLnIters; ++i)
    if (threadIdx.x * 4 + 4 * kLnThreads * i < C) {
#pragma unroll
      for (int j = 0; j < 4; ++j) q += (v[i][j] - m) * (v[i][j] - m);
    }
  const float rs = rsqrtf(block_sum(q, red) / C + eps);
#pragma unroll
  for (int i = 0; i < kLnIters; ++i) {
    const int k = threadIdx.x * 4 + 4 * kLnThreads * i;
    if (k < C) {
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float f = 1.f + sc[i][j];
        o[j] = (v[i][j] - m) * rs * (w[i][j] * f) + (b[i][j] * f + sh[i][j]);
      }
      __nv_bfloat16* hp = h + row * C + k;
      store2(hp, o[0], o[1]);
      store2(hp + 2, o[2], o[3]);
    }
  }
}

// Per-column vectors of a (C -> 2C) product, all f32 of length 2C.
struct GateVecs {
  const float* s;     // int8 scales (ones for bf16 weights)
  const float* b;     // conv bias
  const float* dw;    // (sp * sp, 2C) position-mix taps   (kernel 1 only)
  const float* dwb;   // depthwise bias                    (kernel 1 only)
};

// Epilogues of the (C -> 2C) products: tile column j < 64 is output column
// n0 + j, tile column 64 + j is column C + n0 + j, with n0 = 64 bx.

// Kernel 1: scale, bias, position mix over the SP rows of a sample,
// SimpleGate -> u (f32) and the pooled rows (bf16). The tile rows [lr0, lr1)
// hold whole samples (they come in groups of four). The thread's 2 SP^2 taps
// are loaded once, before it walks its samples.
template <int SP>
struct GateMixOut {
  GateVecs v;
  float* u_out;
  __nv_bfloat16* pooled;
  int M;
  int C;
  __device__ __forceinline__ void prefetch(int, int, int, int) const {}
  __device__ __forceinline__ void operator()(const float* ct, int lr0,
                                             int lr1, int row0,
                                             int bx) const {
    constexpr int H = kBN / 2;
    if (threadIdx.x >= kConsumers) return;
    // this thread's column of each run, and what depends on it alone
    const int j = threadIdx.x & (H - 1), twoC = 2 * C;
    const int ca = bx * H + j, cb = C + ca;
    const float sa = __ldg(v.s + ca), ba = __ldg(v.b + ca);
    const float sb = __ldg(v.s + cb), bb = __ldg(v.b + cb);
    const float da = __ldg(v.dwb + ca), db = __ldg(v.dwb + cb);
    float wa[SP][SP], wb[SP][SP];
#pragma unroll
    for (int p = 0; p < SP; ++p)
#pragma unroll
      for (int q = 0; q < SP; ++q) {
        wa[p][q] = __ldg(v.dw + (long long)(p * SP + q) * twoC + ca);
        wb[p][q] = __ldg(v.dw + (long long)(p * SP + q) * twoC + cb);
      }
    const int last = min(lr1, M - row0);
#pragma unroll 2
    for (int r0 = lr0 + (threadIdx.x / H) * SP; r0 < last;
         r0 += (kConsumers / H) * SP) {   // r0: first tile row of a sample
      float ta[SP], tb[SP];
#pragma unroll
      for (int q = 0; q < SP; ++q) {
        ta[q] = ct[(r0 + q) * kLdC + j] * sa + ba;
        tb[q] = ct[(r0 + q) * kLdC + H + j] * sb + bb;
      }
      float pool = 0.f;
#pragma unroll
      for (int p = 0; p < SP; ++p) {
        float ma = wa[p][0] * ta[0], mb = wb[p][0] * tb[0];
#pragma unroll
        for (int q = 1; q < SP; ++q) {
          ma += wa[p][q] * ta[q];
          mb += wb[p][q] * tb[q];
        }
        const float uu = (ma + da) * (mb + db);
        u_out[(long long)(row0 + r0 + p) * C + ca] = uu;
        pool += uu;
      }
      pooled[(long long)((row0 + r0) / SP) * C + ca] =
          __float2bfloat16(pool / SP);
    }
  }
};

// Kernel 4: scale, bias, SimpleGate -> bf16 rows.
struct GateOut {
  GateVecs v;
  __nv_bfloat16* out;
  int M;
  int C;
  __device__ __forceinline__ void prefetch(int, int, int, int) const {}
  __device__ __forceinline__ void operator()(const float* ct, int lr0,
                                             int lr1, int row0,
                                             int bx) const {
    constexpr int H = kBN / 2;
    if (threadIdx.x >= kConsumers) return;
    const int j = threadIdx.x & (H - 1);
    const int ca = bx * H + j, cb = C + ca;
    const float sa = __ldg(v.s + ca), ba = __ldg(v.b + ca);
    const float sb = __ldg(v.s + cb), bb = __ldg(v.b + cb);
    const int last = min(lr1, M - row0);
#pragma unroll 4
    for (int r = lr0 + threadIdx.x / H; r < last; r += kConsumers / H) {
      const float ta = ct[r * kLdC + j] * sa + ba;
      const float tb = ct[r * kLdC + H + j] * sb + bb;
      out[(long long)(row0 + r) * C + ca] = __float2bfloat16(ta * tb);
    }
  }
};

// Kernel 2 (rows are samples): g = acc * s + b, then the gated rows
// bf16(u * g) of the sample's SP positions.
template <int SP>
struct ScaGateOut {
  const float* u;
  __nv_bfloat16* ug;
  const float* s;
  const float* b;
  int B;
  int C;
  struct Rows {
    float2 u[SP];
  };
  __device__ __forceinline__ void prefetch(int lr0, int lr1, int row0,
                                           int bx) const {
    const int c = bx * kBN + pair_col();
#pragma unroll
    for (int p = 0; p < SP; ++p)
      prefetch_each_row(lr0, lr1, row0, B, [&](int sample) {
        return u + (long long)(sample * SP + p) * C + c;
      });
  }
  __device__ __forceinline__ void operator()(const float* ct, int lr0,
                                             int lr1, int row0,
                                             int bx) const {
    const int c = bx * kBN + pair_col();
    const float2 sc = ldg2(s + c), bi = ldg2(b + c);
    for_each_row<16 / SP>(
        ct, lr0, lr1, row0, B,
        [&](int sample) {
          Rows x;
#pragma unroll
          for (int p = 0; p < SP; ++p)
            x.u[p] = ldg2(u + (long long)(sample * SP + p) * C + c);
          return x;
        },
        [&](int sample, float v0, float v1, const Rows& x) {
          const float g0 = v0 * sc.x + bi.x, g1 = v1 * sc.y + bi.y;
#pragma unroll
          for (int p = 0; p < SP; ++p)
            store2(ug + (long long)(sample * SP + p) * C + c, x.u[p].x * g0,
                   x.u[p].y * g1);
        });
  }
};

// Kernels 3 and 5: out[row, n] = res[row, n] + (acc * s[n] + b[n]) * g[n]
template <typename ResT, typename OutT>
struct ResidualOut {
  OutT* out;
  const ResT* res;
  const float* s;
  const float* b;
  const float* g;
  int N;
  int M;
  __device__ __forceinline__ void prefetch(int lr0, int lr1, int row0,
                                           int bx) const {
    const int c = bx * kBN + pair_col();
    prefetch_each_row(lr0, lr1, row0, M,
                      [&](int row) { return res + (long long)row * N + c; });
  }
  __device__ __forceinline__ void operator()(const float* ct, int lr0,
                                             int lr1, int row0,
                                             int bx) const {
    const int c = bx * kBN + pair_col();
    const float2 sc = ldg2(s + c), bi = ldg2(b + c), gg = ldg2(g + c);
    for_each_row<16>(
        ct, lr0, lr1, row0, M,
        [&](int row) { return ldg2(res + (long long)row * N + c); },
        [&](int row, float v0, float v1, float2 r) {
          store2(out + (long long)row * N + c,
                 r.x + (v0 * sc.x + bi.x) * gg.x,
                 r.y + (v1 * sc.y + bi.y) * gg.y);
        });
  }
};

// Rows of the packed per-channel vectors `vec_c` (8, C).
enum { kBeta, kGamma, kSsca, kBsca, kS3, kB3, kS5, kB5 };

template <typename S>
void launch_ln_rows(const S* x, const LnParams& ln, __nv_bfloat16* h, int M,
                    int C, float eps, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(M);
  cfg.blockDim = dim3(kLnThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, ln_rows_kernel<S>, x, ln, h, C, eps);
}

template <typename WT, int SP>
void launch_block(const __nv_bfloat16* x, __nv_bfloat16* out,
                  const __nv_bfloat16* ln, const __nv_bfloat16* film,
                  const float* vec_c, const float* vec_2c,
                  const float* vec_dw, const void* const* weights,
                  float* scratch, int M, int C, float eps, cudaStream_t st) {
  const WT* w1 = static_cast<const WT*>(weights[0]);
  const WT* wsca = static_cast<const WT*>(weights[1]);
  const WT* w3 = static_cast<const WT*>(weights[2]);
  const WT* w4 = static_cast<const WT*>(weights[3]);
  const WT* w5 = static_cast<const WT*>(weights[4]);
  const int B = M / SP;
  const long long mc = (long long)M * C;
  // scratch (f32 units): u (M, C) f32 | y1 (M, C) f32 | normed rows h, then
  // h2 (M, C) bf16 | gated rows u * g, then the gated FFN rows (M, C) bf16 |
  // pooled (B, C) bf16
  float* u = scratch;
  float* y1 = u + mc;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(y1 + mc);
  __nv_bfloat16* ug = h + mc;
  __nv_bfloat16* pooled = ug + mc;
  // film row: [shift_att, scale_att, shift_ffn, scale_ffn];
  // ln: [w1, b1, w2, b2]
  const LnParams ln1{ln, ln + C, film + C, film};
  const LnParams ln2{ln + 2 * C, ln + 3 * C, film + 3 * C, film + 2 * C};
  const int twoC = 2 * C;
  const GateVecs v1{vec_2c, vec_2c + twoC, vec_dw, vec_2c + 4 * twoC};
  const GateVecs v4{vec_2c + 2 * twoC, vec_2c + 3 * twoC, nullptr, nullptr};
  const float* vc = vec_c;

  launch_ln_rows(x, ln1, h, M, C, eps, st);
  launch_gemm(h, M, w1, twoC, C, true,
              GateMixOut<SP>{v1, u, pooled, M, C}, st);
  launch_gemm(pooled, B, wsca, C, C, false,
              ScaGateOut<SP>{u, ug, vc + kSsca * C, vc + kBsca * C, B, C},
              st);
  launch_gemm(ug, M, w3, C, C, false,
              ResidualOut<__nv_bfloat16, float>{
                  y1, x, vc + kS3 * C, vc + kB3 * C, vc + kBeta * C, C, M},
              st);
  launch_ln_rows(y1, ln2, h, M, C, eps, st);
  launch_gemm(h, M, w4, twoC, C, true, GateOut{v4, ug, M, C}, st);
  launch_gemm(ug, M, w5, C, C, false,
              ResidualOut<float, __nv_bfloat16>{
                  out, y1, vc + kS5 * C, vc + kB5 * C, vc + kGamma * C, C, M},
              st);
}

}  // namespace
}  // namespace hifidiff

// x, out: (M, C) bf16 rows, M = B * sp, sp in {1, 4}; ln: (4, C) bf16
// [norm1.weight, norm1.bias, norm2.weight, norm2.bias]; film: (4C,) bf16
// [shift_att, scale_att, shift_ffn, scale_ffn]; vec_c: (8, C) f32 [beta,
// gamma, s_sca, b_sca, s3, b3, s5, b5]; vec_2c: (5, 2C) f32 [s1, b1, s4, b4,
// dw_bias]; vec_dw: (sp * sp, 2C) f32; w1, w4: (2C, C), wsca, w3, w5: (C, C),
// all bf16 or all int8 (w_int8); scratch: 3 M C + B C / 2 floats.
// C % 128 == 0, C <= 2048, pointers 16-byte aligned. Returns
// cudaGetLastError() after the seven launches.
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
  auto call = sp == 1 ? (w_int8 ? launch_block<int8_t, 1>
                                : launch_block<__nv_bfloat16, 1>)
                      : (w_int8 ? launch_block<int8_t, 4>
                                : launch_block<__nv_bfloat16, 4>);
  call(static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
       static_cast<const __nv_bfloat16*>(ln),
       static_cast<const __nv_bfloat16*>(film),
       static_cast<const float*>(vec_c), static_cast<const float*>(vec_2c),
       static_cast<const float*>(vec_dw), weights,
       static_cast<float*>(scratch), M, C, eps, st);
  return static_cast<int>(cudaGetLastError());
}
