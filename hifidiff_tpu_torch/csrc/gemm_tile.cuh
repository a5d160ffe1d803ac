// The tensor-core tile shared by matmul_w8.cu and cnaf_small.cu.
//
//   C[M, N] = A[M, K] @ W[N, K]^T        (f32 accumulation)
//
// A is produced in bf16 by an "A loader" (plain bf16 rows, or f32/bf16 rows
// with a fused prologue: LayerNorm+FiLM, or the SCA gate); W is the weight in
// PyTorch's (cout, cin) layout, bf16 or int8. An int8 weight crosses device
// memory as int8: each thread loads 16 int8 values with one 16-byte load
// and converts them to bf16 on the way into shared memory (exact: |q| <=
// 127), so the tensor cores see bf16 and HBM sees one byte per weight. The
// per-column scale is applied by the caller to the f32 accumulator.
//
// One block of 128 threads (4 warps) computes a 64x64 tile of C with
// `nvcuda::wmma` 16x16x16 bf16 fragments, each warp a 32x32 quarter. K
// advances in steps of 32 through two shared-memory buffers: while the warps
// multiply the current buffer, every thread holds the next step's 16 A and
// 16 W elements in registers (the loads are in flight during the MMAs) and
// then writes them, transformed, into the other buffer; one __syncthreads per
// step. After the loop the accumulators are written to a f32 tile in shared
// memory (it reuses the operand buffers) for the caller's epilogue.
//
// The tile rows of W are two runs of 32 output columns (`wrow_lo`,
// `wrow_hi`), so a SimpleGate epilogue can have columns n and n + C of a
// (K -> 2C) product in one tile. Requirements: K % 32 == 0, all pointers
// 16-byte aligned, every W row of the tile in range. Rows >= M are read as
// zero and must not be stored by the epilogue.
#pragma once

#include <mma.h>

#include <cstdint>

#include "common.cuh"

namespace hifidiff {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kGemmThreads = 128;
constexpr int kLd = kBK + 8;   // operand row pitch (bf16): 80 B, no 2-way
                               // bank conflicts between fragment rows
constexpr int kLdC = kBN + 4;  // f32 result row pitch

constexpr int kOperandBytes = 2 * (kBM + kBN) * kLd * 2;
constexpr int kResultBytes = kBM * kLdC * 4;
constexpr int kSmemBytes =
    kOperandBytes > kResultBytes ? kOperandBytes : kResultBytes;

// Raw storage: the two A and two W operand buffers, reused for the f32
// result tile once the K loop is over.
struct GemmSmem {
  __align__(128) unsigned char raw[kSmemBytes];
  __device__ __forceinline__ __nv_bfloat16* a(int buf) {
    return reinterpret_cast<__nv_bfloat16*>(raw) + buf * kBM * kLd;
  }
  __device__ __forceinline__ __nv_bfloat16* b(int buf) {
    return reinterpret_cast<__nv_bfloat16*>(raw) + 2 * kBM * kLd +
           buf * kBN * kLd;
  }
  __device__ __forceinline__ float* c() {
    return reinterpret_cast<float*>(raw);
  }
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 floats -> 16 bf16 (round to nearest even) at a 16-byte aligned address.
__device__ __forceinline__ void store16_bf16(__nv_bfloat16* dst,
                                             const float* f) {
  uint4 lo, hi;
  lo.x = pack_bf16x2(f[0], f[1]);
  lo.y = pack_bf16x2(f[2], f[3]);
  lo.z = pack_bf16x2(f[4], f[5]);
  lo.w = pack_bf16x2(f[6], f[7]);
  hi.x = pack_bf16x2(f[8], f[9]);
  hi.y = pack_bf16x2(f[10], f[11]);
  hi.z = pack_bf16x2(f[12], f[13]);
  hi.w = pack_bf16x2(f[14], f[15]);
  reinterpret_cast<uint4*>(dst)[0] = lo;
  reinterpret_cast<uint4*>(dst)[1] = hi;
}

// 16 consecutive elements of a row as f32 registers.
__device__ __forceinline__ void load16_f32(const float* p, float* f) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = reinterpret_cast<const float4*>(p)[i];
    f[4 * i] = v.x;
    f[4 * i + 1] = v.y;
    f[4 * i + 2] = v.z;
    f[4 * i + 3] = v.w;
  }
}
__device__ __forceinline__ void load16_f32(const __nv_bfloat16* p, float* f) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 v = reinterpret_cast<const uint4*>(p)[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 t = __bfloat1622float2(h[j]);
      f[8 * i + 2 * j] = t.x;
      f[8 * i + 2 * j + 1] = t.y;
    }
  }
}

// ---- A loaders. `load` only issues the global loads (so they overlap the
// MMAs of the current step); `store` transforms and writes 16 bf16 values.
// `row` is the global row, `lrow` the row inside the tile, `k` the global
// column of the first of the 16 elements.

// bf16 rows, no prologue.
struct ADirect {
  const __nv_bfloat16* a;
  int lda;
  int M;
  struct Raw {
    uint4 v[2];
  };
  __device__ __forceinline__ Raw load(int row, int k) const {
    Raw r;
    if (row < M) {
      const uint4* p =
          reinterpret_cast<const uint4*>(a + (long long)row * lda + k);
      r.v[0] = p[0];
      r.v[1] = p[1];
    } else {
      r.v[0] = r.v[1] = make_uint4(0, 0, 0, 0);
    }
    return r;
  }
  __device__ __forceinline__ void store(const Raw& r, __nv_bfloat16* dst,
                                        int /*lrow*/, int /*k*/) const {
    reinterpret_cast<uint4*>(dst)[0] = r.v[0];
    reinterpret_cast<uint4*>(dst)[1] = r.v[1];
  }
};

// LayerNorm + folded affine on rows of S (bf16 or f32):
//   bf16(((x - mean[lrow]) * rstd[lrow]) * wa[k] + ba[k])
// mean/rstd (per tile row) and wa/ba (per column) live in shared memory.
template <typename S>
struct ALayerNorm {
  const S* x;
  int ldx;
  int M;
  const float* mean;
  const float* rstd;
  const float* wa;
  const float* ba;
  struct Raw {
    float f[16];
  };
  __device__ __forceinline__ Raw load(int row, int k) const {
    Raw r;
    if (row < M) {
      load16_f32(x + (long long)row * ldx + k, r.f);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) r.f[i] = 0.f;
    }
    return r;
  }
  __device__ __forceinline__ void store(const Raw& r, __nv_bfloat16* dst,
                                        int lrow, int k) const {
    const float m = mean[lrow], s = rstd[lrow];
    float f[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      f[i] = (r.f[i] - m) * s * wa[k + i] + ba[k + i];
    store16_bf16(dst, f);
  }
};

// The SCA gate: bf16(u[row, k] * gate[row / sp, k]), both f32.
struct AGate {
  const float* u;
  const float* gate;
  int ld;
  int M;
  int sp;
  struct Raw {
    float u[16];
    float g[16];
  };
  __device__ __forceinline__ Raw load(int row, int k) const {
    Raw r;
    if (row < M) {
      load16_f32(u + (long long)row * ld + k, r.u);
      load16_f32(gate + (long long)(row / sp) * ld + k, r.g);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) r.u[i] = r.g[i] = 0.f;
    }
    return r;
  }
  __device__ __forceinline__ void store(const Raw& r, __nv_bfloat16* dst,
                                        int /*lrow*/, int /*k*/) const {
    float f[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) f[i] = r.u[i] * r.g[i];
    store16_bf16(dst, f);
  }
};

// ---- W loaders: 16 elements of one weight row.
struct WRawBf16 {
  uint4 v[2];
};
struct WRawInt8 {
  uint4 v;
};
__device__ __forceinline__ WRawBf16 load_w(const __nv_bfloat16* p) {
  WRawBf16 r;
  r.v[0] = reinterpret_cast<const uint4*>(p)[0];
  r.v[1] = reinterpret_cast<const uint4*>(p)[1];
  return r;
}
__device__ __forceinline__ WRawInt8 load_w(const int8_t* p) {
  WRawInt8 r;
  r.v = *reinterpret_cast<const uint4*>(p);
  return r;
}
__device__ __forceinline__ void store_w(const WRawBf16& r,
                                        __nv_bfloat16* dst) {
  reinterpret_cast<uint4*>(dst)[0] = r.v[0];
  reinterpret_cast<uint4*>(dst)[1] = r.v[1];
}
__device__ __forceinline__ void store_w(const WRawInt8& r,
                                        __nv_bfloat16* dst) {
  const int8_t* q = reinterpret_cast<const int8_t*>(&r.v);
  float f[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = static_cast<float>(q[i]);
  store16_bf16(dst, f);
}

// The K loop. On return `sm.c()` holds the kBM x kBN f32 tile (pitch kLdC) and
// the block is synchronised.
template <class AL, typename WT>
__device__ __forceinline__ void gemm_mainloop(const AL& al, const WT* w,
                                              int K, int row0, int wrow_lo,
                                              int wrow_hi, GemmSmem& sm) {
  using namespace nvcuda;
  const int tid = threadIdx.x;
  const int lrow = tid >> 1;          // tile row of A and of W this thread
  const int koff = (tid & 1) * 16;    // stages: 64 rows x 2 halves of 16
  const int arow = row0 + lrow;
  const int wrow = lrow < kBN / 2 ? wrow_lo + lrow
                                  : wrow_hi + (lrow - kBN / 2);
  const WT* wp = w + (long long)wrow * K + koff;
  const int warp = tid >> 5;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  auto ra = al.load(arow, koff);
  auto rw = load_w(wp);
  al.store(ra, sm.a(0) + lrow * kLd + koff, lrow, koff);
  store_w(rw, sm.b(0) + lrow * kLd + koff);
  __syncthreads();

  const int nk = K / kBK;
  for (int t = 0; t < nk; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < nk;
    const int knext = (t + 1) * kBK + koff;
    if (more) {
      ra = al.load(arow, knext);
      rw = load_w(wp + (t + 1) * kBK);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], sm.a(cur) + (wm + 16 * i) * kLd + kk,
                               kLd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], sm.b(cur) + (wn + 16 * j) * kLd + kk,
                               kLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if (more) {
      al.store(ra, sm.a(cur ^ 1) + lrow * kLd + koff, lrow, knext);
      store_w(rw, sm.b(cur ^ 1) + lrow * kLd + koff);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sm.c() + (wm + 16 * i) * kLdC + wn + 16 * j,
                              acc[i][j], kLdC, wmma::mem_row_major);
  __syncthreads();
}

// A whole product with an elementwise epilogue `ep(row, col, acc)`, called
// for rows < ep.M only. Grid: (N / kBN, ceil(M / kBM)).
template <class AL, typename WT, class EP>
__global__ void __launch_bounds__(kGemmThreads)
    gemm_kernel(AL al, const WT* __restrict__ w, int K, EP ep) {
  __shared__ GemmSmem sm;
  const int n0 = blockIdx.x * kBN;
  const int row0 = blockIdx.y * kBM;
  gemm_mainloop(al, w, K, row0, n0, n0 + kBN / 2, sm);
  for (int idx = threadIdx.x; idx < kBM * kBN; idx += kGemmThreads) {
    const int r = idx / kBN, c = idx % kBN;
    if (row0 + r < ep.M) ep(row0 + r, n0 + c, sm.c()[r * kLdC + c]);
  }
}

}  // namespace hifidiff
