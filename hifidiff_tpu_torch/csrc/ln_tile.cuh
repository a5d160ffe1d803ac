// The tile layout shared by the fused LayerNorm + FiLM kernels, forward
// (ln_film.cu) and backward (ln_film_bwd.cu), on NCHW maps.
//
// A LayerNorm over C at each pixel sums across the channel axis, whose
// elements lie H*W apart, while neighbouring addresses hold neighbouring
// pixels of one channel. So the map is read in 16-byte vectors (8 bf16 or
// 4 f32) of V elements, of one of three kinds:
//   - H*W a multiple of the width: V pixels of one channel (PPV = V pixels
//     a vector);
//   - H*W of 1, 2 or 4 pixels dividing the width: V / (H*W) whole channels,
//     each with all its pixels (PPV = H*W);
//   - anything else (a ragged map, or C*H*W not a whole number of vectors):
//     one element at a time, V = PPV = 1, in the same kernels.
// A vector holds CPV = V / PPV channels. A column is the NV = C / CPV
// vectors of one sample that cover the same PPV pixels (a pixel group). A
// block takes GB neighbouring pixel groups of one sample (at most 8, a
// power of two) and splits each group's NV vectors over KB channel lanes:
// thread t is group t % GB, lane t / GB. A warp thus reads GB neighbouring
// vectors of each of 32 / GB channels, whole 32-byte sectors and up to
// 128-byte lines, and a block of at most 256 threads holds 4 vectors a
// thread, loaded once with the table entries of their channels, all of them
// before the first sum, and kept in registers: the kernels read device
// memory once and pass over registers for the mean, the centred variance
// and the output. A column of more than 1,024 vectors (more than 1,024
// channels where a vector holds one) reads the rest again from L2.
//
// Sums over C: each thread sums its vectors per pixel in PPV registers;
// a butterfly of warp shuffles sums the lanes of a warp; where a group
// spans several warps, one step through shared memory with one barrier (two
// where a group spans many warps) sums the warps in a fixed order. Every
// thread of a group ends with the same bits, and so does every run.
#pragma once

#include <algorithm>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "common.cuh"

namespace hifidiff {
namespace ln {

constexpr int kMaxThreads = 256;
constexpr int kMaxGroups = 8;
constexpr int kVecs = 4;  // vectors of each map a thread keeps in registers
// floats of one reduction slot: (warps + 1) x groups x the widest sum (the
// backward's three sums of 8 pixels)
constexpr int kRedSlot = (kMaxThreads / 32 + 1) * kMaxGroups * 24;

struct Layout {
  int C, HW;
  int G;       // pixel groups a sample: HW / PPV
  int NV;      // vectors a column: C / CPV
  int gb_log;  // log2 of GB, the pixel groups a block
  int KB;      // channel lanes a block, a power of two
  int J;       // blocks a sample: ceil(G / GB)
  int warps;   // warps a block: GB * KB / 32
};

struct Plan {
  int V, PPV;
  Layout L;
  int threads() const { return L.KB << L.gb_log; }
};

inline int floor_pow2(int v) {
  int p = 1;
  while (p * 2 <= v) p *= 2;
  return p;
}

// The layout for a (B, C, HW) map of elements `vec` to 16 bytes, its base
// 16-byte aligned: the fewest channel lanes that hold a column at kVecs
// vectors a lane, and as many pixel groups a block (up to 8) as keep the
// block within 256 threads.
inline Plan make_plan(int C, int HW, int vec) {
  Plan p;
  if (HW % vec == 0) {
    p.V = p.PPV = vec;
  } else if (vec % HW == 0 && (long long)C * HW % vec == 0) {
    p.V = vec;
    p.PPV = HW;
  } else {
    p.V = p.PPV = 1;
  }
  Layout& L = p.L;
  L.C = C;
  L.HW = HW;
  L.G = HW / p.PPV;
  L.NV = C / (p.V / p.PPV);
  int kb = 1;
  while (kb * kVecs < L.NV && kb < kMaxThreads) kb *= 2;
  const int gb = floor_pow2(
      std::max(1, std::min({L.G, kMaxGroups, kMaxThreads / kb})));
  L.gb_log = 0;
  while ((1 << L.gb_log) < gb) ++L.gb_log;
  L.J = (L.G + gb - 1) / gb;
  L.KB = std::min(std::max(kb, 32 / gb), kMaxThreads / gb);  // whole warps
  L.warps = p.threads() / 32;
  return p;
}

// Calls f.run<V, PPV>() for the plan's instantiation.
template <typename T, class F>
void dispatch(const Plan& p, const F& f) {
  constexpr int kVec = 16 / sizeof(T);
  if (p.V == 1) return f.template run<1, 1>();
  switch (p.PPV) {
    case kVec: return f.template run<kVec, kVec>();
    case 1: return f.template run<kVec, 1>();
    case 2: return f.template run<kVec, 2>();
    default: return f.template run<kVec, 4>();  // bf16's 2x2 maps
  }
}

// Whether the (C,) tables and the FiLM rows can be read CPV channels at a
// time: every row starts on a multiple of CPV elements.
inline bool rows_aligned(int cpv, int esize, long long film_stride,
                         std::initializer_list<const void*> rows) {
  if (film_stride % cpv) return false;
  for (const void* r : rows)
    if (reinterpret_cast<uintptr_t>(r) % (cpv * esize)) return false;
  return true;
}

template <int Bytes>
struct Word;
template <>
struct Word<2> {
  using type = unsigned short;
};
template <>
struct Word<4> {
  using type = unsigned int;
};
template <>
struct Word<8> {
  using type = uint2;
};
template <>
struct Word<16> {
  using type = uint4;
};

// N elements of T moved as one word of N * sizeof(T) bytes.
template <typename T, int N>
struct Pack {
  using W = typename Word<N * sizeof(T)>::type;
  static __device__ __forceinline__ W load(const T* p) {
    return __ldg(reinterpret_cast<const W*>(p));
  }
  static __device__ __forceinline__ void unpack(const W& w, float* f) {
    if constexpr (std::is_same_v<T, __nv_bfloat16> && N % 2 == 0) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
      for (int j = 0; j < N / 2; ++j) {
        const float2 t = __bfloat1622float2(h[j]);
        f[2 * j] = t.x;
        f[2 * j + 1] = t.y;
      }
    } else {
      const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int j = 0; j < N; ++j) f[j] = to_f32(e[j]);
    }
  }
  static __device__ __forceinline__ void store(T* p, const float* f) {
    W w;
    if constexpr (std::is_same_v<T, __nv_bfloat16> && N % 2 == 0) {
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
      for (int j = 0; j < N / 2; ++j)
        h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    } else {
      T* e = reinterpret_cast<T*>(&w);
#pragma unroll
      for (int j = 0; j < N; ++j) e[j] = from_f32<T>(f[j]);
    }
    *reinterpret_cast<W*>(p) = w;
  }
};

// N entries of a table row from p as one word: one load where `vec`, else
// N.
template <typename T, int N>
__device__ __forceinline__ typename Pack<T, N>::W load_row(const T* p,
                                                           int vec) {
  if (N > 1 && vec) return Pack<T, N>::load(p);
  typename Pack<T, N>::W w;
  T* e = reinterpret_cast<T*>(&w);
#pragma unroll
  for (int j = 0; j < N; ++j) e[j] = __ldg(p + j);
  return w;
}

// N float32 values to p, 16 bytes at a time where N allows (p aligned to N
// floats).
template <int N>
__device__ __forceinline__ void store_f32(float* p, const float* f) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
  } else {
    p[0] = f[0];
  }
}

// One thread's part of the tile of S maps of the same shape (x; or x and g)
// and of NT tables of C entries (w, b and the sample's FiLM rows): its kVecs
// vectors of each map and the table entries of their channels, all loaded
// in the constructor.
template <typename T, int V, int PPV, int S, int NT>
struct Tile {
  static constexpr int R = kVecs;
  static constexpr int CPV = V / PPV;
  using P = Pack<T, V>;
  using Q = Pack<T, CPV>;
  const T* src[S];
  const T* tab[NT];
  long long base, kstride;
  int gl, kl, KB, NV, tab_vec;
  bool live;
  typename P::W cache[S][R];
  typename Q::W tcache[NT][R];

  __device__ __forceinline__ Tile(const Layout& L, const T* const (&maps)[S],
                                  const T* const (&tables)[NT], int tab_vec_)
      : tab_vec(tab_vec_) {
    gl = threadIdx.x & ((1 << L.gb_log) - 1);
    kl = threadIdx.x >> L.gb_log;
    KB = L.KB;
    NV = L.NV;
    const int grp = (blockIdx.x << L.gb_log) + gl;
    live = grp < L.G;
    base = (long long)blockIdx.y * L.C * L.HW + (long long)grp * PPV;
    kstride = (long long)CPV * L.HW;
#pragma unroll
    for (int s = 0; s < S; ++s) src[s] = maps[s];
#pragma unroll
    for (int q = 0; q < NT; ++q) tab[q] = tables[q];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = kl + r * KB;
      const bool ok = live && k < NV;
#pragma unroll
      for (int s = 0; s < S; ++s)
        cache[s][r] = ok ? P::load(src[s] + base + k * kstride)
                         : typename P::W{};
#pragma unroll
      for (int q = 0; q < NT; ++q)
        tcache[q][r] = ok ? load_row<T, CPV>(tab[q] + k * CPV, tab_vec)
                          : typename Q::W{};
    }
  }

  // f(v, t, k, off, ok) for each of the thread's vectors k: v[s] its V
  // values in map s and t[q] its CPV entries of table q, as f32; off its
  // offset in the maps, ok whether it is in the map. Every thread of the
  // block makes the same number of calls (warp shuffles in f meet whole
  // warps); f must use nothing of v or t where !ok.
  template <class F>
  __device__ __forceinline__ void each(F&& f) const {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = kl + r * KB;
      float v[S][V], t[NT][CPV];
#pragma unroll
      for (int s = 0; s < S; ++s) P::unpack(cache[s][r], v[s]);
#pragma unroll
      for (int q = 0; q < NT; ++q) Q::unpack(tcache[q][r], t[q]);
      f(v, t, k, base + k * kstride, live && k < NV);
    }
    for (int k0 = R * KB; k0 < NV; k0 += KB) {  // beyond the registers
      const int k = k0 + kl;
      const bool ok = live && k < NV;
      float v[S][V], t[NT][CPV];
#pragma unroll
      for (int s = 0; s < S; ++s)
        P::unpack(ok ? P::load(src[s] + base + k * kstride) : typename P::W{},
                  v[s]);
#pragma unroll
      for (int q = 0; q < NT; ++q)
        Q::unpack(ok ? load_row<T, CPV>(tab[q] + k * CPV, tab_vec)
                     : typename Q::W{},
                  t[q]);
      f(v, t, k, base + k * kstride, ok);
    }
  }
};

// Sum `a` over the channel lanes of each pixel group of the block; every
// thread of a group ends with the same bits. All threads call it. Lanes of
// a warp by shuffles; then, where a group spans several warps, lane g < GB of
// each warp stores its group's sums and, after a barrier, every thread adds
// its group's sums of all warps in a fixed order. Where that would be more
// than 32 loads a thread, one thread per (group, entry) adds them instead
// and, after a second barrier, every thread loads its group's N totals.
// `red` is one of two slots of kRedSlot floats, taken in turn by successive
// calls: the barriers of the call in between order a slot's reads before
// its next writes.
template <int N>
__device__ __forceinline__ void column_sum(float (&a)[N], float* red,
                                           const Layout& L) {
  const int gb = 1 << L.gb_log;
  for (int o = gb; o < 32; o <<= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) a[i] += __shfl_xor_sync(0xffffffffu, a[i], o);
  if (L.warps == 1) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gl = threadIdx.x & (gb - 1);
  if (lane < gb)
#pragma unroll
    for (int i = 0; i < N; ++i) red[(warp * gb + lane) * N + i] = a[i];
  __syncthreads();
  if (L.warps * N <= 32) {
#pragma unroll
    for (int i = 0; i < N; ++i) a[i] = 0.f;
    for (int w = 0; w < L.warps; ++w)
#pragma unroll
      for (int i = 0; i < N; ++i) a[i] += red[(w * gb + gl) * N + i];
    return;
  }
  float* total = red + L.warps * gb * N;
  for (int e = threadIdx.x; e < gb * N; e += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < L.warps; ++w) s += red[w * gb * N + e];
    total[e] = s;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = total[gl * N + i];
}

}  // namespace ln
}  // namespace hifidiff
