// Fused GroupNorm + per-channel affine + SiLU, NCHW (the SD-VAE block
// prologue).
//
// Replaces the TPU kernel hifidiff_tpu/ops/pallas/groupnorm_silu.py
// (`group_norm_silu_pallas`). Per (sample, group):
//
//   mean = E[x], var = E[(x - mean)^2]          (two passes, f32)
//   y    = (x - mean) * rsqrt(var + eps) * w[c] + b[c]
//   out  = y * sigmoid(y)
//
// The variance is the centred two-pass form: the one-pass E[x^2] - mean^2
// cancels for a near-constant group with a large mean and can go negative.
//
// What bounds it on the card: bytes, one read and one write of the map (some
// fifteen operations per element, two of them on the special-function unit).
// In NCHW one (sample, group) is one contiguous run of (C / G) * H * W
// elements: 8 KB (512 ch x 16^2) to 256 KB (256 ch x 128^2) in bf16 on the
// VAE's path, twice that in f32. Two passes of statistics and one of
// normalisation read the run three times; the runs in flight on a full card
// (tens of MB) do not stay in the 50 MB L2, so a kernel that reads the run
// from device memory for each pass moves three reads and a write.
//
// The on-chip path reads the run from device memory once. The run is cut
// into slices, one per block of a thread-block cluster (1 to 8 blocks, the
// portable cluster size): the bulk-copy unit (`cp.async.bulk`, 1-D) brings
// a block's slice into its shared memory in four chunks on four mbarriers,
// and the sum starts on the first chunk while the others arrive. Each block
// reduces its slice (warp shuffles, then one shared-memory step) and
// publishes the partial sum; after the cluster's barrier every block adds
// the S partials through distributed shared memory in rank order, so all
// blocks hold the same mean, bit for bit. The centred sum of squares is taken
// from shared memory and exchanged the same way; then each block normalises
// its slice from shared memory and writes it with 16-byte stores. No atomics:
// equal bits run to run. The cluster is the smallest (1, 2, 4 or 8 blocks)
// whose slices are at most 64 KB: three blocks of 128 threads are resident
// on an SM, so that one block's loads overlap another's sums and stores
// (measured on the path's shapes: 16-32 KB slices, more blocks with more
// cluster barriers, and 256 threads a block were all slower). (w, b) of the
// channels a slice touches are loaded once per block into a table in shared
// memory, and a thread follows its vectors' channel with a counter, without
// a division per vector. SiLU takes the special-function unit's exp and
// reciprocal (a few ulps).
//
// Every shape runs this file's kernels. A run whose slices would exceed
// 96 KB at the largest cluster (beyond 768 KB), or whose H * W is not a
// whole number of 16-byte vectors (a vector would straddle two channels),
// takes the streaming path: one block of 512 threads per run reads it three
// times from device memory (mean, variance, normalise), element-wise where
// the vectors do not fit. `hifidiff_gn_silu_plan` says which path a shape
// takes and how many times it reads the map.
#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace hifidiff {
namespace {

constexpr int kThreads = 128;            // on-chip path
constexpr int kStreamThreads = 512;      // streaming path
constexpr int kMaxCluster = 8;           // the portable cluster size
constexpr int kChunks = 4;               // bulk copies (mbarriers) a slice
constexpr int kSliceTarget = 64 * 1024;  // bytes: three blocks an SM
constexpr int kMaxSlice = 96 * 1024;     // beyond this: the streaming path
// the largest slice, and its (w, b) table (at most a channel a vector, and
// one more)
constexpr int kMaxDynamic = kMaxSlice + (kMaxSlice / 16 + 1) * 8;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
};

// One 16-byte load as f32 registers (device or shared memory).
__device__ __forceinline__ void load_vec(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 t = __bfloat1622float2(h[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}
__device__ __forceinline__ void store_vec(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

// Sum over the block of NT threads, in a fixed order; every thread gets the
// result. All threads call it.
template <int NT>
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = lane < NT / 32 ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) r += __shfl_xor_sync(0xffffffffu, r, o);
  __syncthreads();  // the next call overwrites `red`
  return r;
}

// y * sigmoid(y) on the special-function unit (__expf, __fdividef: a few
// ulps). Where 1 + exp(-y) exceeds 2^126 (y below -87) the quotient, under
// 1e-35 in size, comes out as 0 (-0 where it is infinite, as in the plain
// version).
__device__ __forceinline__ float silu(float y) {
  return __fdividef(y, 1.f + __expf(-y));
}

// The launch of one shape. `cluster` 0: the streaming path.
struct Plan {
  int cluster;     // blocks a run (0: streaming)
  int slice_vecs;  // 16-byte vectors a block holds (the last may hold fewer)
  int table;       // channel entries of a block's (w, b) table
  int smem;        // dynamic shared memory bytes
  int reads;       // times the map is read from device memory
};

template <typename T>
Plan make_plan(int C, int HW, int G) {
  constexpr int V = Vec<T>::n;
  const int cpg = C / G;
  const long long run_bytes = (long long)cpg * HW * sizeof(T);
  const Plan stream{0, 0, 0, 0, 3};
  if (HW % V != 0) return stream;
  int S = 1;
  while (S < kMaxCluster && run_bytes > (long long)S * kSliceTarget) S *= 2;
  const long long nv = run_bytes / 16;
  const long long slice = (nv + S - 1) / S;
  if (slice * 16 > kMaxSlice) return stream;
  const int vpc = HW / V;
  const int table =
      (int)std::min<long long>(cpg, (slice + vpc - 1) / vpc + 1);
  return Plan{S, (int)slice, table, (int)(slice * 16 + table * 8), 1};
}

// The on-chip path. Grid: B * G * S blocks, clusters of S; block `rank` of
// the cluster of run r = (n, g) holds vectors [rank * slice_vecs, + n) of
// the run. Dynamic shared memory: the slice, then the (w, b) table.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gn_silu_cluster(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ b, T* __restrict__ out, int cpg,
                    int HW, int G, int slice_vecs, int table, float eps) {
  namespace cg = cooperative_groups;
  constexpr int V = Vec<T>::n;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kChunks];
  __shared__ float red[kThreads / 32];
  __shared__ float part[2];  // the slice's sum and centred sum of squares

  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int run = blockIdx.x / S;
  const int vpc = HW / V;                  // vectors a channel
  const int nv = cpg * vpc;                // vectors a run
  const int v0 = rank * slice_vecs;
  const int n = max(0, min(nv, v0 + slice_vecs) - v0);
  const long long base = (long long)run * cpg * HW + (long long)v0 * V;
  const T* src = x + base;
  T* dst = out + base;
  const T* slice = reinterpret_cast<const T*>(smem);
  float* tw = reinterpret_cast<float*>(smem + (size_t)slice_vecs * 16);
  float* tb = tw + table;
  const int tid = threadIdx.x;

  // the slice in kChunks bulk copies, each on its own mbarrier
  const int per = (n + kChunks - 1) / kChunks;
  if (tid == 0) {
    for (int k = 0; k < kChunks; ++k) mbar_init(smem_u32(&bars[k]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int k = 0; k < kChunks; ++k) {
      const int a = min(n, k * per), e = min(n, a + per);
      if (e == a) break;
      const uint32_t bytes = (uint32_t)(e - a) * 16;
      mbar_arrive_expect(smem_u32(&bars[k]), bytes);
      bulk_load(smem_u32(smem + (size_t)a * 16), src + (size_t)a * V, bytes,
                smem_u32(&bars[k]));
    }
  }
  // the table of the channels this slice touches
  const int c_first = n ? v0 / vpc : 0;
  const int c_count = n ? (v0 + n - 1) / vpc - c_first + 1 : 0;
  const int c_base = (run % G) * cpg + c_first;
  for (int k = tid; k < c_count; k += kThreads) {
    tw[k] = to_f32(w[c_base + k]);
    tb[k] = to_f32(b[c_base + k]);
  }

  float s = 0.f;
  for (int k = 0; k < kChunks; ++k) {
    const int a = min(n, k * per), e = min(n, a + per);
    if (e == a) break;
    mbar_wait(smem_u32(&bars[k]), 0);
    for (int v = a + tid; v < e; v += kThreads) {
      float f[V];
      load_vec(slice + (size_t)v * V, f);
#pragma unroll
      for (int j = 0; j < V; ++j) s += f[j];
    }
  }
  const float L = (float)((long long)cpg * HW);
  // the run's sum: the S partials in rank order, the same in every block
  auto run_sum = [&](float mine, int slot) {
    if (S == 1) return mine;
    if (tid == 0) part[slot] = mine;
    cluster_arrive();
    cluster_wait();
    float t = 0.f;
    for (int q = 0; q < S; ++q) t += *cluster.map_shared_rank(&part[slot], q);
    return t;
  };
  const float mean = run_sum(block_sum<kThreads>(s, red), 0) / L;

  float q = 0.f;
  for (int v = tid; v < n; v += kThreads) {
    float f[V];
    load_vec(slice + (size_t)v * V, f);
#pragma unroll
    for (int j = 0; j < V; ++j) q += (f[j] - mean) * (f[j] - mean);
  }
  const float rstd = rsqrtf(run_sum(block_sum<kThreads>(q, red), 1) / L + eps);
  // this block has read what it needs of the others' shared memory; none
  // leaves before every block has (the wait at the end)
  if (S > 1) cluster_arrive();

  // thread tid's vectors are tid, tid + kThreads, ...: their table entry
  // follows with a counter (ch, r) = divmod(v0 + v, vpc)
  const int dq = kThreads / vpc, dr = kThreads % vpc;
  int ch = (v0 + tid) / vpc, r = (v0 + tid) - ch * vpc;
  ch -= c_first;
  for (int v = tid; v < n; v += kThreads) {
    const float a = rstd * tw[ch], bc = tb[ch];
    float f[V];
    load_vec(slice + (size_t)v * V, f);
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] = silu((f[j] - mean) * a + bc);
    store_vec(dst + (size_t)v * V, f);
    ch += dq;
    r += dr;
    if (r >= vpc) r -= vpc, ++ch;
  }
  if (S > 1) cluster_wait();
}

// The streaming path: one block per run, which reads the run from device
// memory three times (mean, variance, normalise).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kStreamThreads)
    gn_silu_stream(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ b, T* __restrict__ out, int cpg,
                   int HW, int G, float eps) {
  __shared__ float red[kStreamThreads / 32];
  constexpr int V = VEC ? Vec<T>::n : 1;
  const long long L = (long long)cpg * HW;
  const long long base = (long long)blockIdx.x * L;  // run (n, g)
  const int c0 = (blockIdx.x % G) * cpg;
  const T* xr = x + base;
  T* outr = out + base;
  const long long start = (long long)threadIdx.x * V;
  const long long step = (long long)kStreamThreads * V;

  float s = 0.f;
  for (long long i = start; i < L; i += step) {
    if (VEC) {
      float f[Vec<T>::n];
      load_vec(xr + i, f);
#pragma unroll
      for (int j = 0; j < Vec<T>::n; ++j) s += f[j];
    } else {
      s += to_f32(xr[i]);
    }
  }
  const float mean = block_sum<kStreamThreads>(s, red) / (float)L;

  float q = 0.f;
  for (long long i = start; i < L; i += step) {
    if (VEC) {
      float f[Vec<T>::n];
      load_vec(xr + i, f);
#pragma unroll
      for (int j = 0; j < Vec<T>::n; ++j) q += (f[j] - mean) * (f[j] - mean);
    } else {
      const float d = to_f32(xr[i]) - mean;
      q += d * d;
    }
  }
  const float rstd =
      rsqrtf(block_sum<kStreamThreads>(q, red) / (float)L + eps);

  for (long long i = start; i < L; i += step) {
    const int c = c0 + (int)(i / HW);  // a vector never straddles a channel
    const float wc = to_f32(w[c]), bc = to_f32(b[c]);
    if (VEC) {
      float f[Vec<T>::n];
      load_vec(xr + i, f);
#pragma unroll
      for (int j = 0; j < Vec<T>::n; ++j)
        f[j] = silu((f[j] - mean) * rstd * wc + bc);
      store_vec(outr + i, f);
    } else {
      outr[i] = from_f32<T>(silu((to_f32(xr[i]) - mean) * rstd * wc + bc));
    }
  }
}

// The on-chip kernel may take more than the default 48 KB of dynamic shared
// memory: opted in once per process (a function-local static is initialised
// once, whatever the threads).
template <typename T>
void opt_in() {
  static const cudaError_t done = cudaFuncSetAttribute(
      gn_silu_cluster<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxDynamic);
  (void)done;
}

template <typename T>
void launch(const void* x, const void* w, const void* b, void* out, int B,
            int C, int HW, int G, float eps, cudaStream_t stream) {
  const Plan p = make_plan<T>(C, HW, G);
  auto xt = static_cast<const T*>(x);
  auto wt = static_cast<const T*>(w);
  auto bt = static_cast<const T*>(b);
  auto ot = static_cast<T*>(out);
  if (p.cluster == 0) {
    const bool vec = HW % Vec<T>::n == 0;
    auto kern = vec ? gn_silu_stream<T, true> : gn_silu_stream<T, false>;
    kern<<<B * G, kStreamThreads, 0, stream>>>(xt, wt, bt, ot, C / G, HW, G,
                                               eps);
    return;
  }
  opt_in<T>();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * G * p.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, gn_silu_cluster<T>, xt, wt, bt, ot, C / G, HW, G,
                     p.slice_vecs, p.table, eps);
}

template <typename T>
void plan_of(int C, int HW, int G, int* out) {
  const Plan p = make_plan<T>(C, HW, G);
  int per_sm = 0;
  if (p.cluster) {
    opt_in<T>();
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gn_silu_cluster<T>,
                                                  kThreads, p.smem);
  }
  cudaGetLastError();
  out[0] = p.cluster ? 1 : 0;
  out[1] = p.cluster;
  out[2] = p.slice_vecs * 16;
  out[3] = p.smem;
  out[4] = per_sm;
  out[5] = p.reads;
}

}  // namespace
}  // namespace hifidiff

// x, out: (B, C, H, W) contiguous, 16-byte aligned; w, b: (C,); one dtype,
// bf16 (is_bf16) or f32; C % G == 0. Returns cudaGetLastError() after the
// launch.
extern "C" int hifidiff_gn_silu(const void* x, const void* w, const void* b,
                                void* out, int B, int C, int HW, int G,
                                float eps, int is_bf16, void* stream) {
  using hifidiff::launch;
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<__nv_bfloat16>(x, w, b, out, B, C, HW, G, eps, st);
  else
    launch<float>(x, w, b, out, B, C, HW, G, eps, st);
  return static_cast<int>(cudaGetLastError());
}

// The path a shape takes: plan[0] 1 on chip, 0 streaming; [1] blocks a run
// (the cluster; 0 streaming); [2] bytes a block holds; [3] its dynamic shared
// memory; [4] such blocks resident on an SM (0 streaming); [5] times the map
// is read from device memory.
extern "C" void hifidiff_gn_silu_plan(int C, int HW, int G, int is_bf16,
                                      int* plan) {
  if (is_bf16)
    hifidiff::plan_of<__nv_bfloat16>(C, HW, G, plan);
  else
    hifidiff::plan_of<float>(C, HW, G, plan);
}
