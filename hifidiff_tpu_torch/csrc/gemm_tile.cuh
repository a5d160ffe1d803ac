// The tensor-core tile shared by matmul_w8.cu and cnaf_small.cu.
//
//   C[M, N] = A[M, K] @ W[N, K]^T        (f32 accumulation)
//
// A is bf16 rows; W is the weight in PyTorch's (cout, cin) layout, bf16 or
// int8. An int8 weight crosses device memory as int8, lands in shared memory
// as int8 and is converted to bf16 there (exact: |q| <= 127), so the tensor
// cores see bf16 and HBM sees one byte per weight. The per-column scale is
// applied by the caller's epilogue to the f32 sum.
//
// What bounds these products on an H100. At the denoiser's shapes (M 50-512,
// K 256-2048, N 1024-8192) a product streams 1-8 MB of weights that no other
// block of the step reuses and does 0.1-4 GFLOP: by the card's peaks (3.35
// TB/s, 989 TFLOP/s) 1-3 us. What a launch really waits for, measured with
// clock stamps inside the kernel:
//   - the TMA unit of an SM delivers a box row about every 3.75 clocks,
//     whether the row holds 64 or 128 bytes and however many boxes are in
//     flight (17 and 33 bytes a clock from L2): the 256 rows of a 128x128x64
//     stage cost 1000 clocks with int8 weights as with bf16 ones (700-1000
//     measured), and A is read again by every column tile;
//   - so the K range has to be split over many SMs, and the f32 partial tiles
//     summed: distributed shared memory moves about 12 bytes a clock into an
//     SM, 2700-5500 clocks for the remote parts of a 64 KB tile, behind a
//     cluster barrier of 1500;
//   - the first bytes arrive 1300 clocks after they are asked for, and every
//     dependent load of an epilogue costs 700.
// What this tile does about it:
//
// * One warp of the block produces, eight consume. A thread of the producer
//   warp asks the TMA unit (`cp.async.bulk.tensor`) for each stage's two
//   boxes: 128 rows of A and 128 rows of W, K depth kBK (64). They
//   land in a ring of six slots in dynamic shared memory, in the swizzle the
//   tensor cores read, and complete the slot's `full` mbarrier; the consumers
//   give a slot back through its `free` mbarrier. No thread computes an
//   address or waits for a copy it issued; up to 144 KB are in flight for a
//   block, rows beyond M and K beyond the matrix arrive as zeros.
// * `wgmma` m64n128k16: each of the two consumer warpgroups multiplies its 64
//   rows of A by the 128 rows of W, both operands read by the tensor cores
//   from shared memory (K-major rows of 128 bytes in the 128-byte swizzle),
//   the f32 sums in 64 registers a thread. The four MMAs of a stage are one
//   group; the group of stage s runs while stage s + 1 is waited for.
//   (Feeding W from registers instead, `wgmma` with a register operand,
//   halves the shared-memory traffic but the assembler then waits for every
//   MMA before the next: it sinks the conversions between them.)
// * int8 weights stay int8 in the ring and are converted once per block by
//   the 256 consumer threads into one of three bf16 tiles behind the ring
//   (`convert_w_rows`: two 16-byte loads, four 16-byte stores a thread, free
//   of bank conflicts), by bit placement: beside the exponent byte 0x43 the
//   low seven bits of a weight are the bf16 128 + l and its sign bit the bf16
//   128 (1 + s); one bf16x2 subtraction gives two weights. Five integer /
//   bf16x2 operations for two weights, none on the conversion unit. A proxy
//   fence and a barrier of the consumers hand the tile to the tensor cores.
// * The whole of M = 128 in one 128x128 tile, and the K range split over a
//   thread-block cluster of 1 to 8 blocks: `pick_split` takes the size with
//   the least estimated time among those whose clusters are all on the card
//   at once ((128, 2048, 2048) runs 16 column tiles x 6 K ranges). The
//   partial sums are reduced through distributed shared memory in rank order
//   before the epilogue (the epilogues are not linear): each block sums one
//   slice of the tile's rows over all ranks, all its remote loads in flight
//   at once, and runs the epilogue on that slice. No atomics: the result is
//   bit-equal from run to run.
// * Epilogues keep a column pair per thread and walk the rows
//   (`for_each_row`): per-column vectors are loaded once, and the lines a row
//   needs from device memory are asked for during the K loop (`prefetch`).
// * The weights a product streams never depend on the kernel before it: with
//   programmatic dependent launch a kernel starts while the one before it
//   drains, its first ring stages of W are asked for before
//   `griddepcontrol.wait`, A after it.
//
// With a paired map the tile rows of W are 64 rows of each half of W (one
// box of a three-dimensional map), so a SimpleGate epilogue has columns n and
// n + C of a (K -> 2C) product in one tile. Requirements: K % 16 == 0,
// N % 128 == 0, all pointers 16-byte aligned. Rows >= M are read as zero and
// must not be stored by the epilogue.
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>

#include <cstdint>
#include <mutex>
#include <unordered_map>

#include "common.cuh"

namespace hifidiff {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;
constexpr int kConsumers = 256;      // two warpgroups that issue the MMAs
constexpr int kProducers = 32;       // one warp; one of its threads issues the
                                     // TMA copies
constexpr int kGemmThreads = kConsumers + kProducers;
constexpr int kMaxSplit = 8;         // the portable cluster size
constexpr int kLdC = kBN + 8;        // f32 result row pitch: the accumulator
                                     // stores of a half-warp (rows g, column
                                     // pairs 2t) fall on distinct banks

// A ring slot: A (128 rows x 64 k bf16, 16 KB), then the weights as they come
// from device memory (int8: 8 KB; bf16: 16 KB). All bf16 tiles start on a
// 1 KB boundary.
constexpr int kABytes = kBM * kBK * 2;
template <typename WT>
constexpr int kSlotBytes = kABytes + kBN * kBK * static_cast<int>(sizeof(WT));
// Six ring slots (a block has its SM to itself), and for int8 weights three
// converted bf16 weight tiles behind the ring: 192 KB either way.
constexpr int kSlots = 6;
constexpr int kWcTiles = 3;
constexpr int kWcBytes = kBN * kBK * 2;
template <typename WT>
constexpr int kRingBytes =
    kSlots * kSlotBytes<WT> + (sizeof(WT) == 1 ? kWcTiles * kWcBytes : 0);
constexpr int kResultBytes = kBM * kLdC * 4;
// the f32 result tile reuses the ring once the K loop is over; 1 KB of slack
// to start the ring on a 1 KB boundary (the 128-byte swizzle's period), and
// the ring's mbarriers (two per slot) behind it
template <typename WT>
constexpr int kSmemBytes = kRingBytes<WT> + 1024 + 16 * kSlots;
static_assert(kResultBytes <= kSlots * kSlotBytes<int8_t>,
              "the result tile fits the ring");
static_assert(kSmemBytes<int8_t> <= 227 * 1024 &&
                  kSmemBytes<__nv_bfloat16> <= 227 * 1024,
              "a block's shared memory");

// ---- warpgroup MMA (`wgmma`): four warps multiply a 64-row tile of A by a
// 128-column tile of W, both read by the tensor cores straight from shared
// memory through 64-bit descriptors, the f32 sums in 64 registers a thread.

// Descriptor of a K-major bf16 tile with rows of 128 bytes in the 128-byte
// swizzle (16-byte chunk c of row r at chunk c ^ (r & 7)), 8-row groups 1 KB
// apart. 16 k further along a row is 32 bytes: + 2 in the address field.
__device__ __forceinline__ uint64_t gmma_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Writes to shared memory made by this thread (stores, completed cp.async)
// become visible to the tensor cores' reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// d += A (64 x 16, rows of `da`) @ W (128 x 16, rows of `db`)^T
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Two int8 of a word (bytes 0, 1 with `sel` 0x5140; bytes 2, 3 with 0x5342)
// -> one bf16 pair, exact, without the conversion unit. A byte q is
// l - 128 s with l its low seven bits and s its sign bit. Beside the byte
// 0x43, l is the bf16 128 + l and the bit s (the exponent's lowest bit) is
// the bf16 128 (1 + s): their difference is q. Two masks, two `prmt` and one
// bf16x2 subtraction.
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint32_t word,
                                                     uint32_t sel) {
  constexpr uint32_t kExp = 0x43434343u;
  const uint32_t low = __byte_perm(word & 0x7f7f7f7fu, kExp, sel);
  const uint32_t sign = __byte_perm(word & 0x80808080u, kExp, sel);
  const __nv_bfloat162 d =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&low),
              *reinterpret_cast<const __nv_bfloat162*>(&sign));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// int8 stage (128 rows of 64 weights, as the TMA unit wrote them: 16-byte
// chunk c of row r at chunk c ^ ((r >> 1) & 3)) -> the bf16 tile `wgmma`
// reads (rows of 128 bytes, chunk j of row r at chunk j ^ (r & 7)). Thread i
// of the 256 consumers converts half a row: two 16-byte loads, 32 weights,
// four 16-byte stores, all free of bank conflicts; every weight of the block
// is converted once.
__device__ __forceinline__ void convert_w_rows(const unsigned char* sw8,
                                               unsigned char* wc) {
  const int r = threadIdx.x >> 1, h = threadIdx.x & 1;
  const unsigned char* src = sw8 + r * 64;
  unsigned char* dst = wc + r * 128;
  const int swz8 = (r >> 1) & 3, swz16 = r & 7;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = 2 * h + i;
    const uint4 q = *reinterpret_cast<const uint4*>(src + ((c ^ swz8) << 4));
    uint4 lo, hi;
    lo.x = int8x2_to_bf16x2(q.x, 0x5140u);
    lo.y = int8x2_to_bf16x2(q.x, 0x5342u);
    lo.z = int8x2_to_bf16x2(q.y, 0x5140u);
    lo.w = int8x2_to_bf16x2(q.y, 0x5342u);
    hi.x = int8x2_to_bf16x2(q.z, 0x5140u);
    hi.y = int8x2_to_bf16x2(q.z, 0x5342u);
    hi.z = int8x2_to_bf16x2(q.w, 0x5140u);
    hi.w = int8x2_to_bf16x2(q.w, 0x5342u);
    *reinterpret_cast<uint4*>(dst + (((2 * c) ^ swz16) << 4)) = lo;
    *reinterpret_cast<uint4*>(dst + (((2 * c + 1) ^ swz16) << 4)) = hi;
  }
}

// A barrier of the 256 consumer threads alone.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// ---- TMA. A ring slot has a `full` mbarrier (one arrival: the producer's,
// which also announces the bytes the TMA copies will deliver) and a `free`
// mbarrier (one arrival per consumer warp).
// One box of the matrix behind `map` (`tensor_map` below), from column `k`
// and row `row` on, to shared memory at `dst`; what lies outside the matrix
// arrives as zeros. The bytes are counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int k, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row), "r"(0)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// The tile rows that rank `r` of a cluster of S blocks sums and finishes:
// from slice_row(r, S) up to slice_row(r + 1, S), whole groups of four rows
// (a sample of a 2x2 map is four rows).
__host__ __device__ __forceinline__ int slice_row(int r, int S) {
  return (r * (kBM / 4) / S) * 4;
}

// Sum the partial tiles of the S blocks of the cluster, in rank order: each
// block its own rows [lr0, lr1), in place (no other block reads that slice
// of this block's tile). All of a thread's remote loads are issued before
// the first sum, so the reduction costs one round trip through distributed
// shared memory (which moves about 12 bytes a clock into an SM: 2-5
// thousand clocks for the 32-56 KB of a slice's remote parts). Leaves the
// cluster's barrier arrived at a second time: the caller waits for it before
// the block ends (no block leaves while its tile is being read), after its
// epilogue.
template <int S>
__device__ __forceinline__ void cluster_reduce(float* ct, int lr0,
                                               int lr1) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int kMaxRows = ((kBM / 4 + S - 1) / S) * 4;
  constexpr int kIters =
      (kMaxRows * (kBN / 4) + kGemmThreads - 1) / kGemmThreads;
  const int items = (lr1 - lr0) * (kBN / 4);   // float4s of the slice
  cluster_arrive();
  cluster_wait();   // every block's partial tile is written
  const float* remote[S];
#pragma unroll
  for (int q = 0; q < S; ++q)   // its own tile by the local path
    remote[q] = q == (int)cluster.block_rank() ? ct
                                               : cluster.map_shared_rank(ct, q);
  float4 v[kIters][S];
  int off[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int idx = threadIdx.x + it * kGemmThreads;
    off[it] = (lr0 + idx / (kBN / 4)) * kLdC + (idx % (kBN / 4)) * 4;
    if (idx < items) {
#pragma unroll
      for (int q = 0; q < S; ++q)
        v[it][q] = *reinterpret_cast<const float4*>(remote[q] + off[it]);
    }
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    if (threadIdx.x + it * kGemmThreads >= items) break;
    float4 sum = v[it][0];
#pragma unroll
    for (int q = 1; q < S; ++q) {
      sum.x += v[it][q].x;
      sum.y += v[it][q].y;
      sum.z += v[it][q].z;
      sum.w += v[it][q].w;
    }
    *reinterpret_cast<float4*>(ct + off[it]) = sum;
  }
  cluster_arrive();   // this block has read what it needs of the others
  __syncthreads();    // the summed slice is whole
}

// A whole product. Grid (column tiles, row tiles, K ranges), launched as
// clusters of (1, 1, K ranges). Column tile bx covers the W rows
// [`w_rows` bx, + 128), or with a paired map (`tensor_map`) [64 bx, + 64) of
// each half of W (tile columns 64.. are the second half's; `w_rows` is 64
// then). After the K loop and the
// reduction over the cluster, `ep(tile, lr0, lr1, row0, bx)` is called by
// the whole block for the tile rows [lr0, lr1) this block owns: `tile` is the
// f32 result in shared memory (pitch kLdC), `row0` the global row of tile row
// 0. The epilogue skips rows >= its M. `ep.prefetch(lr0, lr1, row0, bx)` is
// called by the consumer threads once the grid before this one has ended,
// with the K loop still ahead.
template <typename WT, class EP>
__global__ void __launch_bounds__(kGemmThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_w, int K,
                int w_rows, EP ep) {
  constexpr bool kInt8 = sizeof(WT) == 1;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  griddep_launch_dependents();
  namespace cg = cooperative_groups;
  const int splits = gridDim.z;
  const int rank = splits > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int bx = blockIdx.x;
  const int row0 = blockIdx.y * kBM;

  // this rank's K steps
  const int steps = (K + kBK - 1) / kBK;
  const int per = (steps + splits - 1) / splits;
  const int s0 = rank * per;
  const int n = max(0, min(steps, s0 + per) - s0);
  const uint32_t ring = smem_u32(smem);
  constexpr int kWOff = kABytes;   // a slot: A | W
  const uint32_t bars = ring + kRingBytes<WT>;
  auto full = [&](int slot) { return bars + 8 * slot; };
  auto freed = [&](int slot) { return bars + 8 * (kSlots + slot); };
  if (threadIdx.x < kSlots) {
    mbar_init(full(threadIdx.x), 1);
    mbar_init(freed(threadIdx.x), kConsumers / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x == kConsumers) {
    prefetch_map(&map_w);
    prefetch_map(&map_a);
  }
  __syncthreads();

  if (threadIdx.x == kConsumers) {
    // ---- the producer: one thread asks the TMA unit for each stage's two
    // boxes (the 128 rows of W, then the A rows). The weights do not depend
    // on the grid before this one: the first slots' are asked for before
    // `griddepcontrol.wait`, A after it.
    auto load_w = [&](int j) {
      mbar_arrive_expect(full(j % kSlots), kSlotBytes<WT>);
      tma_load(ring + (j % kSlots) * kSlotBytes<WT> + kWOff, &map_w,
               (s0 + j) * kBK, bx * w_rows, full(j % kSlots));
    };
    auto load_a = [&](int j) {
      tma_load(ring + (j % kSlots) * kSlotBytes<WT>, &map_a, (s0 + j) * kBK,
               row0, full(j % kSlots));
    };
    const int first = min(n, kSlots);
    for (int j = 0; j < first; ++j) load_w(j);
    griddep_wait();
    for (int j = 0; j < first; ++j) load_a(j);
    for (int j = first; j < n; ++j) {
      // the slot's stage before (j - kSlots) has been multiplied
      mbar_wait(freed(j % kSlots), (j / kSlots - 1) & 1);
      load_w(j);
      load_a(j);
    }
  }

  // the tile rows this block finishes
  const int lr0 = splits > 1 ? slice_row(rank, splits) : 0;
  const int lr1 = splits > 1 ? slice_row(rank + 1, splits) : kBM;
  const int lane = threadIdx.x & 31;
  const int wg = threadIdx.x >> 7, w4 = (threadIdx.x >> 5) & 3;
  float acc[64];
  if (threadIdx.x < kConsumers) {
    // ---- consumers: C = A W^T, this warpgroup's 64 rows of A by the 128
    // rows of W, both read by the tensor cores from shared memory. The MMAs
    // of stage s run while stage s + 1 is waited for (and converted); its
    // slot goes back to the producer once they are done.
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    unsigned char* wc = smem + kSlots * kSlotBytes<WT>;   // int8: bf16 tiles
    for (int s = 0; s < n; ++s) {
      unsigned char* tile = smem + (s % kSlots) * kSlotBytes<WT>;
      mbar_wait(full(s % kSlots), (s / kSlots) & 1);
      if (s == 0) {
        // the first A rows are here, so the grid before this one has ended:
        // what the epilogue will read of its results can come to L1 now
        ep.prefetch(lr0, lr1, row0, bx);
      }
      uint64_t db;
      if constexpr (kInt8) {
        // this bf16 tile was last read by the MMAs of stage s - 3: both
        // warpgroups waited for those (in stage s - 2) before they met at
        // the barrier of stage s - 1
        unsigned char* w16 = wc + (s % kWcTiles) * kWcBytes;
        convert_w_rows(tile + kWOff, w16);
        fence_proxy_async();
        consumers_sync();
        db = gmma_desc(w16);
      } else {
        db = gmma_desc(tile + kWOff);
      }
      const uint64_t da = gmma_desc(tile + wg * 64 * 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_m64n128k16(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      wgmma_wait<1>();   // the MMAs of stage s - 1 are done
      if (s >= 1 && lane == 0) mbar_arrive(freed((s - 1) % kSlots));
    }
    wgmma_wait<0>();
  }
  __syncthreads();   // the ring is free: it becomes the f32 result tile

  float* ct = reinterpret_cast<float*>(smem);
  if (threadIdx.x < kConsumers) {
    // acc[4 i ..]: A rows 16 w4 + g, + 8 (c0 c1 | c2 c3) by columns
    // 8 i + 2t, + 1
    float* p = ct + (wg * 64 + w4 * 16 + (lane >> 2)) * kLdC + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      *reinterpret_cast<float2*>(p + 8 * i) =
          make_float2(acc[4 * i], acc[4 * i + 1]);
      *reinterpret_cast<float2*>(p + 8 * kLdC + 8 * i) =
          make_float2(acc[4 * i + 2], acc[4 * i + 3]);
    }
  }
  if (splits > 1) {
    switch (splits) {
      case 2: cluster_reduce<2>(ct, lr0, lr1); break;
      case 3: cluster_reduce<3>(ct, lr0, lr1); break;
      case 4: cluster_reduce<4>(ct, lr0, lr1); break;
      case 5: cluster_reduce<5>(ct, lr0, lr1); break;
      case 6: cluster_reduce<6>(ct, lr0, lr1); break;
      case 7: cluster_reduce<7>(ct, lr0, lr1); break;
      default: cluster_reduce<8>(ct, lr0, lr1); break;
    }
  } else {
    __syncthreads();
  }
  ep(ct, lr0, lr1, row0, bx);
  if (splits > 1) cluster_wait();
}

// ---- host side

// The host-side caches below (the descriptors, and per kernel the resident
// cluster counts) are shared by every caller in the process, and ctypes
// releases the GIL during a call: one mutex guards them. It is held only
// while a cache is read or filled, never across a launch.
inline std::mutex& host_cache_mutex() {
  static std::mutex m;
  return m;
}

// The TMA descriptor of a row-major (rows, K) matrix of 1- or 2-byte
// elements, read in boxes of kBN (or kBM) rows by kBK columns. `halves` 2:
// the matrix is two halves of rows / 2 rows each, and a box takes 64 rows of
// either, the second half's behind the first's in shared memory. Rows of 128
// bytes land in the 128-byte swizzle, rows of 64 bytes (int8) in the 64-byte
// swizzle (chunk c of row r at chunk c ^ ((r >> 1) & 3)). Descriptors are
// kept by what they describe: a layer's weights and the allocator's
// activation buffers come back. The cache empties itself past 16,384 entries,
// so a descriptor is copied out (into `out`) under the lock: no pointer into
// the cache outlives the lookup. Returns false where none can be made.
struct MapKey {
  const void* p;
  int rows, K, elem, halves;
  bool operator==(const MapKey& o) const {
    return p == o.p && rows == o.rows && K == o.K && elem == o.elem &&
           halves == o.halves;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = reinterpret_cast<size_t>(k.p);
    h = h * 1000003u ^ static_cast<size_t>(k.rows);
    h = h * 1000003u ^ static_cast<size_t>(k.K);
    return h * 1000003u ^ static_cast<size_t>(k.elem * 4 + k.halves);
  }
};

inline bool tensor_map(CUtensorMap* out, const void* p, int rows, int K,
                       int elem, int halves) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
      CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
      CUtensorMapFloatOOBfill);
  static const Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                            &found);
    return reinterpret_cast<Encode>(fn);
  }();
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> maps;
  const MapKey key{p, rows, K, elem, halves};
  std::lock_guard<std::mutex> lock(host_cache_mutex());
  auto it = maps.find(key);
  if (it != maps.end()) {
    *out = it->second;
    return true;
  }
  if (maps.size() > 16384) maps.clear();
  CUtensorMap m;
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(K) * elem;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows / halves),
                              static_cast<cuuint64_t>(halves)};
  const cuuint64_t strides[2] = {row_bytes, row_bytes * (rows / halves)};
  const cuuint32_t box[3] = {kBK, static_cast<cuuint32_t>(kBN / halves),
                             static_cast<cuuint32_t>(halves)};
  const cuuint32_t ones[3] = {1, 1, 1};
  if (encode == nullptr ||
      encode(&m, elem == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             3, const_cast<void*>(p), dims, strides, box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             elem == 1 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  *out = maps[key] = m;
  return true;
}

template <typename WT, class EP>
cudaLaunchConfig_t gemm_config(dim3 grid, cudaLaunchAttribute* attrs,
                               cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kGemmThreads);
  cfg.dynamicSmemBytes = kSmemBytes<WT>;
  cfg.stream = st;
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = 1;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = grid.z;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  return cfg;
}

// How many clusters of 1 .. kMaxSplit blocks of this kernel the card holds
// at once (index: the size); asked of the runtime once, under the cache's
// lock (the counts are not written again after). Also opts the kernel into
// its dynamic shared memory.
template <typename WT, class EP>
const int* resident_clusters() {
  static int n[kMaxSplit + 1] = {};
  static bool asked = false;
  std::lock_guard<std::mutex> lock(host_cache_mutex());
  if (!asked) {
    auto kernel = gemm_kernel<WT, EP>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemBytes<WT>);
    for (int size = 1; size <= kMaxSplit; ++size) {
      cudaLaunchAttribute attrs[2];
      const cudaLaunchConfig_t cfg =
          gemm_config<WT, EP>(dim3(1, 1, size), attrs, nullptr);
      if (cudaOccupancyMaxActiveClusters(&n[size], kernel, &cfg) !=
          cudaSuccess)
        n[size] = 0;
    }
    cudaGetLastError();
    asked = true;
  }
  return n;
}

// Into how many K ranges (blocks of a cluster) a product of `tiles` output
// tiles is split: the size, among those at which all the clusters are on the
// card at once (a second wave would double the time), with the least
// estimated time of a block. In clocks, as measured on an H100: a K step
// costs 1000 (the TMA unit's 256 box rows), the reduction over a cluster 2600
// plus the remote parts of a 64 KB slice at 12.5 bytes a clock.
inline int pick_split(int tiles, int K, const int* resident) {
  const int steps = (K + kBK - 1) / kBK;
  constexpr int kStepClk = 1000;
  int best = 1, best_cost = steps * kStepClk;
  for (int size = 2; size <= kMaxSplit; ++size) {
    if (tiles > resident[size]) continue;
    const int cost = (steps + size - 1) / size * kStepClk + 2600 +
                     5243 * (size - 1) / size;
    if (cost < best_cost) best = size, best_cost = cost;
  }
  return best;
}

// Launch one product of (M, K) rows `a` with the (N, K) weight `w`. `paired`:
// a column tile takes 64 rows of each half of `w` (columns n and n + N / 2
// of a SimpleGate product side by side). The launch may start before the
// kernel before it in the stream has ended (programmatic dependent launch:
// that kernel's writes are waited for inside, after the first weight stages
// are on their way).
template <typename WT, class EP>
void launch_gemm(const __nv_bfloat16* a, int M, const WT* w, int N, int K,
                 bool paired, const EP& ep, cudaStream_t st) {
  const int n_tiles = N / kBN, row_tiles = (M + kBM - 1) / kBM;
  const int splits =
      pick_split(n_tiles * row_tiles, K, resident_clusters<WT, EP>());
  CUtensorMap map_a, map_w;
  if (!tensor_map(&map_a, a, M, K, 2, 1) ||
      !tensor_map(&map_w, w, N, K, sizeof(WT), paired ? 2 : 1)) {
    // no descriptor, no launch: leave an error for the caller's check
    cudaFuncSetAttribute(gemm_kernel<WT, EP>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, -1);
    return;
  }
  cudaLaunchAttribute attrs[2];
  const cudaLaunchConfig_t cfg = gemm_config<WT, EP>(
      dim3(n_tiles, row_tiles, splits), attrs, st);
  cudaLaunchKernelEx(&cfg, gemm_kernel<WT, EP>, map_a, map_w, K,
                     paired ? kBN / 2 : kBN, ep);
}

// Epilogue helpers. The first 256 threads of the block each keep one pair
// of adjacent tile columns (`pair_col()`) and walk the rows, four rows apart:
// what depends on the column alone is loaded once, before the walk, and what
// a row needs from device memory (`load(row)`) is asked for kBatch rows at a
// time before the first of them is used (a load from L2 takes some 700
// clocks). `f(row, v0, v1, loaded)` for the tile rows [lr0, lr1) with
// row0 + row < M.
__device__ __forceinline__ int pair_col() {
  return (threadIdx.x & (kBN / 2 - 1)) * 2;
}
constexpr int kRowStride = kConsumers / (kBN / 2);
template <int kBatch, class L, class F>
__device__ __forceinline__ void for_each_row(const float* tile, int lr0,
                                             int lr1, int row0, int M, L load,
                                             F f) {
  if (threadIdx.x >= kConsumers) return;
  const int c = pair_col(), last = min(lr1, M - row0);
  for (int r0 = lr0 + threadIdx.x / (kBN / 2); r0 < last;
       r0 += kRowStride * kBatch) {
    decltype(load(0)) x[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (r0 + j * kRowStride < last) x[j] = load(row0 + r0 + j * kRowStride);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int r = r0 + j * kRowStride;
      if (r < last) {
        const float2 v = *reinterpret_cast<const float2*>(tile + r * kLdC + c);
        f(row0 + r, v.x, v.y, x[j]);
      }
    }
  }
}
struct Nothing {};

// Ask for the lines that `addr(row)` names, for this thread's rows of
// `for_each_row`, to be brought to L1.
template <class P>
__device__ __forceinline__ void prefetch_each_row(int lr0, int lr1, int row0,
                                                  int M, P addr) {
  const int last = min(lr1, M - row0);
  for (int r = lr0 + threadIdx.x / (kBN / 2); r < last; r += kRowStride)
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(addr(row0 + r)));
}


__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
// Read-only data (what no block of this kernel writes): through the
// non-coherent path, so that the compiler may batch the loads of several rows.
__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ldg2(const __nv_bfloat16* p) {
  const unsigned int v = __ldg(reinterpret_cast<const unsigned int*>(p));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

}  // namespace hifidiff
