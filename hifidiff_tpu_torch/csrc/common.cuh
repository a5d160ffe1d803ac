// Shared helpers for the port's hand-written kernels: f32 <-> storage-type
// conversion for the two activation dtypes the pipeline runs in, and
// programmatic dependent launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hifidiff {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// Programmatic dependent launch: `wait` returns once the grid before this one
// in the stream has completed and its writes are visible (at once where the
// launch carried no such dependency); `launch_dependents` lets the grid
// after this one start its own prologue.
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

}  // namespace hifidiff
