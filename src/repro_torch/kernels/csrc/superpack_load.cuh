// The weight-chunk load of kernels C and D: four consecutive output
// channels n .. n+3 of superpack row `row`, as f32, lanes at or past N
// zero.  The f32 overload reads the superpack; the int8 overload is kernel
// E (replaces src/repro/kernels/untangled_conv.py::_tap_panel): it reads
// the codes and multiplies each by the row's scale with one IEEE multiply
// (__fmul_rn, never contracted into an FMA), the rounding of JAX's
// panel.astype(f32) * scale and of torch's q.float() * scale.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

template <bool VEC>
__device__ __forceinline__ float4 load_superpack_chunk(
    const float* __restrict__ w, const float* __restrict__ /*scale*/,
    int row, int n, int N) {
  const float* src = w + (size_t)row * N + n;
  if (VEC) return *reinterpret_cast<const float4*>(src);
  float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
  val.x = src[0];
  if (n + 1 < N) val.y = src[1];
  if (n + 2 < N) val.z = src[2];
  if (n + 3 < N) val.w = src[3];
  return val;
}

template <bool VEC>
__device__ __forceinline__ float4 load_superpack_chunk(
    const int8_t* __restrict__ q, const float* __restrict__ scale, int row,
    int n, int N) {
  const int8_t* src = q + (size_t)row * N + n;
  const float s = scale[row];
  float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
  if (VEC) {
    const char4 c = *reinterpret_cast<const char4*>(src);
    val.x = __fmul_rn(static_cast<float>(c.x), s);
    val.y = __fmul_rn(static_cast<float>(c.y), s);
    val.z = __fmul_rn(static_cast<float>(c.z), s);
    val.w = __fmul_rn(static_cast<float>(c.w), s);
    return val;
  }
  val.x = __fmul_rn(static_cast<float>(src[0]), s);
  if (n + 1 < N) val.y = __fmul_rn(static_cast<float>(src[1]), s);
  if (n + 2 < N) val.z = __fmul_rn(static_cast<float>(src[2]), s);
  if (n + 3 < N) val.w = __fmul_rn(static_cast<float>(src[3]), s);
  return val;
}
