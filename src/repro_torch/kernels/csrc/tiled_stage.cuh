// The staging shared by kernels C and D (the spatially tiled kernels): the
// halo'd input slice of one output tile and the weight rows of one C chunk,
// copied into shared memory.  The halo goes element by element with
// cp.async (zero-filled past the plane and past C), so the copy of the next
// chunk is in flight while the current one is multiplied; this is the
// counterpart of the TPU kernels' double-buffered _halo_stream DMA
// (src/repro/kernels/untangled_conv.py:115).  The f32 weights go the same
// way; the int8 codes go through registers, where load_superpack_chunk
// (superpack_load.cuh, kernel E) dequantizes them as it loads.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "superpack_load.cuh"

namespace tiled {

constexpr int kThreads = 256;
constexpr int kTN = 4;  // output channels per thread

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;  // 0 bytes read: the slot is zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Floats of one halo slot: tin_h*tin_w pixels of CK + 1 floats (the extra
// float keeps neighbouring pixels on different banks), rounded to 16 B.
template <int CK>
__host__ __device__ inline int halo_floats(int tin_h, int tin_w) {
  return (tin_h * tin_w * (CK + 1) + 3) / 4 * 4;
}

// Dynamic shared memory of one block: two halo slots, two weight stages of
// taps*CK*BN floats (the Python wrapper's tiled_smem_bytes).
template <int BN, int CK>
__host__ __device__ inline int smem_bytes(int tin_h, int tin_w, int taps) {
  return 4 * (2 * halo_floats<CK>(tin_h, tin_w) + 2 * taps * CK * BN);
}

// Issue the cp.async copies of one halo slice: rows r0.., cols c0.. of
// image b, channels ch0 .. ch0+CK-1, into sx[pix*(CK+1) + c].
template <int CK>
__device__ __forceinline__ void stage_halo(float* sx, const float* x, int b,
                                           int H, int W, int C, int r0,
                                           int c0, int tin_h, int tin_w,
                                           int ch0) {
  constexpr int CKP = CK + 1;
  const int total = tin_h * tin_w * CK;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int pix = e / CK;
    const int c = e - pix * CK;
    const int hr = pix / tin_w;
    const int row = r0 + hr, col = c0 + pix - hr * tin_w, ch = ch0 + c;
    const bool ok = row < H && col < W && ch < C;
    const float* src =
        ok ? x + ((static_cast<size_t>(b) * H + row) * W + col) * C + ch : x;
    cp_async4(sx + pix * CKP + c, src, ok);
  }
}

// The weight rows of one C chunk for every tap: sw[(t*CK + c)*BN + j] =
// W[t*C + ch0 + c, n0 + j], zero past C and past N.  f32: cp.async (the
// caller commits); int8: loaded, dequantized and stored (synchronous).
template <int BN, int CK, bool VEC>
__device__ __forceinline__ void stage_weights(float* sw, const float* w,
                                              const float* /*scale*/,
                                              int taps, int C, int N,
                                              int ch0, int n0) {
  constexpr int NQ = BN / 4;
  const int total = taps * CK * NQ;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int tc = e / NQ;
    const int nq = e - tc * NQ;
    const int t = tc / CK;
    const int ch = ch0 + tc - t * CK;
    const int n = n0 + nq * 4;
    float* dst = sw + tc * BN + nq * 4;
    const bool row_ok = ch < C;
    const float* src = w + (static_cast<size_t>(t) * C + ch) * N + n;
    if (VEC) {
      const bool ok = row_ok && n < N;
      cp_async16(dst, ok ? src : w, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = row_ok && n + j < N;
        cp_async4(dst + j, ok ? src + j : w, ok);
      }
    }
  }
}

template <int BN, int CK, bool VEC>
__device__ __forceinline__ void stage_weights(float* sw, const int8_t* q,
                                              const float* scale, int taps,
                                              int C, int N, int ch0,
                                              int n0) {
  constexpr int NQ = BN / 4;
  const int total = taps * CK * NQ;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int tc = e / NQ;
    const int nq = e - tc * NQ;
    const int t = tc / CK;
    const int ch = ch0 + tc - t * CK;
    const int n = n0 + nq * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ch < C && n < N) {
      val = load_superpack_chunk<VEC>(q, scale, t * C + ch, n, N);
    }
    *reinterpret_cast<float4*>(sw + tc * BN + nq * 4) = val;
  }
}

// Set the kernel's dynamic shared-memory limit once it needs more than the
// default 48 KB (raised only, once per size per instantiation).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, int* allowed) {
  if (bytes <= 48 * 1024 || bytes <= *allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *allowed = bytes;
  return err;
}

}  // namespace tiled
