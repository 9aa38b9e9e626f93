// Kernel C on Hopper: the spatially tiled single (strided or dilated)
// untangled correlation.
//
// Replaces the TPU kernel src/repro/kernels/untangled_conv.py::_tiled_kernel
// (:158) with its double-buffered halo fetch _halo_stream (:115); entry
// _conv_superpack_tiled (:292, pallas_call at :337).  It computes what
// kernel B computes,
//
//   y[b, oh, ow, n] = sum_{t = m*S + n' < R*S} sum_c
//       x[b, oh*s_h + m*d_h, ow*s_w + n'*d_w, c] * W[t*C + c, n],
//
// one spatial output tile (T_oh x T_ow pixels, BN channels) per block, from
// the tile's halo'd input slice: halo_extent(T, taps, stride, dilation)
// rows and columns from (i*T_oh*s_h, j*T_ow*s_w).
//
// Mapping to the card.  One block per (output tile, N tile, image); blocks
// run in no order, and each walks all of C itself in chunks of CK channels.
// For each chunk the block stages the halo slice (tin_h x tin_w x CK) and
// the chunk's weight rows of every tap (R*S x CK x BN) in shared memory;
// both live in two slots, and the next chunk's copy is issued with cp.async
// before the current chunk is multiplied, so it streams while the FFMAs
// run (the counterpart of _halo_stream's two DMA slots).  Every one of the
// R*S taps then reads its strided/dilated window from the one staged halo:
// the plane is read from device memory once per tile and N tile, not once
// per tap, which is the input reuse across taps HUGE2 is about.  Each
// thread keeps TM pixels x 4 channels in registers and sums in IEEE fp32
// FFMA (no TF32, no tensor cores, so the f64 oracle's ULP bound holds);
// each output is written once.  The ragged edge is masked in the copy
// (zero-fill past the plane and past C) and in the store; nothing is
// padded by copies.  Strides and dilations are runtime arguments.
//
// What bounds it.  On an H100 SXM (data sheet: 67 TFLOP/s fp32 on the CUDA
// cores, 3.35 TB/s HBM) the U-Net sites at a 512^2 image that take this
// kernel are the stem (3 -> 32, bytes-bound: ~0.011 ms at B = 1 for its
// 3 MB plane and 32 MB output), down0 (32 -> 64, stride 2, ~0.036 ms of
// FFMA), fuse0 (64 -> 32, ~0.144 ms of FFMA) and the head (32 -> 3,
// bytes-bound ~0.011 ms).  The design aims at the FFMA-bound case: each
// staged halo value feeds 4 FFMAs per thread and each staged weight TM;
// the halo copy costs one instruction per element (cp.async of 4 B, so any
// C is taken), about a fifth of the chunk's FFMAs at C = 64.  Its known
// costs: a CK = 8 chunk wastes FFMA slots when C < 8 (the stem), and the
// 1 + (taps-1)*d/T halo overlap is read again by the neighbouring tile.
//
// Kernel E, int8 weights (replaces the TPU kernel's int8 tap panel,
// src/repro/kernels/untangled_conv.py::_tap_panel).  The int8 entry stages
// each weight as load_superpack_chunk (superpack_load.cuh) gives it: the
// code times its row's scale with one __fmul_rn, stored as f32 into the
// same shared-memory stage, so the FFMA sequence is the f32 entry's and the
// int8 entry on (q, scale) is bit-equal to the f32 entry on
// dequantize(q, scale).  Its weight copy is synchronous (after the
// chunk's FFMAs), the halo copy still asynchronous.

#include <cuda_runtime.h>

#include <cstdint>

#include "tiled_stage.cuh"

namespace {

using tiled::kThreads;
using tiled::kTN;

template <int BN, int TM, int CK, bool VEC, typename WT>
__global__ void __launch_bounds__(kThreads)
conv_tiled_kernel(const float* __restrict__ x, const WT* __restrict__ w,
                  const float* __restrict__ scale, float* __restrict__ y,
                  int Hp, int Wp, int C, int N, int OH, int OW, int R, int S,
                  int sh, int sw, int dh, int dw, int T_oh, int T_ow,
                  int tin_h, int tin_w, int n_tj) {
  constexpr int NGN = BN / kTN;            // threads across N
  constexpr int NG = kThreads / NGN;       // pixel groups
  constexpr int CKP = CK + 1;
  constexpr bool kAsyncW = std::is_same<WT, float>::value;
  extern __shared__ __align__(16) float smem[];

  const int taps = R * S;
  const int halo = tiled::halo_floats<CK>(tin_h, tin_w);
  float* sx[2] = {smem, smem + halo};
  float* sw_[2] = {smem + 2 * halo, smem + 2 * halo + taps * CK * BN};

  const int b = blockIdx.z;
  const int n0 = blockIdx.y * BN;
  const int ti = blockIdx.x / n_tj;
  const int tj = blockIdx.x - ti * n_tj;
  const int oh0 = ti * T_oh, ow0 = tj * T_ow;
  const int r0 = oh0 * sh, c0 = ow0 * sw;
  const int tid = threadIdx.x;
  const int tx = tid % NGN, ty = tid / NGN;
  const int n_pix = T_oh * T_ow;
  const int n_chunks = (C + CK - 1) / CK;

  // halo offset of each of the thread's pixels' tap-(0, 0) read
  int pbase[TM];
#pragma unroll
  for (int k = 0; k < TM; ++k) {
    const int p = ty + k * NG;
    const int ph = p < n_pix ? p / T_ow : 0;
    const int pw = p < n_pix ? p - ph * T_ow : 0;
    pbase[k] = (ph * sh * tin_w + pw * sw) * CKP;
  }

  auto issue = [&](int it, int slot) {
    tiled::stage_halo<CK>(sx[slot], x, b, Hp, Wp, C, r0, c0, tin_h, tin_w,
                          it * CK);
    if constexpr (kAsyncW) {
      tiled::stage_weights<BN, CK, VEC>(sw_[slot], w, scale, taps, C, N,
                                        it * CK, n0);
    }
    tiled::cp_async_commit();
  };

  float acc[TM][kTN];
#pragma unroll
  for (int k = 0; k < TM; ++k)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[k][j] = 0.f;

  issue(0, 0);
  if constexpr (!kAsyncW) {
    tiled::stage_weights<BN, CK, VEC>(sw_[0], w, scale, taps, C, N, 0, n0);
  }
  for (int it = 0; it < n_chunks; ++it) {
    const int cur = it & 1;
    if (it + 1 < n_chunks) {
      issue(it + 1, cur ^ 1);  // streams while this chunk is multiplied
      tiled::cp_async_wait<1>();
    } else {
      tiled::cp_async_wait<0>();
    }
    __syncthreads();
    const float* X = sx[cur];
    const float* Wt = sw_[cur] + tx * kTN;
    for (int t = 0; t < taps; ++t) {
      const int mi = t / S;
      const int toff = (mi * dh * tin_w + (t - mi * S) * dw) * CKP;
      const float* wt = Wt + t * CK * BN;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        float a[TM];
#pragma unroll
        for (int k = 0; k < TM; ++k) a[k] = X[pbase[k] + toff + c];
        const float4 bv = *reinterpret_cast<const float4*>(wt + c * BN);
#pragma unroll
        for (int k = 0; k < TM; ++k) {
          acc[k][0] = fmaf(a[k], bv.x, acc[k][0]);
          acc[k][1] = fmaf(a[k], bv.y, acc[k][1]);
          acc[k][2] = fmaf(a[k], bv.z, acc[k][2]);
          acc[k][3] = fmaf(a[k], bv.w, acc[k][3]);
        }
      }
    }
    if constexpr (!kAsyncW) {
      if (it + 1 < n_chunks) {
        tiled::stage_weights<BN, CK, VEC>(sw_[cur ^ 1], w, scale, taps, C,
                                          N, (it + 1) * CK, n0);
      }
    }
    __syncthreads();  // this slot is refilled two chunks on
  }

  const int n = n0 + tx * kTN;
  if (n >= N) return;
#pragma unroll
  for (int k = 0; k < TM; ++k) {
    const int p = ty + k * NG;
    if (p >= n_pix) continue;
    const int ph = p / T_ow;
    const int oh = oh0 + ph, ow = ow0 + p - ph * T_ow;
    if (oh >= OH || ow >= OW) continue;
    float* dst = y + ((static_cast<size_t>(b) * OH + oh) * OW + ow) * N + n;
    if (VEC) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
    } else {
      dst[0] = acc[k][0];
      if (n + 1 < N) dst[1] = acc[k][1];
      if (n + 2 < N) dst[2] = acc[k][2];
      if (n + 3 < N) dst[3] = acc[k][3];
    }
  }
}

template <int BN, int TM, int CK, bool VEC, typename WT>
int launch(const float* x, const WT* w, const float* scale, float* y, int B,
           int Hp, int Wp, int C, int N, int OH, int OW, int R, int S,
           int sh, int sw, int dh, int dw, int T_oh, int T_ow, int tin_h,
           int tin_w, int n_ti, int n_tj, cudaStream_t stream) {
  static int allowed = 0;
  const auto kernel = conv_tiled_kernel<BN, TM, CK, VEC, WT>;
  const int smem = tiled::smem_bytes<BN, CK>(tin_h, tin_w, R * S);
  const cudaError_t err = tiled::allow_smem(kernel, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_ti * n_tj, (N + BN - 1) / BN, B);
  kernel<<<grid, kThreads, smem, stream>>>(x, w, scale, y, Hp, Wp, C, N, OH,
                                           OW, R, S, sh, sw, dh, dw, T_oh,
                                           T_ow, tin_h, tin_w, n_tj);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC, typename WT>
int dispatch_vec(int config, const float* x, const WT* w, const float* scale,
                 float* y, int B, int Hp, int Wp, int C, int N, int OH,
                 int OW, int R, int S, int sh, int sw, int dh, int dw,
                 int T_oh, int T_ow, int tin_h, int tin_w, int n_ti,
                 int n_tj, cudaStream_t st) {
  // the Python wrapper's _TILED_CONFIGS: (BN, TM, CK)
  switch (config) {
    case 0:
      return launch<64, 8, 8, VEC>(x, w, scale, y, B, Hp, Wp, C, N, OH, OW,
                                   R, S, sh, sw, dh, dw, T_oh, T_ow, tin_h,
                                   tin_w, n_ti, n_tj, st);
    case 1:
      return launch<32, 4, 8, VEC>(x, w, scale, y, B, Hp, Wp, C, N, OH, OW,
                                   R, S, sh, sw, dh, dw, T_oh, T_ow, tin_h,
                                   tin_w, n_ti, n_tj, st);
    case 2:
      return launch<4, 4, 8, VEC>(x, w, scale, y, B, Hp, Wp, C, N, OH, OW,
                                  R, S, sh, sw, dh, dw, T_oh, T_ow, tin_h,
                                  tin_w, n_ti, n_tj, st);
    case 3:
      return launch<64, 8, 4, VEC>(x, w, scale, y, B, Hp, Wp, C, N, OH, OW,
                                   R, S, sh, sw, dh, dw, T_oh, T_ow, tin_h,
                                   tin_w, n_ti, n_tj, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename WT>
int dispatch(const float* x, const WT* w, const float* scale, float* y,
             int B, int Hp, int Wp, int C, int N, int OH, int OW, int R,
             int S, int sh, int sw, int dh, int dw, int T_oh, int T_ow,
             int tin_h, int tin_w, int n_ti, int n_tj, int config, int vec,
             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    return dispatch_vec<true>(config, x, w, scale, y, B, Hp, Wp, C, N, OH,
                              OW, R, S, sh, sw, dh, dw, T_oh, T_ow, tin_h,
                              tin_w, n_ti, n_tj, st);
  }
  return dispatch_vec<false>(config, x, w, scale, y, B, Hp, Wp, C, N, OH, OW,
                             R, S, sh, sw, dh, dw, T_oh, T_ow, tin_h, tin_w,
                             n_ti, n_tj, st);
}

}  // namespace

// Launches kernel C on `stream` and returns cudaGetLastError() (0 =
// launched).  `config` selects the block (the Python wrapper's
// _TILED_CONFIGS), (T_oh, T_ow) is the block's output tile, tin_h x tin_w
// its halo (halo_extent), n_ti x n_tj the tiles over the output, `vec` the
// float4 weight copy and store (N % 4 == 0, 16-byte aligned w and y).
extern "C" int untangled_conv2d_tiled_f32(
    const float* x, const float* w, float* y, int B, int Hp, int Wp, int C,
    int N, int OH, int OW, int R, int S, int sh, int sw, int dh, int dw,
    int T_oh, int T_ow, int tin_h, int tin_w, int n_ti, int n_tj, int config,
    int vec, void* stream) {
  return dispatch<float>(x, w, nullptr, y, B, Hp, Wp, C, N, OH, OW, R, S, sh,
                         sw, dh, dw, T_oh, T_ow, tin_h, tin_w, n_ti, n_tj,
                         config, vec, stream);
}

// Kernel E inside kernel C: as untangled_conv2d_tiled_f32 on int8 codes `q`
// with one f32 scale per superpack row (`scale`, R*S*C floats); `vec` also
// needs `q` 4-byte aligned (char4 loads).
extern "C" int untangled_conv2d_tiled_i8(
    const float* x, const int8_t* q, const float* scale, float* y, int B,
    int Hp, int Wp, int C, int N, int OH, int OW, int R, int S, int sh,
    int sw, int dh, int dw, int T_oh, int T_ow, int tin_h, int tin_w,
    int n_ti, int n_tj, int config, int vec, void* stream) {
  return dispatch<int8_t>(x, q, scale, y, B, Hp, Wp, C, N, OH, OW, R, S, sh,
                          sw, dh, dw, T_oh, T_ow, tin_h, tin_w, n_ti, n_tj,
                          config, vec, stream);
}
