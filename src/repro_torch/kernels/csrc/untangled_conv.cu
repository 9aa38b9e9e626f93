// Kernel B on Hopper: the single (strided or dilated) untangled correlation.
//
// Replaces the TPU kernel src/repro/kernels/untangled_conv.py::_kernel
// (entry untangled_conv2d_superpack_pallas; HWIO entry
// untangled_conv2d_pallas).  It computes, in ONE launch, the valid
// correlation of a pre-padded NHWC plane with the tap-major superpack,
// with no zero inserted into the plane or the kernel:
//
//   y[b, oh, ow, n] = sum_{t = m*S + n' < R*S} sum_c
//       x[b, oh*s_h + m*d_h, ow*s_w + n'*d_w, c] * W[t*C + c, n]
//
// where W is the (R*S*C, N) superpack (ConvPlan.pack).  Strided and
// dilated kinds are the same kernel: dilation only moves each tap's read
// origin inside the plane.
//
// Mapping to the card.  This is one implicit-im2col GEMM: M = B*OH*OW
// output pixels (the batch folded in, so B = 64 fills the card), N output
// channels, K = R*S*C.  The K index k = t*C + c IS the superpack row, so
// the weight operand is a plain contiguous (K, N) row-major matrix and
// only the plane side is a gather, at (oh*s_h + m*d_h, ow*s_w + n'*d_w).
// K is walked as one flat range (not per tap), so a thin C (the RGB input
// of the first discriminator layer, C = 3, K = 75) wastes no K slots; each
// loaded element finds its own tap from k.  Blocks run in no order on 132
// SMs, so each block owns one (M tile, N tile) output tile and loops over
// all of K itself; that loop replaces the TPU's sequential C grid axis and
// its VMEM scratch accumulator.  Inside the block, (BK x BM) plane chunks
// and (BK x BN) superpack chunks are staged in double-buffered shared
// memory (the next chunk is fetched into registers while the current one
// is multiplied), and every thread accumulates a TM x TN register tile
// with IEEE fp32 FFMA: no TF32, no tensor cores, so the f64 oracle's ULP
// bound holds.  Ragged C, N and M are masked in the loads and stores;
// nothing is padded by copies.  The float4 path needs C % 4 == 0 (then
// four consecutive k share one tap) and N % 4 == 0; anything else takes
// the scalar path, which masks every element.
//
// What bounds it.  On an H100 SXM (data sheet: 67 TFLOP/s fp32 on the
// CUDA cores, 3.35 TB/s HBM; the card these numbers were written for is an
// NVIDIA H100 80GB HBM3 at a 700 W power limit) the DCGAN discriminator
// sites D2-D4 each do 2*OH*OW*25*C*N ~ 419 MFLOP per image and D1 19.7
// MFLOP; their superpacks are 0.04 / 3.3 / 13.1 / 52.4 MB.  At batch 1, D4
// is bytes-bound at ~15.6 us (its 52 MB superpack); at batch 64, D2-D4 are
// ops-bound at ~400 us each.  This first design aims at the compute-bound
// case with a register-tiled SIMT GEMM: the host picks a 128x128 tile (8x8
// per thread) when that alone fills the card, a 64x64 tile (4x4 per thread)
// when it would not, and a 256x16 tile when N is tiny.  At batch 1 the few
// blocks (8-32) each walk all of K with one chunk in flight, so the kernel
// is latency-bound there, far above the memory bound; splitting K across
// blocks is the known next step.
//
// Kernel E, int8 weights (replaces the TPU kernel's int8 tap panel,
// src/repro/kernels/untangled_conv.py::_tap_panel).  The int8 entry takes
// the superpack as int8 codes q (R*S*C, N) and one f32 scale per superpack
// row; since k IS the row, the chunk load reads the codes (char4 on the
// vector path) and multiplies each by scale[k] with one IEEE multiply (the
// rounding of JAX's panel.astype(f32) * scale; csrc/superpack_load.cuh),
// then stores f32 into the same shared-memory tile the f32 kernel uses.
// The FFMA loop, the tiles and the accumulation order are the f32
// kernel's, so the int8 kernel on (q, scale) is bit-equal to the f32
// kernel on dequantize(q, scale).  The scale sits on the contraction dim,
// so it cannot move after the dot.  It cuts the weight bytes about 4x (1 B
// per weight + 4 B per row), but neither entry is bound by them: at B = 1
// both are latency-bound (the serial K walk above), at batch 64 both are
// FFMA-bound, and the int8 entry runs up to ~30% slower than the f32 one
// on the vector path (PERF.md).

#include <cuda_runtime.h>

#include <cstdint>

#include "superpack_load.cuh"

namespace {

constexpr int kThreads = 256;

template <int BM, int BN, int BK, int TM, int TN, bool VEC, typename WT>
__global__ void __launch_bounds__(kThreads)
conv_kernel(const float* __restrict__ x, const WT* __restrict__ w,
            const float* __restrict__ scale, float* __restrict__ y, int B,
            int Hp, int Wp, int C, int N, int OH, int OW, int S, int K,
            int sh, int sw, int dh, int dw) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "one TMxTN tile a thread");
  static_assert(TM % 4 == 0 && TN % 4 == 0 && BK % 4 == 0, "float4 groups");
  constexpr int KQ = BK / 4;                   // float4 chunks per A row
  constexpr int A_CH = BM * KQ;                // float4 chunks of an A tile
  constexpr int B_CH = BK * BN / 4;            // float4 chunks of a B tile
  constexpr int A_PT = (A_CH + kThreads - 1) / kThreads;
  constexpr int B_PT = (B_CH + kThreads - 1) / kThreads;
  constexpr int NQ = BN / 4;                   // float4 chunks per B row
  constexpr int MSTEP = 4 * BM / TM;           // row stride of a thread's groups
  constexpr int NSTEP = 4 * BN / TN;           // col stride of a thread's groups
  constexpr int PAD = 4;

  __shared__ __align__(16) float As[2][BK][BM + PAD];
  __shared__ __align__(16) float Bs[2][BK][BN + PAD];

  const int OHW = OH * OW;
  const int M = B * OHW;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int k_iters = (K + BK - 1) / BK;
  const int tid = threadIdx.x;

  // A chunk coordinates: the plane offset of each row's tap-(0, 0) read
  int a_base[A_PT], a_row[A_PT], a_k[A_PT];
  bool a_ok[A_PT];
#pragma unroll
  for (int i = 0; i < A_PT; ++i) {
    const int q = tid + i * kThreads;
    a_row[i] = q / KQ;
    a_k[i] = (q % KQ) * 4;
    const int m = m0 + a_row[i];
    a_ok[i] = q < A_CH && m < M;
    const int mm = a_ok[i] ? m : 0;
    const int b = mm / OHW, r = mm - (mm / OHW) * OHW;
    const int oh = r / OW, ow = r - (r / OW) * OW;
    a_base[i] = ((b * Hp + oh * sh) * Wp + ow * sw) * C;
  }
  int b_row[B_PT], b_col[B_PT];
  bool b_ok[B_PT];
#pragma unroll
  for (int i = 0; i < B_PT; ++i) {
    const int q = tid + i * kThreads;
    b_row[i] = q / NQ;
    b_col[i] = (q % NQ) * 4;
    b_ok[i] = q < B_CH;
  }

  // plane offset of superpack row k = (m*S + n)*C + c relative to the
  // row's tap-(0, 0) read
  auto tap_shift = [&](int k) -> int {
    const int t = k / C;
    const int c = k - t * C;
    const int mi = t / S;
    const int ni = t - mi * S;
    return (mi * dh * Wp + ni * dw) * C + c;
  };

  float4 a_reg[A_PT], b_reg[B_PT];

  auto load = [&](int it) {
    const int k0 = it * BK;
#pragma unroll
    for (int i = 0; i < A_PT; ++i) {
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      const int k = k0 + a_k[i];
      if (a_ok[i] && k < K) {
        if (VEC) {
          // C % 4 == 0: k .. k+3 lie in one tap, and K % 4 == 0
          val = *reinterpret_cast<const float4*>(x + a_base[i] + tap_shift(k));
        } else {
          val.x = x[a_base[i] + tap_shift(k)];
          if (k + 1 < K) val.y = x[a_base[i] + tap_shift(k + 1)];
          if (k + 2 < K) val.z = x[a_base[i] + tap_shift(k + 2)];
          if (k + 3 < K) val.w = x[a_base[i] + tap_shift(k + 3)];
        }
      }
      a_reg[i] = val;
    }
#pragma unroll
    for (int i = 0; i < B_PT; ++i) {
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      const int k = k0 + b_row[i];
      const int n = n0 + b_col[i];
      if (b_ok[i] && k < K && n < N) {
        val = load_superpack_chunk<VEC>(w, scale, k, n, N);
      }
      b_reg[i] = val;
    }
  };

  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_PT; ++i) {
      if (tid + i * kThreads < A_CH) {
        As[buf][a_k[i] + 0][a_row[i]] = a_reg[i].x;
        As[buf][a_k[i] + 1][a_row[i]] = a_reg[i].y;
        As[buf][a_k[i] + 2][a_row[i]] = a_reg[i].z;
        As[buf][a_k[i] + 3][a_row[i]] = a_reg[i].w;
      }
    }
#pragma unroll
    for (int i = 0; i < B_PT; ++i) {
      if (b_ok[i]) {
        *reinterpret_cast<float4*>(&Bs[buf][b_row[i]][b_col[i]]) = b_reg[i];
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);

  if (k_iters > 0) {
    load(0);
    store(0);
  }
  __syncthreads();
  for (int it = 0; it < k_iters; ++it) {
    const int cur = it & 1;
    if (it + 1 < k_iters) load(it + 1);  // in flight during the products
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 v =
            *reinterpret_cast<const float4*>(&As[cur][k][g * MSTEP + ty * 4]);
        a[g * 4 + 0] = v.x;
        a[g * 4 + 1] = v.y;
        a[g * 4 + 2] = v.z;
        a[g * 4 + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 v =
            *reinterpret_cast<const float4*>(&Bs[cur][k][g * NSTEP + tx * 4]);
        b[g * 4 + 0] = v.x;
        b[g * 4 + 1] = v.y;
        b[g * 4 + 2] = v.z;
        b[g * 4 + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (it + 1 < k_iters) store(cur ^ 1);
    __syncthreads();
  }

  // output row m = (b, oh, ow) is y's row m: (B, OH, OW, N) is contiguous
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + (i / 4) * MSTEP + ty * 4 + (i % 4);
    if (m >= M) continue;
    float* dst = y + (size_t)m * N;
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const int n = n0 + g * NSTEP + tx * 4;
      if (n >= N) continue;
      const float4 val = make_float4(acc[i][g * 4 + 0], acc[i][g * 4 + 1],
                                     acc[i][g * 4 + 2], acc[i][g * 4 + 3]);
      if (VEC) {
        *reinterpret_cast<float4*>(dst + n) = val;
      } else {
        dst[n] = val.x;
        if (n + 1 < N) dst[n + 1] = val.y;
        if (n + 2 < N) dst[n + 2] = val.z;
        if (n + 3 < N) dst[n + 3] = val.w;
      }
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN, typename WT>
void launch(bool vec, dim3 grid, cudaStream_t stream, const float* x,
            const WT* w, const float* scale, float* y, int B, int Hp, int Wp,
            int C, int N, int OH, int OW, int S, int K, int sh, int sw,
            int dh, int dw) {
  if (vec) {
    conv_kernel<BM, BN, BK, TM, TN, true, WT><<<grid, kThreads, 0, stream>>>(
        x, w, scale, y, B, Hp, Wp, C, N, OH, OW, S, K, sh, sw, dh, dw);
  } else {
    conv_kernel<BM, BN, BK, TM, TN, false, WT><<<grid, kThreads, 0, stream>>>(
        x, w, scale, y, B, Hp, Wp, C, N, OH, OW, S, K, sh, sw, dh, dw);
  }
}

template <typename WT>
int dispatch(const float* x, const WT* w, const float* scale, float* y,
             int B, int Hp, int Wp, int C, int N, int OH, int OW, int R,
             int S, int sh, int sw, int dh, int dw, int config, int vec,
             int grid_m, int grid_n, void* stream) {
  const dim3 grid(grid_m, grid_n);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int K = R * S * C;
  switch (config) {
    case 0:
      launch<128, 128, 8, 8, 8>(vec != 0, grid, st, x, w, scale, y, B, Hp,
                                Wp, C, N, OH, OW, S, K, sh, sw, dh, dw);
      break;
    case 1:
      launch<64, 64, 16, 4, 4>(vec != 0, grid, st, x, w, scale, y, B, Hp,
                               Wp, C, N, OH, OW, S, K, sh, sw, dh, dw);
      break;
    case 2:
      launch<256, 16, 8, 4, 4>(vec != 0, grid, st, x, w, scale, y, B, Hp,
                               Wp, C, N, OH, OW, S, K, sh, sw, dh, dw);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches kernel B on `stream` and returns cudaGetLastError() (0 = launched).
// `config` selects the block tile (0: 128x128, 1: 64x64, 2: 256x16; the
// Python wrapper's _CONFIGS), `vec` the float4 path (C % 4 == N % 4 == 0,
// 16-byte aligned pointers), `grid_m` ceil(B*OH*OW / BM) and `grid_n`
// ceil(N / BN).
extern "C" int untangled_conv2d_f32(const float* x, const float* w, float* y,
                                    int B, int Hp, int Wp, int C, int N,
                                    int OH, int OW, int R, int S, int sh,
                                    int sw, int dh, int dw, int config,
                                    int vec, int grid_m, int grid_n,
                                    void* stream) {
  return dispatch<float>(x, w, nullptr, y, B, Hp, Wp, C, N, OH, OW, R, S, sh,
                         sw, dh, dw, config, vec, grid_m, grid_n, stream);
}

// Kernel E inside kernel B: as untangled_conv2d_f32 on int8 codes `q` with
// one f32 scale per superpack row (`scale`, R*S*C floats); `vec` also needs
// `q` 4-byte aligned (char4 loads).
extern "C" int untangled_conv2d_i8(const float* x, const int8_t* q,
                                   const float* scale, float* y, int B,
                                   int Hp, int Wp, int C, int N, int OH,
                                   int OW, int R, int S, int sh, int sw,
                                   int dh, int dw, int config, int vec,
                                   int grid_m, int grid_n, void* stream) {
  return dispatch<int8_t>(x, q, scale, y, B, Hp, Wp, C, N, OH, OW, R, S, sh,
                          sw, dh, dw, config, vec, grid_m, grid_n, stream);
}
