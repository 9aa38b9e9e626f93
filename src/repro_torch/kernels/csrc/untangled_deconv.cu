// Kernel A on Hopper: the fused multi-phase transposed convolution.
//
// Replaces the TPU kernel src/repro/kernels/untangled_conv.py::_deconv_kernel
// (entry untangled_deconv2d_pallas).  It computes, in ONE launch, every
// s_h*s_w output phase of a transposed conv over the globally padded input
// plane, with no zero inserted and no interleave pass afterwards:
//
//   y[b, s_h*u + q_h, s_w*v + q_w, n] =
//       sum_{t < T_h*T_w} sum_c  xg[b, xoff_h + t/T_w + u, xoff_w + t%T_w + v, c]
//                              * W[(tap_off + t)*C + c, n]
//
// where W is the tap-major superpack (ConvPlan.pack) and (q, tap_off, T,
// xoff, U, V) is one phase's plan-time record.  Phases with no taps store
// zeros (the output comes from torch.empty).
//
// Mapping to the card.  Per phase this is a GEMM: M = B*U*V output pixels
// (batch folded in), N output channels, K = T*C with the K index t*C + c
// equal to the superpack row inside the phase, so the B operand is a plain
// contiguous (T*C, N) row block and the A operand an implicit im2col of the
// plane.  Blocks run in no order on 132 SMs, so each block owns one
// (phase, M tile, N tile) output tile and loops over the whole K range
// itself; that loop replaces the TPU's sequential C grid axis and its VMEM
// scratch accumulator.  Inside the block, (BK x BM) plane chunks and (BK x BN)
// superpack chunks are staged in double-buffered shared memory (the next
// chunk is fetched into registers while the current one is multiplied), and
// every thread accumulates a TM x TN register tile with IEEE fp32 FFMA: no
// TF32, no tensor cores, so the f64 oracle's ULP bound holds.  Ragged C, N
// and M are masked in the loads and stores; nothing is padded by copies.
//
// What bounds it.  The fp32 FFMA peak of an H100 SXM is about 67 TFLOP/s,
// HBM about 3.35 TB/s.  At batch 1 the superpack dominates the bytes (DC1:
// 52.4 MB against 0.4 GFLOP) and the layer is memory bound (~15.6 us); at
// batch 64 DC1-DC3 are compute bound (~400 us each).  This first design
// targets the compute-bound case with a register-tiled SIMT GEMM: the host
// picks a 128x128 tile (8x8 per thread) when that fills the card, a 64x64
// tile (4x4 per thread) when it would not, and a 256x16 tile when N is tiny
// (the RGB head, N = 3).  At batch 1 the few blocks each walk all of K with
// one outstanding chunk, so the kernel is latency bound there, far above
// the memory bound; splitting K across blocks is the known next step.
//
// Kernel E, int8 weights (replaces the TPU kernel's int8 tap panel,
// src/repro/kernels/untangled_conv.py::_tap_panel).  The int8 entry takes
// the superpack as int8 codes q (sum T*C, N) and one f32 scale per
// superpack row (tap_off + t)*C + c; the chunk load reads the codes (char4
// on the vector path), multiplies each by its row's scale with one IEEE
// multiply (csrc/superpack_load.cuh) and stores f32 into the same
// shared-memory tile, so the FFMA loop, tiles and accumulation order are
// the f32 kernel's and the int8 kernel on (q, scale) is bit-equal to the
// f32 kernel on dequantize(q, scale).  It moves 1 B per weight (+ 4 B per
// row) instead of 4 (DC1: 52.4 MB -> 13.2 MB), but the kernel is not bound
// by those bytes: at batch 1 it is latency-bound as above, at batch 64
// FFMA-bound, and it runs up to ~30% slower than the f32 entry (PERF.md).

#include <cuda_runtime.h>

#include <cstdint>

#include "superpack_load.cuh"

namespace {

constexpr int kThreads = 256;
// per-phase record: q_h q_w tap_off T_h T_w xoff_h xoff_w U V
constexpr int kRec = 9;

template <int BM, int BN, int BK, int TM, int TN, bool VEC, typename WT>
__global__ void __launch_bounds__(kThreads)
deconv_kernel(const float* __restrict__ xg, const WT* __restrict__ w,
              const float* __restrict__ scale,
              const int* __restrict__ table, float* __restrict__ y,
              int B, int Hg, int Wg, int C, int N, int OH, int OW,
              int sh, int sw, int n_phases) {
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

  // which phase and which M tile of it this block owns
  int tile = blockIdx.x;
  int p = 0;
  for (; p < n_phases; ++p) {
    const int m_p = B * table[p * kRec + 7] * table[p * kRec + 8];
    const int tiles = (m_p + BM - 1) / BM;
    if (tile < tiles) break;
    tile -= tiles;
  }
  if (p == n_phases) return;
  const int* rec = table + p * kRec;
  const int qh = rec[0], qw = rec[1], tap_off = rec[2], tw = rec[4];
  const int xh = rec[5], xw = rec[6], U = rec[7], V = rec[8];
  const int T = rec[3] * tw;
  const int UV = U * V;
  const int M = B * UV;
  const int m0 = tile * BM;
  const int n0 = blockIdx.y * BN;
  const int kc = (C + BK - 1) / BK;
  const int k_iters = T * kc;
  const int tid = threadIdx.x;

  // A chunk coordinates are fixed for the whole K loop
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
    const int b = mm / UV, r = mm - (mm / UV) * UV;
    const int u = r / V, v = r - (r / V) * V;
    a_base[i] = ((b * Hg + xh + u) * Wg + xw + v) * C;
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

  float4 a_reg[A_PT], b_reg[B_PT];

  auto load = [&](int it) {
    const int t = it / kc;
    const int c0 = (it - t * kc) * BK;
    const int shift = ((t / tw) * Wg + (t % tw)) * C;
    const int wrow0 = (tap_off + t) * C + c0;
#pragma unroll
    for (int i = 0; i < A_PT; ++i) {
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      const int c = c0 + a_k[i];
      if (a_ok[i] && c < C) {
        const float* src = xg + a_base[i] + shift + c;
        if (VEC) {
          val = *reinterpret_cast<const float4*>(src);
        } else {
          val.x = src[0];
          if (c + 1 < C) val.y = src[1];
          if (c + 2 < C) val.z = src[2];
          if (c + 3 < C) val.w = src[3];
        }
      }
      a_reg[i] = val;
    }
#pragma unroll
    for (int i = 0; i < B_PT; ++i) {
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      const int c = c0 + b_row[i];
      const int n = n0 + b_col[i];
      if (b_ok[i] && c < C && n < N) {
        val = load_superpack_chunk<VEC>(w, scale, wrow0 + b_row[i], n, N);
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

  // interleaved store: row m = (b, u, v) lands at (s_h*u + q_h, s_w*v + q_w)
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + (i / 4) * MSTEP + ty * 4 + (i % 4);
    if (m >= M) continue;
    const int b = m / UV, r = m - (m / UV) * UV;
    const int u = r / V, v = r - (r / V) * V;
    float* dst = y + ((size_t)(b * OH + sh * u + qh) * OW + sw * v + qw) * N;
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
void launch(bool vec, dim3 grid, cudaStream_t stream, const float* xg,
            const WT* w, const float* scale, const int* table, float* y,
            int B, int Hg, int Wg, int C, int N, int OH, int OW, int sh,
            int sw, int n_phases) {
  if (vec) {
    deconv_kernel<BM, BN, BK, TM, TN, true, WT>
        <<<grid, kThreads, 0, stream>>>(xg, w, scale, table, y, B, Hg, Wg, C,
                                        N, OH, OW, sh, sw, n_phases);
  } else {
    deconv_kernel<BM, BN, BK, TM, TN, false, WT>
        <<<grid, kThreads, 0, stream>>>(xg, w, scale, table, y, B, Hg, Wg, C,
                                        N, OH, OW, sh, sw, n_phases);
  }
}

template <typename WT>
int dispatch(const float* xg, const WT* w, const float* scale,
             const int* table, float* y, int B, int Hg, int Wg, int C, int N,
             int OH, int OW, int sh, int sw, int n_phases, int config,
             int vec, int grid_m, int grid_n, void* stream) {
  const dim3 grid(grid_m, grid_n);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (config) {
    case 0:
      launch<128, 128, 8, 8, 8>(vec != 0, grid, s, xg, w, scale, table, y, B,
                                Hg, Wg, C, N, OH, OW, sh, sw, n_phases);
      break;
    case 1:
      launch<64, 64, 16, 4, 4>(vec != 0, grid, s, xg, w, scale, table, y, B,
                               Hg, Wg, C, N, OH, OW, sh, sw, n_phases);
      break;
    case 2:
      launch<256, 16, 8, 4, 4>(vec != 0, grid, s, xg, w, scale, table, y, B,
                               Hg, Wg, C, N, OH, OW, sh, sw, n_phases);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches kernel A on `stream` and returns cudaGetLastError() (0 = launched).
// `config` selects the block tile (0: 128x128, 1: 64x64, 2: 256x16; the
// Python wrapper's _CONFIGS), `vec` the float4 path (C % 4 == N % 4 == 0,
// 16-byte aligned pointers), `grid_m` the sum over phases of
// ceil(B*U*V / BM) and `grid_n` ceil(N / BN).
extern "C" int untangled_deconv2d_f32(const float* xg, const float* w,
                                      const int* table, float* y, int B,
                                      int Hg, int Wg, int C, int N, int OH,
                                      int OW, int sh, int sw, int n_phases,
                                      int config, int vec, int grid_m,
                                      int grid_n, void* stream) {
  return dispatch<float>(xg, w, nullptr, table, y, B, Hg, Wg, C, N, OH, OW,
                         sh, sw, n_phases, config, vec, grid_m, grid_n,
                         stream);
}

// Kernel E inside kernel A: as untangled_deconv2d_f32 on int8 codes `q`
// with one f32 scale per superpack row (`scale`, sum T*C floats); `vec`
// also needs `q` 4-byte aligned (char4 loads).
extern "C" int untangled_deconv2d_i8(const float* xg, const int8_t* q,
                                     const float* scale, const int* table,
                                     float* y, int B, int Hg, int Wg, int C,
                                     int N, int OH, int OW, int sh, int sw,
                                     int n_phases, int config, int vec,
                                     int grid_m, int grid_n, void* stream) {
  return dispatch<int8_t>(xg, q, scale, table, y, B, Hg, Wg, C, N, OH, OW,
                          sh, sw, n_phases, config, vec, grid_m, grid_n,
                          stream);
}
