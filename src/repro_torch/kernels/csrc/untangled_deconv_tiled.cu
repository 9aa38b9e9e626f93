// Kernel D on Hopper: the spatially tiled fused multi-phase transposed conv.
//
// Replaces the TPU kernel
// src/repro/kernels/untangled_conv.py::_deconv_tiled_kernel (:503) with its
// double-buffered halo fetch _halo_stream (:115); entry _deconv_tiled (:546,
// pallas_call at :595).  It computes what kernel A computes, for uniform
// phases (every phase of one extent U x V, out = stride * (U, V)):
//
//   y[b, q_h + s_h*u, q_w + s_w*v, n] = sum_{t < T_h*T_w of phase q} sum_c
//       xg[b, xoff_h + t_i + u, xoff_w + t_j + v, c] * W[(tap_off + t)*C + c, n]
//
// one tile of T_u x T_v phase-output pixels of EVERY phase per block, from
// one halo'd input slice: the phase tap-origin span of deconv_tap_span
// ((min_h, max_h), (min_w, max_w)) plus the tile, from
// (i*T_u + min_h, j*T_v + min_w) in the globally padded plane.
//
// Mapping to the card.  As kernel C (csrc/untangled_conv_tiled.cu): one
// block per (tile, N tile, image), C walked in chunks of CK channels, the
// chunk's halo slice and the weight rows of all the plan's taps staged in
// two shared-memory slots with cp.async, the next chunk streaming while the
// current one is multiplied, IEEE fp32 FFMA in registers, the ragged edge
// masked in the copy and in the store.  The block owns its tile for all
// s_h*s_w phases, so each staged copy of the halo serves every phase: the
// thread groups split into one run of slots per phase (whole threads, so a
// thread's TM pixels share one phase and one tap list), and phase q's taps
// read the halo at xoff - min + (t_i, t_j).  The flush writes the
// interleaved output o[q_h + s_h*u, q_w + s_w*v] directly; phases with no
// taps write zeros (the wrapper allocates with torch.empty).
//
// What bounds it.  On an H100 SXM (67 TFLOP/s fp32, 3.35 TB/s) the U-Net's
// up0 site at a 512^2 image (256^2 -> 512^2, 64 -> 32, k4 s2: 4 phases of
// 2 x 2 taps) does 2*512^2*4*64*32 = 4.3 GFLOP per image, FFMA-bound at
// ~0.064 ms; its 16.8 MB plane and 33.6 MB output alone take ~0.015 ms.
// The design aims at that FFMA bound as kernel C does.  Its known costs:
// warps of phases with fewer taps idle while the others finish (not at the
// U-Net's k4 s2, where every phase has 2 x 2 taps), and the slots past
// T_u*T_v when it is not a multiple of TM.
//
// Kernel E, int8 weights: as in kernel C, the int8 entry stages each weight
// dequantized by load_superpack_chunk (one __fmul_rn by its row's scale),
// so it is bit-equal to the f32 entry on dequantize(q, scale).

#include <cuda_runtime.h>

#include <cstdint>

#include "tiled_stage.cuh"

namespace {

using tiled::kThreads;
using tiled::kTN;

template <int BN, int TM, int CK, bool VEC, typename WT>
__global__ void __launch_bounds__(kThreads)
deconv_tiled_kernel(const float* __restrict__ xg, const WT* __restrict__ w,
                    const float* __restrict__ scale,
                    const int* __restrict__ phase_table,
                    float* __restrict__ y, int Hg, int Wg, int C, int N,
                    int OH, int OW, int sh, int sw, int n_phases,
                    int total_taps, int T_u, int T_v, int slots, int min_h,
                    int min_w, int tin_h, int tin_w, int U, int V,
                    int n_tj) {
  constexpr int NGN = BN / kTN;
  constexpr int CKP = CK + 1;
  constexpr bool kAsyncW = std::is_same<WT, float>::value;
  extern __shared__ __align__(16) float smem[];

  const int halo = tiled::halo_floats<CK>(tin_h, tin_w);
  float* sx[2] = {smem, smem + halo};
  float* sw_[2] = {smem + 2 * halo, smem + 2 * halo + total_taps * CK * BN};

  const int b = blockIdx.z;
  const int n0 = blockIdx.y * BN;
  const int ti = blockIdx.x / n_tj;
  const int tj = blockIdx.x - ti * n_tj;
  const int r0 = ti * T_u + min_h, c0 = tj * T_v + min_w;
  const int tid = threadIdx.x;
  const int tx = tid % NGN, ty = tid / NGN;
  const int n_chunks = (C + CK - 1) / CK;

  // this thread's phase and its pixel slots g, g + G, ... of that phase
  const int G = slots / TM;  // thread groups per phase
  const int q = ty / G;
  const int g = ty - q * G;
  const bool live = q < n_phases;
  int q_h = 0, q_w = 0, tap_off = 0, th = 0, tw = 0, xh = 0, xw = 0;
  if (live) {
    // the phase record (q_h, q_w, tap_off, T_h, T_w, xoff_h, xoff_w, U, V)
    const int* rec = phase_table + q * 9;
    q_h = rec[0];
    q_w = rec[1];
    tap_off = rec[2];
    th = rec[3];
    tw = rec[4];
    xh = rec[5] - min_h;
    xw = rec[6] - min_w;
  }
  const int tile_pix = T_u * T_v;
  int pbase[TM];
#pragma unroll
  for (int k = 0; k < TM; ++k) {
    const int pl = g + k * G;
    const int ul = pl < tile_pix ? pl / T_v : 0;
    const int vl = pl < tile_pix ? pl - ul * T_v : 0;
    pbase[k] = ((ul + xh) * tin_w + vl + xw) * CKP;
  }

  auto issue = [&](int it, int slot) {
    tiled::stage_halo<CK>(sx[slot], xg, b, Hg, Wg, C, r0, c0, tin_h, tin_w,
                          it * CK);
    if constexpr (kAsyncW) {
      tiled::stage_weights<BN, CK, VEC>(sw_[slot], w, scale, total_taps, C,
                                        N, it * CK, n0);
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
    tiled::stage_weights<BN, CK, VEC>(sw_[0], w, scale, total_taps, C, N, 0,
                                      n0);
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
    for (int t = 0; t < th * tw; ++t) {  // no taps (or not live): no work
      const int t_i = t / tw;
      const int toff = (t_i * tin_w + t - t_i * tw) * CKP;
      const float* wt = Wt + (tap_off + t) * CK * BN;
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
        tiled::stage_weights<BN, CK, VEC>(sw_[cur ^ 1], w, scale, total_taps,
                                          C, N, (it + 1) * CK, n0);
      }
    }
    __syncthreads();  // this slot is refilled two chunks on
  }

  const int n = n0 + tx * kTN;
  if (!live || n >= N) return;
#pragma unroll
  for (int k = 0; k < TM; ++k) {
    const int pl = g + k * G;
    if (pl >= tile_pix) continue;
    const int ul = pl / T_v;
    const int u = ti * T_u + ul, v = tj * T_v + pl - ul * T_v;
    if (u >= U || v >= V) continue;
    const int oh = q_h + sh * u, ow = q_w + sw * v;
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

struct Geometry {
  int B, Hg, Wg, C, N, OH, OW, sh, sw, n_phases, total_taps, T_u, T_v,
      slots, min_h, min_w, tin_h, tin_w, n_ti, n_tj;
};

template <int BN, int TM, int CK, bool VEC, typename WT>
int launch(const float* xg, const WT* w, const float* scale,
           const int* table, float* y, const Geometry& g,
           cudaStream_t stream) {
  static int allowed = 0;
  if (g.n_phases * g.slots > (kThreads / (BN / kTN)) * TM ||
      g.slots % TM != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = deconv_tiled_kernel<BN, TM, CK, VEC, WT>;
  const int smem = tiled::smem_bytes<BN, CK>(g.tin_h, g.tin_w, g.total_taps);
  const cudaError_t err = tiled::allow_smem(kernel, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g.n_ti * g.n_tj, (g.N + BN - 1) / BN, g.B);
  kernel<<<grid, kThreads, smem, stream>>>(
      xg, w, scale, table, y, g.Hg, g.Wg, g.C, g.N, g.OH, g.OW, g.sh, g.sw,
      g.n_phases, g.total_taps, g.T_u, g.T_v, g.slots, g.min_h, g.min_w,
      g.tin_h, g.tin_w, g.OH / g.sh, g.OW / g.sw, g.n_tj);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC, typename WT>
int dispatch_vec(int config, const float* xg, const WT* w,
                 const float* scale, const int* table, float* y,
                 const Geometry& g, cudaStream_t st) {
  // the Python wrapper's _TILED_CONFIGS: (BN, TM, CK)
  switch (config) {
    case 0:
      return launch<64, 8, 8, VEC>(xg, w, scale, table, y, g, st);
    case 1:
      return launch<32, 4, 8, VEC>(xg, w, scale, table, y, g, st);
    case 2:
      return launch<4, 4, 8, VEC>(xg, w, scale, table, y, g, st);
    case 3:
      return launch<64, 8, 4, VEC>(xg, w, scale, table, y, g, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename WT>
int dispatch(const float* xg, const WT* w, const float* scale,
             const int* table, float* y, const Geometry& g, int config,
             int vec, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) return dispatch_vec<true>(config, xg, w, scale, table, y, g, st);
  return dispatch_vec<false>(config, xg, w, scale, table, y, g, st);
}

}  // namespace

// Launches kernel D on `stream` and returns cudaGetLastError() (0 =
// launched).  `table` is the plan's phase records, 9 int32 each (the
// wrapper's _phase_table); (T_u, T_v) the block's tile in phase-output
// pixels with `slots` pixel slots per phase (T_u*T_v rounded up to whole
// threads); (min_h, min_w) and tin_h x tin_w the halo's origin offset and
// extent (deconv_tap_span); n_ti x n_tj the tiles over (U, V) = out /
// stride; `config` and `vec` as for kernel C.
extern "C" int untangled_deconv2d_tiled_f32(
    const float* xg, const float* w, const int* table, float* y, int B,
    int Hg, int Wg, int C, int N, int OH, int OW, int sh, int sw,
    int n_phases, int total_taps, int T_u, int T_v, int slots, int min_h,
    int min_w, int tin_h, int tin_w, int n_ti, int n_tj, int config,
    int vec, void* stream) {
  const Geometry g{B,          Hg,   Wg,    C,     N,     OH,    OW,
                   sh,         sw,   n_phases, total_taps, T_u, T_v, slots,
                   min_h,      min_w, tin_h, tin_w, n_ti, n_tj};
  return dispatch<float>(xg, w, nullptr, table, y, g, config, vec, stream);
}

// Kernel E inside kernel D: as untangled_deconv2d_tiled_f32 on int8 codes
// `q` with one f32 scale per superpack row (`scale`, total_taps*C floats);
// `vec` also needs `q` 4-byte aligned (char4 loads).
extern "C" int untangled_deconv2d_tiled_i8(
    const float* xg, const int8_t* q, const float* scale, const int* table,
    float* y, int B, int Hg, int Wg, int C, int N, int OH, int OW, int sh,
    int sw, int n_phases, int total_taps, int T_u, int T_v, int slots,
    int min_h, int min_w, int tin_h, int tin_w, int n_ti, int n_tj,
    int config, int vec, void* stream) {
  const Geometry g{B,          Hg,   Wg,    C,     N,     OH,    OW,
                   sh,         sw,   n_phases, total_taps, T_u, T_v, slots,
                   min_h,      min_w, tin_h, tin_w, n_ti, n_tj};
  return dispatch<int8_t>(xg, q, scale, table, y, g, config, vec, stream);
}
