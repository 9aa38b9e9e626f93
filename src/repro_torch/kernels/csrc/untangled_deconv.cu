// Kernel A on Hopper: the fused multi-phase transposed convolution.
//
// Replaces the TPU kernel src/repro/kernels/untangled_conv.py::_deconv_kernel
// (entry untangled_deconv2d_pallas).  It computes, in ONE call, every
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
// plane.  K is walked in chunks of BK channels of one tap.  A work unit is
// one (phase, M tile, K slice, N tile): the wrapper's schedule
// (untangled_conv.deconv_schedule) picks the tile and a slice length of L
// chunks shared by all phases, so a phase of K_p chunks has S_p =
// ceil(K_p / L) slices of near-equal length and a 9-tap and a 4-tap phase
// end together.  Unsplit (L at least the longest phase), each unit stores
// its tile interleaved into y; split, each unit stores its f32 partial tile
// into the workspace and deconv_split_reduce sums a tile's slices in slice
// order and stores it interleaved.  Every output is a fixed-order sum (no
// float atomics): two launches are bit-equal.
//
// Inside a unit the plane and superpack chunks stream through a ring of
// STAGES chunks in dynamic shared memory with cp.async (zero-filled by
// src-size 0 past M, C and N), so STAGES - 1 chunks are in flight while
// the FFMA loop multiplies the oldest one (4 stages on the 128x128 tile,
// where the FFMAs set the pace; 6-8 on the small tiles of batch 1, where
// bytes in flight do).  Every thread accumulates a TM x
// TN register tile with IEEE fp32 FFMA in ascending K order: no TF32, no
// tensor cores, so the f64 oracle's ULP bound holds (a split sum has at
// most L + S_p - 1 roundings on any path, fewer than the K terms the bound
// allows).  The plane chunk is copied 4 bytes a channel into a K-major tile
// (the FFMA loop reads four rows as one float4); superpack rows go 16 bytes
// at a time on the vector path (N % 4 == 0, aligned), 4 bytes otherwise.
//
// A row-parallel block.  The call may hold superpack rows [r0, r1) only
// (the rank's block of a superpack split on its rows; [0, sum T*C) is the
// whole one): W is then indexed from r0, and the result is the f32
// partial sum over those rows.  The block may cut a tap and span phases,
// so each phase walks the K chunks that hold rows of the block
// (phase_krange: one range, since the wide tiles walk a phase's rows in
// ascending order) and reads the rows of a boundary chunk outside it as
// zeros; the thin tile walks every chunk with the rows outside read as
// zeros.  The slices then cover the block's chunks only.
//
// Tiles (the wrapper's _DECONV_CONFIGS): 128x128 (8x8 a thread) when that
// fills the card, 64x64 (4x4), and 32x64 / 16x64 for the few rows of a
// batch-1 phase, so no block holds 48 empty rows of 64.  N <= 16 (the RGB
// head, N = 3) takes deconv_thin_kernel: 4 columns a thread (N padded in
// registers only), 2 pixels a thread, a spatial tile of up to 256 phase
// pixels, the unit's whole slice of weight rows staged once in shared
// memory, so no FFMA is spent on 13 padding columns of a 16-wide tile.
// Its K runs C chunk by C chunk and tap by tap inside one, so each C
// chunk's halo of the tile is copied (16 bytes at a time) once for all
// taps instead of once a tap.
//
// What bounds it.  The fp32 FFMA peak of an H100 SXM is about 67 TFLOP/s,
// HBM about 3.35 TB/s.  At batch 1 the superpack dominates the bytes (DC1:
// 52.4 MB against 0.4 GFLOP) and the layer is memory bound (~15.7 us).
// Whole-K tiles would give DC1 32 blocks, each walking 576 chunks one
// after another, bound by the latency of each chunk's load; split K gives
// the card a few hundred units, each with STAGES - 1 chunks in flight.  At
// batch 64 DC1-DC3 are compute bound (~0.4 ms each); at DC1 the 128 blocks
// of the 128x128 tile would make one wave as long as the 9-tap phase,
// which the split evens out.  The thin tile is bound by its shared-memory
// reads (a float4 of plane per 16 FFMAs a pixel), not by the card's peaks.
//
// Kernel E, int8 weights (replaces the TPU kernel's int8 tap panel,
// src/repro/kernels/untangled_conv.py::_tap_panel).  The int8 entry takes
// the superpack as int8 codes q (sum T*C, N) and one f32 scale per
// superpack row (tap_off + t)*C + c.  The codes (4 bytes a copy on the
// vector path) and the chunk's row scales go through the same cp.async
// ring, twice as deep (a chunk carries a quarter of the bytes, so as many
// bytes are in flight), 1 byte a weight; once a chunk has landed, each
// code is dequantized once from shared memory, a chunk ahead of the FFMA
// loop, into one of two f32 operand tiles with one IEEE multiply by its
// row's scale (__fmul_rn, the rounding of JAX's panel.astype(f32) *
// scale and of torch's q.float() * scale).  No
// arithmetic waits on a global load, and the FFMA loop, tiles, slices and
// order are the f32 entry's, so the int8 kernel on (q, scale) is bit-equal
// to the f32 kernel on dequantize(q, scale).  The thin tile dequantizes its
// slice of rows once as it stages them.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

// per-phase record: q_h q_w tap_off T_h T_w xoff_h xoff_w U V
constexpr int kRec = 9;
constexpr int kPad = 4;  // floats of padding per shared-memory tile row
constexpr int kReduceThreads = 256;
constexpr int kThinTV = 64;  // the thin tile's most phase columns
constexpr int kThinTU = 64;  // and rows

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;  // 0 bytes read: the slot is zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
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

// Slices of a phase of `chunks` K chunks under slice length L (at least
// one, also for an empty phase), and where slice s begins: slice s covers
// chunks [begin(s), begin(s + 1)).  The wrapper's _n_slices/_slice_begin.
__device__ __forceinline__ int n_slices(int chunks, int L) {
  return chunks <= L ? 1 : (chunks + L - 1) / L;
}

__device__ __forceinline__ int slice_begin(int chunks, int slices, int s) {
  return static_cast<int>(static_cast<long long>(s) * chunks / slices);
}

struct Geometry {
  int B, Hg, Wg, C, N, OH, OW, sh, sw, n_phases;
  int chunk_len;   // L, K chunks per slice
  int max_chunks;  // the longest slice (the thin tile's weight stage)
  int halo;        // the thin tile's halo pixels (0 for the wide tiles)
  int grid_x;      // work units over (phase, M tile, slice)
  int grid_n;      // N tiles
  int red_x;       // M tiles over all phases (the reduction's grid)
  int r0, r1;      // the superpack rows the call holds: [0, sum T*C) whole,
                   // less for a row-parallel block
};

// One work unit: blockIdx.x -> (phase, M tile, slice), as the wrapper's
// schedule enumerates them.
struct Unit {
  int p, mt, s, S;
};

// Output tiles of one phase.  Wide tiles: BM consecutive rows of the
// phase's B*U*V.  The thin tile: a spatial TU x TV block of one image's
// U x V phase output (TV = min(V, kThinTV), TU = min(BM / TV, kThinTU)),
// so its taps read one staged halo.  The wrapper's _m_tiles.
__device__ __forceinline__ int phase_tiles(const int* rec, int B, int BM,
                                           bool thin) {
  const int U = rec[7], V = rec[8];
  if (!thin) return (B * U * V + BM - 1) / BM;
  if (U * V == 0) return 0;
  const int TV = min(V, kThinTV), TU = min(BM / TV, kThinTU);
  return B * ((U + TU - 1) / TU) * ((V + TV - 1) / TV);
}

// The phase-output row (b*U + u)*V + v of slot r of tile mt, or -1 for a
// slot past the phase's rows (or past the thin tile's U or V edge).
__device__ __forceinline__ int tile_row(const int* rec, int B, int BM,
                                        bool thin, int mt, int r) {
  const int U = rec[7], V = rec[8];
  if (!thin) {
    const int m = mt * BM + r;
    return m < B * U * V ? m : -1;
  }
  const int TV = min(V, kThinTV), TU = min(BM / TV, kThinTU);
  const int n_tv = (V + TV - 1) / TV, n_tu = (U + TU - 1) / TU;
  const int tv = mt % n_tv, rest = mt / n_tv;
  const int tu = rest % n_tu, b = rest / n_tu;
  const int ul = r / TV, u = tu * TU + ul, v = tv * TV + r % TV;
  return ul < TU && u < U && v < V ? (b * U + u) * V + v : -1;
}

// The K chunks [lo, lo + count) of a phase that a call on superpack rows
// [r0, r1) walks.  The wide tiles' K order (tap by tap, BK channels a
// chunk) walks the phase's rows in ascending order, so the chunks that hold
// rows of [r0, r1) are one range, and the rows outside it are read as
// zeros.  The thin tile's order (C chunk by C chunk, tap by tap inside
// one) does not, so it walks every chunk and reads the rows outside
// [r0, r1) as zeros.  The wrapper's _phase_krange.
__device__ __forceinline__ void phase_krange(const int* rec, int C, int BK,
                                             int kc, int r0, int r1,
                                             bool thin, int* lo, int* count) {
  const int T = rec[3] * rec[4];
  *lo = 0;
  *count = T * kc;
  if (thin) return;
  const int base = rec[2] * C;
  const int a = max(r0 - base, 0), b = min(r1 - base, T * C);
  if (b <= a) {
    *count = 0;
    return;
  }
  *lo = (a / C) * kc + (a % C) / BK;
  *count = ((b - 1) / C) * kc + ((b - 1) % C) / BK + 1 - *lo;
}

__device__ __forceinline__ Unit find_unit(const int* table, int n_phases,
                                          int B, int BM, bool thin, int C,
                                          int BK, int kc, int L, int r0,
                                          int r1) {
  int unit = blockIdx.x;
  for (int p = 0; p < n_phases; ++p) {
    const int* rec = table + p * kRec;
    const int tiles = phase_tiles(rec, B, BM, thin);
    int lo, K;
    phase_krange(rec, C, BK, kc, r0, r1, thin, &lo, &K);
    const int S = n_slices(K, L);
    if (unit < tiles * S) return {p, unit / S, unit % S, S};
    unit -= tiles * S;
  }
  return {n_phases, 0, 0, 1};
}

// Plane offset of each of the tile's BM rows (b, u, v) -> the element of
// xg[b, xoff_h + u, xoff_w + v, 0], or -1 past the phase's M rows.
__device__ __forceinline__ void fill_row_bases(int* rb, int BM, int NT,
                                               int m0, int M, int UV, int V,
                                               int Hg, int Wg, int C, int xh,
                                               int xw) {
  for (int r = threadIdx.x; r < BM; r += NT) {
    const int m = m0 + r;
    int base = -1;
    if (m < M) {
      const int b = m / UV, rem = m - (m / UV) * UV;
      const int u = rem / V, v = rem - (rem / V) * V;
      base = ((b * Hg + xh + u) * Wg + xw + v) * C;
    }
    rb[r] = base;
  }
}

// Where output row m of phase (qh, qw) lands in y: its pixel's first channel.
__device__ __forceinline__ float* out_row(float* y, int m, int UV, int V,
                                          int OH, int OW, int N, int sh,
                                          int sw, int qh, int qw) {
  const int b = m / UV, r = m - (m / UV) * UV;
  const int u = r / V, v = r - (r / V) * V;
  return y + (static_cast<size_t>(b * OH + sh * u + qh) * OW + sw * v + qw) *
                 N;
}

// Ring slots of deconv_kernel: STAGES for f32; twice as many for int8,
// whose chunks carry a quarter of the bytes (so as many bytes are in
// flight) and whose dequantized operand tile runs a chunk ahead of the
// FFMA loop.
template <int ST, bool I8>
__host__ __device__ constexpr int ring_slots() {
  return I8 ? 2 * ST : ST;
}

// Dynamic shared memory of deconv_kernel: the row bases, the ring's K-major
// plane chunks, and for f32 the ring's superpack chunks, for int8 two f32
// operand tiles and the ring's row scales and codes.
template <int BM, int BN, int BK, int ST, bool I8>
constexpr int wide_smem_bytes() {
  constexpr int R = ring_slots<ST, I8>();
  return 4 * (BM + R * BK * (BM + kPad) +
              (I8 ? 2 * BK * (BN + kPad) + R * BK + R * BK * BN / 4
                  : R * BK * (BN + kPad)));
}

template <int BM, int BN, int BK, int TM, int TN, int ST, int MINB, bool VEC,
          typename WT>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), MINB)
deconv_kernel(const float* __restrict__ xg, const WT* __restrict__ w,
              const float* __restrict__ scale, const int* __restrict__ table,
              float* __restrict__ y, float* __restrict__ ws, int B, int Hg,
              int Wg, int C, int N, int OH, int OW, int sh, int sw,
              int n_phases, int L, int r0, int r1) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr bool I8 = std::is_same<WT, int8_t>::value;
  static_assert(TM % 4 == 0 && TN % 4 == 0 && BK % 4 == 0, "float4 groups");
  static_assert((BM * BK) % NT == 0 && (BK * BN / 4) % NT == 0,
                "whole copies a thread");
  constexpr int AS = BM + kPad;         // K-major plane tile row stride
  constexpr int BS = BN + kPad;         // superpack tile row stride
  constexpr int A_STAGE = BK * AS;      // floats
  constexpr int B_STAGE = BK * BS;      // floats
  constexpr int Q_STAGE = BK * BN / 4;  // floats' worth of int8 codes
  constexpr int MSTEP = 4 * BM / TM;    // row stride of a thread's groups
  constexpr int NSTEP = 4 * BN / TN;    // col stride of a thread's groups
  constexpr int R = ring_slots<ST, I8>();

  extern __shared__ __align__(16) float smem[];
  int* rb = reinterpret_cast<int*>(smem);
  float* As = smem + BM;
  float* Bs = As + R * A_STAGE;  // f32: the ring; int8: two operand tiles
  float* Ss = Bs + 2 * B_STAGE;  // int8: row scales, R x BK
  int8_t* Qs = reinterpret_cast<int8_t*>(Ss + R * BK);  // int8: codes

  const int kc = (C + BK - 1) / BK;
  const Unit un =
      find_unit(table, n_phases, B, BM, false, C, BK, kc, L, r0, r1);
  if (un.p == n_phases) return;
  const int* rec = table + un.p * kRec;
  const int qh = rec[0], qw = rec[1], tap_off = rec[2], tw = rec[4];
  const int V = rec[8];
  const int UV = rec[7] * V;
  const int M = B * UV;
  int k_lo, K;
  phase_krange(rec, C, BK, kc, r0, r1, false, &k_lo, &K);
  const int k_begin = k_lo + slice_begin(K, un.S, un.s);
  const int n_iter = k_lo + slice_begin(K, un.S, un.s + 1) - k_begin;
  const int m0 = un.mt * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

  fill_row_bases(rb, BM, NT, m0, M, UV, V, Hg, Wg, C, rec[5], rec[6]);
  __syncthreads();

  // issue the cp.async copies of K chunk `it` into ring slot `st`
  auto issue = [&](int it, int st) {
    const int t = it / kc;
    const int c0 = (it - t * kc) * BK;
    const int shift = ((t / tw) * Wg + (t % tw)) * C;
    float* a_dst = As + st * A_STAGE;
#pragma unroll
    for (int i = 0; i < BM * BK / NT; ++i) {
      const int q = tid + i * NT;
      const int row = q / BK, k = q % BK;  // consecutive threads: channels
      const int base = rb[row];
      const int c = c0 + k;
      const bool ok = base >= 0 && c < C;
      cp_async4(a_dst + k * AS + row, ok ? xg + base + shift + c : xg, ok);
    }
    // superpack row wrow0 + row lies at row wrow0 + row - r0 of the call's
    // block; rows outside [r0, r1) are read as zeros
    const int wrow0 = (tap_off + t) * C + c0;
    const int lo_row = max(r0 - wrow0, 0), hi_row = r1 - wrow0;
    if constexpr (!I8) {
      float* b_dst = Bs + st * B_STAGE;
      if (VEC) {
#pragma unroll
        for (int i = 0; i < BK * BN / 4 / NT; ++i) {
          const int q = tid + i * NT;
          const int row = q / (BN / 4), col = (q % (BN / 4)) * 4;
          const bool ok = c0 + row < C && n0 + col < N && row >= lo_row &&
                          row < hi_row;
          const float* src =
              w + static_cast<size_t>(wrow0 + row - r0) * N + n0 + col;
          cp_async16(b_dst + row * BS + col, ok ? src : w, ok);
        }
      } else {
#pragma unroll
        for (int i = 0; i < BK * BN / NT; ++i) {
          const int q = tid + i * NT;
          const int row = q / BN, col = q % BN;
          const bool ok = c0 + row < C && n0 + col < N && row >= lo_row &&
                          row < hi_row;
          const float* src =
              w + static_cast<size_t>(wrow0 + row - r0) * N + n0 + col;
          cp_async4(b_dst + row * BS + col, ok ? src : w, ok);
        }
      }
    } else {
      int8_t* q_dst = Qs + st * Q_STAGE * 4;
      if (VEC) {
#pragma unroll
        for (int i = 0; i < BK * BN / 4 / NT; ++i) {
          const int q = tid + i * NT;
          const int row = q / (BN / 4), col = (q % (BN / 4)) * 4;
          const bool ok = c0 + row < C && n0 + col < N && row >= lo_row &&
                          row < hi_row;
          const int8_t* src =
              w + static_cast<size_t>(wrow0 + row - r0) * N + n0 + col;
          cp_async4(q_dst + row * BN + col, ok ? src : w, ok);
        }
      } else {  // ragged N or unaligned codes: plain loads, synchronous
        for (int q = tid; q < BK * BN; q += NT) {
          const int row = q / BN, col = q % BN;
          const bool ok = c0 + row < C && n0 + col < N && row >= lo_row &&
                          row < hi_row;
          q_dst[row * BN + col] =
              ok ? w[static_cast<size_t>(wrow0 + row - r0) * N + n0 + col]
                 : static_cast<int8_t>(0);
        }
      }
      for (int r = tid; r < BK; r += NT) {
        const bool ok = c0 + r < C && r >= lo_row && r < hi_row;
        cp_async4(Ss + st * BK + r, ok ? scale + wrow0 + r - r0 : scale, ok);
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

  // kernel E: the codes of ring slot `st`, each dequantized once from
  // shared memory into f32 operand tile `buf`
  auto dequant = [&](int st, int buf) {
    const int8_t* q_s = Qs + st * Q_STAGE * 4;
    const float* s_s = Ss + st * BK;
    float* b_dst = Bs + buf * B_STAGE;
#pragma unroll
    for (int e = 0; e < BK * BN / 4 / NT; ++e) {
      const int g = tid + e * NT;
      const int row = g / (BN / 4), col = (g % (BN / 4)) * 4;
      const char4 c = *reinterpret_cast<const char4*>(q_s + row * BN + col);
      const float sc = s_s[row];
      *reinterpret_cast<float4*>(b_dst + row * BS + col) = make_float4(
          __fmul_rn(static_cast<float>(c.x), sc),
          __fmul_rn(static_cast<float>(c.y), sc),
          __fmul_rn(static_cast<float>(c.z), sc),
          __fmul_rn(static_cast<float>(c.w), sc));
    }
  };

#pragma unroll
  for (int s = 0; s < R - 1; ++s) {
    if (s < n_iter) issue(k_begin + s, s);
    cp_async_commit();
  }
  if constexpr (I8) {
    if (n_iter > 0) {
      cp_async_wait<R - 2>();
      __syncthreads();
      dequant(0, 0);
    }
  }
  for (int i = 0; i < n_iter; ++i) {
    // f32: chunk i has landed for every thread; int8: chunk i + 1 has, and
    // chunk i's operand tile is dequantized.  Every thread is done with
    // chunk i - 1, whose ring slot the next issue refills.
    if constexpr (I8) {
      cp_async_wait<R - 3>();
    } else {
      cp_async_wait<R - 2>();
    }
    __syncthreads();
    const int st = i % R;
    if (i + R - 1 < n_iter) issue(k_begin + i + R - 1, (i + R - 1) % R);
    cp_async_commit();
    const float* b_s = Bs + (I8 ? i % 2 : st) * B_STAGE;
    const float* a_s = As + st * A_STAGE;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      if constexpr (I8) {
        // the next chunk's tile (last read by chunk i - 1; past the last
        // chunk it is never read), in among this chunk's FFMAs, so its
        // loads and conversions overlap them: one barrier a chunk, as f32
        if (k == 0) dequant((i + 1) % R, (i + 1) % 2);
      }
      float a[TM], b[TN];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            a_s + k * AS + g * MSTEP + ty * 4);
        a[g * 4 + 0] = v.x;
        a[g * 4 + 1] = v.y;
        a[g * 4 + 2] = v.z;
        a[g * 4 + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            b_s + k * BS + g * NSTEP + tx * 4);
        b[g * 4 + 0] = v.x;
        b[g * 4 + 1] = v.y;
        b[g * 4 + 2] = v.z;
        b[g * 4 + 3] = v.w;
      }
#pragma unroll
      for (int i2 = 0; i2 < TM; ++i2)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i2][j] = fmaf(a[i2], b[j], acc[i2][j]);
    }
  }

  // unsplit: the interleaved store, row m = (b, u, v) at (s_h*u + q_h,
  // s_w*v + q_w); split: the partial tile, row-major BM x BN
  float* tile =
      ws ? ws + (static_cast<size_t>(blockIdx.x) * gridDim.y + blockIdx.y) *
                    (BM * BN)
         : nullptr;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = (i / 4) * MSTEP + ty * 4 + (i % 4);
    const int m = m0 + r;
    if (m >= M) continue;
    float* dst = tile ? tile + r * BN
                      : out_row(y, m, UV, V, OH, OW, N, sh, sw, qh, qw) + n0;
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const int col = g * NSTEP + tx * 4;
      const int n = n0 + col;
      if (n >= N) continue;
      const float4 val = make_float4(acc[i][g * 4 + 0], acc[i][g * 4 + 1],
                                     acc[i][g * 4 + 2], acc[i][g * 4 + 3]);
      if (VEC) {
        *reinterpret_cast<float4*>(dst + col) = val;
      } else {
        dst[col] = val.x;
        if (n + 1 < N) dst[col + 1] = val.y;
        if (n + 2 < N) dst[col + 2] = val.z;
        if (n + 3 < N) dst[col + 3] = val.w;
      }
    }
  }
}

__device__ __forceinline__ float weight_f32(const float* w, const float*,
                                            size_t row, int n, int N) {
  return w[row * N + n];
}

__device__ __forceinline__ float weight_f32(const int8_t* q,
                                            const float* scale, size_t row,
                                            int n, int N) {
  return __fmul_rn(static_cast<float>(q[row * N + n]), scale[row]);
}

// Dynamic shared memory of deconv_thin_kernel: STAGES halo slots of `halo`
// pixels (BK + kPad floats each) and the unit's slice of weight rows (4
// floats each).
template <int BK, int ST>
__host__ __device__ constexpr int thin_halo_floats(int halo) {
  return ST * halo * (BK + kPad);
}

// The thin-N tile (N <= 16): BN = 4 output channels, TM pixels a thread,
// one spatial TU x TV tile of a phase's output a block.  K is walked C
// chunk by C chunk, and inside a chunk tap by tap (K chunk it = cc*T + t):
// the chunk's halo, (TU + T_h - 1) x (TV + T_w - 1) pixels of the plane,
// is staged once and every tap reads it, where an im2col tile would fetch
// each plane pixel once a tap.
template <int BM, int BK, int TM, int ST, bool AVEC, typename WT>
__global__ void __launch_bounds__(BM / TM)
deconv_thin_kernel(const float* __restrict__ xg, const WT* __restrict__ w,
                   const float* __restrict__ scale,
                   const int* __restrict__ table, float* __restrict__ y,
                   float* __restrict__ ws, int B, int Hg, int Wg, int C,
                   int N, int OH, int OW, int sh, int sw, int n_phases,
                   int L, int halo, int r0, int r1) {
  constexpr int NT = BM / TM;
  constexpr int BN = 4;
  constexpr int AS = BK + kPad;     // halo pixel stride (floats)
  constexpr int AW = AVEC ? 4 : 1;  // channels a copy
  static_assert(BK % 4 == 0, "float4 groups");

  extern __shared__ __align__(16) float smem[];
  float* Hs = smem;
  float* Ws = Hs + thin_halo_floats<BK, ST>(halo);

  const int kc = (C + BK - 1) / BK;
  const Unit un =
      find_unit(table, n_phases, B, BM, true, C, BK, kc, L, r0, r1);
  if (un.p == n_phases) return;
  const int* rec = table + un.p * kRec;
  const int qh = rec[0], qw = rec[1], tap_off = rec[2], th = rec[3];
  const int tw = rec[4], U = rec[7], V = rec[8];
  const int T = th * tw;
  const int K = T * kc;
  const int k_begin = slice_begin(K, un.S, un.s);
  const int k_end = slice_begin(K, un.S, un.s + 1);
  const int n_iter = k_end - k_begin;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

  // the tile: image b, phase rows u0.., columns v0..; its halo's origin in
  // the plane and extent
  const int TV = min(V, kThinTV), TU = min(BM / TV, kThinTU);
  const int n_tv = (V + TV - 1) / TV, n_tu = (U + TU - 1) / TU;
  const int tv = un.mt % n_tv, rest = un.mt / n_tv;
  const int b = rest / n_tu, u0 = (rest % n_tu) * TU, v0 = tv * TV;
  const int HW = TV + tw - 1;
  const int HP = (TU + th - 1) * HW;
  const int row0 = rec[5] + u0, col0 = rec[6] + v0;

  // the halo of C chunk cc into slot st
  auto issue = [&](int cc, int st) {
    float* h_dst = Hs + st * halo * AS;
    for (int q = tid; q < HP * (BK / AW); q += NT) {
      const int pix = q / (BK / AW), k = (q % (BK / AW)) * AW;
      const int hr = pix / HW, hc = pix - (pix / HW) * HW;
      const int row = row0 + hr, col = col0 + hc, c = cc * BK + k;
      const bool ok = row < Hg && col < Wg && c < C;
      const float* src =
          ok ? xg + ((static_cast<size_t>(b) * Hg + row) * Wg + col) * C + c
             : xg;
      if (AVEC) {
        cp_async16(h_dst + pix * AS + k, src, ok);
      } else {
        cp_async4(h_dst + pix * AS + k, src, ok);
      }
    }
  };

  const int cc_first = k_begin / T;
  const int n_cc = n_iter > 0 ? (k_end - 1) / T - cc_first + 1 : 0;
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < n_cc) issue(cc_first + s, s);
    cp_async_commit();
  }
  // the slice's weight rows, once: Ws[(i*BK + k)*4 + j] = W[row(i, k), n0+j]
  for (int e = tid; e < n_iter * BK * BN; e += NT) {
    const int j = e % BN, rk = e / BN;
    const int il = rk / BK, k = rk - il * BK;
    const int it = k_begin + il;
    const int cc = it / T;
    const int c = cc * BK + k;
    const int n = n0 + j;
    const int row = (tap_off + it - cc * T) * C + c;
    Ws[e] = c < C && n < N && row >= r0 && row < r1
                ? weight_f32(w, scale, static_cast<size_t>(row - r0), n, N)
                : 0.f;
  }

  // each thread's TM slots: their pixel in the halo (tap (0, 0)); slots
  // past the tile read pixel 0 and are never stored
  int hp[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int slot = tid + r * NT;
    const int ul = slot / TV;
    hp[r] = ul < TU ? ul * HW + slot % TV : 0;
  }
  float acc[TM][BN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < BN; ++j) acc[i][j] = 0.f;

  for (int jc = 0; jc < n_cc; ++jc) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    if (jc + ST - 1 < n_cc) issue(cc_first + jc + ST - 1, (jc + ST - 1) % ST);
    cp_async_commit();
    const int cc = cc_first + jc;
    const float* h_s = Hs + (jc % ST) * halo * AS;
    const int it1 = min(k_end, (cc + 1) * T);
    for (int it = max(k_begin, cc * T); it < it1; ++it) {
      const int t = it - cc * T;
      const int shift = (t / tw) * HW + t % tw;
      const float* w_s = Ws + (it - k_begin) * BK * BN;
#pragma unroll
      for (int k4 = 0; k4 < BK; k4 += 4) {
        float4 a[TM];
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          a[r] = *reinterpret_cast<const float4*>(h_s + (hp[r] + shift) * AS +
                                                  k4);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 bv =
              *reinterpret_cast<const float4*>(w_s + (k4 + kk) * BN);
          const float bb[BN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            const float av = kk == 0 ? a[r].x
                             : kk == 1 ? a[r].y
                             : kk == 2 ? a[r].z
                                       : a[r].w;
#pragma unroll
            for (int j = 0; j < BN; ++j)
              acc[r][j] = fmaf(av, bb[j], acc[r][j]);
          }
        }
      }
    }
  }

  float* tile =
      ws ? ws + (static_cast<size_t>(blockIdx.x) * gridDim.y + blockIdx.y) *
                    (BM * BN)
         : nullptr;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int slot = tid + r * NT;
    const int m = tile_row(rec, B, BM, true, un.mt, slot);
    if (m < 0) continue;
    float* dst = tile ? tile + slot * BN
                      : out_row(y, m, U * V, V, OH, OW, N, sh, sw, qh, qw) +
                            n0;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      if (n0 + j < N) dst[j] = acc[r][j];
    }
  }
}

// The split's second pass: one thread per element of a (phase, M tile, N
// tile) output tile sums the tile's S_p partials in slice order (slice 0,
// then + slice 1, ...) and stores the sum interleaved; a block covers
// kReduceThreads elements of one tile.  Empty phases' partials are zeros.
__global__ void __launch_bounds__(kReduceThreads)
deconv_split_reduce(const float* __restrict__ ws,
                    const int* __restrict__ table, float* __restrict__ y,
                    int B, int C, int N, int OH, int OW, int sh, int sw,
                    int n_phases, int BM, int BN, int BK, int L, int thin,
                    int r0, int r1) {
  const int kc = (C + BK - 1) / BK;
  const int tile_sz = BM * BN;
  const int parts = (tile_sz + kReduceThreads - 1) / kReduceThreads;
  int tile = blockIdx.x / parts, unit0 = 0, p = 0, S = 1;
  const int e = (blockIdx.x - tile * parts) * kReduceThreads + threadIdx.x;
  for (; p < n_phases; ++p) {
    const int* rec = table + p * kRec;
    const int tiles = phase_tiles(rec, B, BM, thin != 0);
    int lo, K;
    phase_krange(rec, C, BK, kc, r0, r1, thin != 0, &lo, &K);
    S = n_slices(K, L);
    if (tile < tiles) break;
    tile -= tiles;
    unit0 += tiles * S;
  }
  if (p == n_phases) return;
  unit0 += tile * S;
  const int* rec = table + p * kRec;
  const int V = rec[8];
  const int nt = blockIdx.y;
  const int col = e % BN, n = nt * BN + col;
  if (e >= tile_sz || n >= N) return;
  const int m = tile_row(rec, B, BM, thin != 0, tile, e / BN);
  if (m < 0) return;
  const size_t slice_stride = static_cast<size_t>(gridDim.y) * tile_sz;
  const float* src =
      ws + (static_cast<size_t>(unit0) * gridDim.y + nt) * tile_sz + e;
  float sum = src[0];
#pragma unroll 4
  for (int s = 1; s < S; ++s) sum += src[s * slice_stride];
  out_row(y, m, rec[7] * V, V, OH, OW, N, sh, sw, rec[0], rec[1])[n] = sum;
}

// Raise an instantiation's dynamic shared-memory limit once it needs more
// than the default 48 KB (only upwards, once per size).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int* allowed) {
  if (bytes <= 48 * 1024 || bytes <= *allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *allowed = bytes;
  return err;
}

int reduce_if_split(const int* table, float* y, float* ws, const Geometry& g,
                    int BM, int BN, int BK, bool thin, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ws == nullptr) return static_cast<int>(err);
  const int parts = (BM * BN + kReduceThreads - 1) / kReduceThreads;
  deconv_split_reduce<<<dim3(g.red_x * parts, g.grid_n), kReduceThreads, 0,
                        stream>>>(ws, table, y, g.B, g.C, g.N, g.OH, g.OW,
                                  g.sh, g.sw, g.n_phases, BM, BN, BK,
                                  g.chunk_len, thin ? 1 : 0, g.r0, g.r1);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int BK, int TM, int TN, int ST, int MINB, bool VEC,
          typename WT>
int launch_wide(const float* xg, const WT* w, const float* scale,
                const int* table, float* y, float* ws, const Geometry& g,
                cudaStream_t stream) {
  static int allowed = 0;
  constexpr bool I8 = std::is_same<WT, int8_t>::value;
  constexpr int smem = wide_smem_bytes<BM, BN, BK, ST, I8>();
  const auto kernel = deconv_kernel<BM, BN, BK, TM, TN, ST, MINB, VEC, WT>;
  const cudaError_t err = allow_smem(kernel, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(g.grid_x, g.grid_n), (BM / TM) * (BN / TN), smem, stream>>>(
      xg, w, scale, table, y, ws, g.B, g.Hg, g.Wg, g.C, g.N, g.OH, g.OW, g.sh,
      g.sw, g.n_phases, g.chunk_len, g.r0, g.r1);
  return reduce_if_split(table, y, ws, g, BM, BN, BK, false, stream);
}

template <int BM, int BK, int TM, int ST, bool AVEC, typename WT>
int launch_thin(const float* xg, const WT* w, const float* scale,
                const int* table, float* y, float* ws, const Geometry& g,
                cudaStream_t stream) {
  static int allowed = 0;
  const int smem =
      4 * thin_halo_floats<BK, ST>(g.halo) + 16 * g.max_chunks * BK;
  const auto kernel = deconv_thin_kernel<BM, BK, TM, ST, AVEC, WT>;
  const cudaError_t err = allow_smem(kernel, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(g.grid_x, g.grid_n), BM / TM, smem, stream>>>(
      xg, w, scale, table, y, ws, g.B, g.Hg, g.Wg, g.C, g.N, g.OH, g.OW, g.sh,
      g.sw, g.n_phases, g.chunk_len, g.halo, g.r0, g.r1);
  return reduce_if_split(table, y, ws, g, BM, 4, BK, true, stream);
}

template <bool VEC, typename WT>
int dispatch_vec(int config, const float* xg, const WT* w,
                 const float* scale, const int* table, float* y, float* ws,
                 const Geometry& g, cudaStream_t s) {
  // the Python wrapper's _DECONV_CONFIGS: (BM, BN, BK); TM x TN a thread,
  // STAGES, blocks an SM asked of ptxas
  switch (config) {
    case 0:
      return launch_wide<128, 128, 16, 8, 8, 4, 1, VEC>(xg, w, scale, table,
                                                        y, ws, g, s);
    case 1:
      return launch_wide<64, 64, 16, 4, 4, 6, 2, VEC>(xg, w, scale, table, y,
                                                      ws, g, s);
    case 2:
      return launch_wide<32, 64, 16, 4, 4, 8, 2, VEC>(xg, w, scale, table, y,
                                                      ws, g, s);
    case 3:
      return launch_wide<16, 64, 16, 4, 4, 8, 2, VEC>(xg, w, scale, table, y,
                                                      ws, g, s);
    case 4:  // thin N: `vec` is the plane's 16-byte path
      return launch_thin<256, 8, 2, 3, VEC>(xg, w, scale, table, y, ws, g, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename WT>
int dispatch(const float* xg, const WT* w, const float* scale,
             const int* table, float* y, float* ws, const Geometry& g,
             int config, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g.grid_x <= 0 || g.grid_n <= 0 || g.chunk_len <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec) return dispatch_vec<true>(config, xg, w, scale, table, y, ws, g, s);
  return dispatch_vec<false>(config, xg, w, scale, table, y, ws, g, s);
}

}  // namespace

// Launches kernel A on `stream` (and, when `ws` is not null, the split's
// reduction after it) and returns cudaGetLastError() (0 = launched).
// `table` is the plan's phase records, 9 int32 each (the wrapper's
// _phase_table); `config` the tile (the wrapper's _DECONV_CONFIGS); `vec`
// the 16-byte path (wide tiles: N % 4 == 0 and aligned superpack and
// output; the thin tile: C % 4 == 0 and an aligned plane); `chunk_len` the
// slice length L in K chunks, `max_chunks` the longest slice, `halo` the
// thin tile's halo pixels, `grid_x` the work units, `grid_n` the N tiles
// and `red_x` the M tiles over all phases, all from the wrapper's
// deconv_schedule; `ws` the f32 workspace
// of grid_x * grid_n partial tiles, or null when no phase is split.  `w`
// holds superpack rows [r0, r1): [0, sum T*C) is the whole superpack, a
// smaller range a row-parallel block (a range per phase: the block may
// span phases), whose partial sum the caller adds to its peers'.
extern "C" int untangled_deconv2d_f32(const float* xg, const float* w,
                                      const int* table, float* y, float* ws,
                                      int B, int Hg, int Wg, int C, int N,
                                      int OH, int OW, int sh, int sw,
                                      int n_phases, int config, int vec,
                                      int chunk_len, int max_chunks,
                                      int halo, int grid_x, int grid_n,
                                      int red_x, int r0, int r1,
                                      void* stream) {
  const Geometry g{B,         Hg,         Wg,   C,      N,      OH,
                   OW,        sh,         sw,   n_phases,
                   chunk_len, max_chunks, halo, grid_x, grid_n, red_x,
                   r0,        r1};
  return dispatch<float>(xg, w, nullptr, table, y, ws, g, config, vec,
                         stream);
}

// Kernel E inside kernel A: as untangled_deconv2d_f32 on int8 codes `q`
// with one f32 scale per superpack row of the block (`scale`, r1 - r0
// floats); `vec` (wide tiles) also needs `q` 4-byte aligned (4-code
// copies).
extern "C" int untangled_deconv2d_i8(const float* xg, const int8_t* q,
                                     const float* scale, const int* table,
                                     float* y, float* ws, int B, int Hg,
                                     int Wg, int C, int N, int OH, int OW,
                                     int sh, int sw, int n_phases, int config,
                                     int vec, int chunk_len, int max_chunks,
                                     int halo, int grid_x, int grid_n,
                                     int red_x, int r0, int r1,
                                     void* stream) {
  const Geometry g{B,         Hg,         Wg,   C,      N,      OH,
                   OW,        sh,         sw,   n_phases,
                   chunk_len, max_chunks, halo, grid_x, grid_n, red_x,
                   r0,        r1};
  return dispatch<int8_t>(xg, q, scale, table, y, ws, g, config, vec,
                          stream);
}
