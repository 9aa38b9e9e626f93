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
// the tile's halo'd input slice, which is staged once per C chunk and
// serves every one of the R*S taps: the input reuse across taps that the
// TPU kernel exists for.
//
// Mapping to the card.  One block per (output tile, N tile, image); blocks
// run in no order, and each walks all of C itself in chunks of kCK = 4
// channels, one 16-byte group per halo pixel.  The wrapper's schedule
// (untangled_conv.tiled_conv_schedule) picks the tile, BN (following N: 4
// for N <= 4, else 32, 64 or 128), the ring's stages and the halo's row
// pitch.  A chunk's halo slice and its weight rows of every tap ride a ring
// of `stages` slots in dynamic shared memory, copied with cp.async (16
// bytes a copy where C % 4 == 0 and the plane is aligned, and for the
// superpack where N % 4 == 0; 4 bytes a copy otherwise; zero-filled by
// src-size 0 past the plane, C and N), so stages - 1 chunks are in flight
// while the FFMA loop multiplies the oldest; one barrier a chunk.
//
// The register tile.  A thread owns kTM = 8 output pixels of one tile row,
// spaced pd columns apart, times kTN = 4 channels: 32 accumulators.  For
// each (chunk, tap row m) it loads the halo span its pixels read across
// the row's S taps, (kTM - 1)*s + (S - 1)*d + 1 values of 4 channels (one
// LDS.128 each), once, and serves all S taps from registers; each weight
// float4 feeds kTM x 4 FFMAs.  R and S are compile-time 3 x 3 on two
// paths: path 1 (s_w = 1; pixels spaced pd = d_w apart, so pixel k of tap
// n reads span value k + n, at a per-thread offset computed once) and
// path 2 (s_w = 2, d_w = 1; pixel k of tap n reads span value 2k + n, at a
// compile-time offset).  Path 0 takes any taps, strides and dilations at
// run time (the 1x1, 2x2 and 7x7 sites), loading per (tap, pixel).  Every
// path sums each output in the same fixed order, chunk by chunk, then tap
// row, tap, channel, in IEEE fp32 FFMA (no TF32, no tensor cores, so the
// f64 oracle's ULP bound holds), and writes it once: two launches are
// bit-equal.  No split K: every tiled site has thousands of tiles.
//
// The halo layout.  A staged halo row holds tin_w 16-byte channel groups;
// column col sits at unit col + col / 8, one pad unit every 8 columns, and
// a row takes `pitch` units.  A thread's pixel groups start 8*s columns
// apart (path 1, 2), so the groups of a warp reading span value j hit
// distinct 16-byte bank groups (their units differ by 9 or 18), and the
// vector reads are conflict-free at every tiled site (tested on the CPU,
// tests/test_torch_tiled_schedule.py, which replays the warp's addresses).
// Pixels of idle thread groups and of the ragged tile edge read inside the
// staged halo and are not stored.
//
// What bounds it.  On an H100 SXM (data sheet: 67 TFLOP/s fp32 on the CUDA
// cores, 3.35 TB/s HBM) the U-Net's tiled sites at a 512^2 image are the
// stem (3 -> 32, bound by writing its 32-channel output), down0 (32 -> 64,
// stride 2) and fuse0 (64 -> 32), bound by FFMA, and the head (32 -> 3),
// bound by reading its plane.  Per (chunk, tap row) a thread issues 96
// FFMAs a tap for (span + 12) shared-memory vector reads; in the SASS a
// chunk of path 1 is 1152 FFMAs among ~1400 instructions, and on an H100
// fuse0 runs at ~57% of its FFMA bound (PERF.md), held by stalls rather
// than by instructions.  The stem's C = 3 is one chunk of 4 channels (the
// fourth zero-filled): 36 K steps a pixel, not 72.
//
// A row block (a row-parallel site: the superpack's tap-major rows split
// over ranks).  The weight operand holds superpack rows [r0, r1) only, and
// the launch returns the f32 partial sum over them: a ring slot's weight
// copies read row t*C + ch from row t*C + ch - r0 of the operand where it
// lies in [r0, r1), and zero-fill it (src-size 0, as past C and N)
// elsewhere, so no other weight row is read.  The tile, the halo ring and
// the register loop are the whole superpack's: a row-block launch walks
// every chunk and tap and costs about what a whole launch costs.
//
// Kernel E, int8 weights (replaces the TPU kernel's int8 tap panel,
// src/repro/kernels/untangled_conv.py::_tap_panel).  The int8 entry's codes
// (4 bytes a copy on the vector path; plain loads otherwise) and row
// scales ride the same ring; once a chunk has landed, each code is
// dequantized once from shared memory, a chunk ahead of the FFMA loop
// (between tap rows 0 and 1 of the chunk before, so its loads hide behind
// that row's FFMAs), into one of two f32 weight tiles (codes_to_f32: a
// byte permute and one subtraction, exact) with one IEEE multiply by its
// row's scale (__fmul_rn, the rounding of JAX's panel.astype(f32) * scale
// and of torch's q.float() * scale).  The FFMA loop and order are the f32
// entry's, so the int8 kernel on (q, scale) is bit-equal to the f32 kernel
// on dequantize(q, scale).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTM = 8;  // output pixels a thread (one tile row)
constexpr int kTN = 4;  // output channels a thread
constexpr int kCK = 4;  // channels a chunk: one 16-byte group a pixel

// threads and blocks an SM (asked of ptxas) per BN; the wrapper's
// _TILED_CONV_BLOCKS
template <int BN>
struct Block {
  static constexpr int kThreads = BN == 4 ? 128 : 256;
  static constexpr int kMinBlocks = 2;
  static constexpr int kNG = BN / kTN;  // threads across N
};

struct Geometry {
  int Hp, Wp, C, N, OH, OW, R, S, sh, sw, dh, dw;
  int T_oh, T_ow;    // output tile
  int tin_h, tin_w;  // staged halo rows and columns
  int pitch;         // 16-byte units a staged halo row
  int n_tj;          // tiles across OW
  int gpr;           // pixel groups a tile row
  int pd;            // columns between a thread's pixels
  int stages;        // ring slots
  int xvec;          // 16-byte plane copies (C % 4 == 0, aligned plane)
  int wvec;          // 16-byte superpack copies and float4 stores
  int r0, r1;         // superpack rows the weight operand holds
};

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

// wait until at most `pending` of this thread's copy groups are in flight
// (the ring's depth is a run-time value; wait_group takes an immediate)
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::); break;
  }
}

// the staged unit of halo column `col`: one pad unit every 8 columns
__host__ __device__ __forceinline__ int halo_unit(int col) {
  return col + (col >> 3);
}

// The four int8 codes of `word` (little-endian) as exact f32 values, with no
// conversion instruction: byte j, offset to q + 128, becomes the mantissa
// of 2^23 + q + 128 (__byte_perm puts it under the exponent byte 0x4B), and
// one subtraction of 2^23 + 128 leaves q, exactly.  Kernel B's codes_to_f32.
__device__ __forceinline__ float4 codes_to_f32(unsigned word) {
  const unsigned u = word ^ 0x80808080u;
  constexpr float kBias = 8388736.0f;  // 2^23 + 128
  return make_float4(__int_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) -
                         kBias,
                     __int_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) -
                         kBias,
                     __int_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) -
                         kBias,
                     __int_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) -
                         kBias);
}

__device__ __forceinline__ float lane(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// acc[k][:] += h[k].c * w for the thread's kTM pixels, channel c
__device__ __forceinline__ void fma_row(float (&acc)[kTM][kTN], float a,
                                        int k, const float4& w) {
  acc[k][0] = fmaf(a, w.x, acc[k][0]);
  acc[k][1] = fmaf(a, w.y, acc[k][1]);
  acc[k][2] = fmaf(a, w.z, acc[k][2]);
  acc[k][3] = fmaf(a, w.w, acc[k][3]);
}

template <int BN, int PATH, typename WT>
__global__ void __launch_bounds__(Block<BN>::kThreads,
                                  Block<BN>::kMinBlocks)
conv_tiled_kernel(const float* __restrict__ x, const WT* __restrict__ w,
                  const float* __restrict__ scale, float* __restrict__ y,
                  const Geometry g) {
  using Blk = Block<BN>;
  constexpr int T = Blk::kThreads;
  constexpr int NG = Blk::kNG;
  constexpr bool I8 = std::is_same<WT, int8_t>::value;
  constexpr int kR = PATH == 0 ? 0 : 3;  // compile-time taps a row (3x3)

  extern __shared__ __align__(16) float smem[];
  const int R = PATH == 0 ? g.R : kR;
  const int S = PATH == 0 ? g.S : kR;
  const int taps = R * S;
  const int C = g.C, N = g.N, RS = g.stages;
  const int halo_fl = g.tin_h * g.pitch * 4;  // floats of one halo slot
  const int w_fl = taps * kCK * BN;           // floats of one f32 weight tile
  float* Xs = smem;                           // RS halo slots
  float* Ws = Xs + RS * halo_fl;  // f32: RS weight slots; int8: 2 tiles
  float* Ss = Ws + (I8 ? 2 : RS) * w_fl;  // int8: RS x taps*kCK scales
  int8_t* Qs = reinterpret_cast<int8_t*>(Ss + (I8 ? RS * taps * kCK : 0));
  const int q_bytes = taps * kCK * BN;  // int8 codes of one slot

  const int b = blockIdx.z;
  const int n0 = blockIdx.y * BN;
  const int ti = blockIdx.x / g.n_tj;
  const int tj = blockIdx.x - ti * g.n_tj;
  const int oh0 = ti * g.T_oh, ow0 = tj * g.T_ow;
  const int r0 = oh0 * g.sh, c0 = ow0 * g.sw;
  const int tid = threadIdx.x;
  const int tx = tid % NG, grp = tid / NG;

  // this thread's pixel group: tile row ph, pixels ow_0 + k*pd
  int ph = grp / g.gpr;
  const int gg = grp - ph * g.gpr;
  const int blk = gg / g.pd;
  int ow_0 = blk * kTM * g.pd + (gg - blk * g.pd);
  const bool live = ph < g.T_oh;
  if (!live) ph = ow_0 = 0;  // reads inside the halo, stores nothing
  const int row_base = ph * g.sh * g.pitch;  // units
  const int row_step = g.dh * g.pitch;       // units a tap row

  // path 1: staged unit of span value j (the column ow_0 + j*pd)
  constexpr int kSpan1 = kTM + 2;
  int offs[PATH == 1 ? kSpan1 : 1];
  if constexpr (PATH == 1) {
#pragma unroll
    for (int j = 0; j < kSpan1; ++j) offs[j] = halo_unit(ow_0 + j * g.pd);
  }
  // path 2: span value j at unit base2 + j + j / 8 (2*ow_0 is 8-aligned)
  const int base2 = halo_unit(2 * ow_0);

  // copy geometry: the halo's units e = tid + i*T, stepped without a
  // division per copy
  const int n_units = g.tin_h * g.tin_w;
  const int e_row0 = tid / g.tin_w, e_col0 = tid - e_row0 * g.tin_w;
  const int step_r = T / g.tin_w, step_c = T - step_r * g.tin_w;
  const int n_chunks = (C + kCK - 1) / kCK;

  // int8 with ragged N or unaligned codes: the codes are plain loads; the
  // thread's first word of a chunk is held in a register and stored after
  // tap row 0 of the current chunk's FFMAs, so its load's latency hides
  // behind them
  unsigned held = 0;
  unsigned* held_dst = nullptr;

  // issue the copies of chunk `it` into ring slot `st` (the caller commits;
  // `defer`: hold the first synchronous code word past the FFMAs)
  auto issue = [&](int it, int st, bool defer) {
    const int ch0 = it * kCK;
    float* xd = Xs + st * halo_fl;
    int row = e_row0, col = e_col0;
    for (int e = tid; e < n_units; e += T) {
      const int gr = r0 + row, gc = c0 + col;
      const bool in = gr < g.Hp && gc < g.Wp;
      const float* src =
          x + ((static_cast<size_t>(b) * g.Hp + gr) * g.Wp + gc) * C + ch0;
      float* dst = xd + (row * g.pitch + halo_unit(col)) * 4;
      if (g.xvec) {
        cp_async16(dst, in ? src : x, in);
      } else {
#pragma unroll
        for (int q = 0; q < kCK; ++q) {
          const bool ok = in && ch0 + q < C;
          cp_async4(dst + q, ok ? src + q : x, ok);
        }
      }
      row += step_r;
      col += step_c;
      if (col >= g.tin_w) {
        col -= g.tin_w;
        ++row;
      }
    }
    // weight rows t*C + ch0 + c of every tap: slot row (t*kCK + c), BN wide
    constexpr int NQ = BN / 4;
    for (int u = tid; u < taps * kCK * NQ; u += T) {
      const int wr = u / NQ, nq = u - wr * NQ;
      const int t = wr / kCK, ch = ch0 + wr - t * kCK;
      const int n = n0 + nq * 4;
      // superpack row t*C + ch, held at row - r0 of the operand; rows
      // outside [g.r0, g.r1) (another rank's block) read as zeros
      const int row = t * C + ch;
      const bool held_row = ch < C && row >= g.r0 && row < g.r1;
      const size_t src =
          held_row ? static_cast<size_t>(row - g.r0) * N + n : 0;
      if constexpr (!I8) {
        float* dst = Ws + st * w_fl + wr * BN + nq * 4;
        if (g.wvec) {
          const bool ok = held_row && n < N;
          cp_async16(dst, ok ? w + src : w, ok);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const bool ok = held_row && n + q < N;
            cp_async4(dst + q, ok ? w + src + q : w, ok);
          }
        }
      } else {
        int8_t* dst = Qs + st * q_bytes + wr * BN + nq * 4;
        if (g.wvec) {
          const bool ok = held_row && n < N;
          cp_async4(dst, ok ? w + src : w, ok);
        } else {  // ragged N or unaligned codes: plain loads
          unsigned word = 0;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (held_row && n + q < N) {
              word |= static_cast<unsigned>(static_cast<uint8_t>(w[src + q]))
                      << (8 * q);
            }
          }
          if (defer && u == tid) {
            held = word;
            held_dst = reinterpret_cast<unsigned*>(dst);
          } else {
            *reinterpret_cast<unsigned*>(dst) = word;
          }
        }
      }
    }
    if constexpr (I8) {
      for (int r = tid; r < taps * kCK; r += T) {
        const int t = r / kCK, ch = ch0 + r - t * kCK;
        const int row = t * C + ch;
        const bool ok = ch < C && row >= g.r0 && row < g.r1;
        cp_async4(Ss + st * taps * kCK + r, ok ? scale + (row - g.r0) : scale,
                  ok);
      }
    }
  };

  // kernel E: the codes of ring slot `st`, each dequantized once from shared
  // memory into f32 weight tile `buf`; with compile-time taps the thread's
  // groups are unrolled, so their loads issue together
  auto dequant = [&](int st, int buf) {
    constexpr int NQ = BN / 4;
    const int8_t* qs = Qs + st * q_bytes;
    const float* ss = Ss + st * taps * kCK;
    float* dst = Ws + buf * w_fl;
    auto group = [&](int u) {
      const int wr = u / NQ, col = (u - wr * NQ) * 4;
      const float4 c = codes_to_f32(
          *reinterpret_cast<const unsigned*>(qs + wr * BN + col));
      const float s = ss[wr];
      *reinterpret_cast<float4*>(dst + wr * BN + col) =
          make_float4(__fmul_rn(c.x, s), __fmul_rn(c.y, s),
                      __fmul_rn(c.z, s), __fmul_rn(c.w, s));
    };
    if constexpr (PATH != 0) {
      constexpr int kGroups = kR * kR * kCK * NQ;
#pragma unroll
      for (int i = 0; i < (kGroups + T - 1) / T; ++i) {
        if (kGroups % T == 0 || tid + i * T < kGroups) group(tid + i * T);
      }
    } else {
      for (int u = tid; u < taps * kCK * NQ; u += T) group(u);
    }
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int k = 0; k < kTM; ++k)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[k][j] = 0.f;

  // one chunk's FFMAs: halo slot `xs`, f32 weight tile `ws`; `between`
  // runs after tap row 0 (the int8 entry's next tile), where its loads
  // hide behind that row's FFMAs
  auto multiply = [&](const float* xs, const float* ws, auto&& between) {
    const float4* X = reinterpret_cast<const float4*>(xs) + row_base;
    const float* W = ws + tx * kTN;
    if constexpr (PATH == 1) {
#pragma unroll
      for (int m = 0; m < kR; ++m) {
        const float4* Xr = X + m * row_step;
        float4 h[kSpan1];
#pragma unroll
        for (int j = 0; j < kSpan1; ++j) h[j] = Xr[offs[j]];
#pragma unroll
        for (int n = 0; n < kR; ++n) {
#pragma unroll
          for (int c = 0; c < kCK; ++c) {
            const float4 wv = *reinterpret_cast<const float4*>(
                W + ((m * kR + n) * kCK + c) * BN);
#pragma unroll
            for (int k = 0; k < kTM; ++k) fma_row(acc, lane(h[k + n], c), k, wv);
          }
        }
        if (m == 0) between();
      }
    } else if constexpr (PATH == 2) {
      constexpr int kSpan2 = 2 * (kTM - 1) + kR;
#pragma unroll
      for (int m = 0; m < kR; ++m) {
        const float4* Xr = X + m * row_step + base2;
        float4 h[kSpan2];
#pragma unroll
        for (int j = 0; j < kSpan2; ++j) h[j] = Xr[j + (j >> 3)];
#pragma unroll
        for (int n = 0; n < kR; ++n) {
#pragma unroll
          for (int c = 0; c < kCK; ++c) {
            const float4 wv = *reinterpret_cast<const float4*>(
                W + ((m * kR + n) * kCK + c) * BN);
#pragma unroll
            for (int k = 0; k < kTM; ++k) {
              fma_row(acc, lane(h[2 * k + n], c), k, wv);
            }
          }
        }
        if (m == 0) between();
      }
    } else {
      for (int m = 0; m < R; ++m) {
        const float4* Xr = X + m * row_step;
        for (int n = 0; n < S; ++n) {
          float4 h[kTM];
#pragma unroll
          for (int k = 0; k < kTM; ++k) {
            h[k] = Xr[halo_unit((ow_0 + k) * g.sw + n * g.dw)];
          }
#pragma unroll
          for (int c = 0; c < kCK; ++c) {
            const float4 wv = *reinterpret_cast<const float4*>(
                W + ((m * S + n) * kCK + c) * BN);
#pragma unroll
            for (int k = 0; k < kTM; ++k) fma_row(acc, lane(h[k], c), k, wv);
          }
        }
        if (m == 0) between();
      }
    }
  };

  // The ring: chunks 0 .. RS-2 in flight before the loop; at chunk i (f32)
  // chunk i has landed for every thread after the barrier, and every thread
  // is done with chunk i - 1, whose slot the next copy refills.  int8:
  // chunk i + 1 has landed and chunk i's weight tile is dequantized.
  for (int s = 0; s < RS - 1; ++s) {
    if (s < n_chunks) issue(s, s, false);
    cp_async_commit();
  }
  if constexpr (I8) {
    cp_async_wait(RS - 2);
    __syncthreads();
    dequant(0, 0);
  }
  int slot = 0, next_slot = RS - 1;  // i % RS, (i + RS - 1) % RS
  for (int i = 0; i < n_chunks; ++i) {
    cp_async_wait(I8 ? RS - 3 : RS - 2);
    __syncthreads();
    if (i + RS - 1 < n_chunks) issue(i + RS - 1, next_slot, true);
    cp_async_commit();
    const int slot1 = slot + 1 == RS ? 0 : slot + 1;
    multiply(Xs + slot * halo_fl, Ws + (I8 ? (i & 1) : slot) * w_fl,
             [&] {
               if constexpr (I8) {
                 // chunk i + RS - 1's held codes (read at its chunk - 1)
                 if (held_dst != nullptr) {
                   *held_dst = held;
                   held_dst = nullptr;
                 }
                 // the next chunk's tile (last read by chunk i - 1): one
                 // barrier a chunk
                 if (i + 1 < n_chunks) dequant(slot1, (i + 1) & 1);
               }
             });
    next_slot = slot;
    slot = slot1;
  }

  const int n = n0 + tx * kTN;
  if (!live || n >= N) return;
  const int oh = oh0 + ph;
  if (oh >= g.OH) return;
#pragma unroll
  for (int k = 0; k < kTM; ++k) {
    const int pw = ow_0 + k * g.pd;
    const int ow = ow0 + pw;
    if (pw >= g.T_ow || ow >= g.OW) continue;
    float* dst = y + ((static_cast<size_t>(b) * g.OH + oh) * g.OW + ow) * N + n;
    if (g.wvec) {
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

// Dynamic shared memory of one block: the ring's halo slots and, for f32,
// its weight slots; for int8 two f32 weight tiles and the ring's scales and
// codes.  The wrapper's tiled_conv_smem_bytes.
template <int BN, bool I8>
int smem_bytes(const Geometry& g, int taps) {
  const int halo = g.tin_h * g.pitch * 16;
  const int wt = 4 * taps * kCK * BN;
  if (!I8) return g.stages * (halo + wt);
  return g.stages * (halo + 4 * taps * kCK + taps * kCK * BN) + 2 * wt;
}

template <int BN, int PATH, typename WT>
int launch(const float* x, const WT* w, const float* scale, float* y, int B,
           int n_ti, const Geometry& g, cudaStream_t stream) {
  static int allowed = 0;
  constexpr bool I8 = std::is_same<WT, int8_t>::value;
  const auto kernel = conv_tiled_kernel<BN, PATH, WT>;
  const int smem = smem_bytes<BN, I8>(g, g.R * g.S);
  if (smem > 48 * 1024 && smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  const dim3 grid(n_ti * g.n_tj, (g.N + BN - 1) / BN, B);
  kernel<<<grid, Block<BN>::kThreads, smem, stream>>>(x, w, scale, y, g);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, typename WT>
int dispatch_path(int path, const float* x, const WT* w, const float* scale,
                  float* y, int B, int n_ti, const Geometry& g,
                  cudaStream_t st) {
  switch (path) {
    case 0:
      return launch<BN, 0>(x, w, scale, y, B, n_ti, g, st);
    case 1:
      if (g.R != 3 || g.S != 3 || g.sw != 1 || g.pd != g.dw) break;
      return launch<BN, 1>(x, w, scale, y, B, n_ti, g, st);
    case 2:
      if (g.R != 3 || g.S != 3 || g.sw != 2 || g.dw != 1 || g.pd != 1) break;
      return launch<BN, 2>(x, w, scale, y, B, n_ti, g, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename WT>
int dispatch(const float* x, const WT* w, const float* scale, float* y,
             int B, const Geometry& g, int n_ti, int bn, int path,
             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int min_stages = std::is_same<WT, int8_t>::value ? 3 : 2;
  if (g.stages < min_stages || g.stages > 8 || g.gpr <= 0 || g.pd <= 0 ||
      g.tin_w <= 0 || g.pitch < halo_unit(g.tin_w - 1) + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (bn) {  // the wrapper's _TILED_CONV_BLOCKS
    case 4:
      return dispatch_path<4>(path, x, w, scale, y, B, n_ti, g, st);
    case 32:
      return dispatch_path<32>(path, x, w, scale, y, B, n_ti, g, st);
    case 64:
      return dispatch_path<64>(path, x, w, scale, y, B, n_ti, g, st);
    case 128:
      return dispatch_path<128>(path, x, w, scale, y, B, n_ti, g, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches kernel C on `stream` and returns cudaGetLastError() (0 =
// launched).  From the wrapper's tiled_conv_schedule: (T_oh, T_ow) the
// block's output tile, tin_h x tin_w its staged halo and `pitch` the units
// of a staged row, n_ti x n_tj the tiles over the output, `gpr` the pixel
// groups a tile row, `pd` the columns between a thread's pixels, `bn` the
// block's N width, `path` the tap loop (0 any taps; 1 3x3 with s_w = 1; 2
// 3x3 with s_w = 2, d_w = 1), `stages` the ring's slots; `xvec` the
// plane's 16-byte copies (C % 4 == 0, 16-byte aligned plane), `wvec` the
// superpack's 16-byte copies and the float4 stores (N % 4 == 0, aligned
// superpack and output).
// [r0, r1): the superpack rows the weight operand holds (0 and all of
// them for the whole superpack; a row-parallel block otherwise, whose
// launch returns the f32 partial sum over those rows and reads no other
// weight row).
extern "C" int untangled_conv2d_tiled_f32(
    const float* x, const float* w, float* y, int B, int Hp, int Wp, int C,
    int N, int OH, int OW, int R, int S, int sh, int sw, int dh, int dw,
    int T_oh, int T_ow, int tin_h, int tin_w, int pitch, int n_ti, int n_tj,
    int gpr, int pd, int bn, int path, int stages, int xvec, int wvec,
    int r0, int r1, void* stream) {
  const Geometry g{Hp,   Wp,    C,     N,     OH,   OW,  R,      S,
                   sh,   sw,    dh,    dw,    T_oh, T_ow, tin_h, tin_w,
                   pitch, n_tj, gpr,   pd,    stages, xvec, wvec,
                   r0,   r1};
  return dispatch<float>(x, w, nullptr, y, B, g, n_ti, bn, path, stream);
}

// Kernel E inside kernel C: as untangled_conv2d_tiled_f32 on int8 codes `q`
// with one f32 scale per superpack row (`scale`, R*S*C floats); `wvec` also
// needs `q` 4-byte aligned (4-code copies); `stages` at least 3.
extern "C" int untangled_conv2d_tiled_i8(
    const float* x, const int8_t* q, const float* scale, float* y, int B,
    int Hp, int Wp, int C, int N, int OH, int OW, int R, int S, int sh,
    int sw, int dh, int dw, int T_oh, int T_ow, int tin_h, int tin_w,
    int pitch, int n_ti, int n_tj, int gpr, int pd, int bn, int path,
    int stages, int xvec, int wvec, int r0, int r1, void* stream) {
  const Geometry g{Hp,   Wp,    C,     N,     OH,   OW,  R,      S,
                   sh,   sw,    dh,    dw,    T_oh, T_ow, tin_h, tin_w,
                   pitch, n_tj, gpr,   pd,    stages, xvec, wvec,
                   r0,   r1};
  return dispatch<int8_t>(x, q, scale, y, B, g, n_ti, bn, path, stream);
}
