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
// Mapping to the card.  One block per (tile, N tile, image); each walks all
// of C itself in chunks of kCK = 4 channels, one 16-byte group a halo
// pixel.  The wrapper's schedule (untangled_conv.tiled_deconv_schedule)
// picks the tap loop, the register split, the tile, BN (following N: 4 for
// N <= 4, else 32, 64 or 128), the ring's stages and the halo's row pitch.
// A chunk's halo slice and its weight rows of every tap of every phase ride
// a ring of `stages` slots in dynamic shared memory, copied with cp.async
// (16 bytes a copy where C % 4 == 0 and the plane is aligned, and for the
// superpack where N % 4 == 0; 4 bytes a copy otherwise; zero-filled by
// src-size 0 past the plane, C and N), so stages - 1 chunks are in flight
// while the FFMA loop multiplies the oldest; one barrier a chunk.  A block
// owns its tile for every phase, so the one staged halo serves all of them.
//
// Path 1, one halo read for every phase.  Where every phase has 2 x 2 taps
// at one xoff (k = 2*s: the U-Net's up sites and the cGAN's k4 s2), the
// phases read the same window and differ only in their weights, so they
// are extra output columns of one 2 x 2 correlation.  A thread holds TM
// pixels of one tile row x TP phases x kTN = 4 channels.  For each (chunk,
// tap row) it loads its halo span, TM + 1 values of 4 channels (one LDS.128
// each), once, and serves both taps of the row and all TP phases from
// registers; each weight float4 feeds TM x 4 FFMAs.  Path 0 takes every
// other uniform geometry at run time (the DCGAN's k5 s2, whose phases have
// 3/2 taps at different xoff; stride 1; a stride-3 plan with empty
// phases): each phase has its own threads (TM pixels x 4 channels), loads
// per (tap, pixel), and threads of a phase with no taps write zeros.
// Every output is one sum in a fixed order, chunk by chunk, then tap (row,
// column), then channel, in IEEE fp32 FFMA (no TF32, no tensor cores, so
// the f64 oracle's ULP bound holds), written once: two launches are
// bit-equal.
//
// The halo layout.  A staged halo row holds tin_w 16-byte channel groups;
// column col sits at unit col + col / 8, one pad unit every 8 columns, and
// a row takes `pitch` units.  The pixel groups of a warp lie in one tile
// row at the card's tiles, TM columns apart, so a warp's span reads hit
// distinct 16-byte bank groups (tests/test_torch_tiled_deconv_schedule.py
// replays them).  Pixels of idle thread groups and of the ragged tile edge
// read inside the staged halo and are not stored.
//
// What bounds it.  On an H100 SXM (data sheet: 67 TFLOP/s fp32 on the CUDA
// cores, 3.35 TB/s HBM) the U-Net's up0 at a 512^2 image (256^2 -> 512^2,
// 64 -> 32, k4 s2: 4 phases of 2 x 2 taps) does 2*256^2*16*64*32 = 4.3
// GFLOP an image, FFMA-bound (~0.064 ms an image); its plane and output
// take a quarter of that in bytes.  Per (chunk, tap row) a path-1 thread
// issues 32*TP*TM FFMAs for TM + 1 + 8*TP shared vector loads: at up0 8
// pixels x 4 phases, 1024 FFMAs for 41 loads.  A block owns 256 positions
// of every phase there, so the 16-tap superpack (128 KB at C = 64, N = 32)
// is staged once per 256 positions, not per 32 (0.5 GB through L2 at B =
// 16, not 4.3).  On an H100 up0 runs at about half of its FFMA bound
// (PERF.md).
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
// (4 bytes a copy on the vector path; plain loads otherwise) and row scales
// ride the same ring; once a chunk has landed, each code is dequantized
// once from shared memory, a chunk ahead of the FFMA loop (path 1: between
// tap rows 0 and 1 of the chunk before), into one of two f32 weight tiles
// (codes_to_f32: a byte permute and one subtraction, exact) with one IEEE
// multiply by its row's scale (__fmul_rn, the rounding of JAX's
// panel.astype(f32) * scale and of torch's q.float() * scale).  The FFMA
// loop and order are the f32 entry's, so the int8 kernel on (q, scale) is
// bit-equal to the f32 kernel on dequantize(q, scale).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTN = 4;  // output channels a thread (one float4)
constexpr int kCK = 4;  // channels a chunk: one 16-byte group a halo pixel
constexpr int kT = 2;   // path 1: 2 x 2 taps a phase, compile-time
constexpr int kRec = 9;  // ints of a phase record (the wrapper's _phase_table)

struct Geometry {
  int Hg, Wg, C, N, OH, OW, sh, sw;
  int n_phases, taps;  // phases; superpack taps (rows / C)
  int T_u, T_v;        // tile, phase-output pixels
  int U, V;            // phase-output extent
  int org_h, org_w;    // the halo's origin offset (the tap span's minimum)
  int tin_h, tin_w;    // staged halo rows and columns
  int pitch;           // 16-byte units a staged halo row
  int n_tj;            // tiles across V
  int gpr;             // pixel groups a tile row
  int gpp;             // path 0: pixel groups a phase
  int stages;          // ring slots
  int xvec;            // 16-byte plane copies (C % 4 == 0, aligned plane)
  int wvec;            // 16-byte superpack copies and float4 stores
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
    default: asm volatile("cp.async.wait_group 5;\n" ::); break;
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

// acc[k][:] += a * w: pixel k, the thread's 4 channels
template <int TM>
__device__ __forceinline__ void fma_row(float (&acc)[TM][kTN], float a,
                                        int k, const float4& w) {
  acc[k][0] = fmaf(a, w.x, acc[k][0]);
  acc[k][1] = fmaf(a, w.y, acc[k][1]);
  acc[k][2] = fmaf(a, w.z, acc[k][2]);
  acc[k][3] = fmaf(a, w.w, acc[k][3]);
}

// BN output channels a block, PATH the tap loop, TM pixels x TP phases a
// thread, T threads a block, MINB blocks an SM (asked of ptxas); the
// wrapper's _TD_VARIANTS
template <int BN, int PATH, int TM, int TP, int T, int MINB, typename WT>
__global__ void __launch_bounds__(T, MINB)
deconv_tiled_kernel(const float* __restrict__ x, const WT* __restrict__ w,
                    const float* __restrict__ scale,
                    const int* __restrict__ table, float* __restrict__ y,
                    const Geometry g) {
  constexpr bool I8 = std::is_same<WT, int8_t>::value;
  constexpr int NQ = BN / kTN;  // threads across one phase's N
  static_assert(PATH == 1 || TP == 1, "path 0 holds one phase a thread");
  static_assert(TM % 8 == 0, "pixel groups start on a pad unit's 8 columns");

  extern __shared__ __align__(16) float smem[];
  const int C = g.C, N = g.N, RS = g.stages, taps = g.taps;
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
  const int r0 = ti * g.T_u + g.org_h, c0 = tj * g.T_v + g.org_w;
  const int tid = threadIdx.x;

  // this thread's columns: phases q0 .. q0 + TP - 1 x 4 channels (its
  // weights from float wofs of a weight tile on); and its pixel group: tile
  // row ph, columns ow_0 ..
  int tx, grp, q0, wofs;
  int th = kT, tw = kT, row_off = 0, col_off = 0;  // path 0: the phase's
  bool live;
  if constexpr (PATH == 1) {
    // phase q's 2 x 2 taps are superpack taps 4q .. 4q + 3 (the schedule
    // checks), so phase q0 + i's weights sit i*16*kCK*BN floats further on
    const int ncg = g.n_phases / TP * NQ;  // column groups
    const int cg = tid % ncg;
    grp = tid / ncg;
    const int pb = cg / NQ;
    tx = cg - pb * NQ;
    q0 = pb * TP;
    wofs = q0 * kT * kT * kCK * BN + tx * kTN;
    live = grp < T / ncg;
  } else {
    tx = tid % NQ;
    const int pg = tid / NQ;
    q0 = pg / g.gpp;
    grp = pg - q0 * g.gpp;
    live = q0 < g.n_phases;
    th = tw = wofs = 0;
    if (live) {
      const int* rec = table + q0 * kRec;
      wofs = rec[2] * kCK * BN + tx * kTN;
      th = rec[3];
      tw = rec[4];
      row_off = rec[5] - g.org_h;
      col_off = rec[6] - g.org_w;
    }
  }
  int ph = grp / g.gpr;
  int ow_0 = (grp - ph * g.gpr) * TM;
  live = live && ph < g.T_u;
  if (!live) {  // reads inside the halo, multiplies nothing, stores nothing
    ph = ow_0 = 0;
    th = tw = 0;
  }
  // path 1: span value j of tap row m at unit base + m*pitch + j + j/8
  // (ow_0 is a multiple of 8)
  const int base = ph * g.pitch + halo_unit(ow_0);

  // copy geometry: the halo's units e = tid + i*T, stepped without a
  // division per copy
  const int n_units = g.tin_h * g.tin_w;
  const int e_row0 = tid / g.tin_w, e_col0 = tid - e_row0 * g.tin_w;
  const int step_r = T / g.tin_w, step_c = T - step_r * g.tin_w;
  const int n_chunks = (C + kCK - 1) / kCK;

  // issue the copies of chunk `it` into ring slot `st` (the caller commits)
  auto issue = [&](int it, int st) {
    const int ch0 = it * kCK;
    float* xd = Xs + st * halo_fl;
    int row = e_row0, col = e_col0;
    for (int e = tid; e < n_units; e += T) {
      const int gr = r0 + row, gc = c0 + col;
      const bool in = gr < g.Hg && gc < g.Wg;
      const float* src =
          x + ((static_cast<size_t>(b) * g.Hg + gr) * g.Wg + gc) * C + ch0;
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
          *reinterpret_cast<unsigned*>(dst) = word;
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
  // memory into f32 weight tile `buf`
  auto dequant = [&](int st, int buf) {
    const int8_t* qs = Qs + st * q_bytes;
    const float* ss = Ss + st * taps * kCK;
    float* dst = Ws + buf * w_fl;
#pragma unroll 2
    for (int u = tid; u < taps * kCK * NQ; u += T) {
      const int wr = u / NQ, col = (u - wr * NQ) * 4;
      const float4 c = codes_to_f32(
          *reinterpret_cast<const unsigned*>(qs + wr * BN + col));
      const float s = ss[wr];
      *reinterpret_cast<float4*>(dst + wr * BN + col) =
          make_float4(__fmul_rn(c.x, s), __fmul_rn(c.y, s),
                      __fmul_rn(c.z, s), __fmul_rn(c.w, s));
    }
  };

  float acc[TP][TM][kTN];
#pragma unroll
  for (int i = 0; i < TP; ++i)
#pragma unroll
    for (int k = 0; k < TM; ++k)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][k][j] = 0.f;

  // one chunk's FFMAs: halo slot `xs`, f32 weight tile `ws`; `between` (the
  // int8 entry's next tile) runs once, where its loads hide behind FFMAs
  auto multiply = [&](const float* xs, const float* ws, auto&& between) {
    const float4* X = reinterpret_cast<const float4*>(xs);
    if constexpr (PATH == 1) {
      // int8 keeps the tap-row loop rolled: the dequantization's registers
      // then fit beside the FFMAs' (measured faster at 8 x 2 a thread, and
      // spill-free at BN 4)
#pragma unroll(I8 ? 1 : kT)
      for (int m = 0; m < kT; ++m) {
        const float4* Xr = X + base + m * g.pitch;
        float4 h[TM + 1];
#pragma unroll
        for (int j = 0; j <= TM; ++j) h[j] = Xr[j + (j >> 3)];
#pragma unroll
        for (int n = 0; n < kT; ++n) {
#pragma unroll
          for (int c = 0; c < kCK; ++c) {
#pragma unroll
            for (int i = 0; i < TP; ++i) {
              const float4 wv = *reinterpret_cast<const float4*>(
                  ws + wofs + (((i * kT + m) * kT + n) * kCK + c) * BN);
#pragma unroll
              for (int k = 0; k < TM; ++k) {
                fma_row(acc[i], lane(h[k + n], c), k, wv);
              }
            }
          }
        }
        if (m == 0) between();
      }
    } else {
      between();
      for (int m = 0; m < th; ++m) {
        const float4* Xr = X + (row_off + ph + m) * g.pitch;
        for (int n = 0; n < tw; ++n) {
          float4 h[TM];
#pragma unroll
          for (int k = 0; k < TM; ++k) {
            h[k] = Xr[halo_unit(col_off + ow_0 + k + n)];
          }
          const float* wt = ws + wofs + (m * tw + n) * kCK * BN;
#pragma unroll
          for (int c = 0; c < kCK; ++c) {
            const float4 wv = *reinterpret_cast<const float4*>(wt + c * BN);
#pragma unroll
            for (int k = 0; k < TM; ++k) fma_row(acc[0], lane(h[k], c), k, wv);
          }
        }
      }
    }
  };

  // The ring: chunks 0 .. RS-2 in flight before the loop; at chunk i (f32)
  // chunk i has landed for every thread after the barrier, and every thread
  // is done with chunk i - 1, whose slot the next copy refills.  int8:
  // chunk i + 1 has landed and chunk i's weight tile is dequantized.
  for (int s = 0; s < RS - 1; ++s) {
    if (s < n_chunks) issue(s, s);
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
    if (i + RS - 1 < n_chunks) issue(i + RS - 1, next_slot);
    cp_async_commit();
    const int slot1 = slot + 1 == RS ? 0 : slot + 1;
    multiply(Xs + slot * halo_fl, Ws + (I8 ? (i & 1) : slot) * w_fl,
             [&] {
               // int8: the next chunk's tile (last read by chunk i - 1):
               // one barrier a chunk
               if constexpr (I8) {
                 if (i + 1 < n_chunks) dequant(slot1, (i + 1) & 1);
               }
             });
    next_slot = slot;
    slot = slot1;
  }

  // the interleaved store: phase (q_h, q_w) pixel (u, v) at
  // (q_h + s_h*u, q_w + s_w*v); a phase with no taps stores zeros
  const int n = n0 + tx * kTN;
  if (!live || n >= N) return;
  const int u = ti * g.T_u + ph;
  if (u >= g.U) return;
#pragma unroll
  for (int i = 0; i < TP; ++i) {
    const int* rec = table + (q0 + i) * kRec;
    const int oh = rec[0] + g.sh * u, qw = rec[1];
#pragma unroll
    for (int k = 0; k < TM; ++k) {
      const int pw = ow_0 + k;
      const int v = tj * g.T_v + pw;
      if (pw >= g.T_v || v >= g.V) continue;
      const int ow = qw + g.sw * v;
      float* dst =
          y + ((static_cast<size_t>(b) * g.OH + oh) * g.OW + ow) * N + n;
      if (g.wvec) {
        *reinterpret_cast<float4*>(dst) = make_float4(
            acc[i][k][0], acc[i][k][1], acc[i][k][2], acc[i][k][3]);
      } else {
        dst[0] = acc[i][k][0];
        if (n + 1 < N) dst[1] = acc[i][k][1];
        if (n + 2 < N) dst[2] = acc[i][k][2];
        if (n + 3 < N) dst[3] = acc[i][k][3];
      }
    }
  }
}

// Dynamic shared memory of one block: the ring's halo slots and, for f32,
// its weight slots; for int8 two f32 weight tiles and the ring's scales and
// codes.  The wrapper's tiled_deconv_smem_bytes.
template <int BN, bool I8>
int smem_bytes(const Geometry& g) {
  const int halo = g.tin_h * g.pitch * 16;
  const int wt = 4 * g.taps * kCK * BN;
  if (!I8) return g.stages * (halo + wt);
  return g.stages * (halo + 4 * g.taps * kCK + g.taps * kCK * BN) + 2 * wt;
}

template <int BN, int PATH, int TM, int TP, int T, int MINB, typename WT>
int launch(const float* x, const WT* w, const float* scale, const int* table,
           float* y, int B, int n_ti, const Geometry& g,
           cudaStream_t stream) {
  static int allowed = 0;
  constexpr bool I8 = std::is_same<WT, int8_t>::value;
  // the thread layout: column groups x pixel groups
  const int ncg = PATH == 1 ? g.n_phases / TP * (BN / kTN) : BN / kTN;
  if (g.n_phases % TP != 0 || ncg > T || T % ncg != 0 ||
      (PATH == 1 ? g.T_u * g.gpr > T / ncg
                 : g.gpp * g.n_phases > T / ncg || g.T_u * g.gpr > g.gpp) ||
      g.gpr * TM < g.T_v) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = deconv_tiled_kernel<BN, PATH, TM, TP, T, MINB, WT>;
  const int smem = smem_bytes<BN, I8>(g);
  if (smem > 48 * 1024 && smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  const dim3 grid(n_ti * g.n_tj, (g.N + BN - 1) / BN, B);
  kernel<<<grid, T, smem, stream>>>(x, w, scale, table, y, g);
  return static_cast<int>(cudaGetLastError());
}

// The instantiated variants, (BN, path, TM, TP, threads, blocks an SM): the
// wrapper's _TD_VARIANTS
template <typename WT>
int dispatch(const float* x, const WT* w, const float* scale,
             const int* table, float* y, int B, int n_ti, const Geometry& g,
             int bn, int path, int tm, int tp, int threads,
             cudaStream_t st) {
  const int min_stages = std::is_same<WT, int8_t>::value ? 3 : 2;
  if (g.stages < min_stages || g.stages > 6 || g.gpr <= 0 ||
      g.tin_w <= 0 || g.pitch < halo_unit(g.tin_w - 1) + 1 ||
      g.n_phases <= 0 || (path == 0 && g.gpp <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define D_VARIANT(BN_, P_, TM_, TP_, T_, MINB_)                           \
  if (bn == BN_ && path == P_ && tm == TM_ && tp == TP_ && threads == T_) \
    return launch<BN_, P_, TM_, TP_, T_, MINB_>(x, w, scale, table, y, B,  \
                                                n_ti, g, st);
  D_VARIANT(4, 0, 8, 1, 256, 2)
  D_VARIANT(32, 0, 8, 1, 256, 2)
  D_VARIANT(64, 0, 8, 1, 256, 2)
  D_VARIANT(128, 0, 8, 1, 256, 2)
  D_VARIANT(4, 1, 8, 2, 256, 2)
  D_VARIANT(32, 1, 8, 4, 256, 1)
  D_VARIANT(32, 1, 8, 2, 256, 2)
  D_VARIANT(64, 1, 8, 2, 256, 2)
  D_VARIANT(128, 1, 8, 2, 256, 2)
#undef D_VARIANT
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches kernel D on `stream` and returns cudaGetLastError() (0 =
// launched).  `table` is the plan's phase records, 9 int32 each (the
// wrapper's _phase_table).  From the wrapper's tiled_deconv_schedule:
// (T_u, T_v) the block's tile in phase-output pixels of (U, V), (org_h,
// org_w) the halo's origin offset, tin_h x tin_w its staged extent and
// `pitch` the units of a staged row, n_ti x n_tj the tiles, `gpr` the
// pixel groups a tile row, `gpp` (path 0) the pixel groups a phase; `bn`,
// `path` (0 run-time taps, phases in their own threads; 1 the shared 2 x 2
// window, phases as extra output columns), `tm` pixels x `tp` phases a
// thread and `threads` a block select the instantiation; `stages` the
// ring's slots; `xvec` the plane's 16-byte copies (C % 4 == 0, aligned
// plane), `wvec` the superpack's 16-byte copies and the float4 stores (N %
// 4 == 0, aligned superpack and output).
// [r0, r1): the superpack rows the weight operand holds (0 and all of
// them for the whole superpack; a row-parallel block otherwise, whose
// launch returns the f32 partial sum over those rows and reads no other
// weight row).
extern "C" int untangled_deconv2d_tiled_f32(
    const float* xg, const float* w, const int* table, float* y, int B,
    int Hg, int Wg, int C, int N, int OH, int OW, int sh, int sw,
    int n_phases, int taps, int T_u, int T_v, int U, int V, int org_h,
    int org_w, int tin_h, int tin_w, int pitch, int n_ti, int n_tj, int gpr,
    int gpp, int bn, int path, int tm, int tp, int threads, int stages,
    int xvec, int wvec, int r0, int r1, void* stream) {
  const Geometry g{Hg,   Wg,    C,     N,     OH,    OW,     sh,   sw,
                   n_phases, taps, T_u, T_v,   U,     V,      org_h, org_w,
                   tin_h, tin_w, pitch, n_tj, gpr,   gpp,    stages, xvec,
                   wvec,  r0,    r1};
  return dispatch<float>(xg, w, nullptr, table, y, B, n_ti, g, bn, path, tm,
                         tp, threads, static_cast<cudaStream_t>(stream));
}

// Kernel E inside kernel D: as untangled_deconv2d_tiled_f32 on int8 codes
// `q` with one f32 scale per superpack row (`scale`, taps*C floats); `wvec`
// also needs `q` 4-byte aligned (4-code copies); `stages` at least 3.
extern "C" int untangled_deconv2d_tiled_i8(
    const float* xg, const int8_t* q, const float* scale, const int* table,
    float* y, int B, int Hg, int Wg, int C, int N, int OH, int OW, int sh,
    int sw, int n_phases, int taps, int T_u, int T_v, int U, int V,
    int org_h, int org_w, int tin_h, int tin_w, int pitch, int n_ti,
    int n_tj, int gpr, int gpp, int bn, int path, int tm, int tp,
    int threads, int stages, int xvec, int wvec, int r0, int r1,
    void* stream) {
  const Geometry g{Hg,   Wg,    C,     N,     OH,    OW,     sh,   sw,
                   n_phases, taps, T_u, T_v,   U,     V,      org_h, org_w,
                   tin_h, tin_w, pitch, n_tj, gpr,   gpp,    stages, xvec,
                   wvec,  r0,    r1};
  return dispatch<int8_t>(xg, q, scale, table, y, B, n_ti, g, bn, path, tm,
                          tp, threads, static_cast<cudaStream_t>(stream));
}
