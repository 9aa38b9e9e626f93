// Kernel B on Hopper: the single (strided or dilated) untangled correlation.
//
// Replaces the TPU kernel src/repro/kernels/untangled_conv.py::_kernel
// (entry untangled_conv2d_superpack_pallas; HWIO entry
// untangled_conv2d_pallas).  It computes, in ONE call, the valid
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
// output pixels (the batch folded in), N output channels, K = R*S*C.  The
// K index k = t*C + c IS the superpack row, so the weight operand is a
// plain contiguous (K, N) row-major matrix and only the plane side is a
// gather, at (oh*s_h + m*d_h, ow*s_w + n'*d_w).  K is walked as one flat
// range in chunks of kBK rows (not per tap), so a thin C (the RGB input of
// the first discriminator layer, C = 3, K = 75) wastes no K slot; each
// copy finds its tap from k, from a cursor that steps with the chunks.
//
// A row-parallel block: the call may hold superpack rows [k0, k0 + K)
// only (K = R*S*C is the whole superpack), and the result is the f32
// partial sum over them.  K is walked from row k0 (the cursor finds each
// row's tap from k0 + k), so a block that cuts a tap needs nothing more.
//
// A work unit is one (M tile, K slice, N tile): the wrapper's schedule
// (untangled_conv.conv_schedule) picks the tile and a slice length of L
// chunks.  Unsplit (L at least K's chunks), each unit stores its tile into
// y; split (where the unsplit grid would leave block slots idle long
// enough to pay for a second pass: batch 1, or a two-block tile's grid
// that fills one slot an SM), each unit stores its f32 partial tile into
// the workspace and conv_split_reduce sums a tile's slices in slice order.
// Every output is a fixed-order sum (ascending K inside a slice, no float
// atomics): two launches are bit-equal.
//
// Inside a unit the plane and superpack chunks stream through a ring of
// STAGES chunks in dynamic shared memory with cp.async (zero-filled by
// src-size 0 past M, K and N), so STAGES - 1 chunks are in flight while
// the FFMA loop multiplies the oldest one (4 stages on the 128-row tiles,
// where the FFMAs set the pace; 6-8 on the small tiles of batch 1, where
// bytes in flight do).  The plane chunk is a row-major (pixel, k) tile:
// on the vector path (C % 4 == 0, aligned plane) four consecutive k of one
// tap are one 16-byte copy, else each element is a 4-byte copy with its
// own tap.  Superpack rows go 16 bytes at a time on the vector path (N % 4
// == 0, aligned), 4 bytes otherwise.  Every thread accumulates a TM x TN
// register tile (rows ty + r*BM/TM, so a warp's plane reads hit distinct
// banks) with IEEE fp32 FFMA in ascending K order: no TF32, no tensor
// cores, so the f64 oracle's ULP bound holds (a split sum has at most
// L*kBK + S - 1 roundings on any path, no more than the K terms the bound
// allows).
//
// Tiles (the wrapper's _CONV_CONFIGS): BN follows N (32, 64 or 128: the
// smallest that holds min(N, 128)), BM follows the rows (128 when that
// fills the card, else 64, 32 or 16 for the few rows of batch 1), and N <=
// 16 (the U-Net's RGB head) takes a 128x16 tile.
//
// What bounds it.  The fp32 FFMA peak of an H100 SXM is about 67 TFLOP/s,
// HBM about 3.35 TB/s.  At batch 1 the superpack dominates the bytes
// (DCGAN D4: 52 MB against 0.42 GFLOP, ~15.7 us) and every site is
// memory bound; whole-K tiles gave those sites 8-16 blocks, each walking
// hundreds of chunks one after another with one chunk in flight, so split
// K gives the card a few hundred units, each with STAGES - 1 chunks in
// flight.  At batch 64 the discriminator and SegNet sites are FFMA bound
// (~0.4 ms at D2-D4); the 128-row tiles keep 64 (8x8) or 32 FFMAs a thread
// per shared-memory float4 pair.
//
// Kernel E, int8 weights (replaces the TPU kernel's int8 tap panel,
// src/repro/kernels/untangled_conv.py::_tap_panel).  The int8 entry takes
// the superpack as int8 codes q (R*S*C, N) and one f32 scale per superpack
// row; since k IS the row, the codes (4 bytes a copy on the vector path)
// and the chunk's row scales go through the same cp.async ring, twice as
// deep (a chunk carries a quarter of the bytes, so as many bytes are in
// flight), 1 byte a weight; once a chunk has landed, each code is
// dequantized once from shared memory, a chunk ahead of the FFMA loop,
// into one of two f32 operand tiles (the code made exact f32 by a byte
// permute and one subtraction, codes_to_f32, not a conversion instruction)
// with one IEEE multiply by its row's scale (__fmul_rn, the rounding of
// JAX's panel.astype(f32) * scale and of torch's q.float() * scale).  No
// arithmetic waits on a global load, and the FFMA loop, tiles, slices and
// order are the f32 entry's, so the int8 kernel on (q, scale) is bit-equal
// to the f32 kernel on dequantize(q, scale).  The scale sits on the
// contraction dim, so it cannot move after the dot.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBK = 16;  // superpack rows (flat K) a chunk
constexpr int kPad = 4;  // floats of padding per shared-memory tile row
constexpr int kReduceThreads = 256;

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

// Slices of `chunks` K chunks under slice length L, and where slice s
// begins: slice s covers chunks [begin(s), begin(s + 1)).  The wrapper's
// _n_slices/_slice_begin.
__host__ __device__ __forceinline__ int n_slices(int chunks, int L) {
  return chunks <= L ? 1 : (chunks + L - 1) / L;
}

__host__ __device__ __forceinline__ int slice_begin(int chunks, int slices,
                                                    int s) {
  return static_cast<int>(static_cast<long long>(s) * chunks / slices);
}

struct Geometry {
  int B, Hp, Wp, C, N, OH, OW, R, S, sh, sw, dh, dw;
  int avec;       // the plane's 16-byte copies (C % 4 == 0, aligned)
  int bvec;       // the superpack's 16-byte copies and float4 stores
  int chunk_len;  // L, K chunks per slice
  int grid_x;     // work units over (M tile, slice)
  int grid_n;     // N tiles
  int m_tiles;    // the reduction's M tiles
  int k0;         // the call's first superpack row (a row-parallel block)
  int K;          // its superpack rows: R*S*C for the whole superpack
};

// Where superpack row k reads the plane, relative to its pixel's tap-(0, 0)
// read: k = (mi*S + ni)*C + c, stepped forward without a division.
struct TapCursor {
  int c, ni, mi;

  __device__ __forceinline__ TapCursor(int k, int C, int S) {
    const int t = k / C;
    c = k - t * C;
    mi = t / S;
    ni = t - mi * S;
  }
  __device__ __forceinline__ void advance(int d, int C, int S) {
    c += d;
    while (c >= C) {
      c -= C;
      if (++ni == S) {
        ni = 0;
        ++mi;
      }
    }
  }
  // step_h = d_h*Wp*C and step_w = d_w*C: the plane offset of one tap row
  // and of one tap column
  __device__ __forceinline__ int shift(int step_h, int step_w) const {
    return mi * step_h + ni * step_w + c;
  }
};

// The four int8 codes of `word` (little-endian) as exact f32 values, with no
// conversion instruction: byte j, offset to q + 128, becomes the mantissa
// of 2^23 + q + 128 (__byte_perm puts it under the exponent byte 0x4B), and
// one subtraction of 2^23 + 128 leaves q, exactly (every value is an
// integer below 2^24).  Equal to static_cast<float>(q) for every code.
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

// Ring slots: STAGES for f32; twice as many for int8, whose chunks carry a
// quarter of the bytes and whose dequantized operand tile runs a chunk
// ahead of the FFMA loop.
template <int ST, bool I8>
__host__ __device__ constexpr int ring_slots() {
  return I8 ? 2 * ST : ST;
}

// Dynamic shared memory of conv_kernel: the ring's row-major plane chunks,
// and for f32 the ring's superpack chunks, for int8 two f32 operand tiles
// and the ring's row scales and codes.
template <int BM, int BN, int ST, bool I8>
constexpr int smem_bytes() {
  constexpr int R = ring_slots<ST, I8>();
  return 4 * (R * BM * (kBK + kPad) +
              (I8 ? 2 * kBK * (BN + kPad) + R * kBK + R * kBK * BN / 4
                  : R * kBK * (BN + kPad)));
}

template <int BM, int BN, int TM, int TN, int ST, int MINB, typename WT>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), MINB)
conv_kernel(const float* __restrict__ x, const WT* __restrict__ w,
            const float* __restrict__ scale, float* __restrict__ y,
            float* __restrict__ ws, const Geometry g) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr bool I8 = std::is_same<WT, int8_t>::value;
  static_assert(BM % TM == 0 && BN % TN == 0 && TN % 4 == 0, "tiles");
  static_assert(NT % (kBK / 4) == 0, "one K offset a thread");
  constexpr int AS = kBK + kPad;          // plane tile row stride
  constexpr int BS = BN + kPad;           // superpack tile row stride
  constexpr int A_STAGE = BM * AS;        // floats
  constexpr int B_STAGE = kBK * BS;       // floats
  constexpr int Q_STAGE = kBK * BN;       // bytes of int8 codes
  constexpr int A_SLOTS = BM * kBK / 4;   // 4-element plane groups a chunk
  constexpr int B_GROUPS = kBK * BN / 4;  // 4-column superpack groups
  constexpr int A_PT = (A_SLOTS + NT - 1) / NT;
  constexpr int B_PT = (B_GROUPS + NT - 1) / NT;
  constexpr int E_PT = (kBK * BN + NT - 1) / NT;
  constexpr int RSTEP = BM / TM;          // row stride of a thread's rows
  constexpr int NSTEP = 4 * BN / TN;      // col stride of a thread's groups
  constexpr int R = ring_slots<ST, I8>();

  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = As + R * A_STAGE;  // f32: the ring; int8: two operand tiles
  float* Ss = Bs + 2 * B_STAGE;  // int8: row scales, R x kBK
  int8_t* Qs = reinterpret_cast<int8_t*>(Ss + R * kBK);  // int8: codes

  const int OHW = g.OH * g.OW;
  const int M = g.B * OHW;
  const int N = g.N, C = g.C, S = g.S;
  const int K = g.K;  // the block's rows, from superpack row g.k0
  const int kc = (K + kBK - 1) / kBK;
  const int S_k = n_slices(kc, g.chunk_len);
  const int mt = blockIdx.x / S_k;
  const int sl = blockIdx.x - mt * S_k;
  const int c_begin = slice_begin(kc, S_k, sl);
  const int n_iter = slice_begin(kc, S_k, sl + 1) - c_begin;
  const int m0 = mt * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

  // This thread's copies are the same in every chunk: plane slots q = tid +
  // i*NT (the tile's pixel row q / (kBK/4), k offset a_k) and superpack
  // groups q = tid + i*NT (row q / (BN/4), four columns from col).  The
  // pixel's plane offset (that of x[b, oh*s_h, ow*s_w, 0], -1 past M) and
  // the group's superpack offset are computed once, so a chunk's copy costs
  // an add and a compare; the cursor follows k = chunk*kBK + a_k through
  // the chunks, which are issued in order.
  const int a_k = (tid % (kBK / 4)) * 4;
  int a_base[A_PT];
#pragma unroll
  for (int i = 0; i < A_PT; ++i) {
    const int m = m0 + (tid + i * NT) / (kBK / 4);
    int base = -1;
    if (m < M) {
      const int b = m / OHW, rem = m - b * OHW;
      const int oh = rem / g.OW, ow = rem - oh * g.OW;
      base = ((b * g.Hp + oh * g.sh) * g.Wp + ow * g.sw) * C;
    }
    a_base[i] = base;
  }
  int b_row[B_PT], b_col[B_PT], b_src[B_PT];
  bool b_in[B_PT];
#pragma unroll
  for (int i = 0; i < B_PT; ++i) {
    const int q = tid + i * NT;
    b_row[i] = q / (BN / 4);
    b_col[i] = (q % (BN / 4)) * 4;
    b_in[i] = (B_GROUPS % NT == 0 || q < B_GROUPS) && n0 + b_col[i] < N;
    b_src[i] = b_row[i] * N + n0 + b_col[i];
  }
  const int step_h = g.dh * g.Wp * C, step_w = g.dw * C;
  int k_next = c_begin * kBK + a_k;
  TapCursor cur(g.k0 + k_next, C, S);

  // issue the cp.async copies of K chunk `it` (the next in order) into
  // ring slot `st`
  auto issue = [&](int it, int st) {
    float* a_dst = As + st * A_STAGE + a_k;
    const int k = k_next;
    if (g.avec) {
      // C % 4 == 0 and k0 % 4 == 0: k .. k+3 lie in one tap, and
      // K % 4 == 0
      const float* xk = x + cur.shift(step_h, step_w);
#pragma unroll
      for (int i = 0; i < A_PT; ++i) {
        const int q = tid + i * NT;
        if (A_SLOTS % NT == 0 || q < A_SLOTS) {
          const bool ok = a_base[i] >= 0 && k < K;
          cp_async16(a_dst + (q / (kBK / 4)) * AS, ok ? xk + a_base[i] : x,
                     ok);
        }
      }
    } else {
      int shift[4];
      TapCursor e = cur;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        shift[j] = e.shift(step_h, step_w);
        e.advance(1, C, S);
      }
#pragma unroll
      for (int i = 0; i < A_PT; ++i) {
        const int q = tid + i * NT;
        if (A_SLOTS % NT == 0 || q < A_SLOTS) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool ok = a_base[i] >= 0 && k + j < K;
            cp_async4(a_dst + (q / (kBK / 4)) * AS + j,
                      ok ? x + a_base[i] + shift[j] : x, ok);
          }
        }
      }
    }
    k_next += kBK;
    cur.advance(kBK, C, S);

    const int k0 = it * kBK;
    const WT* wk = w + static_cast<size_t>(k0) * N;
    if constexpr (!I8) {
      float* b_dst = Bs + st * B_STAGE;
      if (g.bvec) {
#pragma unroll
        for (int i = 0; i < B_PT; ++i) {
          if (B_GROUPS % NT == 0 || tid + i * NT < B_GROUPS) {
            const bool ok = b_in[i] && k0 + b_row[i] < K;
            cp_async16(b_dst + b_row[i] * BS + b_col[i],
                       ok ? wk + b_src[i] : w, ok);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < E_PT; ++i) {
          const int q = tid + i * NT;
          if ((kBK * BN) % NT == 0 || q < kBK * BN) {
            const int row = q / BN, col = q % BN;
            const bool ok = k0 + row < K && n0 + col < N;
            const float* src = w + static_cast<size_t>(k0 + row) * N + n0 +
                               col;
            cp_async4(b_dst + row * BS + col, ok ? src : w, ok);
          }
        }
      }
    } else {
      int8_t* q_dst = Qs + st * Q_STAGE;
      if (g.bvec) {
#pragma unroll
        for (int i = 0; i < B_PT; ++i) {
          if (B_GROUPS % NT == 0 || tid + i * NT < B_GROUPS) {
            const bool ok = b_in[i] && k0 + b_row[i] < K;
            cp_async4(q_dst + b_row[i] * BN + b_col[i],
                      ok ? wk + b_src[i] : w, ok);
          }
        }
      } else {  // ragged N or unaligned codes: plain loads, synchronous
        for (int q = tid; q < kBK * BN; q += NT) {
          const int row = q / BN, col = q % BN;
          const bool ok = k0 + row < K && n0 + col < N;
          q_dst[row * BN + col] =
              ok ? w[static_cast<size_t>(k0 + row) * N + n0 + col]
                 : static_cast<int8_t>(0);
        }
      }
      for (int r = tid; r < kBK; r += NT) {
        const bool ok = k0 + r < K;
        cp_async4(Ss + st * kBK + r, ok ? scale + k0 + r : scale, ok);
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
    const int8_t* q_s = Qs + st * Q_STAGE;
    const float* s_s = Ss + st * kBK;
    float* b_dst = Bs + buf * B_STAGE;
#pragma unroll
    for (int e = 0; e < B_PT; ++e) {
      const int q = tid + e * NT;
      if (B_GROUPS % NT == 0 || q < B_GROUPS) {
        const int row = q / (BN / 4), col = (q % (BN / 4)) * 4;
        const float4 c = codes_to_f32(
            *reinterpret_cast<const unsigned*>(q_s + row * BN + col));
        const float sc = s_s[row];
        *reinterpret_cast<float4*>(b_dst + row * BS + col) =
            make_float4(__fmul_rn(c.x, sc), __fmul_rn(c.y, sc),
                        __fmul_rn(c.z, sc), __fmul_rn(c.w, sc));
      }
    }
  };

#pragma unroll
  for (int s = 0; s < R - 1; ++s) {
    if (s < n_iter) issue(c_begin + s, s);
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
    if (i + R - 1 < n_iter) issue(c_begin + i + R - 1, (i + R - 1) % R);
    cp_async_commit();
    const float* b_s = Bs + (I8 ? i % 2 : st) * B_STAGE;
    const float* a_s = As + st * A_STAGE;
#pragma unroll
    for (int k4 = 0; k4 < kBK; k4 += 4) {
      if constexpr (I8) {
        // the next chunk's tile (last read by chunk i - 1; past the last
        // chunk it is never read), in among this chunk's FFMAs, so its
        // loads and conversions overlap them: one barrier a chunk, as f32
        if (k4 == 0) dequant((i + 1) % R, (i + 1) % 2);
      }
      float4 a[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        a[r] = *reinterpret_cast<const float4*>(a_s + (ty + r * RSTEP) * AS +
                                                k4);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b[TN];
#pragma unroll
        for (int gg = 0; gg < TN / 4; ++gg) {
          const float4 v = *reinterpret_cast<const float4*>(
              b_s + (k4 + kk) * BS + gg * NSTEP + tx * 4);
          b[gg * 4 + 0] = v.x;
          b[gg * 4 + 1] = v.y;
          b[gg * 4 + 2] = v.z;
          b[gg * 4 + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float av = kk == 0   ? a[r].x
                           : kk == 1 ? a[r].y
                           : kk == 2 ? a[r].z
                                     : a[r].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[r][j] = fmaf(av, b[j], acc[r][j]);
        }
      }
    }
  }

  // unsplit: row m of y (contiguous (B, OH, OW, N)); split: the partial
  // tile, row-major BM x BN
  float* tile =
      ws ? ws + (static_cast<size_t>(blockIdx.x) * gridDim.y + blockIdx.y) *
                    (BM * BN)
         : nullptr;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int row = ty + r * RSTEP;
    const int m = m0 + row;
    if (m >= M) continue;
    float* dst = tile ? tile + row * BN : y + static_cast<size_t>(m) * N + n0;
#pragma unroll
    for (int gg = 0; gg < TN / 4; ++gg) {
      const int col = gg * NSTEP + tx * 4;
      const int n = n0 + col;
      if (n >= N) continue;
      const float4 val = make_float4(acc[r][gg * 4 + 0], acc[r][gg * 4 + 1],
                                     acc[r][gg * 4 + 2], acc[r][gg * 4 + 3]);
      if (g.bvec) {
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

// The split's second pass: one thread per element of an (M tile, N tile)
// output tile sums the tile's S partials in slice order (slice 0, then +
// slice 1, ...) and stores the sum into y; a block covers kReduceThreads
// elements of one tile.  Unit x = mt*S + s wrote its partial at (x, N
// tile) of the workspace.
__global__ void __launch_bounds__(kReduceThreads)
conv_split_reduce(const float* __restrict__ ws, float* __restrict__ y,
                  int M, int N, int BM, int BN, int S) {
  const int tile_sz = BM * BN;
  const int parts = (tile_sz + kReduceThreads - 1) / kReduceThreads;
  const int mt = blockIdx.x / parts;
  const int e = (blockIdx.x - mt * parts) * kReduceThreads + threadIdx.x;
  if (e >= tile_sz) return;
  const int row = e / BN, col = e - (e / BN) * BN;
  const int m = mt * BM + row, n = blockIdx.y * BN + col;
  if (m >= M || n >= N) return;
  const size_t slice_stride = static_cast<size_t>(gridDim.y) * tile_sz;
  const float* src =
      ws + (static_cast<size_t>(mt) * S * gridDim.y + blockIdx.y) * tile_sz +
      e;
  float sum = src[0];
#pragma unroll 4
  for (int s = 1; s < S; ++s) sum += src[s * slice_stride];
  y[static_cast<size_t>(m) * N + n] = sum;
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

template <int BM, int BN, int TM, int TN, int ST, int MINB, typename WT>
int launch(const float* x, const WT* w, const float* scale, float* y,
           float* ws, const Geometry& g, cudaStream_t stream) {
  static int allowed = 0;
  constexpr bool I8 = std::is_same<WT, int8_t>::value;
  constexpr int smem = smem_bytes<BM, BN, ST, I8>();
  const auto kernel = conv_kernel<BM, BN, TM, TN, ST, MINB, WT>;
  cudaError_t err = allow_smem(kernel, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(g.grid_x, g.grid_n), (BM / TM) * (BN / TN), smem, stream>>>(
      x, w, scale, y, ws, g);
  err = cudaGetLastError();
  if (err != cudaSuccess || ws == nullptr) return static_cast<int>(err);
  const int kc = (g.K + kBK - 1) / kBK;
  const int parts = (BM * BN + kReduceThreads - 1) / kReduceThreads;
  conv_split_reduce<<<dim3(g.m_tiles * parts, g.grid_n), kReduceThreads, 0,
                      stream>>>(ws, y, g.B * g.OH * g.OW, g.N, BM, BN,
                                n_slices(kc, g.chunk_len));
  return static_cast<int>(cudaGetLastError());
}

template <typename WT>
int dispatch(const float* x, const WT* w, const float* scale, float* y,
             float* ws, const Geometry& g, int config, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g.grid_x <= 0 || g.grid_n <= 0 || g.chunk_len <= 0 || g.m_tiles <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the Python wrapper's _CONV_CONFIGS: (BM, BN, MINB); TM x TN a thread,
  // STAGES, MINB blocks an SM asked of ptxas
  switch (config) {
    case 0:
      return launch<128, 128, 8, 8, 4, 1>(x, w, scale, y, ws, g, s);
    case 1:
      return launch<64, 128, 4, 8, 6, 2>(x, w, scale, y, ws, g, s);
    case 2:
      return launch<32, 128, 4, 4, 8, 2>(x, w, scale, y, ws, g, s);
    case 3:
      return launch<16, 128, 4, 4, 8, 2>(x, w, scale, y, ws, g, s);
    case 4:
      return launch<128, 64, 8, 4, 4, 2>(x, w, scale, y, ws, g, s);
    case 5:
      return launch<64, 64, 4, 4, 6, 2>(x, w, scale, y, ws, g, s);
    case 6:
      return launch<32, 64, 4, 4, 8, 2>(x, w, scale, y, ws, g, s);
    case 7:
      return launch<16, 64, 4, 4, 8, 2>(x, w, scale, y, ws, g, s);
    case 8:
      return launch<128, 32, 4, 4, 4, 2>(x, w, scale, y, ws, g, s);
    case 9:
      return launch<64, 32, 4, 4, 6, 2>(x, w, scale, y, ws, g, s);
    case 10:  // thin N (N <= 16)
      return launch<128, 16, 4, 4, 4, 2>(x, w, scale, y, ws, g, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches kernel B on `stream` (and, when `ws` is not null, the split's
// reduction after it) and returns cudaGetLastError() (0 = launched).
// `config` selects the tile (the wrapper's _CONV_CONFIGS); `avec` the
// plane's 16-byte copies (C % 4 == 0, 16-byte aligned plane), `bvec` the
// superpack's 16-byte copies and the float4 stores (N % 4 == 0, aligned
// superpack and output); `chunk_len` the slice length L in K chunks,
// `grid_x` the work units over (M tile, slice), `grid_n` the N tiles and
// `m_tiles` the M tiles, all from the wrapper's conv_schedule; `ws` the
// f32 workspace of grid_x * grid_n partial tiles, or null when K is not
// split.  `w` holds superpack rows [k0, k0 + K) (K = R*S*C: the whole
// superpack; less: a row-parallel block, whose partial sum the caller adds
// to its peers'); `avec` then also needs k0 % 4 == 0 and K % 4 == 0.
extern "C" int untangled_conv2d_f32(const float* x, const float* w, float* y,
                                    float* ws, int B, int Hp, int Wp, int C,
                                    int N, int OH, int OW, int R, int S,
                                    int sh, int sw, int dh, int dw,
                                    int config, int avec, int bvec,
                                    int chunk_len, int grid_x, int grid_n,
                                    int m_tiles, int k0, int K,
                                    void* stream) {
  const Geometry g{B,  Hp, Wp,   C,    N,         OH,     OW,
                   R,  S,  sh,   sw,   dh,        dw,     avec,
                   bvec, chunk_len, grid_x, grid_n, m_tiles, k0, K};
  return dispatch<float>(x, w, nullptr, y, ws, g, config, stream);
}

// Kernel E inside kernel B: as untangled_conv2d_f32 on int8 codes `q` with
// one f32 scale per superpack row of the block (`scale`, K floats);
// `bvec` also needs `q` 4-byte aligned (4-code copies).
extern "C" int untangled_conv2d_i8(const float* x, const int8_t* q,
                                   const float* scale, float* y, float* ws,
                                   int B, int Hp, int Wp, int C, int N,
                                   int OH, int OW, int R, int S, int sh,
                                   int sw, int dh, int dw, int config,
                                   int avec, int bvec, int chunk_len,
                                   int grid_x, int grid_n, int m_tiles,
                                   int k0, int K, void* stream) {
  const Geometry g{B,  Hp, Wp,   C,    N,         OH,     OW,
                   R,  S,  sh,   sw,   dh,        dw,     avec,
                   bvec, chunk_len, grid_x, grid_n, m_tiles, k0, K};
  return dispatch<int8_t>(x, q, scale, y, ws, g, config, stream);
}
