// Kernel F on Hopper: forward attention with an online softmax over KV chunks.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_kernel
// (entry flash_attention_pallas).  It computes, for q (B, Sq, H, D) and
// k, v (B, Sk, Kh, D) in JAX's layout, read by strides with no transpose:
//
//   o[b, i, h] = sum_j softmax_j(mask(q[b, i, h] . k[b, j, h/g] * scale))
//                * v[b, j, h/g]                       (g = H / Kh, GQA)
//
// with F's masks and constants: query i sits at position q_offset + i, a
// key j is visible when (not causal or j <= pos) and (window == 0 or
// pos - j < window), and a masked score takes the finite value -2^30 (not
// -inf: a chunk wholly masked before a row's first visible key then
// contributes exp(0) = 1 per key, and the first visible chunk multiplies
// that junk by exp(-2^30 - m) = 0 exactly, as in F; with -inf it would be
// exp(-inf + inf) = NaN).  Scores, the running max m, the running sum l,
// the probabilities P and the accumulator are f32, the output is
// acc / max(l, 1e-30) rounded once to q's dtype.  Unlike F, which asserts
// Sq % bq == 0 and Sk % ck == 0, any Sq and Sk are taken: keys past Sk get
// probability 0 outright (they are not masked keys), and query rows past
// Sq are not written.
//
// Two entries, split by dtype (not a fallback: each dtype has one kernel).
//
// bf16: flash_fwd_mma_kernel, on the tensor cores.  One block of 4 warps
// owns one (b, h) and a query tile of BQ = 64 * MT rows (MT = 2 for
// D <= 64, else 1); each warp owns 16 * MT rows.  Q, K and V stay bf16 in
// shared memory, rows padded to D + 8 elements so that the 8 row
// addresses of an ldmatrix fall in distinct banks.  K and V chunks of BK
// keys come through a two-stage cp.async ring, 16 bytes a thread, the next
// chunk's copy issued before the current chunk's products (views that are
// not 16-byte aligned are staged by scalar loads instead).  BK is 64, and
// 32 where the output fragments are large: D = 256 (128 registers a thread
// for them) and D = 192, MLA's q.k dim (96: 184 registers and no spill at
// BK = 32, where BK = 64 spills 20 bytes at 255 registers, takes 125 KB of
// shared memory, one block an SM, and ran 5.83 against 4.83 ms at
// deepseek-v3-671b's MLA layer: tools/sweep_kernel_f.py, H100 80GB HBM3,
// 700 W).  Q.K^T is mma.sync m16n8k16 bf16
// with f32 accumulation (bf16 products are exact in f32), Q's A fragments
// held in registers for the whole key loop (D <= 128; D = 192 and 256
// reload them from shared memory).  The online softmax runs on the accumulator
// fragments in registers: the scale is folded in as scale * log2(e) (one
// FFMA before the exponent where no key of the chunk is masked for the
// warp), the exponentials are the SFU's ex2.approx, the masked value
// stays the finite -2^30 (in these log2 units, so the junk washes out
// exactly as above), row max across the 4 lanes that share a row by
// __shfl_xor_sync, and l sums the f32 P before any rounding (per lane,
// reduced once at the end).
//
// P.V also runs on the tensor cores, and P is the reason for its design.
// F keeps P in f32 for P.V; one bf16 rounding of P (what SDPA does) breaks
// the card's bf16 gate |o - oracle| <= 2e-4 + 2^-7 |oracle| at every
// geometry checked (2.3x to 6.7x the gate; a CPU replay of the smoke's
// geometries on bf16 inputs), while the two-term split P = hi + lo,
// hi = bf16(p), lo = bf16(p - hi), keeps it within 0.45-0.48 of the gate,
// as f32 P does.  So the accumulator fragments of S become bf16 A
// fragments in registers (the m16n8 C layout maps onto the m16n8k16 A
// layout, no trip through shared memory), and each k-step issues two MMAs
// into O's f32 accumulator, P_hi.V and P_lo.V, with V's B fragments from
// ldmatrix.trans.  That is 1.5x the tensor work of the bare algorithm.
//
// Chunks that causality or the window masks wholly for every row of the
// tile are skipped, and within a walked chunk a warp skips the products
// when every one of its rows is masked: their weight is exp(-2^30 - m) = 0
// once a row has seen a visible key, and a skipped chunk before the first
// visible key would only have added the junk that F washes out.  That
// holds only when every row of the tile has at least one visible key; when
// one has none (a window that ends before the cache does), the block walks
// every chunk, as F does, so such a row gets F's uniform average.  Causal
// tiles are uneven, so the longest (the last query tiles) launch first.
//
// f32: flash_fwd_kernel, IEEE f32 FFMA on the CUDA cores (tensor cores on
// f32 inputs would be TF32, about three decimal digits, which breaks the
// f32 check of 2e-4).  One block owns one (b, h) and a 64-row query tile,
// stages K and V as f32 rows padded to D + 1 floats, computes the 64 x 64
// score tile with each thread holding 4 rows x 64/TC columns, and
// accumulates P.V from a P tile in shared memory; TC = 8 threads per row
// group (128 threads) for D <= 64, 16 (256 threads) for D >= 128.
//
// What bounds it.  At llama3.2-1b's prefill (B = 1, S = 4096, H = 32,
// D = 64, causal) one layer needs 4*D*H*S(S+1)/2 = 68.7 GFLOP: 0.069 ms at
// the H100 SXM's dense bf16 tensor-core peak (989 TFLOP/s); its
// 4 x 16.8 MB of q, k, v and o take 0.02 ms at 3.35 TB/s.  So it is bound
// by operations.  mma.sync reaches only part of that peak (wgmma with a
// TMA ring and warp specialisation is the route to the rest), the split P
// adds half again to the tensor work, and the softmax's exponentials, max
// and conversions run on the CUDA cores and SFUs beside it, with 2 blocks
// (8 warps) an SM at D = 64: 255 registers a thread hold the 32 x D output
// and 32 x 64 score fragments and Q's fragments.  The f32 entry is bound by
// its 67 TFLOP/s FFMA peak (1.03 ms) and, before that, by its shared-memory
// loads (4 + 64/TC per 4 * 64/TC FFMAs).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// f32: IEEE FFMA on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;                       // query rows per block
constexpr int BK = 64;                       // keys per staged chunk
constexpr int RPT = 4;                       // query rows per thread
constexpr float NEG_INF = -1073741824.0f;    // -2^30, F's mask value

// Stage rows [row0, row0 + ROWS) of one head (row r at src + r*row_stride,
// D contiguous elements) into dst[ROWS][D + 1]; rows at or past `nrows`
// are zero.  `vec`: 16-byte loads (the caller checked alignment).
template <int D, int ROWS, int NT>
__device__ __forceinline__ void stage_rows(float* __restrict__ dst,
                                           const float* __restrict__ src,
                                           long long row_stride, int row0,
                                           int nrows, int vec) {
  if (vec) {
    constexpr int V = 4;
    constexpr int VPR = D / V;
    for (int i = threadIdx.x; i < ROWS * VPR; i += NT) {
      const int r = i / VPR, c = (i - r * VPR) * V;
      float* out = dst + r * (D + 1) + c;
      if (row0 + r < nrows) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
            src + (long long)(row0 + r) * row_stride + c));
        const float* e = reinterpret_cast<const float*>(&raw);
#pragma unroll
        for (int j = 0; j < V; ++j) out[j] = e[j];
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) out[j] = 0.f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * D; i += NT) {
      const int r = i / D, c = i - r * D;
      dst[r * (D + 1) + c] =
          row0 + r < nrows
              ? src[(long long)(row0 + r) * row_stride + c]
              : 0.f;
    }
  }
}

template <int TC>
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = TC / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <int TC>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = TC / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D, int TC>
__global__ void __launch_bounds__(16 * TC)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int H,
                     int group, int Sq, int Sk, long long qsb, long long qss,
                     long long qsh, long long ksb, long long kss,
                     long long ksh, long long vsb, long long vss,
                     long long vsh, int causal, int window, int q_offset,
                     float scale, int vec) {
  constexpr int NT = 16 * TC;
  constexpr int CPT = BK / TC;  // score columns per thread
  constexpr int DPT = D / TC;   // output columns per thread
  constexpr int LD = D + 1;     // padded row of Q, K, V tiles
  constexpr int LP = BK + 1;    // padded row of the P tile
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][LD]
  float* Ks = Qs + BQ * LD;     // [BK][LD]
  float* Vs = Ks + BK * LD;     // [BK][LD]
  float* Ps = Vs + BK * LD;     // [BQ][LP]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H, kvh = h / group;
  const int q0 = blockIdx.y * BQ;
  const int tx = threadIdx.x % TC, ty = threadIdx.x / TC;
  const float* kb = k + b * ksb + kvh * ksh;
  const float* vb = v + b * vsb + kvh * vsh;

  stage_rows<D, BQ, NT>(Qs, q + b * qsb + h * qsh, qss, q0, Sq, vec);

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  // the chunks any row of this tile can see (all of them when some row
  // sees none: see the header)
  const int last = min(q0 + BQ, Sq) - 1;
  const long long p_lo = (long long)q_offset + q0;
  const long long p_hi = (long long)q_offset + last;
  int c_begin = 0, c_end = (Sk + BK - 1) / BK;
  if (window <= 0 || p_hi < (long long)Sk + window - 1) {
    if (causal) c_end = (int)min((long long)c_end, p_hi / BK + 1);
    if (window > 0 && p_lo - window + 1 > 0)
      c_begin = (int)((p_lo - window + 1) / BK);
  }

  for (int c = c_begin; c < c_end; ++c) {
    const int k0 = c * BK;
    __syncthreads();  // the previous chunk's K, V and P are consumed
    stage_rows<D, BK, NT>(Ks, kb, kss, k0, Sk, vec);
    stage_rows<D, BK, NT>(Vs, vb, vss, k0, Sk, vec);
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(ty * RPT + i) * LD + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[(tx + TC * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const long long pos = p_lo + ty * RPT + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tx + TC * j;
        float x = s[i][j] * scale;
        const bool visible = (!causal || kpos <= pos) &&
                             (window <= 0 || pos - kpos < window);
        x = visible ? x : NEG_INF;
        if (kpos >= Sk) x = -INFINITY;  // past the keys: weight 0
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = row_max<TC>(mx);
      const float r = expf(m[i] - mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - mx);
        Ps[(ty * RPT + i) * LP + tx + TC * j] = p;
        sum += p;
      }
      l[i] = l[i] * r + row_sum<TC>(sum);
      m[i] = mx;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= r;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(ty * RPT + i) * LP + kk];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = Vs[kk * LD + tx + TC * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j)
          acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    if (row >= Sq) continue;
    const float lm = fmaxf(l[i], 1e-30f);
    float* out = o + (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) out[tx + TC * j] = acc[i][j] / lm;
  }
}

template <int D, int TC>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Kh, int Sq, int Sk, const long long* qs,
           const long long* ks, const long long* vs, int causal, int window,
           int q_offset, float scale, int vec, cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(float) * (BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1));
  auto kern = flash_fwd_kernel<D, TC>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  kern<<<grid, 16 * TC, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, H / Kh, Sq, Sk,
      qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], causal,
      window, q_offset, scale, vec);
  return (int)cudaGetLastError();
}

int dispatch_f32(int D, const void* q, const void* k, const void* v,
                 void* o, int B, int H, int Kh, int Sq, int Sk,
                 const long long* qs, const long long* ks,
                 const long long* vs, int causal, int window, int q_offset,
                 float scale, int vec, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<32, 8>(q, k, v, o, B, H, Kh, Sq, Sk, qs, ks, vs, causal,
                           window, q_offset, scale, vec, stream);
    case 64:
      return launch<64, 8>(q, k, v, o, B, H, Kh, Sq, Sk, qs, ks, vs, causal,
                           window, q_offset, scale, vec, stream);
    case 128:
      return launch<128, 16>(q, k, v, o, B, H, Kh, Sq, Sk, qs, ks, vs,
                             causal, window, q_offset, scale, vec, stream);
    case 192:
      return launch<192, 16>(q, k, v, o, B, H, Kh, Sq, Sk, qs, ks, vs,
                             causal, window, q_offset, scale, vec, stream);
    case 256:
      return launch<256, 16>(q, k, v, o, B, H, Kh, Sq, Sk, qs, ks, vs,
                             causal, window, q_offset, scale, vec, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

namespace mma {

typedef __nv_bfloat16 bf16;
constexpr int NW = 4;                        // warps per block
constexpr int NT = 32 * NW;                  // threads per block
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int MT = D <= 64 ? 2 : 1;     // 16-row m-tiles per warp
  static constexpr int BQ = 16 * MT * NW;        // query rows per block
  static constexpr int BK = D <= 128 ? 64 : 32;  // keys per chunk
  static constexpr int LD = D + 8;               // padded smem row (elems)
  static constexpr bool QREG = D * MT <= 128;    // Q fragments in registers
  static constexpr size_t SMEM = sizeof(bf16) * (BQ + 2 * 2 * BK) * LD;
};

// 2^x on the SFU (relative error ~2^-22; results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared; `bytes` = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// p = hi + lo with hi = bf16(p), lo = bf16(p - hi), two columns a register
__device__ __forceinline__ void split_p(float p0, float p1, uint32_t& hi,
                                        uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
}

// Copy rows [row0, row0 + ROWS) of one head (row r at src + r*row_stride,
// D contiguous elements) into dst[ROWS][LD]; rows at or past `nrows` are
// zero.  `vec`: 16-byte cp.async (the caller checked alignment); else
// scalar loads and stores, complete when they return.
template <int D, int ROWS, int LD>
__device__ __forceinline__ void load_rows(bf16* __restrict__ dst,
                                          const bf16* __restrict__ src,
                                          long long row_stride, int row0,
                                          int nrows, int vec) {
  if (vec) {
    constexpr int VPR = D / 8;
    static_assert(ROWS * VPR % NT == 0, "whole vectors per thread");
#pragma unroll
    for (int it = 0; it < ROWS * VPR / NT; ++it) {
      const int i = threadIdx.x + it * NT;
      const int r = i / VPR, c = (i - r * VPR) * 8;
      const bool in = row0 + r < nrows;
      cp_async16(smem_addr(dst + r * LD + c),
                 in ? src + (long long)(row0 + r) * row_stride + c : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * D; i += NT) {
      const int r = i / D, c = i - r * D;
      dst[r * LD + c] = row0 + r < nrows
                            ? src[(long long)(row0 + r) * row_stride + c]
                            : __float2bfloat16_rn(0.f);
    }
  }
}

// One chunk's products and softmax for one warp: S = Q.K^T, the online
// softmax on S's fragments, O += P_hi.V + P_lo.V.  FULL: no key of the
// chunk is masked for any row of the warp, so the mask is not computed and
// the scale goes into the exponent's FFMA (the body is then one basic
// block, which ptxas can schedule across both m-tiles).
template <int D, bool FULL>
__device__ __forceinline__ void chunk(
    float (&acc)[Tile<D>::MT][D / 8][4], float (&m)[Tile<D>::MT][2],
    float (&l)[Tile<D>::MT][2],
    uint32_t (&qa)[Tile<D>::QREG ? D / 16 : 1][Tile<D>::MT][4],
    uint32_t q_base, uint32_t k_base, uint32_t v_base, int k0,
    long long w_lo, int Sk, int causal, int window, float scale_log2) {
  using T = Tile<D>;
  constexpr int MT = T::MT, BK = T::BK, LD = T::LD;
  constexpr int KT = D / 16;   // k-steps of Q.K^T
  constexpr int NS = BK / 8;   // n-tiles of S
  constexpr int NO = D / 8;    // n-tiles of O
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // fragment row / column pair

  // S = Q.K^T (unscaled), f32
  float s[MT][NS][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][j][e] = 0.f;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    uint32_t (&qt)[MT][4] = qa[T::QREG ? kt : 0];
    if constexpr (!T::QREG) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4(qt[i], q_base + (i * 16 * LD + kt * 16) * 2);
    }
#pragma unroll
    for (int np = 0; np < NS / 2; ++np) {
      uint32_t kf[4];
      ldsm_x4(kf, k_base + (np * 16 * LD + kt * 16) * 2);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_bf16(s[i][2 * np], qt[i], kf[0], kf[1]);
        mma_bf16(s[i][2 * np + 1], qt[i], kf[2], kf[3]);
      }
    }
  }

  // the online softmax on the fragments: row g (e = 0, 1) and g + 8
  // (e = 2, 3) of each m-tile, columns k0 + 8j + 2t + {0, 1}
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = m[i][hr];
      if constexpr (FULL) {  // the scale goes into the exponent's FFMA
        float raw = -INFINITY;
#pragma unroll
        for (int j = 0; j < NS; ++j)
          raw = fmaxf(raw, fmaxf(s[i][j][2 * hr], s[i][j][2 * hr + 1]));
        mx = fmaxf(mx, raw * scale_log2);
      } else {
        const long long pos = w_lo + i * 16 + g + hr * 8;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = k0 + 8 * j + 2 * t + e;
            const bool visible = (!causal || kpos <= pos) &&
                                 (window <= 0 || pos - kpos < window);
            float x = visible ? s[i][j][2 * hr + e] * scale_log2
                              : NEG_INF;
            if (kpos >= Sk) x = -INFINITY;  // past the keys: weight 0
            s[i][j][2 * hr + e] = x;
            mx = fmaxf(mx, x);
          }
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float r = ex2(m[i][hr] - mx);
      const float mul = FULL ? scale_log2 : 1.f;  // s scaled or not
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2(fmaf(s[i][j][2 * hr + e], mul, -mx));
          s[i][j][2 * hr + e] = p;
          sum += p;
        }
      }
      l[i][hr] = l[i][hr] * r + sum;
      m[i][hr] = mx;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[i][n][2 * hr] *= r;
        acc[i][n][2 * hr + 1] *= r;
      }
    }
  }

  // O += P_hi.V + P_lo.V, P's A fragments straight from S's
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      split_p(s[i][2 * kk][0], s[i][2 * kk][1], ph[i][0], pl[i][0]);
      split_p(s[i][2 * kk][2], s[i][2 * kk][3], ph[i][1], pl[i][1]);
      split_p(s[i][2 * kk + 1][0], s[i][2 * kk + 1][1], ph[i][2], pl[i][2]);
      split_p(s[i][2 * kk + 1][2], s[i][2 * kk + 1][3], ph[i][3], pl[i][3]);
    }
#pragma unroll
    for (int dp = 0; dp < NO / 2; ++dp) {
      uint32_t vf[4];
      ldsm_x4_trans(vf, v_base + (kk * 16 * LD + dp * 16) * 2);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_bf16(acc[i][2 * dp], ph[i], vf[0], vf[1]);
        mma_bf16(acc[i][2 * dp + 1], ph[i], vf[2], vf[3]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_bf16(acc[i][2 * dp], pl[i], vf[0], vf[1]);
        mma_bf16(acc[i][2 * dp + 1], pl[i], vf[2], vf[3]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
    flash_fwd_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         int H, int group, int Sq, int Sk, long long qsb,
                         long long qss, long long qsh, long long ksb,
                         long long kss, long long ksh, long long vsb,
                         long long vss, long long vsh, int causal,
                         int window, int q_offset, float scale_log2,
                         int vec) {
  using T = Tile<D>;
  constexpr int MT = T::MT, BQ = T::BQ, BK = T::BK, LD = T::LD;
  constexpr int KT = D / 16;   // k-steps of Q.K^T
  constexpr int NO = D / 8;    // n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* ring = Qs + BQ * LD;  // stage s: K [BK][LD], then V [BK][LD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // fragment row / column pair
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H, kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest tiles first
  const bf16* kb = k + b * ksb + kvh * ksh;
  const bf16* vb = v + b * vsb + kvh * vsh;

  // the chunks any row of this tile can see (all of them when some row
  // sees none: see the header)
  const int last = min(q0 + BQ, Sq) - 1;
  const long long p_lo = (long long)q_offset + q0;
  const long long p_hi = (long long)q_offset + last;
  const bool all_see = window <= 0 || p_hi < (long long)Sk + window - 1;
  int c_begin = 0, c_end = (Sk + BK - 1) / BK;
  if (all_see) {
    if (causal) c_end = (int)min((long long)c_end, p_hi / BK + 1);
    if (window > 0 && p_lo - window + 1 > 0)
      c_begin = (int)((p_lo - window + 1) / BK);
  }

  load_rows<D, BQ, LD>(Qs, q + b * qsb + h * qsh, qss, q0, Sq, vec);
  if (c_begin < c_end) {
    load_rows<D, BK, LD>(ring, kb, kss, c_begin * BK, Sk, vec);
    load_rows<D, BK, LD>(ring + BK * LD, vb, vss, c_begin * BK, Sk, vec);
  }
  cp_async_commit();

  // this warp's rows and their positions
  const int w0 = q0 + warp * 16 * MT;
  const bool live = w0 < Sq;
  const long long w_lo = (long long)q_offset + w0;
  const long long w_hi = (long long)q_offset + min(w0 + 16 * MT, Sq) - 1;

  float acc[MT][NO][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      m[i][j] = NEG_INF;
      l[i][j] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  }
  uint32_t qa[T::QREG ? KT : 1][MT][4];  // Q's A fragments

  // ldmatrix row addresses (per lane): an A tile of Q, two n-tiles of K,
  // two k-tiles of V^T
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + (lane >> 4) * 8, k_col = ((lane >> 3) & 1) * 8;
  const int v_row = a_row, v_col = a_col;
  const uint32_t q_base = smem_addr(Qs + (warp * 16 * MT + a_row) * LD + a_col);

  for (int c = c_begin; c < c_end; ++c) {
    const int it = c - c_begin, st = it & 1;
    if (c + 1 < c_end) {
      bf16* nxt = ring + (st ^ 1) * 2 * BK * LD;
      load_rows<D, BK, LD>(nxt, kb, kss, (c + 1) * BK, Sk, vec);
      load_rows<D, BK, LD>(nxt + BK * LD, vb, vss, (c + 1) * BK, Sk, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the chunk just issued has landed
    __syncthreads();

    if constexpr (T::QREG) {
      if (it == 0) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int kt = 0; kt < KT; ++kt)
            ldsm_x4(qa[kt][i], q_base + (i * 16 * LD + kt * 16) * 2);
      }
    }

    const int k0 = c * BK;
    const bool skip = !live || (all_see && ((causal && k0 > w_hi) ||
                                            (window > 0 &&
                                             w_lo - (k0 + BK - 1) >= window)));
    if (!skip) {
      const bf16* Ks = ring + st * 2 * BK * LD;
      const uint32_t k_base = smem_addr(Ks + k_row * LD + k_col);
      const uint32_t v_base = smem_addr(Ks + BK * LD + v_row * LD + v_col);

      const bool full = (!causal || k0 + BK - 1 <= w_lo) &&
                        (window <= 0 || w_hi - k0 < window) && k0 + BK <= Sk;
      if (full)
        chunk<D, true>(acc, m, l, qa, q_base, k_base, v_base, k0, w_lo, Sk,
                       causal, window, scale_log2);
      else
        chunk<D, false>(acc, m, l, qa, q_base, k_base, v_base, k0, w_lo, Sk,
                        causal, window, scale_log2);
    }
    __syncthreads();  // this stage is read; the next copy may overwrite it
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float lr = l[i][hr];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const float lm = fmaxf(lr, 1e-30f);
      const int row = w0 + i * 16 + g + hr * 8;
      if (row >= Sq) continue;
      bf16* out = o + (((long long)b * Sq + row) * H + h) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) =
            __floats2bfloat162_rn(acc[i][n][2 * hr] / lm,
                                  acc[i][n][2 * hr + 1] / lm);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Kh, int Sq, int Sk, const long long* qs,
           const long long* ks, const long long* vs, int causal, int window,
           int q_offset, float scale, int vec, cudaStream_t stream) {
  using T = Tile<D>;
  auto kern = flash_fwd_mma_kernel<D>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid(B * H, (Sq + T::BQ - 1) / T::BQ);
  kern<<<grid, NT, T::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), H, H / Kh, Sq, Sk,
      qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], causal,
      window, q_offset, scale * LOG2E, vec);
  return (int)cudaGetLastError();
}

int dispatch(int D, const void* q, const void* k, const void* v, void* o,
             int B, int H, int Kh, int Sq, int Sk, const long long* qs,
             const long long* ks, const long long* vs, int causal,
             int window, int q_offset, float scale, int vec,
             cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<32>(q, k, v, o, B, H, Kh, Sq, Sk, qs, ks, vs, causal,
                        window, q_offset, scale, vec, stream);
    case 64:
      return launch<64>(q, k, v, o, B, H, Kh, Sq, Sk, qs, ks, vs, causal,
                        window, q_offset, scale, vec, stream);
    case 128:
      return launch<128>(q, k, v, o, B, H, Kh, Sq, Sk, qs, ks, vs, causal,
                         window, q_offset, scale, vec, stream);
    case 192:
      return launch<192>(q, k, v, o, B, H, Kh, Sq, Sk, qs, ks, vs, causal,
                         window, q_offset, scale, vec, stream);
    case 256:
      return launch<256>(q, k, v, o, B, H, Kh, Sq, Sk, qs, ks, vs, causal,
                         window, q_offset, scale, vec, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace mma

}  // namespace

// q (B, Sq, H, D), k and v (B, Sk, Kh, D), each with its last dim
// contiguous and strides (batch, seq, head) in elements; o (B, Sq, H, D)
// contiguous.  bf16 = 0: float32 tensors, 1: bfloat16.  `vec` asks for
// 16-byte loads: every base pointer 16-byte aligned and every stride a
// multiple of 16 bytes.  Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int bf16, int B,
                                   int H, int Kh, int Sq, int Sk, int D,
                                   long long qsb, long long qss,
                                   long long qsh, long long ksb,
                                   long long kss, long long ksh,
                                   long long vsb, long long vss,
                                   long long vsh, int causal, int window,
                                   int q_offset, float scale, int vec,
                                   void* stream) {
  const long long qs[3] = {qsb, qss, qsh};
  const long long ks[3] = {ksb, kss, ksh};
  const long long vs[3] = {vsb, vss, vsh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return mma::dispatch(D, q, k, v, o, B, H, Kh, Sq, Sk, qs, ks, vs, causal,
                         window, q_offset, scale, vec, st);
  return dispatch_f32(D, q, k, v, o, B, H, Kh, Sq, Sk, qs, ks, vs, causal,
                      window, q_offset, scale, vec, st);
}
