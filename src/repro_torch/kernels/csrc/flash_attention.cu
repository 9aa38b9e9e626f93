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
// the probabilities P and the accumulator are all f32 on f32 (or upcast
// bf16) values, the output is acc / max(l, 1e-30) rounded once to q's
// dtype.  Unlike F, which asserts Sq % bq == 0 and Sk % ck == 0, any Sq
// and Sk are taken: keys past Sk get probability 0 outright (they are not
// masked keys), and query rows past Sq are not written.
//
// Mapping to the card.  F walks a sequential grid over (b*h, q block) with
// the whole K/V panel of one head in VMEM.  Here one thread block owns one
// (b, h) and a 64-row query tile; blocks run in no order on the 132 SMs and
// share nothing.  The block stages its Q tile once, then loops over
// 64-key chunks: it stages the chunk's K and V rows (as f32, padded to
// D + 1 floats a row so the column walks below hit distinct banks),
// computes the 64 x 64 score tile with each thread holding 4 rows x 64/TC
// columns in registers (IEEE f32 FFMA), reduces each row's max and sum
// across the TC lanes that share it with warp shuffles, writes P to shared
// memory, and accumulates P.V into a 4 rows x D/TC register tile.  TC = 8
// threads per row group (128 threads) for D <= 64, 16 (256 threads) for
// D >= 128.  The head dims 32, 64, 128 and 256 are instantiated.
//
// Chunks that causality or the window masks wholly for every row of the
// tile are skipped: their weight is exp(-2^30 - m) = 0 once a row has
// seen a visible key, and a skipped chunk before the first visible key
// would only have added the junk that F washes out.  That holds only when
// every row of the tile has at least one visible key; when one has none
// (a window that ends before the cache does), the block walks every chunk,
// as F does, so such a row gets F's uniform average.
//
// What bounds it.  At llama3.2-1b's prefill (B = 1, S = 4096, H = 32,
// D = 64, causal) one layer needs 4*D*H*S(S+1)/2 = 68.7 GFLOP: 0.069 ms at
// the H100 SXM's dense bf16 tensor-core peak (989 TFLOP/s), 1.03 ms at its
// 67 TFLOP/s f32 FFMA peak; its 4 x 16.8 MB (bf16) of q, k, v and o take
// 0.02 ms at 3.35 TB/s.  So it is bound by operations, and this first
// design runs on the CUDA cores (f32 FFMA), well above the tensor-core
// bound: each inner step issues 4 + 64/TC shared-memory loads for
// 4 * 64/TC FFMAs, so shared-memory bandwidth caps it near two thirds of
// the FFMA peak before the exps and the staging.  mma.sync or wgmma for
// Q.K^T (bf16 products are exact in f32) and a TMA ring for K/V are the
// later steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                       // query rows per block
constexpr int BK = 64;                       // keys per staged chunk
constexpr int RPT = 4;                       // query rows per thread
constexpr float NEG_INF = -1073741824.0f;    // -2^30, F's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Stage rows [row0, row0 + ROWS) of one head (row r at src + r*row_stride,
// D contiguous elements) into dst[ROWS][D + 1] as f32; rows at or past
// `nrows` are zero.  `vec`: 16-byte loads (the caller checked alignment).
template <typename T, int D, int ROWS, int NT>
__device__ __forceinline__ void stage_rows(float* __restrict__ dst,
                                           const T* __restrict__ src,
                                           long long row_stride, int row0,
                                           int nrows, int vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    constexpr int VPR = D / V;
    for (int i = threadIdx.x; i < ROWS * VPR; i += NT) {
      const int r = i / VPR, c = (i - r * VPR) * V;
      float* out = dst + r * (D + 1) + c;
      if (row0 + r < nrows) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
            src + (long long)(row0 + r) * row_stride + c));
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < V; ++j) out[j] = to_f32(e[j]);
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
              ? to_f32(src[(long long)(row0 + r) * row_stride + c])
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

template <typename T, int D, int TC>
__global__ void __launch_bounds__(16 * TC)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int H,
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
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  stage_rows<T, D, BQ, NT>(Qs, q + b * qsb + h * qsh, qss, q0, Sq, vec);

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
    stage_rows<T, D, BK, NT>(Ks, kb, kss, k0, Sk, vec);
    stage_rows<T, D, BK, NT>(Vs, vb, vss, k0, Sk, vec);
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
    T* out = o + (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) store_as(out + tx + TC * j, acc[i][j] / lm);
  }
}

template <typename T, int D, int TC>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Kh, int Sq, int Sk, const long long* qs,
           const long long* ks, const long long* vs, int causal, int window,
           int q_offset, float scale, int vec, cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(float) * (BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1));
  auto kern = flash_fwd_kernel<T, D, TC>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  kern<<<grid, 16 * TC, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, H / Kh, Sq, Sk, qs[0],
      qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], causal, window,
      q_offset, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* o,
             int B, int H, int Kh, int Sq, int Sk, const long long* qs,
             const long long* ks, const long long* vs, int causal,
             int window, int q_offset, float scale, int vec,
             cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32, 8>(q, k, v, o, B, H, Kh, Sq, Sk, qs, ks, vs,
                              causal, window, q_offset, scale, vec, stream);
    case 64:
      return launch<T, 64, 8>(q, k, v, o, B, H, Kh, Sq, Sk, qs, ks, vs,
                              causal, window, q_offset, scale, vec, stream);
    case 128:
      return launch<T, 128, 16>(q, k, v, o, B, H, Kh, Sq, Sk, qs, ks, vs,
                                causal, window, q_offset, scale, vec, stream);
    case 256:
      return launch<T, 256, 16>(q, k, v, o, B, H, Kh, Sq, Sk, qs, ks, vs,
                                causal, window, q_offset, scale, vec, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

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
    return dispatch<__nv_bfloat16>(D, q, k, v, o, B, H, Kh, Sq, Sk, qs, ks,
                                   vs, causal, window, q_offset, scale, vec,
                                   st);
  return dispatch<float>(D, q, k, v, o, B, H, Kh, Sq, Sk, qs, ks, vs, causal,
                         window, q_offset, scale, vec, st);
}
