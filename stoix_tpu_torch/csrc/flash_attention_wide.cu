// Flash attention past head dim 256 for Hopper (sm_90a): B2's forward and
// backward and B3 at any head dim, the head dim streamed through shared memory
// in chunks of kChunk columns.
//
//     forward   o = softmax(q * scale . k^T) . v,  lse = m + log(l)
//     backward  dq, dk, dv of the forward, from o, lse and dO (recompute)
//     chunk     pv = sum_k exp(s_qk - m) . v,  m,  l   over one K/V chunk, each
//               key masked by its GLOBAL position (B3, one ring step)
//
// Replaces, past head dim 256, the Pallas TPU kernels
// stoix_tpu/ops/pallas_attention.py::flash_attention (body `_flash_kernel`) and
// ::flash_attention_chunk (body `_flash_chunk_kernel`), which hold one
// (batch, head)'s whole [S, D] K and V in VMEM and so take any head dim VMEM
// holds. The narrow kernels (csrc/flash_forward.cuh, csrc/flash_attention.cu)
// keep three or five 64-row fp32 tiles of the whole head dim in shared memory
// and stop at D = 256. Here no tile spans the head dim:
//
//   * a block holds kRows = 16 query rows of one (batch, head) (the forward,
//     B3, the backward's dQ) or kKeys = 32 keys (the backward's dK, dV) and
//     walks the other side in tiles of kKeys keys or kRows rows;
//   * the scores q.k^T (and in the backward dO.v^T) are summed over the head
//     dim one chunk of kChunk = 64 columns at a time: the chunks of q and K
//     (dO and V) are copied into padded fp32 tiles, each thread adds its 4
//     (row, key) dot products chunk by chunk; the online softmax follows once
//     the whole dot is summed, one warp a row, max and sum by shuffles;
//   * the output accumulator (the forward's acc, B3's pv, the backward's dQ,
//     dK and dV) lives in an fp32 array in device memory that the block owns
//     alone, and is updated one chunk of kChunk columns at a time:
//     acc = acc . alpha + P . V (dV += P^T dO, dK += dS^T q, dQ += dS K). So
//     the head dim has no bound here but the tensors' own memory.
//
// The backward is three kernels in one entry point: delta = rowsum(dO . O), one
// warp a row; dK and dV, a block a key tile walking the query tiles; dQ, a
// block a query tile walking the key tiles. P and dS are recomputed in both
// (from the scores, lse and delta), so no block adds into another's rows:
// deterministic, no atomics.
//
// Bound on an H100: at D = 512, S = 16 the forward does 4.S.D flops a row
// against 4.D.4 bytes of q, k, v and o a row (float32), about 4 flops a byte:
// bytes, as for the narrow kernels. This kernel is simple first: it reads the
// q chunk again for every key tile and moves the accumulator through device
// memory (mostly L2) once a key tile; no tensor cores, exact fp32 FMA, expf.
//
// Types: q, k, v float32, bfloat16 or float16, any head dim; the statistics and
// accumulators are fp32, the outputs rounded once to the input type. q, k, v
// are taken by strides (batch, seq, head; the last dim contiguous); o, dO and
// the outputs are contiguous [B, S, H, D]; lse, m and l contiguous [B, H, S].
// Ragged lengths and the last head-dim chunk are masked, never padded.
//
// Plain C interface, bound from Python with ctypes
// (kernels/flash_attention_wide.py). Each entry point launches on the given
// stream and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kRows = 16;            // query rows a tile holds
constexpr int kKeys = 32;            // keys a tile holds
constexpr int kChunk = 64;           // head-dim columns a chunk holds
constexpr int kPad = kChunk + 1;     // a chunk row in shared memory (odd: no bank conflicts)
constexpr int kThreads = 128;        // 4 warps
constexpr int kScorePad = kKeys + 1;
constexpr unsigned kFull = 0xffffffffu;

struct WideShape {
  long long q_stride[3], k_stride[3], v_stride[3];  // batch, seq, head; in elements
  int batch, q_len, k_len, heads, head_dim;
  float scale;
  int causal;
};

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_float<__half>(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) { return __float2half_rn(x); }

// Copy rows [row0, row0 + ROWS) and columns [c0, c0 + kChunk) of one
// (batch, head)'s [len, D] slice (`base`, rows `row_stride` apart) into an fp32
// tile [ROWS][kPad], times `mul`; past `len` or D the tile holds 0.
// Neighbouring threads take neighbouring columns of a row.
template <typename T, int ROWS>
__device__ __forceinline__ void load_chunk(float* tile, const T* __restrict__ base,
                                           long long row_stride, int row0, int len, int c0,
                                           int head_dim, float mul) {
  for (int i = threadIdx.x; i < ROWS * kChunk; i += kThreads) {
    const int r = i / kChunk, c = i % kChunk;
    const int row = row0 + r, col = c0 + c;
    float x = 0.f;
    if (row < len && col < head_dim) x = to_float(base[row * row_stride + col]) * mul;
    tile[r * kPad + c] = x;
  }
}

// The 4 dot products a thread owns in a [kRows][kKeys] score tile: row
// threadIdx.x / 8, keys 4 * (threadIdx.x % 8) + i, over one chunk.
__device__ __forceinline__ void chunk_dots(const float* a, const float* b, float* s) {
  const int r = threadIdx.x >> 3, j = (threadIdx.x & 7) * 4;
#pragma unroll 8
  for (int d = 0; d < kChunk; ++d) {
    const float x = a[r * kPad + d];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = fmaf(x, b[(j + i) * kPad + d], s[i]);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// ---------------------------------------------------------------- forward and B3

// One block: kRows query rows of one (batch, head), blockIdx.x = b * H + h,
// blockIdx.y the query tile. CHUNK: B3 (positions from q_pos and k_pos,
// outputs pv = work, m with the proxy 0, l); else B2's forward (positions are
// the indices, key tiles past the block's last row skipped when causal;
// outputs o = work / l in T and, if asked, lse).
template <typename T, bool CHUNK>
__global__ void __launch_bounds__(kThreads)
wide_forward_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                    float* work, T* o, float* __restrict__ m_out, float* __restrict__ l_out,
                    float* __restrict__ lse, WideShape s) {
  __shared__ float sq[kRows * kPad];
  __shared__ float skv[kKeys * kPad];
  __shared__ float sp[kRows * kScorePad];
  __shared__ float sm[kRows], sl[kRows], salpha[kRows];
  __shared__ int sprev[kRows], sqp[kRows], skp[kKeys];

  const int bh = blockIdx.x, b = bh / s.heads, h = bh % s.heads;
  const int q0 = blockIdx.y * kRows;
  const int D = s.head_dim, H = s.heads;
  const T* qb = q + b * s.q_stride[0] + h * s.q_stride[2];
  const T* kb = k + b * s.k_stride[0] + h * s.k_stride[2];
  const T* vb = v + b * s.v_stride[0] + h * s.v_stride[2];
  // work, o: contiguous [B, Sq, H, D]; row r of this block at work_row(r).
  const long long row_stride = static_cast<long long>(H) * D;
  const long long base = (static_cast<long long>(b) * s.q_len * H + h) * D;

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  if (t < kRows) {
    sm[t] = -INFINITY;
    sl[t] = 0.f;
    const int row = q0 + t;
    sqp[t] = CHUNK ? (row < s.q_len ? q_pos[row] : INT_MIN) : row;
  }
  int k_end = s.k_len;
  if (!CHUNK && s.causal) k_end = min(s.k_len, q0 + kRows);
  const int n_chunks = (D + kChunk - 1) / kChunk;

  for (int k0 = 0; k0 < k_end; k0 += kKeys) {
    // Scores of the tile, summed over the head dim chunk by chunk.
    float acc_s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c = 0; c < n_chunks; ++c) {
      __syncthreads();
      load_chunk<T, kRows>(sq, qb, s.q_stride[1], q0, s.q_len, c * kChunk, D, s.scale);
      load_chunk<T, kKeys>(skv, kb, s.k_stride[1], k0, s.k_len, c * kChunk, D, 1.f);
      if (c == 0 && t < kKeys) {
        const int key = k0 + t;
        skp[t] = CHUNK ? (key < s.k_len ? k_pos[key] : INT_MAX) : key;
      }
      __syncthreads();
      chunk_dots(sq, skv, acc_s);
    }
    {
      const int r = t >> 3, j = (t & 7) * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool valid = q0 + r < s.q_len && k0 + j + i < s.k_len &&
                           (!s.causal || sqp[r] >= skp[j + i]);
        sp[r * kScorePad + j + i] = valid ? acc_s[i] : -INFINITY;
      }
    }
    __syncthreads();
    // Online softmax, one warp a row, one lane a key: as `_fold_block` folds a block.
    for (int rr = 0; rr < kRows / 4; ++rr) {
      const int r = warp * (kRows / 4) + rr;
      const float x = sp[r * kScorePad + lane];
      const float m_old = sm[r];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float p = x == -INFINITY ? 0.f : expf(x - m_safe);
      const float total = warp_sum(p);
      sp[r * kScorePad + lane] = p;
      if (lane == 0) {
        const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_safe);
        sl[r] = sl[r] * alpha + total;
        salpha[r] = alpha;
        sprev[r] = m_old != -INFINITY;
        sm[r] = m_new;
      }
    }
    // acc = acc . alpha + P . V, one chunk of the head dim at a time.
    for (int c = 0; c < n_chunks; ++c) {
      __syncthreads();
      load_chunk<T, kKeys>(skv, vb, s.v_stride[1], k0, s.k_len, c * kChunk, D, 1.f);
      __syncthreads();
      const int col = t & (kChunk - 1), d = c * kChunk + col;
#pragma unroll
      for (int i = 0; i < kRows / 2; ++i) {
        const int r = (t >> 6) + 2 * i;
        float pv = 0.f;
#pragma unroll 8
        for (int j = 0; j < kKeys; ++j) pv = fmaf(sp[r * kScorePad + j], skv[j * kPad + col], pv);
        if (q0 + r < s.q_len && d < D) {
          float* at = work + base + (q0 + r) * row_stride + d;
          *at = (sprev[r] ? *at * salpha[r] : 0.f) + pv;
        }
      }
    }
  }
  __syncthreads();

  // Epilogue.
  if (CHUNK) {
    if (t < kRows && q0 + t < s.q_len) {
      const long long at = (static_cast<long long>(b) * H + h) * s.q_len + q0 + t;
      m_out[at] = sm[t] == -INFINITY ? 0.f : sm[t];
      l_out[at] = sl[t];
    }
    return;
  }
  if (lse != nullptr && t < kRows && q0 + t < s.q_len) {
    const long long at = (static_cast<long long>(b) * H + h) * s.q_len + q0 + t;
    lse[at] = sl[t] == 0.f ? INFINITY : sm[t] + logf(sl[t]);
  }
  for (int i = t; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    if (q0 + r >= s.q_len) break;
    const long long at = base + (q0 + r) * row_stride + d;
    const float l = sl[r] == 0.f ? 1.f : sl[r];
    o[at] = from_float<T>(work[at] / l);
  }
}

// ---------------------------------------------------------------- backward

// delta[(b, s, h)] = sum_d dO . O over one contiguous [B, S, H, D] row; one
// warp a row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
wide_row_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ delta, long long rows, int head_dim) {
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* a = o + row * head_dim;
  const T* g = dout + row * head_dim;
  float sum = 0.f;
  for (int d = lane; d < head_dim; d += 32) sum = fmaf(to_float(g[d]), to_float(a[d]), sum);
  sum = warp_sum(sum);
  if (lane == 0) delta[row] = sum;
}

// P and dS of a (query tile, key tile) pair into sp and sds [kRows][kScorePad]:
// s = (q . scale) . k^T and dp = dO . v^T summed over the head dim chunk by
// chunk, then P = exp(s - lse) (0 where masked) and dS = P . (dp - delta).
// slse, sdelta: the query tile's rows.
template <typename T>
__device__ __forceinline__ void probabilities_and_ds(
    const T* qb, const T* kb, const T* vb, const T* dob, long long do_row_stride,
    const WideShape& s, int q0, int k0, float* sq, float* sk, float* sdo, float* sv,
    const float* slse, const float* sdelta, float* sp, float* sds) {
  const int t = threadIdx.x;
  const int D = s.head_dim, n_chunks = (D + kChunk - 1) / kChunk;
  float acc_s[4] = {0.f, 0.f, 0.f, 0.f}, acc_p[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();
    load_chunk<T, kRows>(sq, qb, s.q_stride[1], q0, s.q_len, c * kChunk, D, s.scale);
    load_chunk<T, kKeys>(sk, kb, s.k_stride[1], k0, s.k_len, c * kChunk, D, 1.f);
    load_chunk<T, kRows>(sdo, dob, do_row_stride, q0, s.q_len, c * kChunk, D, 1.f);
    load_chunk<T, kKeys>(sv, vb, s.v_stride[1], k0, s.k_len, c * kChunk, D, 1.f);
    __syncthreads();
    chunk_dots(sq, sk, acc_s);
    chunk_dots(sdo, sv, acc_p);
  }
  const int r = t >> 3, j = (t & 7) * 4, row = q0 + r;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + j + i;
    const bool valid = row < s.q_len && key < s.k_len && (!s.causal || key <= row);
    const float p = valid ? expf(acc_s[i] - slse[r]) : 0.f;
    sp[r * kScorePad + j + i] = p;
    sds[r * kScorePad + j + i] = p * (acc_p[i] - sdelta[r]);
  }
  __syncthreads();
}

// Rows of the contiguous [B, S, H, D] arrays that one (batch, head) owns.
struct RowMap {
  long long base, row_stride;
  __device__ RowMap(int b, int h, const WideShape& s)
      : base((static_cast<long long>(b) * s.q_len * s.heads + h) * s.head_dim),
        row_stride(static_cast<long long>(s.heads) * s.head_dim) {}
  __device__ long long at(int row, int d) const { return base + row * row_stride + d; }
};

template <typename T>
__device__ __forceinline__ void load_row_stats(const float* lse, const float* delta,
                                               const WideShape& s, int b, int h, int q0,
                                               float* slse, float* sdelta) {
  const int t = threadIdx.x;
  if (t < kRows) {
    const int row = q0 + t;
    const bool in = row < s.q_len;
    slse[t] = in ? lse[(static_cast<long long>(b) * s.heads + h) * s.q_len + row] : 0.f;
    sdelta[t] = in ? delta[(static_cast<long long>(b) * s.q_len + row) * s.heads + h] : 0.f;
  }
}

// dK and dV: a block a key tile of one (batch, head), walking the query
// tiles that see it; dV += P^T dO and dK += dS^T (q . scale) one chunk of the
// head dim at a time, in dk_work and dv_work (fp32, the block's own rows).
template <typename T>
__global__ void __launch_bounds__(kThreads)
wide_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* dk_work, float* dv_work, T* dk, T* dv,
                 WideShape s) {
  __shared__ float sq[kRows * kPad], sdo[kRows * kPad];
  __shared__ float sk[kKeys * kPad], sv[kKeys * kPad];
  __shared__ float sp[kRows * kScorePad], sds[kRows * kScorePad];
  __shared__ float slse[kRows], sdelta[kRows];

  const int bh = blockIdx.x, b = bh / s.heads, h = bh % s.heads;
  const int k0 = blockIdx.y * kKeys, D = s.head_dim, t = threadIdx.x;
  const T* qb = q + b * s.q_stride[0] + h * s.q_stride[2];
  const T* kb = k + b * s.k_stride[0] + h * s.k_stride[2];
  const T* vb = v + b * s.v_stride[0] + h * s.v_stride[2];
  const RowMap rows(b, h, s);
  const T* dob = dout + rows.base;
  const int n_chunks = (D + kChunk - 1) / kChunk;
  const int first = s.causal ? (k0 / kRows) * kRows : 0;

  for (int q0 = first; q0 < s.q_len; q0 += kRows) {
    __syncthreads();
    load_row_stats<T>(lse, delta, s, b, h, q0, slse, sdelta);
    probabilities_and_ds<T>(qb, kb, vb, dob, rows.row_stride, s, q0, k0, sq, sk, sdo, sv, slse,
                            sdelta, sp, sds);
    for (int c = 0; c < n_chunks; ++c) {
      __syncthreads();
      load_chunk<T, kRows>(sq, qb, s.q_stride[1], q0, s.q_len, c * kChunk, D, s.scale);
      load_chunk<T, kRows>(sdo, dob, rows.row_stride, q0, s.q_len, c * kChunk, D, 1.f);
      __syncthreads();
      const int col = t & (kChunk - 1), d = c * kChunk + col;
#pragma unroll 4
      for (int i = 0; i < kKeys / 2; ++i) {
        const int j = (t >> 6) + 2 * i;
        float gv = 0.f, gk = 0.f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          gv = fmaf(sp[r * kScorePad + j], sdo[r * kPad + col], gv);
          gk = fmaf(sds[r * kScorePad + j], sq[r * kPad + col], gk);
        }
        if (k0 + j < s.k_len && d < D) {
          const long long at = rows.at(k0 + j, d);
          dv_work[at] = (q0 == first ? 0.f : dv_work[at]) + gv;
          dk_work[at] = (q0 == first ? 0.f : dk_work[at]) + gk;
        }
      }
    }
  }
  __syncthreads();
  if (reinterpret_cast<void*>(dk) == reinterpret_cast<void*>(dk_work)) return;
  for (int i = t; i < kKeys * D; i += kThreads) {
    const int j = i / D, d = i % D;
    if (k0 + j >= s.k_len) break;
    const long long at = rows.at(k0 + j, d);
    dk[at] = from_float<T>(dk_work[at]);
    dv[at] = from_float<T>(dv_work[at]);
  }
}

// dQ: a block a query tile of one (batch, head), walking the key tiles it
// sees; dQ += dS K one chunk of the head dim at a time in dq_work, times
// scale once at the end.
template <typename T>
__global__ void __launch_bounds__(kThreads)
wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, float* dq_work, T* dq, WideShape s) {
  __shared__ float sq[kRows * kPad], sdo[kRows * kPad];
  __shared__ float sk[kKeys * kPad], sv[kKeys * kPad];
  __shared__ float sp[kRows * kScorePad], sds[kRows * kScorePad];
  __shared__ float slse[kRows], sdelta[kRows];

  const int bh = blockIdx.x, b = bh / s.heads, h = bh % s.heads;
  const int q0 = blockIdx.y * kRows, D = s.head_dim, t = threadIdx.x;
  const T* qb = q + b * s.q_stride[0] + h * s.q_stride[2];
  const T* kb = k + b * s.k_stride[0] + h * s.k_stride[2];
  const T* vb = v + b * s.v_stride[0] + h * s.v_stride[2];
  const RowMap rows(b, h, s);
  const T* dob = dout + rows.base;
  const int n_chunks = (D + kChunk - 1) / kChunk;
  const int k_end = s.causal ? min(s.k_len, q0 + kRows) : s.k_len;

  load_row_stats<T>(lse, delta, s, b, h, q0, slse, sdelta);
  for (int k0 = 0; k0 < k_end; k0 += kKeys) {
    probabilities_and_ds<T>(qb, kb, vb, dob, rows.row_stride, s, q0, k0, sq, sk, sdo, sv, slse,
                            sdelta, sp, sds);
    for (int c = 0; c < n_chunks; ++c) {
      __syncthreads();
      load_chunk<T, kKeys>(sk, kb, s.k_stride[1], k0, s.k_len, c * kChunk, D, 1.f);
      __syncthreads();
      const int col = t & (kChunk - 1), d = c * kChunk + col;
#pragma unroll
      for (int i = 0; i < kRows / 2; ++i) {
        const int r = (t >> 6) + 2 * i;
        float g = 0.f;
#pragma unroll 8
        for (int j = 0; j < kKeys; ++j) g = fmaf(sds[r * kScorePad + j], sk[j * kPad + col], g);
        if (q0 + r < s.q_len && d < D) {
          const long long at = rows.at(q0 + r, d);
          dq_work[at] = (k0 == 0 ? 0.f : dq_work[at]) + g;
        }
      }
    }
  }
  __syncthreads();
  for (int i = t; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    if (q0 + r >= s.q_len) break;
    const long long at = rows.at(q0 + r, d);
    dq[at] = from_float<T>(dq_work[at] * s.scale);
  }
}

// ---------------------------------------------------------------- launches

bool make_shape(WideShape* s, const long long* strides, int batch, int q_len, int k_len,
                int heads, int head_dim, float scale, int causal) {
  if (batch <= 0 || q_len <= 0 || k_len <= 0 || heads <= 0 || head_dim <= 0) return false;
  if (static_cast<long long>(q_len + kRows - 1) / kRows > 65535) return false;
  if (static_cast<long long>(k_len + kKeys - 1) / kKeys > 65535) return false;
  if (static_cast<long long>(batch) * heads > 0x7fffffffLL) return false;
  for (int i = 0; i < 3; ++i) {
    s->q_stride[i] = strides[i];
    s->k_stride[i] = strides[3 + i];
    s->v_stride[i] = strides[6 + i];
  }
  s->batch = batch;
  s->q_len = q_len;
  s->k_len = k_len;
  s->heads = heads;
  s->head_dim = head_dim;
  s->scale = scale;
  s->causal = causal;
  return true;
}

template <typename T>
void forward_launch(const void* q, const void* k, const void* v, float* work, void* o,
                    float* lse, const WideShape& s, cudaStream_t stream) {
  const dim3 grid(s.batch * s.heads, (s.q_len + kRows - 1) / kRows);
  wide_forward_kernel<T, false><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), nullptr,
      nullptr, work, static_cast<T*>(o), nullptr, nullptr, lse, s);
}

template <typename T>
void chunk_launch(const void* q, const void* k, const void* v, const int* q_pos,
                  const int* k_pos, float* pv, float* m, float* l, const WideShape& s,
                  cudaStream_t stream) {
  const dim3 grid(s.batch * s.heads, (s.q_len + kRows - 1) / kRows);
  wide_forward_kernel<T, true><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), q_pos,
      k_pos, pv, nullptr, m, l, nullptr, s);
}

template <typename T>
void backward_launch(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, float* delta, float* dq_work,
                     float* dk_work, float* dv_work, void* dq, void* dk, void* dv,
                     const WideShape& s, cudaStream_t stream) {
  const long long rows = static_cast<long long>(s.batch) * s.q_len * s.heads;
  const int warps = kThreads / 32;
  wide_row_delta_kernel<T><<<static_cast<unsigned>((rows + warps - 1) / warps), kThreads, 0,
                             stream>>>(static_cast<const T*>(o), static_cast<const T*>(dout),
                                       delta, rows, s.head_dim);
  const dim3 key_grid(s.batch * s.heads, (s.k_len + kKeys - 1) / kKeys);
  wide_dkdv_kernel<T><<<key_grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, dk_work, dv_work, static_cast<T*>(dk),
      static_cast<T*>(dv), s);
  const dim3 query_grid(s.batch * s.heads, (s.q_len + kRows - 1) / kRows);
  wide_dq_kernel<T><<<query_grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, dq_work, static_cast<T*>(dq), s);
}

#define DISPATCH_DTYPE(LAUNCH, DTYPE, ...)                          \
  do {                                                              \
    if ((DTYPE) == 0) {                                             \
      LAUNCH<float>(__VA_ARGS__);                                   \
    } else if ((DTYPE) == 1) {                                      \
      LAUNCH<__nv_bfloat16>(__VA_ARGS__);                           \
    } else if ((DTYPE) == 2) {                                      \
      LAUNCH<__half>(__VA_ARGS__);                                  \
    } else {                                                        \
      return static_cast<int>(cudaErrorInvalidValue);               \
    }                                                               \
  } while (0)

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (q, k, v, o). work: fp32 [B, S, H, D]
// (o itself for float32); lse may be null.
extern "C" int flash_attention_wide_forward(int dtype, const void* q, const void* k,
                                            const void* v, float* work, void* o, float* lse,
                                            const long long* strides, int batch, int seq,
                                            int heads, int head_dim, float scale, int causal,
                                            void* stream) {
  WideShape s;
  if (!make_shape(&s, strides, batch, seq, seq, heads, head_dim, scale, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  DISPATCH_DTYPE(forward_launch, dtype, q, k, v, work, o, lse, s,
                 static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// pv: fp32 [B, Sq, H, D]; m, l: fp32 [B, H, Sq]; positions int32 [Sq], [Sk].
extern "C" int flash_attention_wide_chunk(int dtype, const void* q, const void* k,
                                          const void* v, const void* q_pos, const void* k_pos,
                                          float* pv, float* m, float* l,
                                          const long long* strides, int batch, int q_len,
                                          int k_len, int heads, int head_dim, float scale,
                                          int causal, void* stream) {
  WideShape s;
  if (!make_shape(&s, strides, batch, q_len, k_len, heads, head_dim, scale, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  DISPATCH_DTYPE(chunk_launch, dtype, q, k, v, static_cast<const int*>(q_pos),
                 static_cast<const int*>(k_pos), pv, m, l, s, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// o, dout, dq, dk, dv contiguous [B, S, H, D] in dtype; lse fp32 [B, H, S];
// delta fp32 [B, S, H] (scratch); dq_work, dk_work, dv_work fp32 [B, S, H, D]
// (dq, dk, dv themselves for float32).
extern "C" int flash_attention_wide_backward(int dtype, const void* q, const void* k,
                                             const void* v, const void* o, const void* dout,
                                             const float* lse, float* delta, float* dq_work,
                                             float* dk_work, float* dv_work, void* dq, void* dk,
                                             void* dv, const long long* strides, int batch,
                                             int seq, int heads, int head_dim, float scale,
                                             int causal, void* stream) {
  WideShape s;
  if (!make_shape(&s, strides, batch, seq, seq, heads, head_dim, scale, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  DISPATCH_DTYPE(backward_launch, dtype, q, k, v, o, dout, lse, delta, dq_work, dk_work, dv_work,
                 dq, dk, dv, s, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attention_wide_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
