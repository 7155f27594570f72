// Flash attention over one K/V chunk for Hopper (sm_90a): the unnormalised
// online-softmax accumulator of a query block against a chunk of keys, with its
// row statistics, causal masking by GLOBAL positions. One ring-attention step.
//
//     s_qk = q * scale . k,   scale = D^-1/2,   over the chunk's keys k with
//     k_pos <= q_pos (causal) or all of them;
//     m = max_k s_qk,   l = sum_k exp(s_qk - m),   pv = sum_k exp(s_qk - m) . v
//
// Replaces the Pallas TPU kernel stoix_tpu/ops/pallas_attention.py::flash_attention_chunk
// (body `_flash_chunk_kernel`), which ring attention calls once per ring step
// with the K/V block that step holds. That kernel holds one (batch, head)'s K/V
// chunk whole in VMEM and walks it block by block, bounding a causal walk by
// assuming the positions are contiguous and ascending. Here (B2's forward,
// csrc/flash_attention.cu, with position inputs and stats outputs):
//
//   * one thread owns one query row and keeps its fp32 q, m, l and acc in
//     registers; a block holds `pairs` (batch, head) pairs times `rows` rows,
//     so a short chunk still fills 128-thread blocks;
//   * the chunk's keys are staged 16 at a time in shared memory (widened to
//     fp32), with their positions;
//   * every key is masked by its own position (`q_pos >= k_pos`), which holds
//     for any positions. A block whose chunk lies wholly in its queries'
//     future (the chunk's smallest key position beyond the block's largest
//     query position) exits at once, writing its empty rows' proxy stats and
//     zeros without reading q, K or V; in a causal ring that is almost half of
//     all (rank, step) pairs. Otherwise a key tile wholly beyond the block's
//     last query is skipped before its K/V are read;
//   * Sq and Sk may differ; ragged lengths are masked, never padded.
//
// Bound: at the ring's chunk shapes, operations. A fully visible [64, 128, 4, 32]
// float32 chunk is 4.D.Sq.Sk flops per (batch, head), 0.54 GFLOP, about 8 us at
// the card's 67 TFLOP/s of fp32, against 16.8 MB of q, k, v and pv, about 5 us
// at 3.35 TB/s. No tensor cores: a simple, exact-fp32 first version.
//
// Arithmetic follows `_fold_block`: q scaled in fp32 before the dot; per key
// tile the running max, `m_safe` (0 while a row has seen only masked keys),
// `alpha = exp(m_acc - m_safe)`, `l = l.alpha + sum p`, `acc = acc.alpha + p.v`.
// The outputs are the raw accumulator (pv, fp32), `m` with the finite proxy 0
// for a row that saw no unmasked key (its l and pv are 0), and `l`: ring
// attention folds them, and its fold relies on that proxy. expf, not __expf.
//
// Layout: q, k and v are taken by strides (batch, seq, head; the last dim
// contiguous), so the views of a fused [B, S, 3, H, D] projection go in as they
// are. Positions are contiguous int32 [Sq] and [Sk]; pv is contiguous
// [B, Sq, H, D], m and l contiguous [B, H, Sq].
//
// Plain C interface, bound from Python with ctypes. The entry point launches
// on the given stream and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kTile = 16;          // keys staged per step
constexpr int kMaxThreads = 128;   // threads per block
constexpr int kMaxPairs = 32;      // (batch, head) pairs per block
constexpr int kSmemFloats = 4096;  // one staged operand: pairs * kTile * D <= 4096

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Shape {
  int batch, q_len, k_len, heads;
  int rows;   // query rows of one pair per block (a power of two, at most kMaxThreads)
  int pairs;  // pairs per block
  float scale;
  int causal;
  // q, k, v strides in elements: batch, seq, head (the head-dim stride is 1)
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;
};

__device__ __forceinline__ long long qkv_offset(long long sb, long long ss, long long sh,
                                                int pair, int row, int heads) {
  return (pair / heads) * sb + row * ss + (pair % heads) * sh;
}

// Stage keys [k0, k0 + kTile) of the block's pairs from a strided [B, Sk, H, D]
// tensor into shared memory as fp32 (zeros past Sk or past the last pair).
template <typename T, int D>
__device__ __forceinline__ void stage_keys(float* dst, const T* src, long long sb, long long ss,
                                           long long sh, int first_pair, int k0,
                                           const Shape& s) {
  const int total = s.pairs * kTile * D;
  const int num_pairs = s.batch * s.heads;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int d = idx % D;
    const int r = (idx / D) % kTile;
    const int pair = first_pair + idx / (D * kTile);
    const int key = k0 + r;
    float x = 0.f;
    if (pair < num_pairs && key < s.k_len) {
      x = widen(src[qkv_offset(sb, ss, sh, pair, key, s.heads) + d]);
    }
    dst[idx] = x;
  }
}

template <int D>
__device__ __forceinline__ float dot_row(const float (&a)[D], const float* smem_row) {
  const float4* b = reinterpret_cast<const float4*>(smem_row);
  float sum = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const float4 x = b[d4];
    sum = fmaf(a[4 * d4 + 0], x.x, sum);
    sum = fmaf(a[4 * d4 + 1], x.y, sum);
    sum = fmaf(a[4 * d4 + 2], x.z, sum);
    sum = fmaf(a[4 * d4 + 3], x.w, sum);
  }
  return sum;
}

template <int D>
__device__ __forceinline__ void axpy_row(float (&acc)[D], float p, const float* smem_row) {
  const float4* b = reinterpret_cast<const float4*>(smem_row);
#pragma unroll
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const float4 x = b[d4];
    acc[4 * d4 + 0] = fmaf(p, x.x, acc[4 * d4 + 0]);
    acc[4 * d4 + 1] = fmaf(p, x.y, acc[4 * d4 + 1]);
    acc[4 * d4 + 2] = fmaf(p, x.z, acc[4 * d4 + 2]);
    acc[4 * d4 + 3] = fmaf(p, x.w, acc[4 * d4 + 3]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kMaxThreads)
flash_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                   float* __restrict__ pv, float* __restrict__ m_out, float* __restrict__ l_out,
                   Shape s) {
  __shared__ __align__(16) float k_s[kSmemFloats];
  __shared__ __align__(16) float v_s[kSmemFloats];
  __shared__ int kpos_s[kTile];
  __shared__ int q_max_s, k_min_s;
  const int local_pair = threadIdx.x / s.rows;
  const int first_pair = blockIdx.x * s.pairs;
  const int pair = first_pair + local_pair;
  const int row = blockIdx.y * s.rows + threadIdx.x % s.rows;
  const bool active = local_pair < s.pairs && pair < s.batch * s.heads && row < s.q_len;
  const int b = pair / s.heads, h = pair % s.heads;
  float* out = pv + ((static_cast<long long>(b) * s.q_len + row) * s.heads + h) * D;
  const long long stat = static_cast<long long>(pair) * s.q_len + row;

  // Causal: the block's largest query position and the chunk's smallest key
  // position. A chunk wholly beyond the block's queries leaves every row
  // empty: write the empty rows without reading q, K or V.
  const int row_pos = active ? q_pos[row] : INT_MIN;
  if (threadIdx.x == 0) {
    q_max_s = INT_MIN;
    k_min_s = INT_MAX;
  }
  __syncthreads();
  if (s.causal) {
    if (active) atomicMax(&q_max_s, row_pos);
    int k_min = INT_MAX;
    for (int j = threadIdx.x; j < s.k_len; j += blockDim.x) k_min = min(k_min, k_pos[j]);
    atomicMin(&k_min_s, k_min);
  }
  __syncthreads();
  const int q_max = q_max_s;
  if (s.causal && k_min_s > q_max) {  // the same for every thread of the block
    if (active) {
#pragma unroll
      for (int d = 0; d < D; ++d) out[d] = 0.f;
      m_out[stat] = 0.f;  // the finite proxy of an empty row
      l_out[stat] = 0.f;
    }
    return;
  }

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = 0.f;
    acc[d] = 0.f;
  }
  if (active) {
    const T* qp = q + qkv_offset(s.qb, s.qs, s.qh, pair, row, s.heads);
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = widen(qp[d]) * s.scale;
  }

  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < s.k_len; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    if (s.causal) {
      for (int j = threadIdx.x; j < kTile; j += blockDim.x) {
        kpos_s[j] = k0 + j < s.k_len ? k_pos[k0 + j] : INT_MAX;
      }
      __syncthreads();
      int tile_min = INT_MAX;
#pragma unroll
      for (int j = 0; j < kTile; ++j) tile_min = min(tile_min, kpos_s[j]);
      if (tile_min > q_max) continue;  // the same for every thread of the block
    }
    stage_keys<T, D>(k_s, k, s.kb, s.ks, s.kh, first_pair, k0, s);
    stage_keys<T, D>(v_s, v, s.vb, s.vs, s.vh, first_pair, k0, s);
    __syncthreads();
    if (!active) continue;
    const float* ks = k_s + local_pair * kTile * D;
    const float* vs = v_s + local_pair * kTile * D;
    float p[kTile];
    float m_blk = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const int key = k0 + j;
      const bool valid = key < s.k_len && (!s.causal || kpos_s[j] <= row_pos);
      p[j] = valid ? dot_row<D>(qr, ks + j * D) : -INFINITY;
      m_blk = fmaxf(m_blk, p[j]);
    }
    const float m_new = fmaxf(m, m_blk);
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      p[j] = p[j] == -INFINITY ? 0.f : expf(p[j] - m_safe);
      p_sum += p[j];
    }
    const float alpha = m == -INFINITY ? 0.f : expf(m - m_safe);
    l = l * alpha + p_sum;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kTile; ++j) axpy_row<D>(acc, p[j], vs + j * D);
    m = m_new;
  }
  if (!active) return;
#pragma unroll
  for (int d = 0; d < D; ++d) out[d] = acc[d];
  m_out[stat] = m == -INFINITY ? 0.f : m;  // the finite proxy of an empty row
  l_out[stat] = l;
}

// ---------------------------------------------------------------- host side

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Fill the tiling; false when the shape is not one the kernel takes.
bool make_shape(Shape* s, const long long* strides, int batch, int q_len, int k_len, int heads,
                int head_dim, float scale, int causal) {
  if (batch <= 0 || q_len <= 0 || k_len <= 0 || heads <= 0) return false;
  if (head_dim != 16 && head_dim != 32 && head_dim != 64) return false;
  s->batch = batch;
  s->q_len = q_len;
  s->k_len = k_len;
  s->heads = heads;
  s->rows = next_pow2(q_len < kMaxThreads ? q_len : kMaxThreads);
  int pairs = kMaxThreads / s->rows;
  const int by_smem = kSmemFloats / (kTile * head_dim);
  if (pairs > by_smem) pairs = by_smem;
  if (pairs > kMaxPairs) pairs = kMaxPairs;
  s->pairs = pairs < 1 ? 1 : pairs;
  s->scale = scale;
  s->causal = causal;
  s->qb = strides[0]; s->qs = strides[1]; s->qh = strides[2];
  s->kb = strides[3]; s->ks = strides[4]; s->kh = strides[5];
  s->vb = strides[6]; s->vs = strides[7]; s->vh = strides[8];
  return true;
}

template <typename T, int D>
void chunk_launch(const void* q, const void* k, const void* v, const void* q_pos,
                  const void* k_pos, void* pv, void* m, void* l, const Shape& s,
                  cudaStream_t stream) {
  const int num_pairs = s.batch * s.heads;
  const dim3 grid((num_pairs + s.pairs - 1) / s.pairs, (s.q_len + s.rows - 1) / s.rows);
  flash_chunk_kernel<T, D><<<grid, s.rows * s.pairs, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(q_pos), static_cast<const int*>(k_pos), static_cast<float*>(pv),
      static_cast<float*>(m), static_cast<float*>(l), s);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v); pv, m, l are float32 either way.
extern "C" int flash_attention_chunk(int dtype, const void* q, const void* k, const void* v,
                                     const void* q_pos, const void* k_pos, void* pv, void* m,
                                     void* l, const long long* strides, int batch, int q_len,
                                     int k_len, int heads, int head_dim, float scale, int causal,
                                     void* stream) {
  Shape s;
  if (!make_shape(&s, strides, batch, q_len, k_len, heads, head_dim, scale, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (head_dim) {
      case 16: chunk_launch<float, 16>(q, k, v, q_pos, k_pos, pv, m, l, s, st); break;
      case 32: chunk_launch<float, 32>(q, k, v, q_pos, k_pos, pv, m, l, s, st); break;
      default: chunk_launch<float, 64>(q, k, v, q_pos, k_pos, pv, m, l, s, st); break;
    }
  } else if (dtype == 1) {
    switch (head_dim) {
      case 16: chunk_launch<__nv_bfloat16, 16>(q, k, v, q_pos, k_pos, pv, m, l, s, st); break;
      case 32: chunk_launch<__nv_bfloat16, 32>(q, k, v, q_pos, k_pos, pv, m, l, s, st); break;
      default: chunk_launch<__nv_bfloat16, 64>(q, k, v, q_pos, k_pos, pv, m, l, s, st); break;
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attention_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
