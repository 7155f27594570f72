// Flash attention for Hopper (sm_90a): a forward kernel and a two-kernel
// backward, over [B, S, H, D] self-attention (queries and keys share S).
//
//     o = softmax(q * scale . k^T) . v,     scale = D^-1/2,     optional causal mask
//
// Replaces the Pallas TPU kernel stoix_tpu/ops/pallas_attention.py::flash_attention
// (body `_flash_kernel`, fold `_fold_block`). That kernel holds one (batch, head)'s
// K/V whole in VMEM, pads S to its 128-row blocks and walks K/V blocks in a
// sequential grid. Here:
//
//   * one thread owns one query row (forward, dQ) or one key row (dK/dV) and
//     keeps that row's fp32 state in registers; a block holds `pairs`
//     (batch, head) pairs times `rows` rows, so short sequences (S = 16 on the
//     ff_trans_ppo path) still fill 128-thread blocks, and a long S takes one
//     block per 128 rows;
//   * the other side's rows are staged 16 at a time in shared memory (widened
//     to fp32) and read back by every thread of the pair as broadcasts;
//   * ragged S is masked, never padded; a causal block stops at the last key
//     tile that holds a key at or before its last query (`_flash_kernel`'s
//     bound), and dK/dV starts at the first query tile that can see its keys.
//
// Bound: bytes. At S = 16, D = 32 a pair's q, k, v, o are 8 KiB and its work
// is at most 4.S^2.D = 32 K flops, about 4 flops per byte, far below the
// card's float32 balance point (67 TFLOP/s over 3.35 TB/s = 20 flops/byte).
// Each input row is read once per block that needs it and each output row is
// written once. No tensor cores: a simple, exact-fp32 first version.
//
// Arithmetic follows `_fold_block`: q scaled in fp32 before the dot; per key
// tile the running max, `m_safe` (0 while a row has seen only masked keys),
// `alpha = exp(m_acc - m_safe)`, `l = l.alpha + sum p`, `acc = acc.alpha + p.v`;
// `l_safe = 1` where l == 0, and one rounding to the output type. expf, not
// __expf. When a gradient is needed the forward also writes
// lse = m + log(l) ([B, H, S] fp32; +inf where l == 0, so P = 0 there).
//
// Backward (recompute from lse, deterministic, no atomics):
//   dQ kernel:    delta_i = sum_d dO.O (written out), then over key tiles
//                 P = exp(q.scale.k - lse), dP = dO.v, dS = P.(dP - delta),
//                 dQ = scale . sum_j dS.k
//   dK/dV kernel: over query tiles, dV = sum_i P.dO, dK = sum_i dS.(q.scale)
// dQ runs first: dK/dV reads its delta.
//
// Layout: q, k and v are taken by strides (batch, seq, head; the last dim
// contiguous), so the three views of a fused [B, S, 3, H, D] projection go in
// as they are. o, dO, dQ, dK, dV are contiguous [B, S, H, D]; lse and delta
// contiguous [B, H, S].
//
// Plain C interface, bound from Python with ctypes. Each entry point launches
// on the given stream and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 16;         // rows of the other side staged per step
constexpr int kMaxThreads = 128;  // threads per block
constexpr int kMaxPairs = 32;     // (batch, head) pairs per block
constexpr int kSmemFloats = 4096; // one staged operand: pairs * kTile * D <= 4096

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Shape {
  int batch, seq, heads;
  int rows;   // rows of one pair per block (a power of two, at most kMaxThreads)
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

__device__ __forceinline__ long long row_offset(int pair, int row, const Shape& s, int dim) {
  // contiguous [B, S, H, D]
  return ((static_cast<long long>(pair / s.heads) * s.seq + row) * s.heads + pair % s.heads) * dim;
}

__device__ __forceinline__ long long stat_offset(int pair, int row, const Shape& s) {
  // contiguous [B, H, S]
  return static_cast<long long>(pair) * s.seq + row;
}

// Stage rows [r0, r0 + kTile) of the block's pairs from a strided [B, S, H, D]
// tensor into shared memory as fp32 (zeros past S or past the last pair),
// multiplied by `mul`.
template <typename T, int D>
__device__ __forceinline__ void stage_strided(float* dst, const T* src, long long sb, long long ss,
                                              long long sh, int first_pair, int r0,
                                              const Shape& s, float mul) {
  const int total = s.pairs * kTile * D;
  const int num_pairs = s.batch * s.heads;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int d = idx % D;
    const int r = (idx / D) % kTile;
    const int pair = first_pair + idx / (D * kTile);
    const int row = r0 + r;
    float x = 0.f;
    if (pair < num_pairs && row < s.seq) {
      x = widen(src[qkv_offset(sb, ss, sh, pair, row, s.heads) + d]) * mul;
    }
    dst[idx] = x;
  }
}

template <typename T, int D>
__device__ __forceinline__ void stage_contiguous(float* dst, const T* src, int first_pair, int r0,
                                                 const Shape& s) {
  const int total = s.pairs * kTile * D;
  const int num_pairs = s.batch * s.heads;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int d = idx % D;
    const int r = (idx / D) % kTile;
    const int pair = first_pair + idx / (D * kTile);
    const int row = r0 + r;
    float x = 0.f;
    if (pair < num_pairs && row < s.seq) x = widen(src[row_offset(pair, row, s, D) + d]);
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

// ---------------------------------------------------------------- forward

template <typename T, int D>
__global__ void __launch_bounds__(kMaxThreads)
flash_forward_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse, Shape s) {
  __shared__ __align__(16) float k_s[kSmemFloats];
  __shared__ __align__(16) float v_s[kSmemFloats];
  const int local_pair = threadIdx.x / s.rows;
  const int first_pair = blockIdx.x * s.pairs;
  const int pair = first_pair + local_pair;
  const int row = blockIdx.y * s.rows + threadIdx.x % s.rows;
  const bool active = local_pair < s.pairs && pair < s.batch * s.heads && row < s.seq;

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

  const int block_end = min(s.seq, (blockIdx.y + 1) * s.rows);
  const int key_end = s.causal ? block_end : s.seq;
  for (int k0 = 0; k0 < key_end; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    stage_strided<T, D>(k_s, k, s.kb, s.ks, s.kh, first_pair, k0, s, 1.f);
    stage_strided<T, D>(v_s, v, s.vb, s.vs, s.vh, first_pair, k0, s, 1.f);
    __syncthreads();
    if (!active) continue;
    const float* ks = k_s + local_pair * kTile * D;
    const float* vs = v_s + local_pair * kTile * D;
    float p[kTile];
    float m_blk = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const int key = k0 + j;
      const bool valid = key < s.seq && (!s.causal || key <= row);
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
  const float l_safe = l == 0.f ? 1.f : l;
  T* op = o + row_offset(pair, row, s, D);
#pragma unroll
  for (int d = 0; d < D; ++d) op[d] = narrow<T>(acc[d] / l_safe);
  if (lse != nullptr) lse[stat_offset(pair, row, s)] = l == 0.f ? INFINITY : m + logf(l);
}

// ---------------------------------------------------------------- backward: dQ and delta

template <typename T, int D>
__global__ void __launch_bounds__(kMaxThreads)
flash_backward_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ o,
                         const T* __restrict__ dout, const float* __restrict__ lse,
                         T* __restrict__ dq, float* __restrict__ delta, Shape s) {
  __shared__ __align__(16) float k_s[kSmemFloats];
  __shared__ __align__(16) float v_s[kSmemFloats];
  const int local_pair = threadIdx.x / s.rows;
  const int first_pair = blockIdx.x * s.pairs;
  const int pair = first_pair + local_pair;
  const int row = blockIdx.y * s.rows + threadIdx.x % s.rows;
  const bool active = local_pair < s.pairs && pair < s.batch * s.heads && row < s.seq;

  float qr[D], dor[D], acc[D];
  float row_delta = 0.f, row_lse = INFINITY;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = 0.f;
    dor[d] = 0.f;
    acc[d] = 0.f;
  }
  if (active) {
    const T* qp = q + qkv_offset(s.qb, s.qs, s.qh, pair, row, s.heads);
    const long long r = row_offset(pair, row, s, D);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[d] = widen(qp[d]) * s.scale;
      dor[d] = widen(dout[r + d]);
      row_delta = fmaf(dor[d], widen(o[r + d]), row_delta);
    }
    row_lse = lse[stat_offset(pair, row, s)];
    delta[stat_offset(pair, row, s)] = row_delta;
  }

  const int block_end = min(s.seq, (blockIdx.y + 1) * s.rows);
  const int key_end = s.causal ? block_end : s.seq;
  for (int k0 = 0; k0 < key_end; k0 += kTile) {
    __syncthreads();
    stage_strided<T, D>(k_s, k, s.kb, s.ks, s.kh, first_pair, k0, s, 1.f);
    stage_strided<T, D>(v_s, v, s.vb, s.vs, s.vh, first_pair, k0, s, 1.f);
    __syncthreads();
    if (!active) continue;
    const float* ks = k_s + local_pair * kTile * D;
    const float* vs = v_s + local_pair * kTile * D;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const int key = k0 + j;
      const bool valid = key < s.seq && (!s.causal || key <= row);
      if (!valid) continue;
      const float p = expf(dot_row<D>(qr, ks + j * D) - row_lse);
      const float ds = p * (dot_row<D>(dor, vs + j * D) - row_delta);
      axpy_row<D>(acc, ds, ks + j * D);
    }
  }
  if (!active) return;
  T* dqp = dq + row_offset(pair, row, s, D);
#pragma unroll
  for (int d = 0; d < D; ++d) dqp[d] = narrow<T>(acc[d] * s.scale);
}

// ---------------------------------------------------------------- backward: dK and dV

template <typename T, int D>
__global__ void __launch_bounds__(kMaxThreads)
flash_backward_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           T* __restrict__ dk, T* __restrict__ dv, Shape s) {
  __shared__ __align__(16) float q_s[kSmemFloats];
  __shared__ __align__(16) float do_s[kSmemFloats];
  __shared__ float lse_s[kMaxPairs * kTile];
  __shared__ float delta_s[kMaxPairs * kTile];
  const int local_pair = threadIdx.x / s.rows;
  const int first_pair = blockIdx.x * s.pairs;
  const int pair = first_pair + local_pair;
  const int row = blockIdx.y * s.rows + threadIdx.x % s.rows;  // this thread's key
  const int num_pairs = s.batch * s.heads;
  const bool active = local_pair < s.pairs && pair < num_pairs && row < s.seq;

  float kr[D], vr[D], dk_acc[D], dv_acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kr[d] = 0.f;
    vr[d] = 0.f;
    dk_acc[d] = 0.f;
    dv_acc[d] = 0.f;
  }
  if (active) {
    const T* kp = k + qkv_offset(s.kb, s.ks, s.kh, pair, row, s.heads);
    const T* vp = v + qkv_offset(s.vb, s.vs, s.vh, pair, row, s.heads);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      kr[d] = widen(kp[d]);
      vr[d] = widen(vp[d]);
    }
  }

  // Causal: the queries that see this block's keys start at its first key.
  const int q_begin = s.causal ? (blockIdx.y * s.rows) / kTile * kTile : 0;
  for (int q0 = q_begin; q0 < s.seq; q0 += kTile) {
    __syncthreads();
    stage_strided<T, D>(q_s, q, s.qb, s.qs, s.qh, first_pair, q0, s, s.scale);
    stage_contiguous<T, D>(do_s, dout, first_pair, q0, s);
    for (int idx = threadIdx.x; idx < s.pairs * kTile; idx += blockDim.x) {
      const int p = first_pair + idx / kTile;
      const int r = q0 + idx % kTile;
      const bool in = p < num_pairs && r < s.seq;
      lse_s[idx] = in ? lse[stat_offset(p, r, s)] : INFINITY;
      delta_s[idx] = in ? delta[stat_offset(p, r, s)] : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    const float* qs = q_s + local_pair * kTile * D;
    const float* dos = do_s + local_pair * kTile * D;
    const float* lses = lse_s + local_pair * kTile;
    const float* deltas = delta_s + local_pair * kTile;
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const int query = q0 + i;
      const bool valid = query < s.seq && (!s.causal || row <= query);
      if (!valid) continue;
      const float p = expf(dot_row<D>(kr, qs + i * D) - lses[i]);
      axpy_row<D>(dv_acc, p, dos + i * D);
      const float ds = p * (dot_row<D>(vr, dos + i * D) - deltas[i]);
      axpy_row<D>(dk_acc, ds, qs + i * D);
    }
  }
  if (!active) return;
  const long long r = row_offset(pair, row, s, D);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dk[r + d] = narrow<T>(dk_acc[d]);
    dv[r + d] = narrow<T>(dv_acc[d]);
  }
}

// ---------------------------------------------------------------- host side

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Fill the tiling; false when the shape is not one the kernels take.
bool make_shape(Shape* s, const long long* strides, int batch, int seq, int heads,
                int head_dim, float scale, int causal) {
  if (batch <= 0 || seq <= 0 || heads <= 0) return false;
  if (head_dim != 16 && head_dim != 32 && head_dim != 64) return false;
  s->batch = batch;
  s->seq = seq;
  s->heads = heads;
  s->rows = next_pow2(seq < kMaxThreads ? seq : kMaxThreads);
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

dim3 grid_of(const Shape& s) {
  const int num_pairs = s.batch * s.heads;
  return dim3((num_pairs + s.pairs - 1) / s.pairs, (s.seq + s.rows - 1) / s.rows);
}

template <typename T, int D>
void forward_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                    const Shape& s, cudaStream_t stream) {
  flash_forward_kernel<T, D><<<grid_of(s), s.rows * s.pairs, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), s);
}

template <typename T, int D>
void dq_launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const void* lse, void* dq, void* delta, const Shape& s, cudaStream_t stream) {
  flash_backward_dq_kernel<T, D><<<grid_of(s), s.rows * s.pairs, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<T*>(dq), static_cast<float*>(delta), s);
}

template <typename T, int D>
void dkdv_launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* delta, void* dk, void* dv, const Shape& s, cudaStream_t stream) {
  flash_backward_dkdv_kernel<T, D><<<grid_of(s), s.rows * s.pairs, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), s);
}

// Calls LAUNCH<T, D>(args...) for the runtime dtype code (0 float32, 1 bfloat16)
// and head dim; returns cudaErrorInvalidValue for anything else.
#define DISPATCH(LAUNCH, DTYPE, HEAD_DIM, ...)                                     \
  do {                                                                             \
    if ((DTYPE) == 0) {                                                            \
      switch (HEAD_DIM) {                                                          \
        case 16: LAUNCH<float, 16>(__VA_ARGS__); break;                            \
        case 32: LAUNCH<float, 32>(__VA_ARGS__); break;                            \
        case 64: LAUNCH<float, 64>(__VA_ARGS__); break;                            \
        default: return static_cast<int>(cudaErrorInvalidValue);                   \
      }                                                                            \
    } else if ((DTYPE) == 1) {                                                     \
      switch (HEAD_DIM) {                                                          \
        case 16: LAUNCH<__nv_bfloat16, 16>(__VA_ARGS__); break;                    \
        case 32: LAUNCH<__nv_bfloat16, 32>(__VA_ARGS__); break;                    \
        case 64: LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__); break;                    \
        default: return static_cast<int>(cudaErrorInvalidValue);                   \
      }                                                                            \
    } else {                                                                       \
      return static_cast<int>(cudaErrorInvalidValue);                              \
    }                                                                              \
  } while (0)

}  // namespace

// lse may be null (no gradient needed).
extern "C" int flash_attention_forward(int dtype, const void* q, const void* k, const void* v,
                                       void* o, void* lse, const long long* strides, int batch,
                                       int seq, int heads, int head_dim, float scale,
                                       int causal, void* stream) {
  Shape s;
  if (!make_shape(&s, strides, batch, seq, heads, head_dim, scale, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  DISPATCH(forward_launch, dtype, head_dim, q, k, v, o, lse, s,
           static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_attention_backward_dq(int dtype, const void* q, const void* k,
                                           const void* v, const void* o, const void* dout,
                                           const void* lse, void* dq, void* delta,
                                           const long long* strides, int batch, int seq,
                                           int heads, int head_dim, float scale, int causal,
                                           void* stream) {
  Shape s;
  if (!make_shape(&s, strides, batch, seq, heads, head_dim, scale, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  DISPATCH(dq_launch, dtype, head_dim, q, k, v, o, dout, lse, dq, delta, s,
           static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_attention_backward_dkdv(int dtype, const void* q, const void* k,
                                             const void* v, const void* dout, const void* lse,
                                             const void* delta, void* dk, void* dv,
                                             const long long* strides, int batch, int seq,
                                             int heads, int head_dim, float scale, int causal,
                                             void* stream) {
  Shape s;
  if (!make_shape(&s, strides, batch, seq, heads, head_dim, scale, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  DISPATCH(dkdv_launch, dtype, head_dim, q, k, v, dout, lse, delta, dk, dv, s,
           static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
