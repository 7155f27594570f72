// Flash attention past head dim 256 for Hopper (sm_90a): B2's forward and
// backward and B3 at any head dim.
//
//     forward   o = softmax(q * scale . k^T) . v,  lse = m + log(l)
//     backward  dq, dk, dv of the forward, from o, lse and dO (recompute)
//     chunk     pv = sum_k exp(s_qk - m) . v,  m,  l   over one K/V chunk, each
//               key masked by its GLOBAL position (B3, one ring step)
//
// Replaces, past head dim 256, the Pallas TPU kernels
// stoix_tpu/ops/pallas_attention.py::flash_attention (body `_flash_kernel`,
// fold `_fold_block`, whose fp32 carry `_init_carry` stays on chip) and
// ::flash_attention_chunk (body `_flash_chunk_kernel`). Those hold one
// (batch, head)'s whole [S, D] K and V in VMEM and so take any head dim VMEM
// holds. The TPU kernel has no backward (ROADMAP C4); the backward here is the
// port's own, held against jax.grad of the JAX package's `full_attention`.
//
// Bound on an H100: bytes. At [4096, 16, 2, 512] float32 causal the forward
// must read q, k, v and write o (1 GiB, 0.32 ms at 3.35 TB/s) for 2.3 GFLOP
// (0.035 ms at 67 TFLOP/s); the backward reads q, k, v, o, dO and writes dQ,
// dK, dV (2 GiB, 0.64 ms). So the design moves each byte once and keeps
// enough copies in flight; the arithmetic is exact fp32 FMA on the CUDA
// cores (TF32 would miss the 1e-5 parity every check holds), expf, no atomics.
//
// Tiles: a tile is 16 query rows (kRows) or 16 keys (kKeys) of one
// (batch, head) pair by 64 head-dim columns (kChunk), held in shared memory in
// the input type (bf16 and fp16 are widened to fp32, and q scaled, as the
// arithmetic reads them). A block's outputs cover at most 512 columns
// (kSliceChunks chunks): head dims up to 512 take one slice (regime 1); past
// 512 the output columns are split over blockIdx.z slices of 512 (regime 2),
// and each slice recomputes its scores over the whole head dim, streamed
// through shared memory chunk by chunk. The accumulators stay on chip in both
// regimes.
//
// Forward (and B3, `wide_forward_kernel<.., CHUNK>`): a block holds kPairs = 2
// pairs' 16-row query tile (128 threads a pair) and walks the key tiles (a
// causal B2 block stops at the key tile of its last row). Per key tile:
//   1. scores, summed over the head dim a chunk at a time: each thread a 4 x 4
//      tile of (row, key), over the chunk's columns 4f..4f+3 with f = part and
//      part + 8 (8 parts a tile, neighbouring lanes on neighbouring columns),
//      the 8 partial sums added by shuffles once the last chunk is in;
//   2. the online softmax of `_fold_block` (8 lanes a row, max and sum by
//      shuffles): m_safe, alpha = exp(m - m_safe), l = l.alpha + sum p;
//   3. acc = acc.alpha + P.V chunk by chunk, each thread 2 rows by 4 columns of
//      every chunk of the slice: 64 fp32 registers at 512 columns.
// The epilogue writes o = acc . (1 / l) (rounded once to T) straight from
// the registers, and lse (+inf where l == 0), or B3's raw pv, m (the proxy 0 on a
// row that saw no key) and l.
//
// Backward (`wide_backward_kernel`, one launch): a block owns one 16-key tile
// of one pair and one output slice, and walks the query tiles that see it.
// Per query tile:
//   1. stream q, dO, O and (on the first query tile) K and V chunk by chunk;
//      each thread a 4 x 4 tile of both q.k^T and dO.v^T over one column group
//      of each chunk (16 parts a tile), and delta = rowsum(dO.O) from the same
//      copies (16 threads a row): delta never leaves the block;
//   2. P = exp(s - lse) and dS = P.(dP - delta), once, into shared memory;
//   3. dV += P^T.dO and dK += dS^T.q, each thread 8 keys by 4 columns of both
//      (64 fp32 registers, kept across the query tiles), and this tile's
//      dQ = scale.dS.K, 8 rows by 4 columns, written from the registers: as
//      it is with one key tile a pair (S <= 16), else as this key tile's fp32
//      partial into its own slice of a zeroed [tiles, B, S, H, D] buffer that
//      the wrapper sums in tile order.
// In regime 1 q, dO and K of the slice stay in shared memory between steps 1
// and 3 (and K across query tiles), so at S <= 16 every operand is read once
// and every output written once.
//
// What the design does about the five costs of the kernels it replaced (the
// first wide route: head dim streamed 64 columns at a time, accumulators in
// device memory):
//   * the accumulators (acc, pv, dQ, dK, dV) live in registers, never in
//     device memory; no fp32 [B, S, H, D] work arrays, for any type;
//   * copies are 16-byte cp.async pieces, neighbouring threads on neighbouring
//     pieces of a row, in a ring of 4 stages: the next chunks fly while this
//     one's dots run (head dims whose rows are not whole 16-byte pieces, such
//     as 257, copy element by element);
//   * a key tile holds 16 keys, so at S = 16 no key is padding, and a forward
//     block packs 2 pairs (grid B.H / 2 x S / 16);
//   * the backward is one launch: delta in the block, P and dS once per
//     (query tile, key tile), each operand read once at S <= 16;
//   * scores take 4 x 4 register tiles (8 or 16 lanes a tile), the softmax
//     8 lanes a row.
//
// Types: q, k, v float32, bfloat16 or float16, any head dim; the statistics and
// accumulators are fp32, the outputs rounded once to the input type. q, k, v
// are taken by strides (batch, seq, head; the last dim contiguous); o, dO and
// the outputs are contiguous [B, S, H, D]; lse, m and l contiguous [B, H, S].
// Ragged lengths and the last head-dim chunk are masked, never padded in
// device memory.
//
// Plain C interface, bound from Python with ctypes
// (kernels/flash_attention_wide.py). Each entry point launches on the given
// stream and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;                        // query rows of a tile
constexpr int kKeys = 16;                        // keys of a tile
constexpr int kChunk = 64;                       // head-dim columns of a chunk
constexpr int kSliceChunks = 8;                  // chunks of an output slice: 512 columns
constexpr int kPairs = 2;                        // forward: pairs a block holds
constexpr int kPairThreads = 128;                // forward: threads of a pair
constexpr int kFwdThreads = kPairs * kPairThreads;
constexpr int kFwdParts = 8;                     // forward: partial sums of a score
constexpr int kBwdThreads = 256;
constexpr int kBwdParts = 16;                    // backward: partial sums of a score
constexpr int kStages = 4;                       // ring stages of chunk copies
constexpr int kFwdTile = kPairs * kRows * kChunk;  // elements of a forward chunk tile
constexpr int kBwdTile = kRows * kChunk;           // elements of a backward chunk tile
constexpr unsigned kFull = 0xffffffffu;

struct WideShape {
  long long q_stride[3], k_stride[3], v_stride[3];  // batch, seq, head; in elements
  int batch, q_len, k_len, heads, head_dim;
  float scale;
  int causal;
  int chunks;   // head-dim chunks, ceil(D / kChunk)
  int slices;   // output slices, ceil(chunks / kSliceChunks)
  int aligned;  // every input row starts on 16 bytes and D is whole pieces
  int vec_out;  // outputs stored 4 elements at a time (D % 4 == 0)
};

// ---------------------------------------------------------------- element types

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ float put(float x) { return x; }
  static __device__ __forceinline__ void store4(float* p, float4 x) {
    *reinterpret_cast<float4*>(p) = x;
  }
};
template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ __nv_bfloat16 put(float x) { return __float2bfloat16_rn(x); }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
    __nv_bfloat162 h[2] = {__floats2bfloat162_rn(x.x, x.y), __floats2bfloat162_rn(x.z, x.w)};
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
  }
};
template <>
struct Elem<__half> {
  static __device__ __forceinline__ float4 load4(const __half* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
    const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ __half put(float x) { return __float2half_rn(x); }
  static __device__ __forceinline__ void store4(__half* p, float4 x) {
    __half2 h[2] = {__floats2half2_rn(x.x, x.y), __floats2half2_rn(x.z, x.w)};
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
  }
};

__device__ __forceinline__ float4 scaled(float4 a, float mul) {
  return make_float4(a.x * mul, a.y * mul, a.z * mul, a.w * mul);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

__device__ __forceinline__ float lane(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// acc[c] = fma(x, b[c], acc[c]) for the 4 columns of b.
__device__ __forceinline__ void axpy4(float (&acc)[4], float x, const float4& b) {
  acc[0] = fmaf(x, b.x, acc[0]);
  acc[1] = fmaf(x, b.y, acc[1]);
  acc[2] = fmaf(x, b.z, acc[2]);
  acc[3] = fmaf(x, b.w, acc[3]);
}

// Write 4 fp32 values at columns col..col+3 of a row (`row` points at its
// column 0), rounded once to OutT; columns at or past D are not written.
template <typename OutT>
__device__ __forceinline__ void store_row4(OutT* row, int col, const float (&x)[4], float mul,
                                           const WideShape& s) {
  if (col >= s.head_dim) return;
  if (s.vec_out) {
    Elem<OutT>::store4(row + col, make_float4(x[0] * mul, x[1] * mul, x[2] * mul, x[3] * mul));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (col + i < s.head_dim) row[col + i] = Elem<OutT>::put(x[i] * mul);
  }
}

// ---------------------------------------------------------------- copies

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
               "r"(valid ? 16 : 0));  // 0 source bytes: the 16 bytes are zero-filled
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy columns [c0, c0 + kChunk) of `rows` rows of one operand into a
// [rows][kChunk] tile of T in shared memory. Row r is row `row0 + r % 16` of
// pair r / 16, whose row 0 starts at `base[r / 16]` (null for a pair past the
// last one); rows are `stride` elements apart. Rows at or past `len` and
// columns at or past D are zeros. With `s.aligned`, each thread moves 16-byte
// pieces by cp.async, neighbouring threads on neighbouring pieces of a row;
// else element by element (a head dim such as 257, whose rows do not start on
// 16 bytes).
template <typename T, int kThreadsT>
__device__ __forceinline__ void copy_chunk(T* tile, const T* const* base, const T* any, int rows,
                                           long long stride, int row0, int len, int c0,
                                           const WideShape& s) {
  if (s.aligned) {
    constexpr int kElems = 16 / sizeof(T);
    constexpr int kPieces = kChunk / kElems;
    for (int idx = threadIdx.x; idx < rows * kPieces; idx += kThreadsT) {
      const int r = idx / kPieces, piece = idx % kPieces;
      const int row = row0 + r % kRows, col = c0 + piece * kElems;
      const T* from = base[r / kRows];
      const bool valid = from != nullptr && row < len && col < s.head_dim;
      cp_async16(tile + r * kChunk + piece * kElems, valid ? from + row * stride + col : any,
                 valid);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * kChunk; idx += kThreadsT) {
      const int r = idx / kChunk, c = idx % kChunk;
      const int row = row0 + r % kRows, col = c0 + c;
      const T* from = base[r / kRows];
      tile[idx] = from != nullptr && row < len && col < s.head_dim ? from[row * stride + col]
                                                                    : Elem<T>::put(0.f);
    }
  }
}

// ---------------------------------------------------------------- forward and B3

// One block: the 16-row query tile blockIdx.y of pairs 2 * blockIdx.x and
// 2 * blockIdx.x + 1, output columns of slice blockIdx.z. CHUNK: B3 (positions
// from q_pos and k_pos, outputs OutT = float pv, m with the proxy 0, l); else
// B2's forward (positions are the indices; outputs o in OutT = T and, if
// asked, lse).
template <typename T, typename OutT, bool CHUNK>
__global__ void __launch_bounds__(kFwdThreads, 2)
wide_forward_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                    OutT* __restrict__ out, float* __restrict__ lse, float* __restrict__ m_out,
                    float* __restrict__ l_out, WideShape s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(16) float sp[kPairs][kRows][kKeys];  // scores, then P
  __shared__ float alpha_s[kPairs][kRows], l_s[kPairs][kRows];
  __shared__ const T* q_base[kPairs];
  __shared__ const T* k_base[kPairs];
  __shared__ const T* v_base[kPairs];

  const int tid = threadIdx.x;
  const int num_pairs = s.batch * s.heads;
  const int first_pair = blockIdx.x * kPairs;
  // Causal walks are uneven: the query tiles with the most key tiles go first.
  const int query_tile = !CHUNK && s.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = query_tile * kRows;
  const int c_lo = blockIdx.z * kSliceChunks;
  const int n_out = min(kSliceChunks, s.chunks - c_lo);  // chunks of this slice
  // Regime 1 (one slice): q stays in shared memory for every key tile.
  const bool q_resident = s.slices == 1;
  const int slots = q_resident ? 1 : 2;  // chunk tiles a ring stage holds
  T* q_res = reinterpret_cast<T*>(smem_raw);
  T* ring = q_res + (q_resident ? s.chunks * kFwdTile : 0);

  if (tid < kPairs) {
    const int pair = first_pair + tid, b = pair / s.heads, h = pair % s.heads;
    const bool ok = pair < num_pairs;
    q_base[tid] = ok ? q + b * s.q_stride[0] + h * s.q_stride[2] : nullptr;
    k_base[tid] = ok ? k + b * s.k_stride[0] + h * s.k_stride[2] : nullptr;
    v_base[tid] = ok ? v + b * s.v_stride[0] + h * s.v_stride[2] : nullptr;
  }
  __syncthreads();

  const int g = tid / kPairThreads, t = tid % kPairThreads;
  const int lane_id = tid & 31, warp = t / 32;
  // Score role: a 4 x 4 tile (rows rb.., keys kb..) over the columns of `part`.
  const int part = lane_id % kFwdParts, tile = warp * 4 + lane_id / kFwdParts;
  const int rb = tile / 4 * 4, kb = tile % 4 * 4;
  // Softmax role: 8 lanes a row, 2 keys each.
  const int srow = t / 8, skey = t % 8 * 2;
  // Output role: rows orow, orow + 1 by columns 4 * col4.. of every chunk.
  const int col4 = t % 16, orow = t / 16 * 2;

  const bool pair_ok = first_pair + g < num_pairs;
  const int row_end = min(s.q_len, q0 + kRows);
  int key_tiles = (s.k_len + kKeys - 1) / kKeys;
  if (!CHUNK && s.causal) key_tiles = min(key_tiles, (row_end - 1) / kKeys + 1);
  const int per_tile = s.chunks + n_out;  // ring steps a key tile: scores, then P.V
  const int steps = key_tiles * per_tile;

  auto stage = [&](int i) { return ring + (i % kStages) * slots * kFwdTile; };
  auto start_copies = [&](int i) {
    if (i < steps) {
      const int kt = i / per_tile, j = i % per_tile;
      T* dst = stage(i);
      if (j < s.chunks) {
        if (!q_resident || kt == 0)
          copy_chunk<T, kFwdThreads>(q_resident ? q_res + j * kFwdTile : dst + kFwdTile, q_base,
                                     q, kPairs * kRows, s.q_stride[1], q0, s.q_len, j * kChunk, s);
        copy_chunk<T, kFwdThreads>(dst, k_base, k, kPairs * kKeys, s.k_stride[1], kt * kKeys,
                                   s.k_len, j * kChunk, s);
      } else {
        copy_chunk<T, kFwdThreads>(dst, v_base, v, kPairs * kKeys, s.v_stride[1], kt * kKeys,
                                   s.k_len, (c_lo + j - s.chunks) * kChunk, s);
      }
    }
    cp_async_commit();  // every thread commits one group a step, empty or not
  };
  int step = 0;
  // Wait for this step's copies, free the stage the last step read, start the
  // copies kStages - 1 steps ahead; returns this step's stage.
  auto advance = [&]() {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    start_copies(step + kStages - 1);
    return stage(step++);
  };

  float acc[kSliceChunks][2][4];
#pragma unroll
  for (int c = 0; c < kSliceChunks; ++c)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[c][r][x] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;  // the softmax role's row
  const int srow_global = q0 + srow;
  const bool srow_ok = pair_ok && srow_global < s.q_len;
  const int srow_pos = srow_ok ? (CHUNK ? q_pos[srow_global] : srow_global) : INT_MIN;

  for (int i = 0; i < kStages - 1; ++i) start_copies(i);
  for (int kt = 0; kt < key_tiles; ++kt) {
    const int k0 = kt * kKeys;
    float sc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[r][j] = 0.f;
    for (int c = 0; c < s.chunks; ++c) {
      const T* st = advance();
      const T* qt = (q_resident ? q_res + c * kFwdTile : st + kFwdTile) + (g * kRows + rb) * kChunk;
      const T* kt_rows = st + (g * kKeys + kb) * kChunk;
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        const int col = 4 * (part + half * kFwdParts);
        float4 a[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = scaled(Elem<T>::load4(qt + r * kChunk + col), s.scale);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 b = Elem<T>::load4(kt_rows + j * kChunk + col);
#pragma unroll
          for (int r = 0; r < 4; ++r) sc[r][j] = dot4(a[r], b, sc[r][j]);
        }
      }
    }
    // The 8 parts of a tile are neighbouring lanes: their sums by shuffles.
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int off = 1; off < kFwdParts; off *= 2)
          sc[r][j] += __shfl_xor_sync(kFull, sc[r][j], off);
    if (part == 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<float4*>(&sp[g][rb + r][kb]) =
            make_float4(sc[r][0], sc[r][1], sc[r][2], sc[r][3]);
    }
    __syncthreads();

    {  // the online softmax, as `_fold_block` folds a block
      float x[2], p[2];
      bool seen[2];
      float m_tile = -INFINITY;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + skey + e;
        seen[e] = srow_ok && key < s.k_len &&
                  (!s.causal || srow_pos >= (CHUNK ? k_pos[key] : key));
        x[e] = sp[g][srow][skey + e];
        if (seen[e]) m_tile = fmaxf(m_tile, x[e]);
      }
#pragma unroll
      for (int off = 1; off < 8; off *= 2)
        m_tile = fmaxf(m_tile, __shfl_xor_sync(kFull, m_tile, off));
      const float m_new = fmaxf(m_run, m_tile);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
#pragma unroll
      for (int e = 0; e < 2; ++e) p[e] = seen[e] ? expf(x[e] - m_safe) : 0.f;
      float p_sum = p[0] + p[1];
#pragma unroll
      for (int off = 1; off < 8; off *= 2) p_sum += __shfl_xor_sync(kFull, p_sum, off);
      const float alpha = m_run == -INFINITY ? 0.f : expf(m_run - m_safe);
      l_run = l_run * alpha + p_sum;
      m_run = m_new;
      sp[g][srow][skey] = p[0];
      sp[g][srow][skey + 1] = p[1];
      if (t % 8 == 0) alpha_s[g][srow] = alpha;
    }
    __syncthreads();

    // acc = acc.alpha + P.V, one chunk of the slice a step.
    const float a0 = alpha_s[g][orow], a1 = alpha_s[g][orow + 1];
#pragma unroll
    for (int c = 0; c < kSliceChunks; ++c) {
      if (c < n_out) {
        const T* vt = advance() + g * kKeys * kChunk + 4 * col4;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          acc[c][0][x] *= a0;
          acc[c][1][x] *= a1;
        }
#pragma unroll 1
        for (int j4 = 0; j4 < kKeys; j4 += 4) {
          const float4 pa = *reinterpret_cast<const float4*>(&sp[g][orow][j4]);
          const float4 pb = *reinterpret_cast<const float4*>(&sp[g][orow + 1][j4]);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float4 b = Elem<T>::load4(vt + (j4 + jj) * kChunk);
            axpy4(acc[c][0], lane(pa, jj), b);
            axpy4(acc[c][1], lane(pb, jj), b);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // the empty groups past the last step

  // Epilogue: the rows' statistics (slice 0 writes them), then
  // o = acc . (1 / l) (B3: the raw pv) straight from the registers.
  if (t % 8 == 0) l_s[g][srow] = l_run;
  if (t % 8 == 0 && srow_ok && blockIdx.z == 0) {
    const long long stat = static_cast<long long>(first_pair + g) * s.q_len + srow_global;
    if constexpr (CHUNK) {
      m_out[stat] = m_run == -INFINITY ? 0.f : m_run;  // the finite proxy of an empty row
      l_out[stat] = l_run;
    } else if (lse != nullptr) {
      lse[stat] = l_run == 0.f ? INFINITY : m_run + logf(l_run);
    }
  }
  __syncthreads();
  if (!pair_ok) return;
  const int pair = first_pair + g, b = pair / s.heads, h = pair % s.heads;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + orow + r;
    if (row >= s.q_len) continue;
    const float row_l = l_s[g][orow + r];
    const float inv_l = 1.f / (row_l == 0.f ? 1.f : row_l);
    OutT* dst = out + ((static_cast<long long>(b) * s.q_len + row) * s.heads + h) * s.head_dim;
#pragma unroll
    for (int c = 0; c < kSliceChunks; ++c) {
      if (c < n_out) {
        float x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = CHUNK ? acc[c][r][i] : acc[c][r][i] * inv_l;
        store_row4<OutT>(dst, (c_lo + c) * kChunk + 4 * col4, x, 1.f, s);
      }
    }
  }
}

// ---------------------------------------------------------------- backward

// One block: key tile blockIdx.y (16 keys) of pair blockIdx.x, output columns
// of slice blockIdx.z; it walks the query tiles that see the key tile.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads, 1)
wide_backward_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ o, const T* __restrict__ dout,
                     const float* __restrict__ lse, T* __restrict__ dq,
                     float* __restrict__ dq_partial, T* __restrict__ dk, T* __restrict__ dv,
                     WideShape s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(16) float p_s[kRows][kKeys];   // P of (query, key)
  __shared__ __align__(16) float ds_s[kRows][kKeys];  // dS of (query, key)
  __shared__ __align__(16) float dst_s[kKeys][kRows];  // dS transposed
  __shared__ float lse_s[kRows], delta_s[kRows];

  const int tid = threadIdx.x, lane_id = tid & 31, warp = tid / 32;
  const int pair = blockIdx.x, b = pair / s.heads, h = pair % s.heads;
  const int key_tile = blockIdx.y, k0 = key_tile * kKeys;
  const int c_lo = blockIdx.z * kSliceChunks;
  const int n_out = min(kSliceChunks, s.chunks - c_lo);
  const int res_chunks = min(s.chunks, kSliceChunks);
  const int slots = s.slices > 1 ? 5 : 2;  // chunk tiles a ring stage holds
  T* k_res = reinterpret_cast<T*>(smem_raw);  // the slice's columns of K, q, dO
  T* q_res = k_res + res_chunks * kBwdTile;
  T* do_res = q_res + res_chunks * kBwdTile;
  T* ring = do_res + res_chunks * kBwdTile;

  const T* q_row0[1] = {q + b * s.q_stride[0] + h * s.q_stride[2]};
  const T* k_row0[1] = {k + b * s.k_stride[0] + h * s.k_stride[2]};
  const T* v_row0[1] = {v + b * s.v_stride[0] + h * s.v_stride[2]};
  const long long rows_base = (static_cast<long long>(b) * s.q_len * s.heads + h) * s.head_dim;
  const long long row_stride = static_cast<long long>(s.heads) * s.head_dim;  // o, dO, outputs
  const T* o_row0[1] = {o + rows_base};
  const T* do_row0[1] = {dout + rows_base};

  // Step 1 role: a 4 x 4 tile of scores and of dO.v^T over one column group a
  // chunk; delta: 16 threads a row.
  const int part = lane_id % kBwdParts, tile = warp * 2 + lane_id / kBwdParts;
  const int rb = tile / 4 * 4, kb = tile % 4 * 4;
  const int drow = tid / kBwdParts, dgrp = tid % kBwdParts;
  // Step 3 role: column group cg (4 columns of the slice), keys (dK, dV) or
  // rows (dQ) 8 * half...
  const int cg = tid / 2, half = tid % 2;
  const bool b_active = cg < n_out * (kChunk / 4);
  const int res_at = cg / (kChunk / 4) * kBwdTile + cg % (kChunk / 4) * 4;  // row 0, its columns
  const int out_col = c_lo * kChunk + 4 * cg;

  float kv[2][8][4];  // dV, dK: 8 keys by 4 columns, summed over the query tiles
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) kv[n][j][x] = 0.f;

  const int query_tiles = (s.q_len + kRows - 1) / kRows;
  const int first_qt = s.causal ? key_tile : 0;
  for (int qt = first_qt; qt < query_tiles; ++qt) {
    const int q0 = qt * kRows;
    if (tid < kRows) {
      const int row = q0 + tid;
      lse_s[tid] = row < s.q_len ? lse[static_cast<long long>(pair) * s.q_len + row] : 0.f;
    }
    // The tiles of chunk c: the slice's q, dO and K in their resident buffers,
    // the rest in the ring stage (V, O; and q, dO, K past the slice).
    auto tiles_of = [&](int c, T** t5) {
      const bool in = c >= c_lo && c < c_lo + n_out;
      T* st = ring + (c % kStages) * slots * kBwdTile;
      t5[0] = st;             // V
      t5[1] = st + kBwdTile;  // O
      t5[2] = in ? q_res + (c - c_lo) * kBwdTile : st + 2 * kBwdTile;
      t5[3] = in ? do_res + (c - c_lo) * kBwdTile : st + 3 * kBwdTile;
      t5[4] = in ? k_res + (c - c_lo) * kBwdTile : st + 4 * kBwdTile;
    };
    auto start_copies = [&](int c) {
      if (c < s.chunks) {
        T* t5[5];
        tiles_of(c, t5);
        const bool in = c >= c_lo && c < c_lo + n_out;
        const int c0 = c * kChunk;
        copy_chunk<T, kBwdThreads>(t5[0], v_row0, v, kKeys, s.v_stride[1], k0,
                                   s.k_len, c0, s);
        copy_chunk<T, kBwdThreads>(t5[1], o_row0, o, kRows, row_stride, q0,
                                   s.q_len, c0, s);
        copy_chunk<T, kBwdThreads>(t5[2], q_row0, q, kRows, s.q_stride[1], q0,
                                   s.q_len, c0, s);
        copy_chunk<T, kBwdThreads>(t5[3], do_row0, dout, kRows, row_stride, q0,
                                   s.q_len, c0, s);
        if (!in || qt == first_qt)  // the slice's K stays for every query tile
          copy_chunk<T, kBwdThreads>(t5[4], k_row0, k, kKeys, s.k_stride[1], k0,
                                     s.k_len, c0, s);
      }
      cp_async_commit();
    };

    float sc[4][4], dp[4][4], delta = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[r][j] = dp[r][j] = 0.f;
    for (int c = 0; c < kStages - 1; ++c) start_copies(c);
    for (int c = 0; c < s.chunks; ++c) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      start_copies(c + kStages - 1);
      T* t5[5];
      tiles_of(c, t5);
      const int col = 4 * part;
      float4 a[4], gr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[r] = scaled(Elem<T>::load4(t5[2] + (rb + r) * kChunk + col), s.scale);
        gr[r] = Elem<T>::load4(t5[3] + (rb + r) * kChunk + col);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 kk = Elem<T>::load4(t5[4] + (kb + j) * kChunk + col);
        const float4 vv = Elem<T>::load4(t5[0] + (kb + j) * kChunk + col);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          sc[r][j] = dot4(a[r], kk, sc[r][j]);
          dp[r][j] = dot4(gr[r], vv, dp[r][j]);
        }
      }
      delta = dot4(Elem<T>::load4(t5[3] + drow * kChunk + 4 * dgrp),
                   Elem<T>::load4(t5[1] + drow * kChunk + 4 * dgrp), delta);
    }
    cp_async_wait<0>();
#pragma unroll
    for (int off = 1; off < kBwdParts; off *= 2) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[r][j] += __shfl_xor_sync(kFull, sc[r][j], off);
          dp[r][j] += __shfl_xor_sync(kFull, dp[r][j], off);
        }
      delta += __shfl_xor_sync(kFull, delta, off);
    }
    if (dgrp == 0) delta_s[drow] = delta;
    __syncthreads();

    if (part == 0) {  // P and dS of the tile, once
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = q0 + rb + r;
        float p[4], ds[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + kb + j;
          const bool seen = row < s.q_len && key < s.k_len && (!s.causal || key <= row);
          p[j] = seen ? expf(sc[r][j] - lse_s[rb + r]) : 0.f;
          ds[j] = p[j] * (dp[r][j] - delta_s[rb + r]);
          dst_s[kb + j][rb + r] = ds[j];
        }
        *reinterpret_cast<float4*>(&p_s[rb + r][kb]) = make_float4(p[0], p[1], p[2], p[3]);
        *reinterpret_cast<float4*>(&ds_s[rb + r][kb]) = make_float4(ds[0], ds[1], ds[2], ds[3]);
      }
    }
    __syncthreads();

    if (b_active) {
      // dV += P^T.dO and dK += dS^T.q over this tile's rows.
#pragma unroll 4
      for (int r = 0; r < kRows; ++r) {
        const float4 g4 = Elem<T>::load4(do_res + res_at + r * kChunk);
        const float4 q4 = Elem<T>::load4(q_res + res_at + r * kChunk);
        const float4 p_lo = *reinterpret_cast<const float4*>(&p_s[r][8 * half]);
        const float4 p_hi = *reinterpret_cast<const float4*>(&p_s[r][8 * half + 4]);
        const float4 d_lo = *reinterpret_cast<const float4*>(&ds_s[r][8 * half]);
        const float4 d_hi = *reinterpret_cast<const float4*>(&ds_s[r][8 * half + 4]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          axpy4(kv[0][j], lane(p_lo, j), g4);
          axpy4(kv[0][4 + j], lane(p_hi, j), g4);
          axpy4(kv[1][j], lane(d_lo, j), q4);
          axpy4(kv[1][4 + j], lane(d_hi, j), q4);
        }
      }
      // dQ = scale.dS.K over the key tile: rows 8 * half.. by the 4 columns.
      float dqt[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int x = 0; x < 4; ++x) dqt[r][x] = 0.f;
#pragma unroll 4
      for (int j = 0; j < kKeys; ++j) {
        const float4 k4 = Elem<T>::load4(k_res + res_at + j * kChunk);
        const float4 lo = *reinterpret_cast<const float4*>(&dst_s[j][8 * half]);
        const float4 hi = *reinterpret_cast<const float4*>(&dst_s[j][8 * half + 4]);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          axpy4(dqt[r], lane(lo, r), k4);
          axpy4(dqt[4 + r], lane(hi, r), k4);
        }
      }
      const long long tiles_stride = static_cast<long long>(s.batch) * s.heads * s.q_len *
                                     s.head_dim;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = q0 + 8 * half + r;
        if (row >= s.q_len) continue;
        const long long at = rows_base + row * row_stride;
        if (gridDim.y == 1) {
          store_row4<T>(dq + at, out_col, dqt[r], s.scale, s);
        } else {  // this key tile's partial, into its own slice of the buffer
          store_row4<float>(dq_partial + key_tile * tiles_stride + at, out_col, dqt[r], s.scale,
                            s);
        }
      }
    }
    __syncthreads();  // q_res, do_res, P and dS are read no more this query tile
  }

  if (!b_active) return;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int key = k0 + 8 * half + j;
    if (key >= s.k_len) continue;
    const long long at = rows_base + key * row_stride;
    store_row4<T>(dv + at, out_col, kv[0][j], 1.f, s);
    store_row4<T>(dk + at, out_col, kv[1][j], s.scale, s);
  }
}

// ---------------------------------------------------------------- launches

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

bool make_shape(WideShape* s, const long long* strides, int elem_size, int batch, int q_len,
                int k_len, int heads, int head_dim, float scale, int causal) {
  if (batch <= 0 || q_len <= 0 || k_len <= 0 || heads <= 0 || head_dim <= 0) return false;
  if (static_cast<long long>(q_len + kRows - 1) / kRows > 65535) return false;
  if (static_cast<long long>(k_len + kKeys - 1) / kKeys > 65535) return false;
  if (static_cast<long long>(batch) * heads > 0x7fffffffLL) return false;
  s->aligned = head_dim % (16 / elem_size) == 0;
  for (int i = 0; i < 3; ++i) {
    s->q_stride[i] = strides[i];
    s->k_stride[i] = strides[3 + i];
    s->v_stride[i] = strides[6 + i];
  }
  for (int i = 0; i < 9; ++i)
    if (strides[i] * elem_size % 16 != 0) s->aligned = 0;
  s->batch = batch;
  s->q_len = q_len;
  s->k_len = k_len;
  s->heads = heads;
  s->head_dim = head_dim;
  s->scale = scale;
  s->causal = causal;
  s->chunks = (head_dim + kChunk - 1) / kChunk;
  s->slices = (s->chunks + kSliceChunks - 1) / kSliceChunks;
  s->vec_out = head_dim % 4 == 0;
  return true;
}

// Dynamic shared memory of a forward block: q of the block's rows over the
// whole head dim (one slice), and the ring.
template <typename T>
size_t forward_smem(const WideShape& s) {
  const bool resident = s.slices == 1;
  return ((resident ? s.chunks : 0) + kStages * (resident ? 1 : 2)) * kFwdTile * sizeof(T);
}

// Dynamic shared memory of a backward block: K, q, dO of the slice's columns,
// and the ring.
template <typename T>
size_t backward_smem(const WideShape& s) {
  const int res_chunks = s.chunks < kSliceChunks ? s.chunks : kSliceChunks;
  return (3 * res_chunks + kStages * (s.slices > 1 ? 5 : 2)) * kBwdTile * sizeof(T);
}

// Opt a kernel in to `bytes` of dynamic shared memory (above 48 KiB only so)
// once; a failure is left for cudaGetLastError() to report, and retried.
template <typename Kernel>
bool opt_in(Kernel kernel, bool* opted, size_t bytes) {
  if (!*opted) {
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes)) != cudaSuccess)
      return false;
    *opted = true;
  }
  return true;
}

template <typename T, typename OutT, bool CHUNK>
void forward_launch(const void* q, const void* k, const void* v, const int* q_pos,
                    const int* k_pos, void* out, float* lse, float* m, float* l,
                    const WideShape& s, cudaStream_t stream) {
  static bool opted = false;
  const auto kernel = wide_forward_kernel<T, OutT, CHUNK>;
  // The most either regime takes: 8 resident q chunks and 4 one-tile stages.
  if (!opt_in(kernel, &opted, (kSliceChunks + kStages) * kFwdTile * sizeof(T))) return;
  const int num_pairs = s.batch * s.heads;
  const dim3 grid((num_pairs + kPairs - 1) / kPairs, (s.q_len + kRows - 1) / kRows, s.slices);
  kernel<<<grid, kFwdThreads, forward_smem<T>(s), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), q_pos, k_pos,
      static_cast<OutT*>(out), lse, m, l, s);
}

template <typename T>
void backward_launch(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, void* dq, float* dq_partial, void* dk,
                     void* dv, const WideShape& s, cudaStream_t stream) {
  static bool opted = false;
  const auto kernel = wide_backward_kernel<T>;
  // The most either regime takes: 3 x 8 resident chunks and 4 five-tile stages.
  if (!opt_in(kernel, &opted, (3 * kSliceChunks + kStages * 5) * kBwdTile * sizeof(T))) return;
  const dim3 grid(s.batch * s.heads, (s.k_len + kKeys - 1) / kKeys, s.slices);
  kernel<<<grid, kBwdThreads, backward_smem<T>(s), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, static_cast<T*>(dq),
      dq_partial, static_cast<T*>(dk), static_cast<T*>(dv), s);
}

int elem_size(int dtype) { return dtype == 0 ? 4 : 2; }

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

template <typename T>
void b2_forward(const void* q, const void* k, const void* v, void* o, float* lse,
                const WideShape& s, cudaStream_t stream) {
  forward_launch<T, T, false>(q, k, v, nullptr, nullptr, o, lse, nullptr, nullptr, s, stream);
}

template <typename T>
void b3_chunk(const void* q, const void* k, const void* v, const int* q_pos, const int* k_pos,
              float* pv, float* m, float* l, const WideShape& s, cudaStream_t stream) {
  forward_launch<T, float, true>(q, k, v, q_pos, k_pos, pv, nullptr, m, l, s, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (q, k, v, o). o contiguous
// [B, S, H, D]; lse may be null.
extern "C" int flash_attention_wide_forward(int dtype, const void* q, const void* k,
                                            const void* v, void* o, float* lse,
                                            const long long* strides, int batch, int seq,
                                            int heads, int head_dim, float scale, int causal,
                                            void* stream) {
  WideShape s;
  if (dtype < 0 || dtype > 2 ||
      !make_shape(&s, strides, elem_size(dtype), batch, seq, seq, heads, head_dim, scale, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q) || !aligned16(k) || !aligned16(v)) s.aligned = 0;
  DISPATCH_DTYPE(b2_forward, dtype, q, k, v, o, lse, s, static_cast<cudaStream_t>(stream));
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
  if (dtype < 0 || dtype > 2 || !make_shape(&s, strides, elem_size(dtype), batch, q_len, k_len,
                                            heads, head_dim, scale, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q) || !aligned16(k) || !aligned16(v)) s.aligned = 0;
  DISPATCH_DTYPE(b3_chunk, dtype, q, k, v, static_cast<const int*>(q_pos),
                 static_cast<const int*>(k_pos), pv, m, l, s, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// o, dout, dq, dk, dv contiguous [B, S, H, D] in dtype; lse fp32 [B, H, S].
// dq is written when S <= 16 (one key tile a pair) and may be null otherwise;
// dq_partial, a zeroed fp32 [ceil(S / 16), B, S, H, D], takes one dQ partial a
// key tile past it and may be null otherwise.
extern "C" int flash_attention_wide_backward(int dtype, const void* q, const void* k,
                                             const void* v, const void* o, const void* dout,
                                             const float* lse, void* dq, float* dq_partial,
                                             void* dk, void* dv, const long long* strides,
                                             int batch, int seq, int heads, int head_dim,
                                             float scale, int causal, void* stream) {
  WideShape s;
  if (dtype < 0 || dtype > 2 ||
      !make_shape(&s, strides, elem_size(dtype), batch, seq, seq, heads, head_dim, scale, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((seq > kKeys ? static_cast<void*>(dq_partial) : dq) == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o) || !aligned16(dout))
    s.aligned = 0;
  DISPATCH_DTYPE(backward_launch, dtype, q, k, v, o, dout, lse, dq, dq_partial, dk, dv, s,
                 static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attention_wide_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
