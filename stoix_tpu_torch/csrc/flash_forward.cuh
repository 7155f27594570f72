// The flash-attention forward core for Hopper (sm_90a), shared by B2's forward
// (csrc/flash_attention.cu, `flash_forward_kernel`) and B3
// (csrc/flash_attention_chunk.cu, `flash_chunk_kernel`), and the copy and
// register-tile primitives both sources use.
//
// A block holds kTileRows = 64 query rows: G pairs of R rows, R the next power
// of two >= max(Sq, Sk) (at least 4, at most 64), G = 64 / R, so S = 16 puts 4
// (batch, head) pairs in a block. It walks key tiles of R keys a pair (past
// 64, a block owns one 64-row query tile of one pair and walks 64-key tiles).
// Per key tile, kThreads = 256 threads:
//   1. copy the tile's K and V rows into padded, skewed fp32 tiles in shared
//      memory, one 16-byte piece a thread, neighbouring threads on
//      neighbouring pieces of a row (cp.async for fp32, bf16 and fp16 widened
//      on the way; past S the piece is zero-filled). q goes with the first tile;
//   2. scores and the online softmax: 4 neighbouring lanes share a query row
//      (R <= 16), or 16 share 4 rows (R > 16), each lane a register tile of
//      its rows by R / 4 or R / 16 keys (q scaled in fp32 before the dot, as
//      `_fold_block` does). A row's max and sum are taken by shuffles among
//      those lanes; per tile, as `_fold_block` folds a block:
//      m_safe (0 while the row has seen only masked keys),
//      alpha = exp(m - m_safe) (0 while m is -inf), l = l.alpha + sum p;
//      P goes to shared memory;
//   3. acc = acc.alpha + P.V, each thread a register tile of max(1, D / 16)
//      rows by 4 columns (R <= 16), or of max(4, D / 16) rows by 4 columns
//      (R > 16); where the tiles are fewer than the threads, 2 or more lanes
//      split a tile's keys and sum by shuffles at the end; up to the last key
//      any of its rows sees.
// Head dims 8, 16, 32, 64, 128 and 256 are built (a 16-byte piece is a whole
// row of 8 16-bit values); q, k, v are float32, bfloat16 or float16. At
// D = 256 the three 64-row tiles and P take 212 KiB, so one block fills an SM
// and a thread keeps 64 accumulators (16 rows by 4 columns).
// The epilogue writes the accumulator out through shared memory as 16-byte
// coalesced stores (normalised and rounded once to the output type for B2,
// raw fp32 pv for B3) and the row statistics as coalesced rows.
// Deterministic: no atomics; every sum is taken in a fixed order.
//
// A block copies a key tile, then computes on it; another resident block's
// arithmetic covers its copies. Two K/V buffers, the next tile's copy in
// flight during this one's arithmetic, were measured at S = 512 and gained
// nothing, so a block keeps one.
//
// Masks: B2 masks `key <= row` (causal) by index; B3 by the keys' and
// queries' own global positions, staged with each tile, so shuffled
// positions hold. Ragged lengths are masked, never padded.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kTileRows = 64;  // rows of each side a block holds
constexpr int kThreads = 256;  // threads of a forward block: 4 per query row
constexpr int kMaxTilePairs = kTileRows / 4;  // pairs a block holds at most (R = 4)

// An operand tile is [kTileRows] rows of D + 4 floats, with 4 more floats after
// every 8 rows: the 8 rows 2 apart that one quarter-warp reads together then
// fall in different banks.
template <int D>
__device__ __forceinline__ int tile_row(int r) {
  return r * (D + 4) + (r / 8) * 4;
}

__host__ __device__ constexpr int tile_floats(int d, int rows = kTileRows) {
  return rows * (d + 4) + rows / 8 * 4;
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
               "r"(valid ? 16 : 0));  // 0 source bytes: the 16 bytes are zero-filled
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}


// The 16-bit input types (bfloat16, float16): a 16-byte piece of eight is
// widened to fp32 (times `mul`) on the way into a tile, and eight fp32 values
// are rounded once each into a piece on the way out.
template <typename T>
struct Narrow;
template <>
struct Narrow<__nv_bfloat16> {
  using Pair = __nv_bfloat162;
  static __device__ __forceinline__ float2 widen(Pair x) { return __bfloat1622float2(x); }
  static __device__ __forceinline__ Pair round(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
};
template <>
struct Narrow<__half> {
  using Pair = __half2;
  static __device__ __forceinline__ float2 widen(Pair x) { return __half22float2(x); }
  static __device__ __forceinline__ Pair round(float a, float b) { return __floats2half2_rn(a, b); }
};

template <typename T>
__device__ __forceinline__ void widen_piece(float* to, uint4 raw, float mul) {
  const typename Narrow<T>::Pair* h = reinterpret_cast<const typename Narrow<T>::Pair*>(&raw);
  const float2 a = Narrow<T>::widen(h[0]), b = Narrow<T>::widen(h[1]);
  const float2 c = Narrow<T>::widen(h[2]), e = Narrow<T>::widen(h[3]);
  reinterpret_cast<float4*>(to)[0] = make_float4(a.x * mul, a.y * mul, b.x * mul, b.y * mul);
  reinterpret_cast<float4*>(to)[1] = make_float4(c.x * mul, c.y * mul, e.x * mul, e.y * mul);
}

template <typename T>
__device__ __forceinline__ uint4 round_piece(const float* x) {
  __align__(16) typename Narrow<T>::Pair h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = Narrow<T>::round(x[2 * i], x[2 * i + 1]);
  return *reinterpret_cast<const uint4*>(h);
}

__device__ __forceinline__ float lane(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// The head dims the kernels are built for (kernels/flash_attention.py::HEAD_DIMS).
inline bool built_head_dim(int d) {
  return d == 8 || d == 16 || d == 32 || d == 64 || d == 128 || d == 256;
}

inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// ---------------------------------------------------------------- the forward core

struct ForwardShape {
  int batch, q_len, k_len, heads;
  int rows, log_rows;  // R rows of a pair per block (a power of two) and log2(R)
  int pairs;           // G = kTileRows / R pairs per block
  float scale;
  int causal;
  // q, k, v strides in elements: batch, seq, head (the head-dim stride is 1)
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;
};

// Fill the forward tiling; false when the shape is not one the kernels take.
inline bool make_forward_shape(ForwardShape* s, const long long* strides, int batch, int q_len,
                               int k_len, int heads, int head_dim, float scale, int causal) {
  if (batch <= 0 || q_len <= 0 || k_len <= 0 || heads <= 0) return false;
  if (!built_head_dim(head_dim)) return false;
  int rows = next_pow2(q_len > k_len ? q_len : k_len);
  // A thread's output tile is max(1, D / 16) rows of ONE pair (v_first), so a
  // pair must hold at least that many rows: R >= 8 at D = 128, 16 at D = 256
  // (the rows past the sequence are masked).
  const int min_rows = head_dim / 16 > 4 ? head_dim / 16 : 4;
  if (rows < min_rows) rows = min_rows;
  if (rows > kTileRows) rows = kTileRows;
  s->batch = batch;
  s->q_len = q_len;
  s->k_len = k_len;
  s->heads = heads;
  s->rows = rows;
  s->log_rows = 0;
  while ((1 << s->log_rows) < rows) ++s->log_rows;
  s->pairs = kTileRows / rows;
  s->scale = scale;
  s->causal = causal;
  s->qb = strides[0]; s->qs = strides[1]; s->qh = strides[2];
  s->kb = strides[3]; s->ks = strides[4]; s->kh = strides[5];
  s->vb = strides[6]; s->vs = strides[7]; s->vh = strides[8];
  return true;
}

// Dynamic shared-memory floats of one forward block: q (then the output), k
// and v tiles, and P ([kTileRows][R + 4]).
__host__ __device__ constexpr int forward_smem_floats(int d, int r) {
  return 3 * tile_floats(d) + kTileRows * (r + 4);
}

inline dim3 forward_grid(const ForwardShape& s) {
  const int num_pairs = s.batch * s.heads;
  return dim3((num_pairs + s.pairs - 1) / s.pairs, (s.q_len + s.rows - 1) / s.rows);
}

// Copy rows [r0, r0 + R) of each of the block's pairs (row `base[g] + row *
// row_stride` of pair g; rows at or past `len`, and pairs at or past
// `num_pairs`, zero) into an fp32 operand tile, one 16-byte piece a thread,
// neighbouring threads on neighbouring pieces of a row. bf16 and fp16 are
// widened and multiplied by `mul` on the way; fp32 goes by cp.async as it is (the caller
// scales it after the wait, `scale_tile`).
template <typename T, int D>
__device__ __forceinline__ void copy_tile(float* dst, const T* src, const long long* base,
                                          long long row_stride, int r0, int len, int num_pairs,
                                          const ForwardShape& s, float mul) {
  constexpr int kElems = 16 / sizeof(T);  // elements in a 16-byte piece
  constexpr int kPieces = D / kElems;     // pieces in a row
  for (int idx = threadIdx.x; idx < kTileRows * kPieces; idx += kThreads) {
    const int slot = idx / kPieces, piece = idx % kPieces;
    const int g = slot >> s.log_rows, row = r0 + (slot & (s.rows - 1));
    const bool valid = g < num_pairs && row < len;
    const T* from = valid ? src + base[g] + row * row_stride + piece * kElems : src;
    float* to = dst + tile_row<D>(slot) + piece * kElems;
    if constexpr (sizeof(T) == 4) {
      cp_async16(to, from, valid);
    } else {
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (valid) raw = __ldg(reinterpret_cast<const uint4*>(from));
      widen_piece<T>(to, raw, mul);
    }
  }
}

// Multiply the fp32 pieces this thread copied by `mul`, after its wait.
template <int D>
__device__ __forceinline__ void scale_tile(float* tile, float mul) {
  constexpr int kPieces = D / 4;
  for (int idx = threadIdx.x; idx < kTileRows * kPieces; idx += kThreads) {
    float4* x = reinterpret_cast<float4*>(tile + tile_row<D>(idx / kPieces)) + idx % kPieces;
    const float4 y = *x;
    *x = make_float4(y.x * mul, y.y * mul, y.z * mul, y.w * mul);
  }
}

// Write rows [r0, r0 + R) of each of the block's pairs of a contiguous
// [B, Sq, H, D] tensor from an fp32 tile (zeros when `src` is null), one
// 16-byte piece a thread, rounded once to OutT; rows at or past Sq and pairs
// at or past `num_pairs` are not written.
template <typename OutT, int D>
__device__ __forceinline__ void store_tile_rows(OutT* dst, const float* src, const long long* base,
                                                int r0, int num_pairs, const ForwardShape& s) {
  constexpr int kElems = 16 / sizeof(OutT);
  constexpr int kPieces = D / kElems;
  const long long row_stride = static_cast<long long>(s.heads) * D;
  for (int idx = threadIdx.x; idx < kTileRows * kPieces; idx += kThreads) {
    const int slot = idx / kPieces, piece = idx % kPieces;
    const int g = slot >> s.log_rows, row = r0 + (slot & (s.rows - 1));
    if (g >= num_pairs || row >= s.q_len) continue;
    OutT* to = dst + base[g] + row * row_stride + piece * kElems;
    float x[kElems];
#pragma unroll
    for (int i = 0; i < kElems; ++i) x[i] = src ? src[tile_row<D>(slot) + piece * kElems + i] : 0.f;
    if constexpr (sizeof(OutT) == 4) {
      *reinterpret_cast<float4*>(to) = make_float4(x[0], x[1], x[2], x[3]);
    } else {
      *reinterpret_cast<uint4*>(to) = round_piece<OutT>(x);
    }
  }
}

// Score tiles: kLanes neighbouring lanes share kLanes / 4 query rows, each
// lane a register tile of those rows by R / kLanes keys. Short sequences
// (R <= kSmallRows) take 4 lanes a row (1 x R/4 tiles); longer ones 16 lanes
// a group of 4 rows (4 x R/16 tiles: 8 shared-memory reads for 64 FMA).
constexpr int kSmallRows = 16;
constexpr int kMaxKeysPT = 4;  // keys of a score tile, at most
// Resident blocks an SM must hold: caps a thread's registers (64 for the short
// sequences, whose copies need many blocks in flight; 128 for the long). At
// D = 128 shared memory holds two short blocks or one long one an SM, and a
// thread keeps 32 accumulators: 128 and 255 registers. At D = 256 one block of
// either variant fills an SM's shared memory: 255 registers for both.
constexpr int kSmallMinBlocks = 4;
constexpr int kLargeMinBlocks = 2;

template <int kLanes, int D>
__host__ __device__ constexpr int min_blocks() {
  return D > 128 ? 1
         : D > 64 ? (kLanes == 4 ? 2 : 1)
                  : (kLanes == 4 ? kSmallMinBlocks : kLargeMinBlocks);
}


// The forward over one 64-row query tile of the block's pairs.
//   B2 (kChunk false): o = acc / l_safe in OutT = T; lse = m + log(l) (+inf
//   where l == 0) when `lse` is not null; masks by index.
//   B3 (kChunk true): raw pv, m (the finite proxy 0 on a row that saw no key)
//   and l, fp32; masks by q_pos / k_pos; a chunk wholly in the block's future
//   writes the proxy stats without reading q, K or V, and a key tile wholly
//   past the block's last query is skipped before its K/V are copied.
template <typename T, typename OutT, int D, bool kChunk, int kLanes>
__device__ __forceinline__ void forward_core(const T* __restrict__ q, const T* __restrict__ k,
                                             const T* __restrict__ v, const int* __restrict__ q_pos,
                                             const int* __restrict__ k_pos, OutT* __restrict__ o,
                                             float* __restrict__ lse, float* __restrict__ m_out,
                                             float* __restrict__ l_out, const ForwardShape& s) {
  constexpr int kRT = kLanes / 4;   // query rows of a score tile
  constexpr int kCols = D / 4;      // 4-wide column groups of a row
  // Output tiles: kRowsPT rows by 4 columns, each shared by kSplit neighbouring
  // lanes that take every kSplit-th group of 4 keys (4 x 4 tiles or taller for
  // long sequences: 8 shared-memory reads for 64 FMA).
  constexpr int kRowsPT = kLanes == 4 ? (D >= 16 ? D / 16 : 1) : (D >= 64 ? D / 16 : 4);
  constexpr int kSplit = kThreads / (kTileRows / kRowsPT * kCols);
  static_assert(kTileRows / kRT * kLanes == kThreads, "one score tile a thread");
  static_assert(kSplit * (kTileRows / kRowsPT * kCols) == kThreads, "a tile's share a thread");

  extern __shared__ __align__(16) float smem[];
  const int R = s.rows;
  const int stride_p = R + 4;  // P rows, padded so 4 rows 2 apart fall in different banks
  float* q_s = smem;  // q scaled, then the output tile
  float* k_s = q_s + tile_floats(D);
  float* v_s = k_s + tile_floats(D);
  float* p_s = v_s + tile_floats(D);
  __shared__ long long q_base[kMaxTilePairs], k_base[kMaxTilePairs], v_base[kMaxTilePairs];
  __shared__ long long o_base[kMaxTilePairs];
  __shared__ float alpha_s[kTileRows], m_s[kTileRows], l_s[kTileRows];
  __shared__ int last_s[kTileRows];  // one past the last key a row sees in this tile
  __shared__ int qpos_s[kTileRows], kpos_s[kTileRows];
  __shared__ int red_s[2][kThreads / 32];

  const int tid = threadIdx.x;
  const int first_pair = blockIdx.x * s.pairs;
  const int num_pairs = min(s.pairs, s.batch * s.heads - first_pair);
  // Causal walks are uneven: the query tiles with the most key tiles go first.
  const int query_tile = s.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = query_tile * R;

  if (tid < num_pairs) {
    const int pair = first_pair + tid, b = pair / s.heads, h = pair % s.heads;
    q_base[tid] = b * s.qb + h * s.qh;
    k_base[tid] = b * s.kb + h * s.kh;
    v_base[tid] = b * s.vb + h * s.vh;
    o_base[tid] = (static_cast<long long>(b) * s.q_len * s.heads + h) * D;
  }
  if (tid < kTileRows) {
    const int row = q0 + (tid & (R - 1));
    const bool valid = (tid >> s.log_rows) < num_pairs && row < s.q_len;
    if constexpr (kChunk) qpos_s[tid] = valid ? q_pos[row] : INT_MIN;
    else qpos_s[tid] = valid ? row : INT_MIN;
  }
  __syncthreads();

  const int warp = tid / 32, lane_id = tid % 32;
  int q_max = INT_MAX;  // the block's largest query position (B3, causal)
  if constexpr (kChunk) {
    if (s.causal) {
      // The block's largest query position and the chunk's smallest key
      // position, by shuffles and one pass through shared memory.
      int k_min = INT_MAX;
      for (int j = tid; j < s.k_len; j += kThreads) k_min = min(k_min, k_pos[j]);
      int hi = tid < kTileRows ? qpos_s[tid] : INT_MIN;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        k_min = min(k_min, __shfl_xor_sync(0xffffffffu, k_min, off));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
      }
      if (lane_id == 0) {
        red_s[0][warp] = k_min;
        red_s[1][warp] = hi;
      }
      __syncthreads();
      k_min = INT_MAX;
      q_max = INT_MIN;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) {
        k_min = min(k_min, red_s[0][w]);
        q_max = max(q_max, red_s[1][w]);
      }
      if (k_min > q_max) {  // the whole chunk is in the block's future
        store_tile_rows<OutT, D>(o, nullptr, o_base, q0, num_pairs, s);
        if (tid < kTileRows && qpos_s[tid] != INT_MIN) {
          const long long stat = static_cast<long long>(first_pair + (tid >> s.log_rows)) *
                                     s.q_len + q0 + (tid & (R - 1));
          m_out[stat] = 0.f;  // the finite proxy of an empty row
          l_out[stat] = 0.f;
        }
        return;
      }
    }
  }

  // q goes out with the first key tile's K and V: one wait for the three.
  copy_tile<T, D>(q_s, q, q_base, s.qs, q0, s.q_len, num_pairs, s, s.scale);
  bool q_scaled = sizeof(T) != 4;  // bf16 and fp16 are scaled on the way in

  // Score role: rows slot0 .. slot0 + kRT - 1 by keys key0 .. key0 + keys_pt - 1.
  const int part = tid % kLanes, slot0 = tid / kLanes * kRT;
  const int keys_pt = R / kLanes, key0 = part * keys_pt;
  const int k_first = (slot0 >> s.log_rows) * R + key0;  // its first key's row in k_s
  float m[kRT], l[kRT];
#pragma unroll
  for (int r = 0; r < kRT; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  // Output role: kRowsPT rows by 4 columns of the accumulator, keys split kSplit ways.
  const int split = tid % kSplit, micro = tid / kSplit;
  const int col = micro % kCols, out_slot0 = micro / kCols * kRowsPT;
  const int v_first = (out_slot0 >> s.log_rows) * R;
  float acc[kRowsPT][4];
#pragma unroll
  for (int r = 0; r < kRowsPT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  const int row_end = min(s.q_len, q0 + R);  // one past the tile's last query row
  const int key_tiles = !kChunk && s.causal ? (row_end - 1) / R + 1 : (s.k_len + R - 1) / R;
  // The first key tile at or after `tile` that the block's queries can see
  // (B3, causal: a tile whose smallest position is past the block's last
  // query is skipped before its K/V are copied). Each warp reads the tile's
  // positions itself, so every warp takes the same tiles.
  auto next_tile = [&](int tile) {
    if constexpr (kChunk) {
      for (; s.causal && tile < key_tiles; ++tile) {
        const int k0 = tile * R;
        int tile_min = INT_MAX;
        for (int j = lane_id; j < R && k0 + j < s.k_len; j += 32)
          tile_min = min(tile_min, k_pos[k0 + j]);
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          tile_min = min(tile_min, __shfl_xor_sync(0xffffffffu, tile_min, off));
        if (tile_min <= q_max) break;
      }
    }
    return tile;
  };
  for (int key_tile = next_tile(0); key_tile < key_tiles; key_tile = next_tile(key_tile + 1)) {
    const int k0 = key_tile * R;
    copy_tile<T, D>(k_s, k, k_base, s.ks, k0, s.k_len, num_pairs, s, 1.f);
    copy_tile<T, D>(v_s, v, v_base, s.vs, k0, s.k_len, num_pairs, s, 1.f);
    if constexpr (kChunk) {
      if (tid < R) kpos_s[tid] = k0 + tid < s.k_len ? k_pos[k0 + tid] : INT_MAX;
    }
    cp_async_wait_all();  // the first time, q's pieces too
    if (!q_scaled) {
      scale_tile<D>(q_s, s.scale);
      q_scaled = true;
    }
    __syncthreads();

    {  // scores, the rows' max and sum, P
      unsigned mask[kRT];  // the keys of this tile each row sees
      unsigned any = 0u;
#pragma unroll
      for (int r = 0; r < kRT; ++r) {
        const int q_row_pos = qpos_s[slot0 + r];
        mask[r] = 0u;
#pragma unroll
        for (int j = 0; j < kMaxKeysPT; ++j) {
          if (j < keys_pt) {
            const int key = key0 + j;
            const int pos = kChunk ? kpos_s[key] : k0 + key;
            const bool seen = k0 + key < s.k_len && (!s.causal || pos <= q_row_pos);
            mask[r] |= static_cast<unsigned>(seen) << j;
          }
        }
        any |= mask[r];
      }
      float sc[kRT][kMaxKeysPT];
#pragma unroll
      for (int r = 0; r < kRT; ++r)
#pragma unroll
        for (int j = 0; j < kMaxKeysPT; ++j) sc[r][j] = 0.f;
      if (any != 0u) {
#pragma unroll 2
        for (int d4 = 0; d4 < D / 4; ++d4) {
          float4 a[kRT];
#pragma unroll
          for (int r = 0; r < kRT; ++r)
            a[r] = reinterpret_cast<const float4*>(q_s + tile_row<D>(slot0 + r))[d4];
#pragma unroll
          for (int j = 0; j < kMaxKeysPT; ++j) {
            if (j < keys_pt) {
              const float4 b = reinterpret_cast<const float4*>(k_s + tile_row<D>(k_first + j))[d4];
#pragma unroll
              for (int r = 0; r < kRT; ++r) sc[r][j] = dot4(a[r], b, sc[r][j]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRT; ++r) {
        float m_tile = -INFINITY;
#pragma unroll
        for (int j = 0; j < kMaxKeysPT; ++j)
          if ((mask[r] >> j) & 1u) m_tile = fmaxf(m_tile, sc[r][j]);
#pragma unroll
        for (int off = 1; off < kLanes; off *= 2)
          m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, off));
        const float m_new = fmaxf(m[r], m_tile);
        const float m_safe = m_new == -INFINITY ? 0.f : m_new;
        float p_sum = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxKeysPT; ++j) {
          sc[r][j] = (mask[r] >> j) & 1u ? expf(sc[r][j] - m_safe) : 0.f;
          p_sum += sc[r][j];
        }
#pragma unroll
        for (int off = 1; off < kLanes; off *= 2)
          p_sum += __shfl_xor_sync(0xffffffffu, p_sum, off);
        const float alpha = m[r] == -INFINITY ? 0.f : expf(m[r] - m_safe);
        l[r] = l[r] * alpha + p_sum;
        m[r] = m_new;
        float* p_row = p_s + (slot0 + r) * stride_p + key0;
        if (keys_pt == 4) {
          *reinterpret_cast<float4*>(p_row) = make_float4(sc[r][0], sc[r][1], sc[r][2], sc[r][3]);
        } else {
#pragma unroll
          for (int j = 0; j < kMaxKeysPT; ++j)
            if (j < keys_pt) p_row[j] = sc[r][j];
        }
        int last = mask[r] ? key0 + 32 - __clz(mask[r]) : 0;
#pragma unroll
        for (int off = 1; off < kLanes; off *= 2)
          last = max(last, __shfl_xor_sync(0xffffffffu, last, off));
        if (part == 0) {
          alpha_s[slot0 + r] = alpha;
          last_s[slot0 + r] = last;
        }
      }
    }
    __syncthreads();

    {  // acc = acc.alpha + P.V over the keys this thread's rows see
      int key_end = 0;
#pragma unroll
      for (int r = 0; r < kRowsPT; ++r) {
        const float a = alpha_s[out_slot0 + r];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] *= a;
        key_end = max(key_end, last_s[out_slot0 + r]);
      }
      for (int j = 4 * split; j < key_end; j += 4 * kSplit) {
        float4 p[kRowsPT];
#pragma unroll
        for (int r = 0; r < kRowsPT; ++r)
          p[r] = *reinterpret_cast<const float4*>(p_s + (out_slot0 + r) * stride_p + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 b =
              reinterpret_cast<const float4*>(v_s + tile_row<D>(v_first + j + jj))[col];
#pragma unroll
          for (int r = 0; r < kRowsPT; ++r) {
            const float x = lane(p[r], jj);
            acc[r][0] = fmaf(x, b.x, acc[r][0]);
            acc[r][1] = fmaf(x, b.y, acc[r][1]);
            acc[r][2] = fmaf(x, b.z, acc[r][2]);
            acc[r][3] = fmaf(x, b.w, acc[r][3]);
          }
        }
      }
    }
    __syncthreads();  // this tile's K, V, P and positions are consumed
  }
  cp_async_wait_all();  // q's pieces, had no key tile been walked

  // Epilogue: the rows' statistics, then the accumulator through q_s (the
  // kSplit partial sums added by shuffles in a fixed order).
#pragma unroll
  for (int lanes = 1; lanes < kSplit; lanes *= 2)
#pragma unroll
    for (int r = 0; r < kRowsPT; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], lanes);
  if (part == 0) {
#pragma unroll
    for (int r = 0; r < kRT; ++r) {
      m_s[slot0 + r] = m[r];
      l_s[slot0 + r] = l[r];
    }
  }
  __syncthreads();  // q_s is read no more; m_s, l_s are in place
  if (split == 0) {
#pragma unroll
    for (int r = 0; r < kRowsPT; ++r) {
      float out[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) out[c] = acc[r][c];
      if constexpr (!kChunk) {
        const float row_l = l_s[out_slot0 + r];
        const float l_safe = row_l == 0.f ? 1.f : row_l;
#pragma unroll
        for (int c = 0; c < 4; ++c) out[c] = out[c] / l_safe;
      }
      reinterpret_cast<float4*>(q_s + tile_row<D>(out_slot0 + r))[col] =
          make_float4(out[0], out[1], out[2], out[3]);
    }
  }
  if (tid < kTileRows && qpos_s[tid] != INT_MIN) {
    const long long stat = static_cast<long long>(first_pair + (tid >> s.log_rows)) * s.q_len +
                           q0 + (tid & (R - 1));
    const float row_m = m_s[tid], row_l = l_s[tid];
    if constexpr (kChunk) {
      m_out[stat] = row_m == -INFINITY ? 0.f : row_m;  // the finite proxy of an empty row
      l_out[stat] = row_l;
    } else if (lse != nullptr) {
      lse[stat] = row_l == 0.f ? INFINITY : row_m + logf(row_l);
    }
  }
  __syncthreads();
  store_tile_rows<OutT, D>(o, q_s, o_base, q0, num_pairs, s);
}

// Launch `kernel` for a shape: the variant for short sequences when R <=
// kSmallRows, else the one for long ones; each opts in to its largest block's
// dynamic shared memory once (above 48 KiB from D = 64). A failure is left for
// cudaGetLastError() to report, and retried next call.
template <int D, typename Kernel, typename... Args>
void launch_forward(Kernel small, Kernel large, bool (&opted)[2], const ForwardShape& s,
                    cudaStream_t stream, Args... args) {
  const int variant = s.rows <= kSmallRows ? 0 : 1;
  const Kernel kernel = variant == 0 ? small : large;
  if (!opted[variant]) {
    const int rows = variant == 0 ? kSmallRows : kTileRows;
    const int most = forward_smem_floats(D, rows) * sizeof(float);
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most) !=
        cudaSuccess)
      return;
    opted[variant] = true;
  }
  const size_t smem = forward_smem_floats(D, s.rows) * sizeof(float);
  kernel<<<forward_grid(s), kThreads, smem, stream>>>(args..., s);
}

// Calls LAUNCH<T, D>(args...) for the runtime dtype code (0 float32, 1 bfloat16,
// 2 float16) and head dim; returns cudaErrorInvalidValue for anything else.
#define DISPATCH_HEAD_DIM(LAUNCH, T, HEAD_DIM, ...)                                \
  switch (HEAD_DIM) {                                                              \
    case 8: LAUNCH<T, 8>(__VA_ARGS__); break;                                      \
    case 16: LAUNCH<T, 16>(__VA_ARGS__); break;                                    \
    case 32: LAUNCH<T, 32>(__VA_ARGS__); break;                                    \
    case 64: LAUNCH<T, 64>(__VA_ARGS__); break;                                    \
    case 128: LAUNCH<T, 128>(__VA_ARGS__); break;                                  \
    case 256: LAUNCH<T, 256>(__VA_ARGS__); break;                                  \
    default: return static_cast<int>(cudaErrorInvalidValue);                       \
  }
#define DISPATCH(LAUNCH, DTYPE, HEAD_DIM, ...)                                     \
  do {                                                                             \
    if ((DTYPE) == 0) {                                                            \
      DISPATCH_HEAD_DIM(LAUNCH, float, HEAD_DIM, __VA_ARGS__)                      \
    } else if ((DTYPE) == 1) {                                                     \
      DISPATCH_HEAD_DIM(LAUNCH, __nv_bfloat16, HEAD_DIM, __VA_ARGS__)              \
    } else if ((DTYPE) == 2) {                                                     \
      DISPATCH_HEAD_DIM(LAUNCH, __half, HEAD_DIM, __VA_ARGS__)                     \
    } else {                                                                       \
      return static_cast<int>(cudaErrorInvalidValue);                              \
    }                                                                              \
  } while (0)

}  // namespace
