// Flash attention for Hopper (sm_90a): a forward kernel and a fused backward
// kernel, over [B, S, H, D] self-attention (queries and keys share S).
//
//     o = softmax(q * scale . k^T) . v,     scale = D^-1/2,     optional causal mask
//
// Replaces the Pallas TPU kernel stoix_tpu/ops/pallas_attention.py::flash_attention
// (body `_flash_kernel`, fold `_fold_block`). That kernel holds one (batch, head)'s
// K/V whole in VMEM, pads S to its 128-row blocks and walks K/V blocks in a
// sequential grid. The TPU kernel has no backward (no custom VJP); the backward
// here is the port's own, held against jax.grad of the JAX package's
// `full_attention`.
//
// Forward (the shared core, csrc/flash_forward.cuh): a block holds 64 query
//   rows (4 pairs at S = 16), copies q, K and V as 16-byte coalesced pieces
//   into padded fp32 tiles, scores each row in register tiles shared by 4
//   lanes whose max and sum are taken by shuffles, folds the online softmax
//   per key tile of R keys (64 past S = 64) as `_fold_block` folds a block,
//   keeps the output as register tiles and stores it through shared memory.
//   Ragged S is masked, never padded; a causal block stops at the key tile of
//   its last query (`_flash_kernel`'s bound), and the query tiles with the
//   most key tiles are launched first. `l_safe = 1` where l == 0, and one
//   rounding to the output type. expf, not __expf. When a gradient is needed
//   the forward also writes lse = m + log(l) ([B, H, S] fp32; +inf where
//   l == 0, so P = 0 there).
//
// Backward, one launch for dQ, dK and dV (recompute from lse, deterministic,
// no atomics):
//     delta = rowsum(dO.O),  P = exp(q.k^T.scale - lse),  dS = P.(dO.v^T - delta),
//     dV = P^T.dO,  dK = scale.dS^T.q,  dQ = scale.dS.k
//   A block holds N = bwd_rows(D) rows of each side (64; 32 at D = 256, where
//   five 64-row fp32 operand tiles, 333 KiB, would outgrow a block's 227 KiB):
//   G pairs of R rows, R the next power of two >= S (at least 4, at most N),
//   G = N / R. A block owns
//   one key tile of its pairs (K and V resident) and walks the query tiles that
//   can see it (from the key tile on, when causal). For each query tile it
//     1. copies q, o, dO rows (and lse) into shared memory, 16 bytes a thread,
//        neighbouring threads on neighbouring pieces of a row (cp.async for
//        fp32; bf16 and fp16 widened to fp32 on the way);
//     2. forms delta from shared memory (no trip through device memory), 256 / N
//        threads a row;
//     3. forms the R x R scores of each pair once, a thread per 2 x 2 tile of
//        (query, key), and from them P and dS once, masked by position;
//     4. forms dV and dK (accumulated over query tiles in registers), each
//        thread a 4 x 4 tile of (key, d) outputs, and this tile's dQ, a 4 x 4
//        tile of (query, d) outputs shared by 64 / D neighbouring threads and
//        summed by shuffles;
//     5. writes dQ out through shared memory as 16-byte coalesced stores.
//   dK and dV go out the same way after the walk. With one key tile per pair
//   (every S <= N, the path's S = 16) dQ is written as it is; with several,
//   each key tile writes its fp32 dQ partial to its own slice of a
//   [tiles, B, S, H, D] scratch buffer, which the wrapper sums in a fixed order.
//   At S <= N each operand is read once and each output written once. At
//   D = 256 (N = 32) a thread's work is D = 128's: 16 dV and 16 dK tiles and
//   2 dQ tiles of 4 x 4, in 171 KiB of shared memory, one block an SM.
//
// What the design does about the two-kernel backward it replaces: every global
// load and store is a 16-byte piece of a row, coalesced across the warp (no
// thread walks a row by itself); P and dS are computed once, not once per
// kernel, and delta never leaves the block (13 passes over a [B, S, H, D]
// operand become 8); a thread keeps 16 fp32 accumulators at D <= 32 (32 at
// D = 64, 64 at D >= 128) across query tiles, not 4.D row registers, and is
// capped at 80 registers so three blocks share an SM (D >= 128: one block an SM,
// uncapped); the causal walk skips query tiles
// before the key tile, score tiles above the diagonal are skipped, and on the
// diagonal tile each 4 x 4 product starts (dK, dV) or stops (dQ) at its own
// diagonal, so no lane idles on masked rows of a staged tile. Rows are padded
// and skewed in shared memory so that the rows a quarter-warp reads together
// fall in different banks.
//
// Bound: bytes. At [4096, 16, 4, 32] float32 causal the backward must read q,
// k, v, o, dO and lse and write dQ, dK, dV: 269 484 032 bytes, 0.0804 ms at
// 3.35 TB/s; its 0.73 GFLOP take 0.011 ms at 67 TFLOP/s (2.7 flops per byte).
// Arithmetic stays fp32 FMA on the CUDA cores (no tensor cores: TF32 would miss
// the 1e-5 parity every check holds).
//
// Bound of the forward: bytes. At [4096, 16, 4, 32] float32 causal it must read
// q, k, v and write o: 134 217 728 bytes, 0.0401 ms at 3.35 TB/s, against
// 0.29 GFLOP (0.0043 ms at 67 TFLOP/s).
//
// Types: q, k, v (and o, dO, dQ, dK, dV) float32, bfloat16 or float16, head
// dims 8, 16, 32, 64, 128 and 256; arithmetic in fp32, one rounding per output.
//
// Layout: q, k and v are taken by strides (batch, seq, head; the last dim
// contiguous), so the three views of a fused [B, S, 3, H, D] projection go in
// as they are. o, dO, dQ, dK, dV are contiguous [B, S, H, D]; lse contiguous
// [B, H, S]. Both kernels need every row of q, k, v (and o, dO) 16-byte aligned.
//
// Plain C interface, bound from Python with ctypes. Each entry point launches
// on the given stream and returns cudaGetLastError() (0 on success).

#include "flash_forward.cuh"

namespace {

// Rows of each side a backward block holds: 64, or 32 at D = 256, whose five
// operand tiles would otherwise outgrow a block's shared memory.
__host__ __device__ constexpr int bwd_rows(int d) { return d > 128 ? 32 : kTileRows; }
constexpr int kBwdThreads = kThreads;  // threads per backward block: 4 a row (8 at D = 256)
// Backward blocks an SM must hold at once: caps a thread at 80 registers, so
// that one block's copies overlap another's arithmetic. At D = 128 one block
// fills an SM's shared memory (198 KiB; 171 KiB at D = 256) and a thread keeps
// 64 accumulators.
template <int D>
__host__ __device__ constexpr int bwd_min_blocks() {
  return D > 64 ? 1 : 3;
}

struct Shape {
  int batch, seq, heads;
  int rows;   // rows of one pair per block (a power of two)
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

// ---------------------------------------------------------------- forward

template <typename T, int D, int kLanes>
__global__ void __launch_bounds__(kThreads, min_blocks<kLanes, D>())
flash_forward_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse, ForwardShape s) {
  forward_core<T, T, D, false, kLanes>(q, k, v, nullptr, nullptr, o, lse, nullptr, nullptr, s);
}

// ---------------------------------------------------------------- backward (fused)

// Shared-memory floats of one backward block: five operand tiles (q, k, v, o,
// dO) of bwd_rows(d) rows, P and dS ([bwd_rows(d)][R]), lse and delta.
__host__ __device__ constexpr int bwd_smem_floats(int d, int r) {
  return 5 * tile_floats(d, bwd_rows(d)) + 2 * bwd_rows(d) * r + 2 * bwd_rows(d);
}

// Copy rows [r0, r0 + R) of each of the block's pairs from a [B, S, H, D]
// tensor (strides sb, ss, sh; the head dim contiguous) into an fp32 operand
// tile, one 16-byte piece a thread, neighbouring threads on neighbouring
// pieces of a row. Rows past S or past the last pair are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long sb, long long ss,
                                          long long sh, int first_pair, int r0, const Shape& s) {
  constexpr int kElems = 16 / sizeof(T);  // elements in a 16-byte piece
  constexpr int kPieces = D / kElems;     // pieces in a row
  const int num_pairs = s.batch * s.heads;
  for (int idx = threadIdx.x; idx < bwd_rows(D) * kPieces; idx += kBwdThreads) {
    const int slot = idx / kPieces, piece = idx % kPieces;
    const int pair = first_pair + slot / s.rows, row = r0 + slot % s.rows;
    const bool valid = pair < num_pairs && row < s.seq;
    const T* from = valid ? src + qkv_offset(sb, ss, sh, pair, row, s.heads) + piece * kElems : src;
    float* to = dst + tile_row<D>(slot) + piece * kElems;
    if constexpr (sizeof(T) == 4) {
      cp_async16(to, from, valid);
    } else {
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (valid) raw = __ldg(reinterpret_cast<const uint4*>(from));
      widen_piece<T>(to, raw, 1.f);
    }
  }
}

// Write an fp32 operand tile out as rows [r0, r0 + R) of the block's pairs of
// a contiguous [B, S, H, D] tensor, one 16-byte piece a thread, rounded once to
// OutT; rows past S or past the last pair are not written.
template <typename OutT, int D>
__device__ __forceinline__ void store_tile(OutT* dst, const float* src, int first_pair, int r0,
                                           const Shape& s) {
  constexpr int kElems = 16 / sizeof(OutT);
  constexpr int kPieces = D / kElems;
  const int num_pairs = s.batch * s.heads;
  for (int idx = threadIdx.x; idx < bwd_rows(D) * kPieces; idx += kBwdThreads) {
    const int slot = idx / kPieces, piece = idx % kPieces;
    const int pair = first_pair + slot / s.rows, row = r0 + slot % s.rows;
    if (pair >= num_pairs || row >= s.seq) continue;
    const float* from = src + tile_row<D>(slot) + piece * kElems;
    OutT* to = dst + row_offset(pair, row, s, D) + piece * kElems;
    if constexpr (sizeof(OutT) == 4) {
      *reinterpret_cast<float4*>(to) = *reinterpret_cast<const float4*>(from);
    } else {
      *reinterpret_cast<uint4*>(to) = round_piece<OutT>(from);
    }
  }
}

// acc[r][c] += a[r] * b[c]
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float4& a, const float4& b) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float x = lane(a, r);
    acc[r][0] = fmaf(x, b.x, acc[r][0]);
    acc[r][1] = fmaf(x, b.y, acc[r][1]);
    acc[r][2] = fmaf(x, b.z, acc[r][2]);
    acc[r][3] = fmaf(x, b.w, acc[r][3]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads, bwd_min_blocks<D>())
flash_backward_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ o, const T* __restrict__ dout,
                      const float* __restrict__ lse, T* __restrict__ dq,
                      float* __restrict__ dq_partial, T* __restrict__ dk, T* __restrict__ dv,
                      Shape s) {
  constexpr int kRows = bwd_rows(D);               // rows of each side
  constexpr int kDg = D / 4;                        // 4-wide column groups
  constexpr int kMicro = kRows / 4 * kDg;           // 4 x 4 tiles of one [kRows, D] output
  constexpr int kKvPerThread = (2 * kMicro + kBwdThreads - 1) / kBwdThreads;  // dV, dK tiles
  // dQ tiles: kQSplit threads share one (D <= 64), or a thread takes kQTiles (D >= 128).
  constexpr int kQSplit = kMicro < kBwdThreads ? kBwdThreads / kMicro : 1;
  constexpr int kQTiles = kMicro < kBwdThreads ? 1 : kMicro / kBwdThreads;
  constexpr int kDeltaLanes = kBwdThreads / kRows;  // threads summing one row's delta
  constexpr int kDeltaCols = D / kDeltaLanes;       // columns each of them sums
  static_assert(kDeltaLanes * kRows == kBwdThreads, "delta takes whole rows of threads");
  static_assert(kQSplit * kMicro == kBwdThreads * kQTiles, "every dQ tile is taken once");

  extern __shared__ __align__(16) float smem[];
  const int R = s.rows;
  constexpr int kTile = tile_floats(D, kRows);
  float* q_s = smem;
  float* k_s = q_s + kTile;
  float* v_s = k_s + kTile;
  float* o_s = v_s + kTile;  // o, then this query tile's dQ
  float* do_s = o_s + kTile;
  float* p_s = do_s + kTile;        // [kRows][R]: P of (query slot, key)
  float* ds_s = p_s + kRows * R;    // dS, likewise
  float* lse_s = ds_s + kRows * R;
  float* delta_s = lse_s + kRows;

  const int first_pair = blockIdx.x * s.pairs;
  const int num_pairs = s.batch * s.heads;
  const int key_tile = blockIdx.y;
  const int k0 = key_tile * R;
  const int tiles = gridDim.y;
  const long long row_stride = static_cast<long long>(s.heads) * D;  // contiguous o, dO

  load_tile<T, D>(k_s, k, s.kb, s.ks, s.kh, first_pair, k0, s);
  load_tile<T, D>(v_s, v, s.vb, s.vs, s.vh, first_pair, k0, s);

  float kv[kKvPerThread][4][4];  // dV then dK tiles, summed over query tiles
#pragma unroll
  for (int n = 0; n < kKvPerThread; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[n][r][c] = 0.f;

  for (int query_tile = s.causal ? key_tile : 0; query_tile < tiles; ++query_tile) {
    const int q0 = query_tile * R;
    const bool diagonal = s.causal && query_tile == key_tile;
    __syncthreads();  // the previous tile's dQ is out of o_s
    load_tile<T, D>(q_s, q, s.qb, s.qs, s.qh, first_pair, q0, s);
    load_tile<T, D>(o_s, o, s.seq * row_stride, row_stride, D, first_pair, q0, s);
    load_tile<T, D>(do_s, dout, s.seq * row_stride, row_stride, D, first_pair, q0, s);
    for (int slot = threadIdx.x; slot < kRows; slot += kBwdThreads) {
      const int pair = first_pair + slot / R, row = q0 + slot % R;
      lse_s[slot] = pair < num_pairs && row < s.seq ? lse[stat_offset(pair, row, s)] : INFINITY;
    }
    cp_async_wait_all();
    __syncthreads();

    {  // delta = rowsum(dO.o), kDeltaLanes threads a row
      const int slot = threadIdx.x / kDeltaLanes, part = threadIdx.x % kDeltaLanes;
      const float* a = do_s + tile_row<D>(slot) + part * kDeltaCols;
      const float* b = o_s + tile_row<D>(slot) + part * kDeltaCols;
      float sum = 0.f;
#pragma unroll
      for (int d = 0; d < kDeltaCols; ++d) sum = fmaf(a[d], b[d], sum);
#pragma unroll
      for (int lanes = 1; lanes < kDeltaLanes; lanes *= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, lanes);
      if (part == 0) delta_s[slot] = sum;
    }
    __syncthreads();

    // P and dS, once per (query, key) of each pair: a thread per 2 x 2 tile of
    // them (2 queries by 2 keys of one pair; neighbouring threads on
    // neighbouring keys). Tiles inside a 4 x 4 block wholly above the causal
    // diagonal are skipped: no product below reads them.
    const int side = R / 2;  // 2 x 2 tiles along a pair's side
    for (int idx = threadIdx.x; idx < kRows / 2 * side; idx += kBwdThreads) {
      const int slot0 = idx / side * 2, key0 = idx % side * 2;  // first query slot, first key
      const int first = slot0 / R * R, query0 = slot0 % R;      // the pair's first slot
      if (diagonal && key0 / 4 > query0 / 4) continue;
      float sc[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      const float* q_rows[2] = {q_s + tile_row<D>(slot0), q_s + tile_row<D>(slot0 + 1)};
      const float* do_rows[2] = {do_s + tile_row<D>(slot0), do_s + tile_row<D>(slot0 + 1)};
      const float* k_rows[2] = {k_s + tile_row<D>(first + key0), k_s + tile_row<D>(first + key0 + 1)};
      const float* v_rows[2] = {v_s + tile_row<D>(first + key0), v_s + tile_row<D>(first + key0 + 1)};
#pragma unroll 2
      for (int d4 = 0; d4 < kDg; ++d4) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float4 a = reinterpret_cast<const float4*>(q_rows[r])[d4];
          const float4 g = reinterpret_cast<const float4*>(do_rows[r])[d4];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            sc[r][c] = dot4(a, reinterpret_cast<const float4*>(k_rows[c])[d4], sc[r][c]);
            dp[r][c] = dot4(g, reinterpret_cast<const float4*>(v_rows[c])[d4], dp[r][c]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int slot = slot0 + r, query = q0 + query0 + r;
        const float row_lse = lse_s[slot], row_delta = delta_s[slot];
        float p[2], ds[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = k0 + key0 + c;
          const bool valid = query < s.seq && key < s.seq && (!s.causal || key <= query);
          p[c] = valid ? expf(sc[r][c] * s.scale - row_lse) : 0.f;
          ds[c] = p[c] * (dp[r][c] - row_delta);
        }
        *reinterpret_cast<float2*>(p_s + slot * R + key0) = make_float2(p[0], p[1]);
        *reinterpret_cast<float2*>(ds_s + slot * R + key0) = make_float2(ds[0], ds[1]);
      }
    }
    __syncthreads();

    // dV += P^T.dO and dK += dS^T.q over this tile's queries: a thread's tiles
    // are 4 keys of one pair by 4 columns, kept in registers across query
    // tiles; on the diagonal the sum starts at the tile's first key.
#pragma unroll
    for (int n = 0; n < kKvPerThread; ++n) {
      const int task = threadIdx.x + n * kBwdThreads;
      if (task < 2 * kMicro) {
        const int kind = task / kMicro, micro = task % kMicro;
        const int row0 = micro / kDg * 4, dg = micro % kDg;
        const int first = row0 / R * R, local0 = row0 % R;
        const float* w = kind == 0 ? p_s : ds_s;
        const float* x = kind == 0 ? do_s : q_s;
        for (int i = diagonal ? local0 : 0; i < R; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(w + (first + i) * R + local0);
          const float4 b = reinterpret_cast<const float4*>(x + tile_row<D>(first + i))[dg];
          outer4(kv[n], a, b);
        }
      }
    }

    // dQ = scale.dS.k over the key tile: kQSplit neighbouring threads share a
    // tile of 4 queries by 4 columns, each summing every kQSplit-th group of 4
    // keys (on the diagonal, up to the tile's last query); their sums are added
    // by shuffles in a fixed order; at D >= 128 a thread takes kQTiles tiles in turn.
    for (int tile = 0; tile < kQTiles; ++tile) {
      const int micro = threadIdx.x / kQSplit + tile * (kBwdThreads / kQSplit);
      const int part = threadIdx.x % kQSplit;
      const int row0 = micro / kDg * 4, dg = micro % kDg;
      const int first = row0 / R * R, local0 = row0 % R;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      const int key_end = diagonal ? local0 + 4 : R;
      for (int j = part * 4; j < key_end; j += 4 * kQSplit) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 b = reinterpret_cast<const float4*>(k_s + tile_row<D>(first + j + jj))[dg];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float x = ds_s[(row0 + r) * R + j + jj];
            acc[r][0] = fmaf(x, b.x, acc[r][0]);
            acc[r][1] = fmaf(x, b.y, acc[r][1]);
            acc[r][2] = fmaf(x, b.z, acc[r][2]);
            acc[r][3] = fmaf(x, b.w, acc[r][3]);
          }
        }
      }
#pragma unroll
      for (int lanes = 1; lanes < kQSplit; lanes *= 2)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], lanes);
      if (part == 0) {
#pragma unroll
        for (int r = 0; r < 4; ++r)  // o_s is free: delta has been formed
          reinterpret_cast<float4*>(o_s + tile_row<D>(row0 + r))[dg] =
              make_float4(acc[r][0] * s.scale, acc[r][1] * s.scale, acc[r][2] * s.scale,
                          acc[r][3] * s.scale);
      }
    }
    __syncthreads();
    if (tiles == 1) {
      store_tile<T, D>(dq, o_s, first_pair, q0, s);
    } else {
      const long long slice = static_cast<long long>(num_pairs) * s.seq * D;
      store_tile<float, D>(dq_partial + key_tile * slice, o_s, first_pair, q0, s);
    }
  }

  // dV and dK through v_s and k_s (last read before the barrier above).
#pragma unroll
  for (int n = 0; n < kKvPerThread; ++n) {
    const int task = threadIdx.x + n * kBwdThreads;
    if (task < 2 * kMicro) {
      const int kind = task / kMicro, micro = task % kMicro;
      const int row0 = micro / kDg * 4, dg = micro % kDg;
      float* out = kind == 0 ? v_s : k_s;
      const float mul = kind == 0 ? 1.f : s.scale;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        reinterpret_cast<float4*>(out + tile_row<D>(row0 + r))[dg] =
            make_float4(kv[n][r][0] * mul, kv[n][r][1] * mul, kv[n][r][2] * mul,
                        kv[n][r][3] * mul);
    }
  }
  __syncthreads();
  store_tile<T, D>(dk, k_s, first_pair, k0, s);
  store_tile<T, D>(dv, v_s, first_pair, k0, s);
}

// ---------------------------------------------------------------- host side

// Fill the backward's shape and tiling: R rows a pair (the next power of two
// >= S, within [4, bwd_rows(D)]) and bwd_rows(D) / R pairs a block; false when
// the shape is not one the kernels take.
bool make_backward_shape(Shape* s, const long long* strides, int batch, int seq, int heads,
                         int head_dim, float scale, int causal) {
  if (batch <= 0 || seq <= 0 || heads <= 0) return false;
  if (!built_head_dim(head_dim)) return false;
  const int block_rows = bwd_rows(head_dim);
  int rows = next_pow2(seq);
  if (rows < 4) rows = 4;
  if (rows > block_rows) rows = block_rows;
  s->batch = batch;
  s->seq = seq;
  s->heads = heads;
  s->rows = rows;
  s->pairs = block_rows / rows;
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
                    const ForwardShape& s, cudaStream_t stream) {
  static bool opted[2] = {false, false};
  launch_forward<D>(flash_forward_kernel<T, D, 4>, flash_forward_kernel<T, D, 16>, opted, s, stream,
                    static_cast<const T*>(q), static_cast<const T*>(k),
                    static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse));
}

template <typename T, int D>
void backward_launch(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const void* lse, void* dq, void* dq_partial, void* dk,
                     void* dv, const Shape& s, cudaStream_t stream) {
  // Above 48 KiB of shared memory only after opting in, for the largest tiling;
  // a failure is left for cudaGetLastError() to report, and retried next call.
  static bool opted = false;
  if (!opted) {
    if (cudaFuncSetAttribute(flash_backward_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bwd_smem_floats(D, bwd_rows(D)) * sizeof(float))) !=
        cudaSuccess)
      return;
    opted = true;
  }
  const size_t smem = bwd_smem_floats(D, s.rows) * sizeof(float);
  flash_backward_kernel<T, D><<<grid_of(s), kBwdThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<T*>(dq), static_cast<float*>(dq_partial), static_cast<T*>(dk),
      static_cast<T*>(dv), s);
}


}  // namespace

// lse may be null (no gradient needed).
extern "C" int flash_attention_forward(int dtype, const void* q, const void* k, const void* v,
                                       void* o, void* lse, const long long* strides, int batch,
                                       int seq, int heads, int head_dim, float scale,
                                       int causal, void* stream) {
  ForwardShape s;
  if (!make_forward_shape(&s, strides, batch, seq, seq, heads, head_dim, scale, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  DISPATCH(forward_launch, dtype, head_dim, q, k, v, o, lse, s,
           static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// dq is written when S <= bwd_rows(D) (one key tile a pair: 64, or 32 at
// D = 256) and may be null otherwise; dq_partial, a zeroed fp32
// [ceil(S / bwd_rows(D)), B, S, H, D], takes one dQ partial a key tile past it
// and may be null otherwise.
extern "C" int flash_attention_backward(int dtype, const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const void* lse,
                                        void* dq, void* dq_partial, void* dk, void* dv,
                                        const long long* strides, int batch, int seq, int heads,
                                        int head_dim, float scale, int causal, void* stream) {
  Shape s;
  if (!make_backward_shape(&s, strides, batch, seq, heads, head_dim, scale, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((seq > bwd_rows(head_dim) ? dq_partial : dq) == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  DISPATCH(backward_launch, dtype, head_dim, q, k, v, o, dout, lse, dq, dq_partial, dk, dv, s,
           static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
