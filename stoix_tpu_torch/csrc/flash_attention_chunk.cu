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
// assuming the positions are contiguous and ascending. Here it runs on the
// forward core B2's forward shares (csrc/flash_forward.cuh): 64 query rows a
// block, 16-byte coalesced copies into padded fp32 tiles, scores and the
// online softmax in register tiles with the row max and sum taken by shuffles,
// the accumulator in register tiles, folded over key tiles of up to 64 keys.
// What differs from B2:
//
//   * every key is masked by its own position (`q_pos >= k_pos`), staged with
//     its tile, which holds for any positions, shuffled ones included;
//   * a block whose chunk lies wholly in its queries' future (the chunk's
//     smallest key position beyond the block's largest query position) writes
//     its empty rows' proxy stats and zeros as coalesced stores without
//     reading q, K or V; in a causal ring that is almost half of all
//     (rank, step) pairs. Otherwise a key tile wholly beyond the block's last
//     query is skipped before its K/V are copied;
//   * the outputs are the raw accumulator (pv, fp32), `m` with the finite
//     proxy 0 for a row that saw no unmasked key (its l and pv are 0), and `l`:
//     ring attention folds them, and its fold relies on that proxy;
//   * Sq and Sk may differ; ragged lengths are masked, never padded.
//
// Bound: at the ring's chunk shapes, operations. A fully visible [64, 128, 4, 32]
// float32 chunk is 4.D.Sq.Sk flops per (batch, head), 0.54 GFLOP, about 8 us at
// the card's 67 TFLOP/s of fp32, against 16.8 MB of q, k, v and pv, about 5 us
// at 3.35 TB/s. No tensor cores: exact fp32 FMA, expf, not __expf.
//
// Types: q, k, v float32, bfloat16 or float16, head dims 8, 16, 32, 64, 128 and
// 256 (wider ones run on csrc/flash_attention_wide.cu).
//
// Layout: q, k and v are taken by strides (batch, seq, head; the last dim
// contiguous; rows 16-byte aligned), so the views of a fused [B, S, 3, H, D]
// projection go in as they are. Positions are contiguous int32 [Sq] and [Sk];
// pv is contiguous [B, Sq, H, D], m and l contiguous [B, H, Sq].
//
// Plain C interface, bound from Python with ctypes. The entry point launches
// on the given stream and returns cudaGetLastError() (0 on success).

#include "flash_forward.cuh"

namespace {

template <typename T, int D, int kLanes>
__global__ void __launch_bounds__(kThreads, min_blocks<kLanes, D>())
flash_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                   float* __restrict__ pv, float* __restrict__ m_out, float* __restrict__ l_out,
                   ForwardShape s) {
  forward_core<T, float, D, true, kLanes>(q, k, v, q_pos, k_pos, pv, nullptr, m_out, l_out, s);
}

template <typename T, int D>
void chunk_launch(const void* q, const void* k, const void* v, const void* q_pos,
                  const void* k_pos, void* pv, void* m, void* l, const ForwardShape& s,
                  cudaStream_t stream) {
  static bool opted[2] = {false, false};
  launch_forward<D>(flash_chunk_kernel<T, D, 4>, flash_chunk_kernel<T, D, 16>, opted, s, stream,
                    static_cast<const T*>(q), static_cast<const T*>(k),
                    static_cast<const T*>(v), static_cast<const int*>(q_pos),
                    static_cast<const int*>(k_pos), static_cast<float*>(pv),
                    static_cast<float*>(m), static_cast<float*>(l));
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (q, k, v); pv, m, l are float32 either way.
extern "C" int flash_attention_chunk(int dtype, const void* q, const void* k, const void* v,
                                     const void* q_pos, const void* k_pos, void* pv, void* m,
                                     void* l, const long long* strides, int batch, int q_len,
                                     int k_len, int heads, int head_dim, float scale, int causal,
                                     void* stream) {
  ForwardShape s;
  if (!make_forward_shape(&s, strides, batch, q_len, k_len, heads, head_dim, scale, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  DISPATCH(chunk_launch, dtype, head_dim, q, k, v, q_pos, k_pos, pv, m, l, s,
           static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attention_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
