// Reverse linear recurrence for Hopper (sm_90a), and truncated GAE on it:
//
//     acc_t = delta_t + weight_t * acc_{t+1},   acc_T = init,   t = T-1 ... 0
//
// over [T, B] row-major inputs (B = every trailing dim flattened). It replaces
// the Pallas TPU kernel stoix_tpu/ops/scan_kernels.py::pallas_linear_recurrence_reverse
// (body `_recurrence_kernel`), which walks time blocks in a sequential grid
// and carries the accumulator across them in VMEM scratch. A GPU has no
// sequential grid, so here one lane owns one column and walks the whole time
// axis with the carry in a register: no cross-block carry, no padding.
//
// Two entry points share one kernel template:
//   * the generic recurrence (weight, delta, init -> out), float32 or bfloat16;
//   * truncated GAE (r, discount, v_tm1, v_t, truncation, lambda -> advantages,
//     targets), float32, in ONE launch: the recurrence with the elementwise
//     producer (delta, weight) and consumer (targets) that XLA fuses around
//     the Pallas call in the JAX package's jitted GAE
//     (stoix_tpu/ops/multistep.py::truncated_generalized_advantage_estimation).
//
// Bound: bytes. Each input element is read once and each output written once;
// a few flops per element are nothing beside that. At the rollout's [16, 1024]
// the bytes take 0.06 us (generic) and 0.14 us (GAE) at 3.35 TB/s, so the
// launch and one memory round trip are the floor, and the design is about
// latency:
//   * A block owns 32 columns (one per lane of its warp 0) and W warps. The
//     time axis is cut into stages of W * R rows. Every warp loads R rows of
//     a stage (rows interleaved over the warps, so a short T still spreads
//     over all of them), each row a coalesced 128-byte piece for float32, and
//     puts them in shared memory; warp 0 then folds the stage from there.
//   * The next stage's loads are issued before the current stage's fold, so
//     they fly while the FMA chain runs: one stage costs one round trip, and
//     a long T one per stage, overlapped with the chain.
//   * The stage shape is chosen by T at launch: T <= 16 (the rollout) in one
//     16-row stage over 8 warps, 2 rows each, the fewest loads a thread
//     before the fold starts; a longer T in 64-row stages over 4 warps, 16
//     rows each, the most loads in flight while a stage folds (the two
//     were the fastest of the stage shapes timed side by side on the card).
//   * 32 columns a block put [16, 1024] on 32 SMs and [128, 4096] on 128.
//   * The ragged column edge is masked by the column bound; the ragged stage
//     at t = 0 by the row bound.
//
// Precision: the accumulator is float32 for every input type. Loads widen to
// float32; each row is rounded once to the output type on store. The update
// is ONE fused multiply-add, __fmaf_rn(weight, acc, delta): XLA compiles the
// JAX reference's `delta + weight * acc` into an FMA (a single rounding), and
// stating it with the intrinsic fixes the rounding whatever nvcc's
// contraction flags, which makes float32 bitwise equal to the reference. The
// GAE producer and consumer are written with explicit _rn intrinsics too, in
// the JAX package's order (nvcc would otherwise contract a*b+c on its own):
//   delta  = (r + discount * v_t) - v_tm1      one FMA, then a subtraction
//   weight = (discount * lambda) * (1 - truncation)
//   target = v_tm1 + acc
//
// Plain C interface, bound from Python with ctypes. Each entry point launches
// on the given stream and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

constexpr int kCols = 32;  // columns of a block: warp 0's lanes
constexpr int kShortT = 16;  // the longest T that takes the short stage shape
// Stage shapes: warps of a block by rows each warp loads a stage. Short T
// (<= kShortT) takes one 16-row stage over 8 warps, longer T 64-row stages
// over 4 warps.
constexpr int kShortWarps = 8, kShortRows = 2;
constexpr int kLongWarps = 4, kLongRows = 16;

// What the fold reads per element: {weight, delta, ...}, and what it writes.
template <typename T>
struct Recurrence {
  static constexpr int kArrays = 2;  // weight, delta
  const T* __restrict__ weight;
  const T* __restrict__ delta;
  const T* __restrict__ init;
  T* __restrict__ out;

  __device__ __forceinline__ float start(int col) const { return widen(init[col]); }
  __device__ __forceinline__ void load(long long i, float (&v)[kArrays]) const {
    v[0] = widen(weight[i]);
    v[1] = widen(delta[i]);
  }
  __device__ __forceinline__ void emit(long long i, float acc, const float (&)[kArrays]) const {
    out[i] = narrow<T>(acc);
  }
};

template <bool kTruncation>
struct TruncatedGae {
  static constexpr int kArrays = 3;  // weight, delta, v_tm1
  const float* __restrict__ r;
  const float* __restrict__ discount;
  const float* __restrict__ v_tm1;
  const float* __restrict__ v_t;
  const float* __restrict__ truncation;
  float lambda;
  float* __restrict__ advantages;
  float* __restrict__ targets;

  __device__ __forceinline__ float start(int) const { return 0.0f; }
  __device__ __forceinline__ void load(long long i, float (&v)[kArrays]) const {
    const float d = discount[i];
    const float value = v_tm1[i];
    const float cont = kTruncation ? __fsub_rn(1.0f, truncation[i]) : 1.0f;
    v[0] = __fmul_rn(__fmul_rn(d, lambda), cont);
    v[1] = __fsub_rn(__fmaf_rn(d, v_t[i], r[i]), value);
    v[2] = value;
  }
  __device__ __forceinline__ void emit(long long i, float acc, const float (&v)[kArrays]) const {
    advantages[i] = acc;
    targets[i] = __fadd_rn(v[2], acc);
  }
};

// Slot j of a stage that ends (exclusive) at row `hi` holds row hi - 1 - j, so
// the fold walks slots upward. Warp w loads slots w, w + Warps, ...; every
// warp loads, warp 0 folds.
template <typename Source, int Warps, int RowsPerWarp>
__global__ void __launch_bounds__(kCols * Warps)
reverse_recurrence_kernel(const Source src, const int t_len, const int b_len) {
  constexpr int kArrays = Source::kArrays;
  constexpr int kStage = Warps * RowsPerWarp;  // rows per stage
  __shared__ float stage[kArrays][kStage][kCols];
  const int lane = threadIdx.x % kCols;
  const int warp = threadIdx.x / kCols;
  const int col = blockIdx.x * kCols + lane;
  const bool live = col < b_len;

  float held[RowsPerWarp][kArrays];
  auto load = [&](int hi) {
#pragma unroll
    for (int i = 0; i < RowsPerWarp; ++i) {
      const int row = hi - 1 - (warp + Warps * i);
      if (live && row >= 0) src.load(static_cast<long long>(row) * b_len + col, held[i]);
    }
  };

  float acc = (warp == 0 && live) ? src.start(col) : 0.0f;
  load(t_len);
  for (int hi = t_len; hi > 0; hi -= kStage) {
#pragma unroll
    for (int i = 0; i < RowsPerWarp; ++i) {
      const int slot = warp + Warps * i;
      if (live && slot < hi) {  // the slots `load` filled; the fold reads no other
#pragma unroll
        for (int a = 0; a < kArrays; ++a) stage[a][slot][lane] = held[i][a];
      }
    }
    __syncthreads();
    if (hi > kStage) load(hi - kStage);  // in flight while warp 0 folds this stage
    if (warp == 0 && live) {
      const int rows = hi < kStage ? hi : kStage;
#pragma unroll 4
      for (int j = 0; j < rows; ++j) {
        float v[kArrays];
#pragma unroll
        for (int a = 0; a < kArrays; ++a) v[a] = stage[a][j][lane];
        acc = __fmaf_rn(v[0], acc, v[1]);
        src.emit(static_cast<long long>(hi - 1 - j) * b_len + col, acc, v);
      }
    }
    __syncthreads();
  }
}

__global__ void empty_kernel() {}

int blocks_for(int b_len) { return (b_len + kCols - 1) / kCols; }

// Threads of a block for T: the one place the stage shape is chosen by T.
int threads_for(int t_len) { return kCols * (t_len <= kShortT ? kShortWarps : kLongWarps); }

template <typename Source>
int launch(const Source& src, int t_len, int b_len, void* stream) {
  if (t_len > 0 && b_len > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (threads_for(t_len) == kCols * kShortWarps) {
      reverse_recurrence_kernel<Source, kShortWarps, kShortRows>
          <<<blocks_for(b_len), threads_for(t_len), 0, s>>>(src, t_len, b_len);
    } else {
      reverse_recurrence_kernel<Source, kLongWarps, kLongRows>
          <<<blocks_for(b_len), threads_for(t_len), 0, s>>>(src, t_len, b_len);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_recurrence(const void* weight, const void* delta, const void* init, void* out,
                      int t_len, int b_len, void* stream) {
  const Recurrence<T> src{static_cast<const T*>(weight), static_cast<const T*>(delta),
                          static_cast<const T*>(init), static_cast<T*>(out)};
  return launch(src, t_len, b_len, stream);
}

}  // namespace

extern "C" int linear_recurrence_reverse_f32(const void* weight, const void* delta,
                                             const void* init, void* out, int t_len,
                                             int b_len, void* stream) {
  return launch_recurrence<float>(weight, delta, init, out, t_len, b_len, stream);
}

extern "C" int linear_recurrence_reverse_bf16(const void* weight, const void* delta,
                                              const void* init, void* out, int t_len,
                                              int b_len, void* stream) {
  return launch_recurrence<__nv_bfloat16>(weight, delta, init, out, t_len, b_len, stream);
}

// `truncation` may be null: no truncation anywhere (continue = 1).
extern "C" int truncated_gae_f32(const void* r, const void* discount, const void* v_tm1,
                                 const void* v_t, const void* truncation, float lambda,
                                 void* advantages, void* targets, int t_len, int b_len,
                                 void* stream) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* adv = static_cast<float*>(advantages);
  float* tgt = static_cast<float*>(targets);
  if (truncation == nullptr) {
    const TruncatedGae<false> src{f(r), f(discount), f(v_tm1), f(v_t), nullptr, lambda, adv, tgt};
    return launch(src, t_len, b_len, stream);
  }
  const TruncatedGae<true> src{f(r), f(discount), f(v_tm1), f(v_t), f(truncation), lambda, adv,
                               tgt};
  return launch(src, t_len, b_len, stream);
}

// An empty kernel on the grid a [t_len, b_len] launch takes: the practical
// floor of a launch.
extern "C" int linear_recurrence_empty(int t_len, int b_len, void* stream) {
  if (t_len > 0 && b_len > 0) {
    empty_kernel<<<blocks_for(b_len), threads_for(t_len), 0,
                   static_cast<cudaStream_t>(stream)>>>();
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* linear_recurrence_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
