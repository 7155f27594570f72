// Reverse linear recurrence for Hopper (sm_90a):
//
//     acc_t = delta_t + weight_t * acc_{t+1},   acc_T = init,   t = T-1 ... 0
//
// over [T, B] row-major inputs (B = every trailing dim flattened). It replaces
// the Pallas TPU kernel stoix_tpu/ops/scan_kernels.py::pallas_linear_recurrence_reverse
// (body `_recurrence_kernel`), which walks time blocks in a sequential grid
// and carries the accumulator across them in VMEM scratch. A GPU has no
// sequential grid, so here each thread owns ONE column and walks the whole
// time axis with the carry in a register: no cross-block carry, no padding.
//
// Bound: bytes. Each element of weight and delta is read once and each output
// written once; there is one FMA (2 flops) per element. Neighbouring threads read
// neighbouring addresses of row t, so every row load and store coalesces.
// The ragged batch edge is masked by the column bound.
//
// Precision: the accumulator is float32 for every input type. Loads widen to
// float32; each row is rounded once to the output type on store. The update
// is ONE fused multiply-add, __fmaf_rn(weight, acc, delta): XLA compiles the
// JAX reference's `delta + weight * acc` into an FMA (a single rounding), and
// stating it with the intrinsic fixes the rounding whatever nvcc's
// contraction flags, which makes float32 bitwise equal to the reference.
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

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
linear_recurrence_reverse_kernel(const T* __restrict__ weight, const T* __restrict__ delta,
                                 const T* __restrict__ init, T* __restrict__ out,
                                 int t_len, int b_len) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= b_len) return;
  float acc = widen(init[col]);
  const T* w = weight + col;
  const T* d = delta + col;
  T* o = out + col;
  const long long stride = b_len;
#pragma unroll 4
  for (int t = t_len - 1; t >= 0; --t) {
    const long long row = static_cast<long long>(t) * stride;
    acc = __fmaf_rn(widen(w[row]), acc, widen(d[row]));
    o[row] = narrow<T>(acc);
  }
}

template <typename T>
int launch(const void* weight, const void* delta, const void* init, void* out, int t_len,
           int b_len, void* stream) {
  if (t_len > 0 && b_len > 0) {
    const int blocks = (b_len + kThreads - 1) / kThreads;
    linear_recurrence_reverse_kernel<T><<<blocks, kThreads, 0,
                                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(weight), static_cast<const T*>(delta),
        static_cast<const T*>(init), static_cast<T*>(out), t_len, b_len);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int linear_recurrence_reverse_f32(const void* weight, const void* delta,
                                             const void* init, void* out, int t_len,
                                             int b_len, void* stream) {
  return launch<float>(weight, delta, init, out, t_len, b_len, stream);
}

extern "C" int linear_recurrence_reverse_bf16(const void* weight, const void* delta,
                                              const void* init, void* out, int t_len,
                                              int b_len, void* stream) {
  return launch<__nv_bfloat16>(weight, delta, init, out, t_len, b_len, stream);
}

extern "C" const char* linear_recurrence_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
