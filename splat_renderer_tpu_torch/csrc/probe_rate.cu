// Elementwise arithmetic-rate probe, hand-written for Hopper (sm_90a): how
// fast is a chain of dependent multiply-adds in float32 and in bfloat16
// outside the tensor cores?  It decides whether a bfloat16 profile of the
// blend kernels' alpha arithmetic could pay.
//
// Replaces the Pallas TPU kernel benchmarks/probe_bf16.py::make(dtype).kernel:
// R repeats of acc = acc * 0.5 + 1 on a (128, 256) float32 panel, in float32
// or bfloat16, over a grid of STEPS steps that all read the same panel and
// write the same result.
//
// What bounds it on the H100: operations.  The panel is 128 KB in and 128 KB
// out, read and written once; the work is repeats * steps * 32768
// multiply-adds on the FP32 pipes (one FMA per lane per clock) or, for
// bfloat16, on the same pipes two values at a time (__hfma2 on
// __nv_bfloat162).
//
// Design: the TPU's sequential grid of identical steps becomes the grid's y
// dimension: every (x, y) block recomputes the chain for its slice of the
// panel and stores the same values, so the stores race benignly and the
// compiler cannot fold the steps away.  One thread carries one chain in a
// register (two in a bfloat162); with 256 threads a block and tens of
// thousands of blocks, every scheduler has warps to hide the FMA latency.
// The library is built with -fmad=false, which would split an `a * b + c`
// written in C, so the chains use the explicit fused intrinsics fmaf and
// __hfma2 (one rounding per step, as the TPU's fused multiply-add).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void probe_f32_kernel(const float* __restrict__ x, float* __restrict__ out,
                                 int n, int repeats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = x[i];
#pragma unroll 16
  for (int r = 0; r < repeats; ++r) acc = fmaf(acc, 0.5f, 1.0f);
  out[i] = acc;
}

// one thread per pair of neighbouring elements
__global__ void probe_bf16_kernel(const float2* __restrict__ x, float2* __restrict__ out,
                                  int n_pairs, int repeats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pairs) return;
  __nv_bfloat162 acc = __float22bfloat162_rn(x[i]);
  const __nv_bfloat162 half = __float2bfloat162_rn(0.5f);
  const __nv_bfloat162 one = __float2bfloat162_rn(1.0f);
#pragma unroll 16
  for (int r = 0; r < repeats; ++r) acc = __hfma2(acc, half, one);
  out[i] = __bfloat1622float2(acc);
}

}  // namespace

// x, out: (n) float32 on the device, n even.  bf16 = 0 runs the chain in
// float32, 1 in bfloat16 (input rounded to nearest even, result widened
// back).  The grid is (blocks over the panel, steps).  Launches on `stream`
// without synchronising; returns the CUDA error code of the launch.
extern "C" int probe_rate_forward(const float* x, float* out, int n, int repeats,
                                  int steps, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || (n & 1) || repeats < 0 || steps < 1 || steps > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bf16) {
    const int n_pairs = n / 2;
    const dim3 grid((n_pairs + kThreads - 1) / kThreads, steps);
    probe_bf16_kernel<<<grid, kThreads, 0, s>>>(
        reinterpret_cast<const float2*>(x), reinterpret_cast<float2*>(out), n_pairs, repeats);
  } else {
    const dim3 grid((n + kThreads - 1) / kThreads, steps);
    probe_f32_kernel<<<grid, kThreads, 0, s>>>(x, out, n, repeats);
  }
  return static_cast<int>(cudaGetLastError());
}
