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
// multiply-adds on the FP32 pipes (FFMA) or, for bfloat16, two values at a
// time (__hfma2 on __nv_bfloat162, HFMA2.BF16_V2 in SASS).
//
// Design: the TPU's sequential grid of identical steps becomes the grid's y
// dimension: every (x, y) block recomputes the chains for its slice of the
// panel and stores the same values, so the stores race benignly and the
// compiler cannot fold the steps away.  Each thread carries kChains
// independent chains (elements i, i + stride, ...), interleaved in one loop,
// so the scheduler always has an independent multiply-add to issue: with
// one chain a thread, float32 waited on FFMA latency and block start-up;
// 8 chains keep the FP32 pipes busier.  bfloat16 gains nothing past 2
// chains: on the H100 HFMA2.BF16_V2 issues at about half a warp
// instruction per scheduler and clock, so a pair of bfloat16 values costs
// what one float32 FFMA costs, whatever the layout (`probe_rate_sweep`
// below times 1 to 8 chains, 128 or 256 threads and 1 to 64 steps a block,
// in float32, bfloat16 and float16; PERF.md, K6).
// However the chains are laid out, each element's chain is one fused
// multiply-add a round, so the results are bit-equal to probe_rate_plain.
// The library is built with -fmad=false, which would split an `a * b + c`
// written in C, so the chains use the explicit fused intrinsics fmaf and
// __hfma2 (one rounding per step, as the TPU's fused multiply-add).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChainsF32 = 8;
constexpr int kChainsBf16 = 2;

// the chain type: float, or a pair of neighbouring bfloat16 / float16 values
struct F32 {
  using T = float;
  using In = float;
  __device__ static T load(In v) { return v; }
  __device__ static In store(T v) { return v; }
  __device__ static T step(T a) { return fmaf(a, 0.5f, 1.0f); }
};
struct BF16 {
  using T = __nv_bfloat162;
  using In = float2;
  __device__ static T load(In v) { return __float22bfloat162_rn(v); }
  __device__ static In store(T v) { return __bfloat1622float2(v); }
  __device__ static T step(T a) {
    return __hfma2(a, __float2bfloat162_rn(0.5f), __float2bfloat162_rn(1.0f));
  }
};
struct F16 {
  using T = __half2;
  using In = float2;
  __device__ static T load(In v) { return __float22half2_rn(v); }
  __device__ static In store(T v) { return __half22float2(v); }
  __device__ static T step(T a) {
    return __hfma2(a, __float2half2_rn(0.5f), __float2half2_rn(1.0f));
  }
};

// Loads and stores the compiler may not merge across a block's steps.
__device__ __forceinline__ float ld_v(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float2 ld_v(const float2* p) {
  float2 v;
  asm volatile("ld.global.cg.v2.f32 {%0,%1}, [%2];" : "=f"(v.x), "=f"(v.y) : "l"(p));
  return v;
}
__device__ __forceinline__ void st_v(float* p, float v) {
  asm volatile("st.global.f32 [%0], %1;" ::"l"(p), "f"(v) : "memory");
}
__device__ __forceinline__ void st_v(float2* p, float2 v) {
  asm volatile("st.global.v2.f32 [%0], {%1,%2};" ::"l"(p), "f"(v.x), "f"(v.y) : "memory");
}

// C chains a thread (elements i, i + stride, ...), S of the probe's steps a
// block.  The probe itself runs S = 1: one step a block, the steps on the
// grid's y dimension.
template <class K, int C, int S>
__global__ void probe_kernel(const typename K::In* __restrict__ x, typename K::In* __restrict__ out,
                             int n, int repeats) {
  const int stride = gridDim.x * blockDim.x;
  const int i0 = blockIdx.x * blockDim.x + threadIdx.x;
  for (int s = 0; s < S; ++s) {
    typename K::T acc[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int i = i0 + k * stride;
      typename K::In v{};
      if (i < n) v = S > 1 ? ld_v(x + i) : x[i];
      acc[k] = K::load(v);
    }
#pragma unroll 8
    for (int r = 0; r < repeats; ++r) {
#pragma unroll
      for (int k = 0; k < C; ++k) acc[k] = K::step(acc[k]);
    }
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int i = i0 + k * stride;
      if (i < n) {
        if (S > 1) st_v(out + i, K::store(acc[k]));
        else out[i] = K::store(acc[k]);
      }
    }
  }
}

template <class K, int C, int S>
int launch(const float* x, float* out, int n, int repeats, int steps, int threads,
           cudaStream_t st) {
  if (steps % S || threads < 32 || threads > 1024) return cudaErrorInvalidValue;
  const int items = sizeof(typename K::In) == 4 ? n : n / 2;
  const dim3 grid((items + threads * C - 1) / (threads * C), steps / S);
  probe_kernel<K, C, S><<<grid, threads, 0, st>>>(
      reinterpret_cast<const typename K::In*>(x), reinterpret_cast<typename K::In*>(out),
      items, repeats);
  return cudaGetLastError();
}

template <class K>
int dispatch(int chains, int per_block, const float* x, float* out, int n, int repeats,
             int steps, int threads, cudaStream_t s) {
#define SWEEP_CASE(C, S) \
  if (chains == C && per_block == S) return launch<K, C, S>(x, out, n, repeats, steps, threads, s);
  SWEEP_CASE(1, 1) SWEEP_CASE(2, 1) SWEEP_CASE(4, 1) SWEEP_CASE(8, 1)
  SWEEP_CASE(1, 8) SWEEP_CASE(2, 8) SWEEP_CASE(4, 8) SWEEP_CASE(8, 8)
  SWEEP_CASE(1, 64) SWEEP_CASE(2, 64) SWEEP_CASE(4, 64) SWEEP_CASE(8, 64)
#undef SWEEP_CASE
  return cudaErrorInvalidValue;
}

bool bad_shape(int n, int repeats, int steps) {
  return n <= 0 || (n & 1) || repeats < 0 || steps < 1 || steps > 65535;
}

}  // namespace

// x, out: (n) float32 on the device, n even.  bf16 = 0 runs the chain in
// float32, 1 in bfloat16 (input rounded to nearest even, result widened
// back).  The grid is (blocks over the panel, steps).  Launches on `stream`
// without synchronising; returns the CUDA error code of the launch.
extern "C" int probe_rate_forward(const float* x, float* out, int n, int repeats,
                                  int steps, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(n, repeats, steps)) return static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? launch<BF16, kChainsBf16, 1>(x, out, n, repeats, steps, kThreads, s)
              : launch<F32, kChainsF32, 1>(x, out, n, repeats, steps, kThreads, s);
}

// The layout sweep (ops/probe_rate.py --sweep): the same chains in dtype
// 0 float32, 1 bfloat16, 2 float16; chains in {1, 2, 4, 8} a thread, steps
// a block in {1, 8, 64} (dividing `steps`), `threads` a block.  Every
// layout computes each element's chain as one fused multiply-add a round,
// so every output equals probe_rate_plain's.  Returns the CUDA error code
// of the launch.
extern "C" int probe_rate_sweep(int dtype, const float* x, float* out, int n, int repeats,
                                int steps, int chains, int per_block, int threads,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(n, repeats, steps)) return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch<F32>(chains, per_block, x, out, n, repeats, steps, threads, s);
  if (dtype == 1) return dispatch<BF16>(chains, per_block, x, out, n, repeats, steps, threads, s);
  if (dtype == 2) return dispatch<F16>(chains, per_block, x, out, n, repeats, steps, threads, s);
  return cudaErrorInvalidValue;
}
