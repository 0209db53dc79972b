// Issue-rate probe for Hopper (sm_90a): which pipe an instruction issues
// on, read from how many of it an SM completes a clock.
//
// Each kernel runs one instruction kind, over and over: eight
// accumulators a thread, each step a[i] = OP(a[i], a[i + 1], ...), 16
// steps of all eight an iteration (128 instructions, independent across
// the eight), `iters` iterations, every thread of a full card. The values
// are runtime, so nothing folds. The mixed kernels run two kinds, one on
// the even accumulators and one on the odd: two kinds that each issue 64
// lanes a clock alone and 128 together issue on two pipes, 64 together
// on one. chip_smoke.py (phase 2) builds this file with nvcc, counts the
// instructions in each kernel's loop from `cuobjdump -sass` and divides
// by the time: lanes an SM a clock.
// Not part of the port: no entry point calls it.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int ACC = 8;
constexpr int STEPS = 16;

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

__device__ __forceinline__ __nv_bfloat162 bf2(uint32_t x) {
  return *reinterpret_cast<const __nv_bfloat162*>(&x);
}

__device__ __forceinline__ uint32_t u32(__nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

// the instruction kinds, in the order of swtpu_probe_names
enum Op {
  IMNMX, VIADDMNMX, VIMNMX3_16X2, VIMNMX_16X2_RELU, HMNMX2, HFMA2_RELU, HADD2, IMAD,
  PRMT, LOP3, IADD3, N_OPS
};

template <int OP>
__device__ __forceinline__ uint32_t op(uint32_t a, uint32_t b, uint32_t c, uint32_t k) {
  if constexpr (OP == IMNMX) return static_cast<uint32_t>(max(static_cast<int>(a), static_cast<int>(b)));
  if constexpr (OP == VIADDMNMX) return static_cast<uint32_t>(
      __viaddmax_s32(static_cast<int>(a), static_cast<int>(k), static_cast<int>(b)));
  if constexpr (OP == VIMNMX3_16X2) return __vimax3_s16x2(a, b, c);
  if constexpr (OP == VIMNMX_16X2_RELU) return __vimin_s16x2_relu(a, b);
  if constexpr (OP == HMNMX2) return u32(__hmax2(bf2(a), bf2(b)));
  if constexpr (OP == HFMA2_RELU) return u32(__hfma2_relu(bf2(a), bf2(k), bf2(b)));
  if constexpr (OP == HADD2) return u32(__hsub2(bf2(a), bf2(b)));
  if constexpr (OP == IMAD) return a * k + b;
  if constexpr (OP == PRMT) return prmt(a, b, k);
  if constexpr (OP == LOP3) return (a & b) ^ k;
  if constexpr (OP == IADD3) return a + b + k;
  return a;
}

template <int OP, int OP2>
__global__ void __launch_bounds__(256) probe_kernel(uint32_t* out, int iters, uint32_t seed) {
  const uint32_t tid = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t a[ACC];
  uint32_t k = seed ^ (tid * 0x9E3779B9u);
#pragma unroll
  for (int i = 0; i < ACC; ++i) a[i] = (tid + i) * 0x3C6EF372u ^ seed;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
#pragma unroll
      for (int i = 0; i < ACC; ++i)
        a[i] = i % 2 ? op<OP2>(a[i], a[(i + 1) % ACC], a[(i + 2) % ACC], k)
                     : op<OP>(a[i], a[(i + 1) % ACC], a[(i + 2) % ACC], k);
    }
  }
  uint32_t x = 0;
#pragma unroll
  for (int i = 0; i < ACC; ++i) x ^= a[i];
  out[tid] = x;
}

template <int OP, int OP2 = OP>
cudaError_t launch(int blocks, int threads, int iters, uint32_t* out, cudaStream_t s) {
  probe_kernel<OP, OP2><<<blocks, threads, 0, s>>>(out, iters, 0x1234567u);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// the kinds each kernel repeats, in the order of swtpu_probe's `which`
const char* swtpu_probe_names() {
  return "IMNMX VIADDMNMX VIMNMX3 VIMNMX HMNMX2 HFMA2 HADD2 IMAD PRMT LOP3 IADD3 "
         "VIADDMNMX+LOP3 VIMNMX3+LOP3 HMNMX2+LOP3 HMNMX2+IMNMX IMAD+LOP3";
}

// Launches kernel `which` (the names' order) with `blocks` x `threads`
// threads, `iters` iterations; out holds blocks x threads uint32.
int swtpu_probe(int which, int blocks, int threads, int iters, void* out, void* stream) {
  auto* o = static_cast<uint32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (which) {
    case IMNMX: return launch<IMNMX>(blocks, threads, iters, o, s);
    case VIADDMNMX: return launch<VIADDMNMX>(blocks, threads, iters, o, s);
    case VIMNMX3_16X2: return launch<VIMNMX3_16X2>(blocks, threads, iters, o, s);
    case VIMNMX_16X2_RELU: return launch<VIMNMX_16X2_RELU>(blocks, threads, iters, o, s);
    case HMNMX2: return launch<HMNMX2>(blocks, threads, iters, o, s);
    case HFMA2_RELU: return launch<HFMA2_RELU>(blocks, threads, iters, o, s);
    case HADD2: return launch<HADD2>(blocks, threads, iters, o, s);
    case IMAD: return launch<IMAD>(blocks, threads, iters, o, s);
    case PRMT: return launch<PRMT>(blocks, threads, iters, o, s);
    case LOP3: return launch<LOP3>(blocks, threads, iters, o, s);
    case IADD3: return launch<IADD3>(blocks, threads, iters, o, s);
    case N_OPS: return launch<VIADDMNMX, LOP3>(blocks, threads, iters, o, s);
    case N_OPS + 1: return launch<VIMNMX3_16X2, LOP3>(blocks, threads, iters, o, s);
    case N_OPS + 2: return launch<HMNMX2, LOP3>(blocks, threads, iters, o, s);
    case N_OPS + 3: return launch<HMNMX2, IMNMX>(blocks, threads, iters, o, s);
    case N_OPS + 4: return launch<IMAD, LOP3>(blocks, threads, iters, o, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* swtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
