// Fused AMP denoiser tail for unmodulated real SPARCs, for sm_90a.
//
// Replaces ldpc_sparc_tpu/ops/denoiser_pallas.py::_kernel (through
// fused_denoise_update). For each section of M entries (codeword b,
// section l):
//     s        = beta + tau * azo
//     beta_new = softmax(s / tau)        (the K=1 Bayes-MMSE estimate)
//     sec_en   = sum(beta_new^2)         (the psi statistic's input)
// with tau = tau_sec[b, l]. The logits are s / tau, a division, as in the
// TPU kernel; the plain AMP tail multiplies by 1/tau instead, so the two
// differ by float32 rounding.
//
// What bounds it: device memory. Per codeword and iteration at L=1024,
// M=512 it reads beta and azo and writes s and beta_new, 4 x 2 MB, once
// each; the plain torch tail makes several passes over the same state
// (s-update, scale, max, exp, sum, divide, square-sum). One block owns one
// section and keeps its M values in registers (4 per thread at M >= 128),
// so max, sum and energy are block reductions (warp shuffles, then one
// shared-memory step across warps) and nothing else touches memory.
//
// Eligible shapes (checked by the caller too): M a power of two,
// 32 <= M <= 2^22.
//
// Up to M = 4096 one block of M / 4 threads (32 below 128) holds a section
// in registers, as above. From 8192 a thread would hold M / 1024 values,
// which spill from about 2^14, so a section of 8192 or more takes one block
// of 1024 threads that walks it three times (denoise_update_long_kernel):
// write s and take the max of s / tau; sum exp(s / tau - max); write
// beta_new and sum its squares. Up to 2^15 the logits, then their exps, wait
// in shared memory (128 KB at 2^15); above, the walks re-read s from the s
// output and compute s / tau and the exp anew, the same operations on the
// same operands. Up to 2^15 the re-read would take 1 %, 13 % and 24 % longer
// at 2^13, 2^14 and 2^15 (time_k3.py, H100 80GB HBM3 at 700 W). The per-entry operations are those of the register kernel,
// so only the order of the reductions differs from the plain version. A
// grid has one block a section: at M = 2^20 and more a batch of few
// sections leaves multiprocessors idle.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float neg_inf() { return __int_as_float(static_cast<int>(0xff800000u)); }

struct MaxOp {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
  __device__ static float identity() { return neg_inf(); }
};

struct SumOp {
  __device__ float operator()(float a, float b) const { return a + b; }
  __device__ static float identity() { return 0.0f; }
};

// All-reduce over the block; blockDim.x is a multiple of 32, at most 1024.
template <typename Op>
__device__ float block_allreduce(float v, float* red) {
  const Op op{};
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();  // red[] may still be read by the previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : Op::identity();
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One block per section; VEC entries per thread, entry threadIdx.x + j *
// blockDim.x, so each of the VEC loads and stores is coalesced.
template <int VEC>
__global__ void __launch_bounds__(1024)
denoise_update_kernel(const float* __restrict__ beta,
                      const float* __restrict__ azo,
                      const float* __restrict__ tau,
                      float* __restrict__ s_out, float* __restrict__ beta_out,
                      float* __restrict__ sec_en) {
  __shared__ float red[32];
  const long long sec = blockIdx.x;
  const long long off = sec * VEC * blockDim.x + threadIdx.x;
  const float t = tau[sec];
  float v[VEC];
  float m = neg_inf();
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const long long i = off + j * blockDim.x;
    // explicit rounding: no fused multiply-add, as in the plain version
    const float s = __fadd_rn(beta[i], __fmul_rn(t, azo[i]));
    s_out[i] = s;
    v[j] = s / t;
    m = fmaxf(m, v[j]);
  }
  m = block_allreduce<MaxOp>(m, red);
  float z = 0.0f;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    v[j] = expf(v[j] - m);
    z += v[j];
  }
  z = block_allreduce<SumOp>(z, red);
  float en = 0.0f;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float p = v[j] / z;
    beta_out[off + j * blockDim.x] = p;
    en += p * p;
  }
  en = block_allreduce<SumOp>(en, red);
  if (threadIdx.x == 0) sec_en[sec] = en;
}

constexpr int kLongThreads = 1024;
constexpr int kLongSmemMax = 1 << 15;   // entries of a section kept in shared memory

// One block of kLongThreads per section of M >= 8192 entries; each thread
// takes float4 pieces 4 * threadIdx.x + 4096 j, so every load and store is
// coalesced. IN_SMEM: the section's logits, then exps, wait in shared
// memory (M floats); else every walk re-reads s from s_out, which the same
// thread wrote.
template <bool IN_SMEM>
__global__ void __launch_bounds__(kLongThreads)
denoise_update_long_kernel(const float* __restrict__ beta,
                           const float* __restrict__ azo,
                           const float* __restrict__ tau, float* s_out,
                           float* __restrict__ beta_out,
                           float* __restrict__ sec_en, int M) {
  extern __shared__ float4 held[];
  __shared__ float red[32];
  const long long base = static_cast<long long>(blockIdx.x) * M;
  const float4* b4 = reinterpret_cast<const float4*>(beta + base);
  const float4* a4 = reinterpret_cast<const float4*>(azo + base);
  float4* s4 = reinterpret_cast<float4*>(s_out + base);
  float4* p4 = reinterpret_cast<float4*>(beta_out + base);
  const int n4 = M / 4;
  const float t = tau[blockIdx.x];
  float m = neg_inf();
  for (int i = threadIdx.x; i < n4; i += kLongThreads) {
    const float4 b = b4[i], a = a4[i];
    // explicit rounding: no fused multiply-add, as in the plain version
    const float4 s = make_float4(__fadd_rn(b.x, __fmul_rn(t, a.x)),
                                 __fadd_rn(b.y, __fmul_rn(t, a.y)),
                                 __fadd_rn(b.z, __fmul_rn(t, a.z)),
                                 __fadd_rn(b.w, __fmul_rn(t, a.w)));
    s4[i] = s;
    const float4 v = make_float4(s.x / t, s.y / t, s.z / t, s.w / t);
    if (IN_SMEM) held[i] = v;
    m = fmaxf(m, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
  }
  m = block_allreduce<MaxOp>(m, red);
  // the exps of piece i, from shared memory or anew from s
  auto exps = [&](int i) {
    if (IN_SMEM) return held[i];
    const float4 s = s4[i];
    return make_float4(expf(s.x / t - m), expf(s.y / t - m), expf(s.z / t - m),
                       expf(s.w / t - m));
  };
  float z = 0.0f;
  for (int i = threadIdx.x; i < n4; i += kLongThreads) {
    float4 e;
    if (IN_SMEM) {
      const float4 v = held[i];
      e = make_float4(expf(v.x - m), expf(v.y - m), expf(v.z - m), expf(v.w - m));
      held[i] = e;
    } else {
      e = exps(i);
    }
    z += e.x + e.y + e.z + e.w;
  }
  z = block_allreduce<SumOp>(z, red);
  float en = 0.0f;
  for (int i = threadIdx.x; i < n4; i += kLongThreads) {
    const float4 e = exps(i);
    const float4 p = make_float4(e.x / z, e.y / z, e.z / z, e.w / z);
    p4[i] = p;
    en += p.x * p.x + p.y * p.y + p.z * p.z + p.w * p.w;
  }
  en = block_allreduce<SumOp>(en, red);
  if (threadIdx.x == 0) sec_en[blockIdx.x] = en;
}

}  // namespace

// beta, azo, s, beta_new: (sections, M) float32; tau, sec_en: (sections,).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ldpc_denoise_update(const float* beta, const float* azo,
                                   const float* tau, float* s, float* beta_new,
                                   float* sec_en, long long sections, int M,
                                   void* stream) {
  cudaGetLastError();  // clear a stale error of an earlier call
  if (sections <= 0 || sections > 0x7FFFFFFF || M < 32 || M > (1 << 22) ||
      (M & (M - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(sections);
  if (M > 4096 && M <= kLongSmemMax) {
    const int smem = M * static_cast<int>(sizeof(float));
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          denoise_update_long_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    denoise_update_long_kernel<true><<<grid, kLongThreads, smem, st>>>(
        beta, azo, tau, s, beta_new, sec_en, M);
  } else if (M > kLongSmemMax) {
    denoise_update_long_kernel<false><<<grid, kLongThreads, 0, st>>>(
        beta, azo, tau, s, beta_new, sec_en, M);
  } else if (M >= 128) {
    denoise_update_kernel<4><<<grid, M / 4, 0, st>>>(beta, azo, tau, s,
                                                     beta_new, sec_en);
  } else if (M == 64) {
    denoise_update_kernel<2><<<grid, 32, 0, st>>>(beta, azo, tau, s, beta_new,
                                                  sec_en);
  } else {
    denoise_update_kernel<1><<<grid, 32, 0, st>>>(beta, azo, tau, s, beta_new,
                                                  sec_en);
  }
  return static_cast<int>(cudaGetLastError());
}
