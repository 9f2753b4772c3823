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
// Three routes, by section length (ldpc_denoise_update's `route`):
//
//   registers (M <= 4096) One block of M / 4 threads (32 below 128) holds a
//            section in registers, as above.
//   block    (8192 <= M <= 2^22) From 8192 a thread would hold M / 1024
//            values, which spill from about 2^14, so one block of 1024
//            threads walks its section three times
//            (denoise_update_long_kernel): write s and take the max of
//            s / tau; sum exp(s / tau - max); write beta_new and sum its
//            squares. Up to 2^15 the logits, then their exps, wait in shared
//            memory (128 KB at 2^15); above, the walks re-read s from the s
//            output and compute s / tau and the exp anew, the same
//            operations on the same operands. Up to 2^15 the re-read would
//            take 1 %, 13 % and 24 % longer at 2^13, 2^14 and 2^15
//            (time_k3.py, H100 80GB HBM3 at 700 W). The default up to 2^15;
//            above it stays reachable by name, for time_k3.py's comparison.
//   cluster  (2^16 <= M <= 2^22, the default there) A thread-block cluster
//            of C blocks of 1024 threads owns a section: C = M / 2^14 up to
//            2^18, and 16 (above the portable cluster size, asked for
//            explicitly) from 2^18. Block c of the cluster owns the
//            contiguous share [c M / C, (c + 1) M / C) and walks it as the
//            block route walks a section, holding its share in shared memory
//            up to 2^15 entries (64 KB shares, two blocks an SM, up to 2^18;
//            128 KB at 2^19) and, from 2^20, the first 2^15 entries of its
//            share, re-reading s for the rest. Shares of 2^14 read 6-11 %
//            faster than shares of 2^15 at 2^16 and 2^17, whose single block
//            an SM left the memory idle while it reduced; at 2^19 shares of
//            2^14 would re-read half of each, and read 12 % slower
//            (time_k3.py beside a copy with either split, H100 80GB HBM3 at
//            700 W).
//            The section's max, sum of exps and energy are block
//            reductions whose partials each block pushes into slot c of
//            every block's shared memory (distributed shared memory), and
//            after a cluster barrier each block combines the C partials in
//            rank order: one input gives one output, run after run, and no
//            float atomics. With one block a section, a batch of few long
//            sections left most SMs idle (32 blocks at (4, 8, 2^20)) and
//            above 2^15 every walk re-read s; C blocks a section give C
//            times the blocks and keep up to 2^19 on chip.
//
// The per-entry operations are those of the register kernel on every
// route, so s is bit-equal to the plain version and only the order of the
// three reductions differs.
//
// The AMP loop's freeze (optional, every route): given a (B,) mask of the
// codewords that have stopped and the last s, a block whose codeword has
// stopped copies beta to beta_new and the last s to s, and sums the squares
// of beta in the thread order and reduction of a live step, so its energy
// is the one the step that wrote beta computed. A stopped section moves the
// same 16 bytes an entry as a live one (beta and the last s read, s and
// beta_new written) and skips azo, the exps and two reductions. All blocks
// of a section, and of a cluster, take the same branch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

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

// The freeze's arguments: stopped[b] != 0 for a codeword that has stopped
// (none when stopped is null), s_prev its last s, row_sections sections a
// codeword. Section indices fit 31 bits (ldpc_denoise_update checks).
struct Freeze {
  const unsigned char* stopped;
  const float* s_prev;
  unsigned row_sections;

  __device__ bool stopped_row(long long sec) const {
    return stopped != nullptr &&
           stopped[static_cast<unsigned>(sec) / row_sections] != 0;
  }
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
                      float* __restrict__ sec_en, Freeze fr) {
  __shared__ float red[32];
  const long long sec = blockIdx.x;
  const long long off = sec * VEC * blockDim.x + threadIdx.x;
  if (fr.stopped_row(sec)) {
    float en = 0.0f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const long long i = off + j * blockDim.x;
      const float p = beta[i];
      s_out[i] = fr.s_prev[i];
      beta_out[i] = p;
      en += p * p;
    }
    en = block_allreduce<SumOp>(en, red);
    if (threadIdx.x == 0) sec_en[sec] = en;
    return;
  }
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

// A stopped section's walk over its n4 float4 pieces (piece threadIdx.x +
// 1024 j, as a live walk takes them): beta and the last s copied through,
// and the thread's partial of the energy, summed piece by piece as the live
// walk sums it.
__device__ float copy_through(const float4* __restrict__ b4,
                              const float4* __restrict__ sp4, float4* s4,
                              float4* __restrict__ p4, int n4) {
  float en = 0.0f;
  for (int i = threadIdx.x; i < n4; i += kLongThreads) {
    const float4 p = b4[i];
    s4[i] = sp4[i];
    p4[i] = p;
    en += p.x * p.x + p.y * p.y + p.z * p.z + p.w * p.w;
  }
  return en;
}

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
                           float* __restrict__ sec_en, int M, Freeze fr) {
  extern __shared__ float4 held[];
  __shared__ float red[32];
  const long long base = static_cast<long long>(blockIdx.x) * M;
  const float4* b4 = reinterpret_cast<const float4*>(beta + base);
  const float4* a4 = reinterpret_cast<const float4*>(azo + base);
  float4* s4 = reinterpret_cast<float4*>(s_out + base);
  float4* p4 = reinterpret_cast<float4*>(beta_out + base);
  const int n4 = M / 4;
  if (fr.stopped_row(blockIdx.x)) {
    float en = copy_through(b4, reinterpret_cast<const float4*>(fr.s_prev + base),
                            s4, p4, n4);
    en = block_allreduce<SumOp>(en, red);
    if (threadIdx.x == 0) sec_en[blockIdx.x] = en;
    return;
  }
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

constexpr int kShareLog = 14;        // a cluster block's share up to M = 2^18
constexpr int kHeldMaxLog = 15;      // entries of a share kept in shared memory
constexpr int kClusterMaxLog = 4;    // at most 16 blocks a section: C = 16 from 2^18
constexpr int kClusterMinM = 1 << 16;

// A barrier in two halves that orders execution only; the arrive at the
// start and the wait before the first remote store make sure every block of
// the cluster runs before its shared memory is written.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The section's reduction from each block's partial `v` (every thread of
// the block holds it): threads 0..C-1 push it into slot c of every block's
// `part`, a cluster barrier (release and acquire) makes the pushes visible,
// and every thread combines the C slots in rank order, so every block of
// the cluster gets the same bits.
template <typename Op>
__device__ float cluster_combine(cg::cluster_group& cluster, float v, float* part,
                                 int c, int C) {
  if (static_cast<int>(threadIdx.x) < C) {
    cluster.map_shared_rank(part, static_cast<int>(threadIdx.x))[c] = v;
  }
  cluster.sync();
  const Op op{};
  float r = part[0];
  for (int k = 1; k < C; ++k) r = op(r, part[k]);
  return r;
}

// One cluster of C = 2^log_c blocks of kLongThreads per section of M = C *
// 2^LOG_SHARE entries. Thread t of block c takes the float4 pieces t + 1024 j
// of the block's share; pieces j < kHeld (the first 2^15 entries at most)
// keep their logits, then their exps, in shared memory (64 or 128 KB), the
// rest re-read s from s_out, which the same thread wrote.
template <int LOG_SHARE>
__global__ void __launch_bounds__(kLongThreads)
denoise_update_cluster_kernel(const float* __restrict__ beta,
                              const float* __restrict__ azo,
                              const float* __restrict__ tau, float* s_out,
                              float* __restrict__ beta_out,
                              float* __restrict__ sec_en, int log_c, Freeze fr) {
  constexpr int kHeldLog = LOG_SHARE < kHeldMaxLog ? LOG_SHARE : kHeldMaxLog;
  constexpr int kPieces = (1 << LOG_SHARE) / 4 / kLongThreads;   // 4 to 64
  constexpr int kHeld = (1 << kHeldLog) / 4 / kLongThreads;      // 4 or 8
  extern __shared__ float4 held[];
  __shared__ float red[32];
  __shared__ float part_max[1 << kClusterMaxLog];
  __shared__ float part_sum[1 << kClusterMaxLog];
  __shared__ float part_en[1 << kClusterMaxLog];
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int C = 1 << log_c;
  const int c = static_cast<int>(cluster.block_rank());
  const long long sec = static_cast<long long>(blockIdx.x) >> log_c;
  const long long base = ((sec << log_c) + c) << LOG_SHARE;
  const float4* b4 = reinterpret_cast<const float4*>(beta + base);
  const float4* a4 = reinterpret_cast<const float4*>(azo + base);
  float4* s4 = reinterpret_cast<float4*>(s_out + base);
  float4* p4 = reinterpret_cast<float4*>(beta_out + base);
  const int t0 = static_cast<int>(threadIdx.x);
  if (fr.stopped_row(sec)) {
    float en = copy_through(b4, reinterpret_cast<const float4*>(fr.s_prev + base),
                            s4, p4, kPieces * kLongThreads);
    en = block_allreduce<SumOp>(en, red);
    cluster_wait();   // every block of the cluster runs: its slots may be written
    en = cluster_combine<SumOp>(cluster, en, part_en, c, C);
    if (c == 0 && t0 == 0) sec_en[sec] = en;
    return;
  }
  const float t = tau[sec];
  float m = neg_inf();
#pragma unroll 4
  for (int j = 0; j < kPieces; ++j) {
    const int i = t0 + j * kLongThreads;
    const float4 b = b4[i], a = a4[i];
    // explicit rounding: no fused multiply-add, as in the plain version
    const float4 s = make_float4(__fadd_rn(b.x, __fmul_rn(t, a.x)),
                                 __fadd_rn(b.y, __fmul_rn(t, a.y)),
                                 __fadd_rn(b.z, __fmul_rn(t, a.z)),
                                 __fadd_rn(b.w, __fmul_rn(t, a.w)));
    s4[i] = s;
    const float4 v = make_float4(s.x / t, s.y / t, s.z / t, s.w / t);
    if (j < kHeld) held[i] = v;
    m = fmaxf(m, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
  }
  m = block_allreduce<MaxOp>(m, red);
  cluster_wait();   // every block of the cluster runs: its slots may be written
  m = cluster_combine<MaxOp>(cluster, m, part_max, c, C);
  // the exps of piece i beyond the held ones, anew from s
  auto exps = [&](int i) {
    const float4 s = s4[i];
    return make_float4(expf(s.x / t - m), expf(s.y / t - m), expf(s.z / t - m),
                       expf(s.w / t - m));
  };
  float z = 0.0f;
#pragma unroll 4
  for (int j = 0; j < kPieces; ++j) {
    const int i = t0 + j * kLongThreads;
    float4 e;
    if (j < kHeld) {
      const float4 v = held[i];
      e = make_float4(expf(v.x - m), expf(v.y - m), expf(v.z - m), expf(v.w - m));
      held[i] = e;
    } else {
      e = exps(i);
    }
    z += e.x + e.y + e.z + e.w;
  }
  z = block_allreduce<SumOp>(z, red);
  z = cluster_combine<SumOp>(cluster, z, part_sum, c, C);
  float en = 0.0f;
#pragma unroll 4
  for (int j = 0; j < kPieces; ++j) {
    const int i = t0 + j * kLongThreads;
    const float4 e = j < kHeld ? held[i] : exps(i);
    const float4 p = make_float4(e.x / z, e.y / z, e.z / z, e.w / z);
    p4[i] = p;
    en += p.x * p.x + p.y * p.y + p.z * p.z + p.w * p.w;
  }
  en = block_allreduce<SumOp>(en, red);
  // after this barrier no block touches another's shared memory, so each
  // may exit
  en = cluster_combine<SumOp>(cluster, en, part_en, c, C);
  if (c == 0 && t0 == 0) sec_en[sec] = en;
}

template <int LOG_SHARE>
cudaError_t launch_cluster(const float* beta, const float* azo, const float* tau,
                           float* s, float* beta_new, float* sec_en,
                           long long sections, int log_c, Freeze fr, cudaStream_t st) {
  auto kernel = denoise_update_cluster_kernel<LOG_SHARE>;
  constexpr int smem = (1 << (LOG_SHARE < kHeldMaxLog ? LOG_SHARE : kHeldMaxLog)) *
                       static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (log_c > 3) {   // 16 blocks: above the portable cluster size
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(sections << log_c), 1, 1);
  cfg.blockDim = dim3(kLongThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << log_c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, beta, azo, tau, s, beta_new, sec_en,
                            log_c, fr);
}

enum Route { kRouteAuto = 0, kRouteBlock = 1, kRouteCluster = 2 };

}  // namespace

// beta, azo, s, beta_new: (sections, M) float32; tau, sec_en: (sections,).
// route: 0 the default for M (registers to 4096, block to 2^15, cluster
// from 2^16), 1 registers or block, 2 cluster (M >= 2^16 only). stopped:
// null (every section live), or (sections / row_sections,) bytes, nonzero
// where a codeword has stopped, whose s is then s_prev's (sections, M)
// and beta_new beta. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int ldpc_denoise_update(const float* beta, const float* azo,
                                   const float* tau, float* s, float* beta_new,
                                   float* sec_en, long long sections, int M,
                                   int route, const unsigned char* stopped,
                                   const float* s_prev, long long row_sections,
                                   void* stream) {
  cudaGetLastError();  // clear a stale error of an earlier call
  if (sections <= 0 || sections > 0x7FFFFFFF || M < 32 || M > (1 << 22) ||
      (M & (M - 1)) != 0 || route < kRouteAuto || route > kRouteCluster ||
      (route == kRouteCluster && M < kClusterMinM) ||
      (stopped != nullptr && (s_prev == nullptr || row_sections <= 0 ||
                              sections % row_sections != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Freeze fr{stopped, s_prev,
                  static_cast<unsigned>(row_sections > 0 ? row_sections : 1)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(sections);
  if (M >= kClusterMinM && route != kRouteBlock) {
    int log_m = 0;
    while ((1 << log_m) < M) ++log_m;
    const int log_c = log_m - kShareLog < kClusterMaxLog ? log_m - kShareLog
                                                         : kClusterMaxLog;
    if ((sections << log_c) > 0x7FFFFFFF) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err;
    switch (log_m - log_c) {
      case 14: err = launch_cluster<14>(beta, azo, tau, s, beta_new, sec_en, sections, log_c, fr, st); break;
      case 15: err = launch_cluster<15>(beta, azo, tau, s, beta_new, sec_en, sections, log_c, fr, st); break;
      case 16: err = launch_cluster<16>(beta, azo, tau, s, beta_new, sec_en, sections, log_c, fr, st); break;
      case 17: err = launch_cluster<17>(beta, azo, tau, s, beta_new, sec_en, sections, log_c, fr, st); break;
      default: err = launch_cluster<18>(beta, azo, tau, s, beta_new, sec_en, sections, log_c, fr, st); break;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  } else if (M > 4096 && M <= kLongSmemMax) {
    const int smem = M * static_cast<int>(sizeof(float));
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          denoise_update_long_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    denoise_update_long_kernel<true><<<grid, kLongThreads, smem, st>>>(
        beta, azo, tau, s, beta_new, sec_en, M, fr);
  } else if (M > kLongSmemMax) {
    denoise_update_long_kernel<false><<<grid, kLongThreads, 0, st>>>(
        beta, azo, tau, s, beta_new, sec_en, M, fr);
  } else if (M >= 128) {
    denoise_update_kernel<4><<<grid, M / 4, 0, st>>>(beta, azo, tau, s,
                                                     beta_new, sec_en, fr);
  } else if (M == 64) {
    denoise_update_kernel<2><<<grid, 32, 0, st>>>(beta, azo, tau, s, beta_new,
                                                  sec_en, fr);
  } else {
    denoise_update_kernel<1><<<grid, 32, 0, st>>>(beta, azo, tau, s, beta_new,
                                                  sec_en, fr);
  }
  return static_cast<int>(cudaGetLastError());
}
