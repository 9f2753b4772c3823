// LDPC belief propagation: the whole decode of a codeword in one block, for
// sm_90a.
//
// Replaces ldpc_sparc_tpu/ops/bp_pallas.py:56 _make_kernel (through
// _pallas_decode and bp_decode_pallas). It computes what the TPU kernel
// computes (variable update, check update by the forward-backward Lxor
// trellis, a per-codeword freeze, an iteration count and an early exit),
// with another layout: the TPU kernel put 128 codewords on the vector
// lanes, ran the tile in lockstep until its slowest codeword stopped (pad
// lanes held +1e30) and unrolled the protograph at trace time. Here one
// block owns one codeword and stops as soon as its own parity checks hold,
// and the graph is data: small int tables (edge shifts, and the edge lists
// of each protograph column and row in ascending edge id) copied to shared
// memory at the start.
//
// State per block, all in shared memory for the whole decode: the (E, z)
// messages in check order, updated in place by both half-iterations (each
// edge belongs to exactly one column and one row, and a thread reads each
// slot it writes before it writes it), the check phase's (E, z) forward
// prefixes, the channel LLRs and the APP (Np, z). That is 25 KB at 802.11n
// r=1/2 z=27 and 136 KB at 802.16 r=3/4 B z=150, above 48 KB as dynamic
// shared memory.
//
// What bounds it on this card: latency, not bytes. The state never leaves
// shared memory; device memory sees each codeword's LLRs once and its APP
// once. Each iteration is two phases split by a barrier, and the check
// phase is a dependent chain of about 2 * dc Lxor steps per thread (each
// an expf and a log1pf for sum-product), with few warps per codeword at
// z = 27 (Mp * z = 324 checks, one per thread). The design's answer is
// occupancy across codewords: the trellis keeps no array in registers (its
// prefixes live in shared memory beside the messages), so ptxas needs 52
// registers per thread and at z = 27 three codewords (352 threads each)
// share an SM and hide each other's chains; 256 codewords run in one wave
// over 132 SMs. (Keeping the trellis's arrays in registers takes 128
// registers, one codeword per SM, and 1.6-1.9x the decode time.) The
// launch bound keeps that: at most 64 registers, two 512-thread blocks per
// SM. Bounds of three or four blocks (40 or 32 registers) measured no
// faster. At z = 150 the state allows one block per SM. Several codewords
// per block at small z, warp-level rows and a persistent grid are later
// work.
//
// Numerics kept from the reference: sign(0) is +1 inside Lxor; sum-product
// adds log1p(exp(-|a+b|)) - log1p(exp(-|a-b|)) in that order, with expf and
// log1pf (no fast math); min-sum scales every extrinsic by corr_factor,
// the 1e30 of a degree-1 row included; parity holds only when every check's
// aggregate is > 0, strictly. The variable sum is ch first, then the
// column's edges in ascending id, the order of the plain version
// (ops/bp.py), so the two agree to the last bit wherever expf and log1pf do.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMinBlocks = 2;    // at most 64 registers per thread
constexpr float kBig = 1e30f;

__device__ __forceinline__ float lxor(float a, float b, bool correction) {
  const float sgn = (a == 0.0f || b == 0.0f) ? 1.0f
                    : ((a < 0.0f) != (b < 0.0f) ? -1.0f : 1.0f);
  float out = sgn * fminf(fabsf(a), fabsf(b));
  if (correction) {
    out = out + log1pf(expf(-fabsf(a + b)));
    out = out - log1pf(expf(-fabsf(a - b)));
  }
  return out;
}

// tables: shift (E) | col_ptr (Np+1) | col_edge (E) | row_ptr (Mp+1) |
// row_edge (E). One block per codeword; at least kMinBlocks blocks per SM.
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
bp_decode_kernel(const float* __restrict__ ch, const int* __restrict__ tables,
                 float* __restrict__ app, int* __restrict__ iters, int z,
                 int Np, int Mp, int E, int max_iters, bool correction,
                 float corr_factor) {
  extern __shared__ int smem[];
  const int n_int = 3 * E + Np + Mp + 2;
  for (int i = threadIdx.x; i < n_int; i += blockDim.x) smem[i] = tables[i];
  const int* shift = smem;
  const int* col_ptr = shift + E;
  const int* col_edge = col_ptr + Np + 1;
  const int* row_ptr = col_edge + E;
  const int* row_edge = row_ptr + Mp + 1;
  float* msg = reinterpret_cast<float*>(smem + n_int);   // (E, z)
  float* fwd = msg + E * z;                               // (E, z)
  float* chs = fwd + E * z;                               // (Np, z)
  float* tot_s = chs + Np * z;                            // (Np, z)

  const int Nv = Np * z;
  const int Nc = Mp * z;
  const long long off = static_cast<long long>(blockIdx.x) * Nv;
  for (int p = threadIdx.x; p < Nv; p += blockDim.x) {
    chs[p] = ch[off + p];
    tot_s[p] = 0.0f;
  }
  for (int p = threadIdx.x; p < E * z; p += blockDim.x) msg[p] = 0.0f;
  __syncthreads();

  int it = 0;
  for (int t = 0; t < max_iters; ++t) {
    // ---- variable nodes: thread per (column j, position v) ----
    for (int p = threadIdx.x; p < Nv; p += blockDim.x) {
      const int j = p / z;
      const int v = p - j * z;
      const int k0 = col_ptr[j], k1 = col_ptr[j + 1];
      float tot = chs[p];
      for (int k = k0; k < k1; ++k) {
        const int e = col_edge[k];
        int c = v - shift[e];
        if (c < 0) c += z;
        tot += msg[e * z + c];
      }
      for (int k = k0; k < k1; ++k) {
        const int e = col_edge[k];
        int c = v - shift[e];
        if (c < 0) c += z;
        msg[e * z + c] = tot - msg[e * z + c];
      }
      tot_s[p] = tot;
    }
    __syncthreads();

    // ---- check nodes: thread per (row i, position c), the Lxfb trellis ----
    // m[k] is the row's k-th incoming message, at slot edges[k] * z + c of
    // msg. The forward pass keeps each prefix f[k] = Lxor(m[0..k]) at
    // the same slot of fwd; the backward pass carries b = Lxor(m[k+1..d-1]),
    // reads m[k] just before it overwrites that slot with the extrinsic
    // value Lxor(f[k-1], b), and ends with b = the aggregate of the row.
    int ok = 1;
    for (int q = threadIdx.x; q < Nc; q += blockDim.x) {
      const int i = q / z;
      const int c = q - i * z;
      const int* edges = row_edge + row_ptr[i];
      const int d = row_ptr[i + 1] - row_ptr[i];
      float f = d > 0 ? msg[edges[0] * z + c] : 0.0f;
      if (d > 0) fwd[edges[0] * z + c] = f;
      for (int k = 1; k < d - 1; ++k) {
        const int slot = edges[k] * z + c;
        f = lxor(f, msg[slot], correction);
        fwd[slot] = f;
      }
      float b = 0.0f;
      for (int k = d - 1; k >= 0; --k) {
        const int slot = edges[k] * z + c;
        const float mk = msg[slot];
        float ext;
        if (d == 1) {
          ext = kBig;
        } else if (k == d - 1) {
          ext = fwd[edges[k - 1] * z + c];
        } else if (k == 0) {
          ext = b;
        } else {
          ext = lxor(fwd[edges[k - 1] * z + c], b, correction);
        }
        if (!correction) ext *= corr_factor;
        b = (k == d - 1) ? mk : lxor(b, mk, correction);
        msg[slot] = ext;
      }
      ok &= b > 0.0f;
    }
    if (__syncthreads_and(ok)) break;   // parity holds: this codeword is done
    ++it;
  }

  for (int p = threadIdx.x; p < Nv; p += blockDim.x) app[off + p] = tot_s[p];
  if (threadIdx.x == 0) iters[blockIdx.x] = it;
}

}  // namespace

// ch, app: (B, Np*z) float32; iters: (B,) int32; tables as above.
// correction != 0: sum-product; 0: min-sum scaled by corr_factor.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ldpc_bp_decode(const float* ch, const int* tables, float* app,
                              int* iters, int B, int z, int Np, int Mp, int E,
                              int max_iters, int correction, float corr_factor,
                              void* stream) {
  cudaGetLastError();  // clear a stale error of an earlier call
  if (B <= 0 || z <= 0 || Np <= 0 || Mp <= 0 || E <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(int) * (3 * E + Np + Mp + 2) +
                      sizeof(float) * (2 * static_cast<size_t>(E) * z +
                                       2 * static_cast<size_t>(Np) * z);
  if (smem > 48 * 1024) {
    const cudaError_t st = cudaFuncSetAttribute(
        bp_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (st != cudaSuccess) return static_cast<int>(st);
  }
  int threads = ((Mp * z + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  bp_decode_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      ch, tables, app, iters, z, Np, Mp, E, max_iters, correction != 0,
      corr_factor);
  return static_cast<int>(cudaGetLastError());
}
