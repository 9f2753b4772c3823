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
// faster. At z = 150 the state allows one block per SM.
//
// Two variants of the check phase, bit-equal to each other (every value is
// the same lxor of the same operands in the same order):
//   "check_thread": one thread owns one check and runs its 3d - 5 Lxors as
//       one stream with a dependent chain of 2d - 3 (the design above).
//   "split": two threads own one check, thread q of the block's first half
//       and thread q of its second, so that a warp runs one role. The
//       forward prefixes and the backward suffixes are independent chains of
//       d - 2 and d - 1 Lxors: the first thread runs the first into fwd, the
//       second the second into a second (E, z) buffer bwd; after a barrier
//       the d extrinsic values Lxor(f[k-1], s[k+1]) are dealt out between
//       the two by the parity of k. A thread's stream drops to about 1.5 d
//       Lxors, and at z = 27 the block has 704 threads, one a variable
//       position too. This is the answer to the regime where one codeword
//       is alone on an SM and the card waits on the latency of a few warps.
//       (Two neighbouring lanes a check, the first attempt, lost: a warp
//       then runs both chains in turn, 0.26 against 0.20 ms.)
// Measured on an NVIDIA H100 80GB HBM3, 700 W (`time_k4.py`), check_thread
// against split: 802.11n r=1/2 z=27, 256 codewords, at most 50 iterations,
// 0.203 against 0.192 ms (slowest codeword 29 iterations) and 0.35-0.38
// against 0.31-0.35 ms (codewords at the cap); 802.16 r=1/2 z=27, 512
// codewords, at most 200 iterations, 2.07 against 1.26 ms at 1.5 dB and
// 0.67 against 0.55 ms at 2.5 dB, split alone on its SM (the kernel bounded
// for one block, 64 registers: with more codewords than one wave of two
// blocks an SM holds, one fast block after another beats two slow ones
// side by side). At z = 150 (900 or 1800 checks) one thread a check in a
// 1024-thread block wins, 0.94 against 1.04 ms. One dependent Lxor takes
// 0.094 us on a warp of its own, the slowest codeword's chain 0.036 ms of
// the 0.19: the decode is bound by the SM's instruction rate, not by the
// chain.
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
// row_edge (E). One block per codeword. SPLIT picks the variant of the
// check phase; the launch bound is MAXT threads, at least MINB blocks per SM.
template <bool SPLIT, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB)
bp_decode_kernel(const float* __restrict__ ch, const int* __restrict__ tables,
                 float* __restrict__ app, int* __restrict__ iters, int z, int Np,
                 int Mp, int E, int max_iters, bool correction, float corr_factor) {
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
  float* bwd = fwd + E * z;                               // (E, z), SPLIT only
  float* chs = SPLIT ? bwd + E * z : bwd;                 // (Np, z)
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

    // ---- check nodes: the Lxfb trellis of check (row i, position c) ----
    // m[k] is the row's k-th incoming message, at slot edges[k] * z + c of
    // msg; f[k] = Lxor(m[0..k]) the forward prefixes, s[k] =
    // Lxor(m[d-1], ..., m[k]) the backward suffixes (s[0] is the row's
    // aggregate), and the extrinsic value of edge k is Lxor(f[k-1], s[k+1]).
    int ok = 1;
    if (SPLIT) {
      // thread tid of the block's first half and thread tid + half of its
      // second share check q: whole warps take one role, so no warp runs
      // both chains in turn
      const int half = blockDim.x >> 1;
      const int role = threadIdx.x >= half;
      for (int base = 0; base < Nc; base += half) {
        const int q = base + threadIdx.x - role * half;
        const bool live = q < Nc;
        const int i = live ? q / z : 0;
        const int c = q - i * z;
        const int* edges = row_edge + row_ptr[i];
        const int d = row_ptr[i + 1] - row_ptr[i];
        if (live && role == 0 && d > 0) {
          float f = msg[edges[0] * z + c];
          fwd[edges[0] * z + c] = f;
          for (int k = 1; k < d - 1; ++k) {
            const int slot = edges[k] * z + c;
            f = lxor(f, msg[slot], correction);
            fwd[slot] = f;
          }
        }
        if (live && role == 1) {
          float b = 0.0f;
          for (int k = d - 1; k >= 0; --k) {
            const int slot = edges[k] * z + c;
            const float mk = msg[slot];
            b = (k == d - 1) ? mk : lxor(b, mk, correction);
            bwd[slot] = b;
          }
          ok &= b > 0.0f;
        }
        __syncthreads();
        if (live) {
          for (int k = role; k < d; k += 2) {
            float ext;
            if (d == 1) {
              ext = kBig;
            } else if (k == d - 1) {
              ext = fwd[edges[k - 1] * z + c];
            } else if (k == 0) {
              ext = bwd[edges[1] * z + c];
            } else {
              ext = lxor(fwd[edges[k - 1] * z + c], bwd[edges[k + 1] * z + c],
                         correction);
            }
            if (!correction) ext *= corr_factor;
            msg[edges[k] * z + c] = ext;
          }
        }
      }
    } else {
      // one thread a check. The forward pass keeps each prefix at its slot
      // of fwd; the backward pass carries b = s[k+1], reads m[k] just
      // before it overwrites that slot with the extrinsic value, and ends
      // with b = the aggregate of the row.
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
    }
    if (__syncthreads_and(ok)) break;   // parity holds: this codeword is done
    ++it;
  }

  for (int p = threadIdx.x; p < Nv; p += blockDim.x) app[off + p] = tot_s[p];
  if (threadIdx.x == 0) iters[blockIdx.x] = it;
}

// One warp runs n Lxors that each wait for the one before: the time of a
// launch over n is the latency of one dependent Lxor, the second bound of
// the decode (the slowest codeword's chain).
__global__ void lxor_chain_kernel(float* io, int n, bool correction) {
  float a = io[threadIdx.x];
  const float b = io[32 + threadIdx.x];
  for (int i = 0; i < n; ++i) a = lxor(a, b, correction);
  io[64 + threadIdx.x] = a;
}

template <bool SPLIT, int MAXT, int MINB>
cudaError_t launch(int blocks, int threads, size_t smem, cudaStream_t st,
                   const float* ch, const int* tables, float* app, int* iters, int z,
                   int Np, int Mp, int E, int max_iters, bool correction,
                   float corr_factor) {
  if (threads > MAXT) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bp_decode_kernel<SPLIT, MAXT, MINB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  bp_decode_kernel<SPLIT, MAXT, MINB><<<blocks, threads, smem, st>>>(
      ch, tables, app, iters, z, Np, Mp, E, max_iters, correction, corr_factor);
  return cudaGetLastError();
}

}  // namespace

// ch, app: (B, Np*z) float32; iters: (B,) int32; tables as above.
// correction != 0: sum-product; 0: min-sum scaled by corr_factor.
// split != 0: two lanes a check (needs a third (E, z) buffer), else one
// thread a check. threads: the block's size, a multiple of 32 (64 with
// split). two_blocks != 0: the kernel compiled for two blocks an SM (at
// most 512 threads, 704 with split, and 64 or 48 registers); 0: the one
// compiled for 1024 threads and 64 registers.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ldpc_bp_decode(const float* ch, const int* tables, float* app,
                              int* iters, int B, int z, int Np, int Mp, int E,
                              int max_iters, int correction, float corr_factor,
                              int split, int threads, int two_blocks, void* stream) {
  cudaGetLastError();  // clear a stale error of an earlier call
  if (B <= 0 || z <= 0 || Np <= 0 || Mp <= 0 || E <= 0 || threads <= 0 ||
      threads % (split ? 64 : 32) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(int) * (3 * E + Np + Mp + 2) +
                      sizeof(float) * ((split ? 3 : 2) * static_cast<size_t>(E) * z +
                                       2 * static_cast<size_t>(Np) * z);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool corr = correction != 0;
#define LDPC_BP(SPLIT, MAXT, MINB)                                               \
  return static_cast<int>(launch<SPLIT, MAXT, MINB>(                             \
      B, threads, smem, st, ch, tables, app, iters, z, Np, Mp, E, max_iters,     \
      corr, corr_factor))
  if (split) {
    if (two_blocks) LDPC_BP(true, 704, 2);
    LDPC_BP(true, 1024, 1);
  }
  if (two_blocks) LDPC_BP(false, 512, 2);
  LDPC_BP(false, 1024, 1);
#undef LDPC_BP
}

// Runs n dependent Lxors on one warp; io holds 96 floats (a, b, out for 32
// lanes). Returns cudaGetLastError() after the launch.
extern "C" int ldpc_bp_lxor_chain(float* io, int n, int correction, void* stream) {
  cudaGetLastError();
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  lxor_chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      io, n, correction != 0);
  return static_cast<int>(cudaGetLastError());
}
