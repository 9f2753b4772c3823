// Signed fast Walsh-Hadamard transform over the last axis, for sm_90a.
//
// Replaces ldpc_sparc_tpu/ops/wht_pallas.py::_ms_kernel (through
// _fwht_signed_ms and fwht_signed): the unnormalised Sylvester WHT of each
// row of an (R, w) float32 array, with a +-1 sign diagonal applied before
// the transform (apply_pre, the forward design product) or after it (the
// adjoint), or no signs at all. Row r uses sign row r % E, so one (E, w)
// sign plane serves a whole batch of codewords. The block scale is not
// applied here: the caller applies it on the small side of the product.
//
// Arithmetic is float32 throughout. The +-1 butterflies are adds and
// subtracts; they need no tensor cores, and the TPU kernel's bf16 operands
// are not carried over.
//
// What bounds it: device memory. A transform has to read its w inputs and
// write its w outputs, 8w bytes a row; log2(w) butterfly stages of w adds
// are far below the card's float32 rate. So the design keeps a row on
// chip from its one read to its one write, by one of three routes:
//
//   block    (w <= 2^15) One block owns one row. The row (128 KB at 2^15)
//            streams into dynamic shared memory as cp.async chunks of 2^14
//            floats, all requested at once; the 10 stages local to each
//            2^10 floats of a chunk run as soon as it has landed, while the
//            later chunk is still in flight, and the last group (strides
//            2^10 and up) stores straight to device memory.
//   cluster  (2^16 <= w <= 2^19) A thread-block cluster of C = w / 2^15
//            blocks (2, 4, 8, 16) holds the row in its shared memories
//            together, block c the contiguous segment [c 2^15, (c+1) 2^15).
//            The top log2(C) stages run across the blocks, the low 15
//            inside each as above. A row that comes from device memory
//            takes the top stages first: block c loads positions
//            [c 2^15 / C, (c + 1) 2^15 / C) of all C segments, runs their
//            butterflies in registers and sends result m to block m's tile
//            over distributed shared memory, remote stores that nothing
//            waits for; after a cluster barrier each block finishes its
//            own segment and stores it (or gathers from it). The clusters
//            are persistent, as many as the card holds at once, and ask for
//            the next row's share before the local stages of this one. A
//            row scattered on chip takes the local stages first and the
//            top stages on the way out, reading the other tiles in 16-byte
//            vectors, once. The barriers that only keep a tile alive order
//            execution, not memory (barrier.cluster.arrive.relaxed), so a
//            block's stores drain behind it. C = 16 is above the portable
//            cluster size and is asked for explicitly.
//   two_pass (2^10 <= w <= 2^22) The Kronecker split H_w = H_a (x) H_b on
//            the (a, b) row-major view of each row, for the widths no
//            cluster can hold: pass 1 transforms contiguous segments of
//            b = 2^min(12, log2 w - 5) floats, pass 2 a x 32 tiles along a
//            (a >= 32, so every thread of a tile has work), in place. The
//            state crosses device memory twice.
//
// The SRHT's index side is folded into the on-chip routes, so that it
// never exists at full width in device memory. Scatter mode (the adjoint
// product): the block zeroes its tile and scatters the k values of its row
// at idx[r % E] into it, in place of loading w inputs. Gather mode (the
// forward product): the result stays in shared memory and the block writes
// only the k outputs at idx[r % E]. Each block of a cluster takes the
// indices that fall in its own segment.
//
// A design of E blocks whose window side is Lw < E blocks (a spatially
// coupled design, window w <= 2^15, its window side the columns) also has
// that side folded in, by a segment table: window block s holds the design's
// blocks blocks[ptr[s]] .. blocks[ptr[s + 1] - 1], ascending
// (fwht_blocks_kernel, each row in fwht_onchip_kernel's steps, onchip_row).
// Gather mode reads its row straight from window block s of the (B, Lw, w)
// input, by index, in place of a (B, E, w) copy selected beforehand; the omega
// rows that read one window block run next to each other, so it crosses
// device memory once. Scatter mode sums in place of a (B, E, w) array of
// parts and an atomic segment sum: one block owns output row (b, s), walks
// s's blocks in ascending order, stores the first transform and adds each
// later one to what it stored (in L2: 132 rows of 128 KB are in flight), so
// the sum runs in block order and two runs give the same bits.
//
// Rows are taken in the order that keeps the rows of one sign row next to
// each other: an (E, w) sign plane larger than L2 is then read from device
// memory once, not once a row (the block-indexed kernel keeps the sign rows
// of one window block together across the codewords instead). Where a row
// streams in behind its own copies, a thread keeps its signs as bits, asked
// for ahead of the copies (SignBits).
//
// Inside a tile the stages run in groups: a work item holds the elements of
// one butterfly in registers, 32 of them (five stages) from 2^13 up, where
// the tile crosses shared memory three times for all 15 stages and that
// traffic is what the butterflies cost, and 8 (three stages) below. After
// every 32 floats of a one-row tile come 4 unused ones, so that a group at
// stride 1 (16-byte accesses, a thread's 8 or 32 floats in a row) and the
// group at stride 8 touch 32 distinct banks; at strides of 32 and more a
// warp's accesses are consecutive. Tile sizes are template parameters, so
// every loop has a compile-time trip count.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr int kRowMaxLog = 12;   // two_pass pass-1 segment: b <= 4096 floats
constexpr int kColMinLog = 5;    // two_pass pass-2 tile: a >= 32 rows
constexpr int kColMaxLog = 10;   //                       a <= 1024 rows
constexpr int kCols = 32;        // two_pass pass-2 tile width
constexpr int kThreads = 256;
constexpr int kSegMaxLog = 15;      // on-chip segment of one block: 2^15 floats
constexpr int kChunkLog = 14;       // streamed in as chunks of 2^14 floats
constexpr int kLowLog = 10;         // stages local to 2^10 floats run by chunk
constexpr int kSmallMaxLog = 12;    // up to here: no chunks, radix-8 groups
constexpr int kClusterMaxLog = 4;   // at most 16 blocks a cluster: w <= 2^19
constexpr int kSegThreads = 512;

enum Mode { kPlain = 0, kScatter = 1, kGather = 2 };
enum Route { kRouteBlock = 0, kRouteCluster = 1, kRouteTwoPass = 2 };

template <int LOG_N>
__host__ __device__ constexpr int rows_threads() {
  return (1 << LOG_N) / 8 < 32 ? 32
         : ((1 << LOG_N) / 8 > kThreads ? kThreads : (1 << LOG_N) / 8);
}

template <int LOG_S>
__host__ __device__ constexpr int seg_threads() {
  return (1 << LOG_S) / 8 < 32
             ? 32
             : ((1 << LOG_S) / 8 > kSegThreads ? kSegThreads : (1 << LOG_S) / 8);
}

// Shared-memory slot of element (row i, column c) of an n x C tile.
template <int C>
__device__ __forceinline__ int slot(int i, int c) {
  if constexpr (C == 1) {
    return i + ((i >> 5) << 2);   // 4 pad floats after every 32
  } else {
    return i * C + c;
  }
}

template <int N, int C>
__host__ __device__ constexpr int tile_floats() {
  return C == 1 ? N + ((N >> 5) << 2) : N * C;
}

// The Sylvester butterflies of 2^G values held in registers.
template <int G>
__device__ __forceinline__ void butterflies(float* v) {
#pragma unroll
  for (int hh = 1; hh < (1 << G); hh <<= 1) {
#pragma unroll
    for (int j = 0; j < (1 << G); ++j) {
      if ((j & hh) == 0) {
        const float a = v[j];
        const float b = v[j + hh];
        v[j] = a + b;
        v[j + hh] = a - b;
      }
    }
  }
}

// G butterfly stages at row strides H, 2H, ..., 2^(G-1) H over an N-row,
// C-column tile. Work item (g, c) holds rows base + j*H (j < 2^G) of column
// c, where base has the G row bits from log2(H) upward cleared. Values come
// from device memory (element (i, c) at in[i * ld + c]) or from the shared
// tile, times the pre-sign sg[i * ld + c] when pre, and go to device memory
// (times the post-sign when post) or back to the tile. Items are taken in
// chunks of at most 16 values per thread: all of a chunk's loads are issued
// first. ACC with add: each store to device memory adds what out holds there,
// which this thread stored itself (the item map is the same on every call).
template <int G, int H, int N, int C, int T, bool FROM_GLOBAL, bool TO_GLOBAL,
          bool ACC = false>
__device__ __forceinline__ void group(float* tile, const float* in, float* out,
                                      const float* sg, long long ld, bool pre,
                                      bool post, bool add = false) {
  constexpr int R = 1 << G;
  constexpr int ITEMS = (N >> G) * C;
  constexpr int PER = (ITEMS + T - 1) / T;
  constexpr int CH0 = R < 16 ? 16 / R : 1;
  constexpr int CH = CH0 < PER ? CH0 : PER;
  constexpr bool VEC = C == 1 && H == 1 && R == 8;   // 8 contiguous: 2 x 16 B
#pragma unroll 1
  for (int k0 = 0; k0 < PER; k0 += CH) {
    float v[CH][R];
    int base[CH];
    int col[CH];
    bool ok[CH];
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int it = threadIdx.x + (k0 + k) * T;
      ok[k] = (ITEMS % T == 0 && PER % CH == 0) || (k0 + k < PER && it < ITEMS);
      col[k] = it % C;
      const int g = it / C;
      base[k] = (g / H) * (H << G) + (g % H);
      if (!ok[k]) continue;
      if constexpr (VEC) {
        const float* src;
        if constexpr (FROM_GLOBAL) {
          src = in + base[k];
        } else {
          src = tile + slot<C>(base[k], 0);
        }
        const float4* p = reinterpret_cast<const float4*>(src);
        const float4 a = p[0];
        const float4 b = p[1];
        v[k][0] = a.x; v[k][1] = a.y; v[k][2] = a.z; v[k][3] = a.w;
        v[k][4] = b.x; v[k][5] = b.y; v[k][6] = b.z; v[k][7] = b.w;
        if (pre) {
          const float4* q = reinterpret_cast<const float4*>(sg + base[k]);
          const float4 s = q[0];
          const float4 t = q[1];
          v[k][0] *= s.x; v[k][1] *= s.y; v[k][2] *= s.z; v[k][3] *= s.w;
          v[k][4] *= t.x; v[k][5] *= t.y; v[k][6] *= t.z; v[k][7] *= t.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int i = base[k] + j * H;
          const long long at = i * ld + col[k];
          float x;
          if constexpr (FROM_GLOBAL) {
            x = in[at];
          } else {
            x = tile[slot<C>(i, col[k])];
          }
          if (pre) x *= sg[at];
          v[k][j] = x;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      if (!ok[k]) continue;
      butterflies<G>(v[k]);
      if constexpr (VEC && !TO_GLOBAL) {
        float4* p = reinterpret_cast<float4*>(tile + slot<C>(base[k], 0));
        p[0] = make_float4(v[k][0], v[k][1], v[k][2], v[k][3]);
        p[1] = make_float4(v[k][4], v[k][5], v[k][6], v[k][7]);
      } else {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int i = base[k] + j * H;
          if constexpr (TO_GLOBAL) {
            const long long at = i * ld + col[k];
            float x = v[k][j];
            if (post) x *= sg[at];
            if constexpr (ACC) {
              if (add) x += out[at];
            }
            out[at] = x;
          } else {
            tile[slot<C>(i, col[k])] = v[k][j];
          }
        }
      }
    }
  }
  if constexpr (!TO_GLOBAL) __syncthreads();
}

// two_pass: the whole transform of an N = 2^LOG_N row tile: the first group
// (the LOG_N mod 3 stages, or 3) from device memory, whole radix-8 groups
// through shared memory, the last to device memory. `in` and `out` may be
// the same tile: every element is loaded before the last group stores.
template <int LOG_N, int C, int T>
__device__ __forceinline__ void transform(float* tile, const float* in,
                                          float* out, const float* sg,
                                          long long ld, bool pre, bool post) {
  constexpr int N = 1 << LOG_N;
  constexpr int NG = (LOG_N + 2) / 3;
  if constexpr (NG == 0) {
    for (int c = threadIdx.x; c < C; c += T) {
      float x = in[c];
      if (pre) x *= sg[c];
      if (post) x *= sg[c];
      out[c] = x;
    }
  } else {
    constexpr int G0 = LOG_N - 3 * (NG - 1);
    if constexpr (NG == 1) {
      group<G0, 1, N, C, T, true, true>(tile, in, out, sg, ld, pre, post);
    } else {
      group<G0, 1, N, C, T, true, false>(tile, in, out, sg, ld, pre, false);
      if constexpr (NG >= 3) {
        group<3, (1 << G0), N, C, T, false, false>(tile, in, out, sg, ld,
                                                   false, false);
      }
      if constexpr (NG >= 4) {
        group<3, (1 << (G0 + 3)), N, C, T, false, false>(tile, in, out, sg,
                                                         ld, false, false);
      }
      static_assert(NG <= 4, "at most 4 stage groups (2^12 rows)");
      group<3, (1 << (LOG_N - 3)), N, C, T, false, true>(tile, in, out, sg, ld,
                                                         false, post);
    }
  }
}

// two_pass pass 1: one block per contiguous segment of b = 2^LOG_B floats;
// segment seg starts at element seg * b.
template <int LOG_B>
__global__ void __launch_bounds__(rows_threads<LOG_B>())
fwht_rows_kernel(const float* __restrict__ x, const float* __restrict__ signs,
                 float* __restrict__ y, int log_w, int E, int pre, int post) {
  __shared__ __align__(16) float tile[tile_floats<(1 << LOG_B), 1>()];
  const long long seg = blockIdx.x;
  const long long off = seg << LOG_B;
  const long long r = seg >> (log_w - LOG_B);
  const float* sg =
      signs ? signs + (r % E) * (1LL << log_w) + (off - (r << log_w)) : nullptr;
  transform<LOG_B, 1, rows_threads<LOG_B>()>(tile, x + off, y + off, sg, 1,
                                             pre != 0, post != 0);
}

// two_pass pass 2: one block per (row, 32-column strip) of the (a, b) view,
// in place.
template <int LOG_A>
__global__ void __launch_bounds__(kThreads)
fwht_cols_kernel(float* y, const float* __restrict__ signs, int log_b, int E,
                 int post) {
  extern __shared__ __align__(16) float dyn_tile[];
  const long long b = 1LL << log_b;
  const long long strips = b / kCols;
  const long long r = blockIdx.x / strips;
  const long long col0 = (blockIdx.x % strips) * kCols;
  const long long w = b << LOG_A;
  float* base = y + r * w + col0;
  const float* sg = signs ? signs + (r % E) * w + col0 : nullptr;
  transform<LOG_A, kCols, kThreads>(dyn_tile, base, base, sg, b, false,
                                    post != 0);
}

// ---- the on-chip routes ------------------------------------------------------

// 16 bytes from device memory to shared memory, past the registers.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `pending` of this thread's committed groups are still
// in flight (the instruction takes an immediate).
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// A cluster barrier in two halves, without the release of memory that
// cluster.sync() implies: it orders execution only. Where the barrier is
// there to say "I have finished reading your tile", the reads are complete
// once the values they returned have been used, and nothing waits for this
// block's own stores to device memory to drain.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// All LOG_N <= 12 stages of a one-row tile that already sits in shared
// memory: pre-signs in the first group, and the last group to device
// memory (with the post-signs, and added to what it holds when ACC and add)
// when TO_GLOBAL, else back to the tile.
template <int LOG_N, int T, bool TO_GLOBAL, bool ACC = false>
__device__ __forceinline__ void tile_transform(float* tile, float* out,
                                               const float* sg, bool pre,
                                               bool post, bool add = false) {
  constexpr int N = 1 << LOG_N;
  constexpr int NG = (LOG_N + 2) / 3;
  static_assert(NG >= 1 && NG <= 4, "1 to 12 stages");
  constexpr int G0 = LOG_N - 3 * (NG - 1);
  if constexpr (NG == 1) {
    group<G0, 1, N, 1, T, false, TO_GLOBAL, ACC>(tile, nullptr, out, sg, 1, pre,
                                                 post, add);
  } else {
    group<G0, 1, N, 1, T, false, false>(tile, nullptr, out, sg, 1, pre, false);
    if constexpr (NG >= 3) {
      group<3, (1 << G0), N, 1, T, false, false>(tile, nullptr, out, sg, 1,
                                                 false, false);
    }
    if constexpr (NG >= 4) {
      group<3, (1 << (G0 + 3)), N, 1, T, false, false>(tile, nullptr, out, sg, 1,
                                                       false, false);
    }
    group<3, (1 << (LOG_N - 3)), N, 1, T, false, TO_GLOBAL, ACC>(
        tile, nullptr, out, sg, 1, false, post, add);
  }
}

// A thread of the 2^13 .. 2^15 kernels keeps the (at most 64) signs it will
// need as one bit each, so that no sign load waits in the queue behind the
// row's own cp.async traffic. Bit b set means sign -1; the sign is applied
// by flipping the value's sign bit, which is what a product with -1.0f
// does. (The signs are +-1: only their sign bits are kept.)
struct SignBits {
  unsigned lo = 0, hi = 0;
  template <int B>
  __device__ __forceinline__ void set(float s) {   // bit B = the sign of s
    const unsigned u = __float_as_uint(s) & 0x80000000u;
    if constexpr (B < 32) {
      lo |= u >> (31 - B);
    } else {
      hi |= u >> (63 - B);
    }
  }
  __device__ __forceinline__ unsigned byte(int i) const {   // bits 8i .. 8i+7
    return ((i < 4 ? lo : hi) >> (8 * (i & 3))) & 0xffu;
  }
  // bits b, b + 1, ... up to the end of b's 32-bit half, from bit 0 up
  __device__ __forceinline__ unsigned from(int b) const {
    return (b < 32 ? lo : hi) >> (b & 31);
  }
};

// bits[B] = the sign of s[B], for each B of the sequence.
template <int... B>
__device__ __forceinline__ void set_signs(SignBits& bits, const float* s,
                                          std::integer_sequence<int, B...>) {
  (bits.set<B>(s[B]), ...);
}

// v with its sign flipped if bit j of bits is set.
__device__ __forceinline__ float flip(float v, unsigned bits, int j) {
  return __uint_as_float(__float_as_uint(v) ^ ((bits << (31 - j)) & 0x80000000u));
}

// The post-signs top_group<LOG_S - 10, S, T, true> will apply, in its order:
// bit i R + j for element threadIdx.x + i T + j 2^10 of the segment.
template <int LOG_S, int T>
__device__ __forceinline__ SignBits top_group_signs(const float* sgl) {
  constexpr int R = 1 << (LOG_S - kLowLog);
  constexpr int PER = (1 << kLowLog) / T;
  float s[PER * R];
#pragma unroll
  for (int b = 0; b < PER * R; ++b) {
    s[b] = sgl[threadIdx.x + (b / R) * T + (b % R) * (1 << kLowLog)];
  }
  SignBits bits;
  set_signs(bits, s, std::make_integer_sequence<int, PER * R>{});
  return bits;
}

// The last LOG_S - 10 stages of a one-row tile (strides 2^10 and up): work
// item g holds elements g + j 2^10. To device memory with the post-signs
// (see top_group_signs), or back to the tile. ACC with add: each result is
// added to what out holds, which this thread stored there itself (the item
// map is the same on every call).
template <int G, int S, int T, bool TO_GLOBAL, bool ACC = false>
__device__ __forceinline__ void top_group(float* tile, float* out,
                                          const SignBits& sbits, bool post,
                                          bool add = false) {
  constexpr int R = 1 << G;
  constexpr int H = 1 << kLowLog;
  constexpr int PER = (S >> G) / T;
  constexpr int CH0 = R < 16 ? 16 / R : 1;
  constexpr int CH = CH0 < PER ? CH0 : PER;
  static_assert((S >> G) == H && H % T == 0 && PER % CH == 0 && PER * R <= 64 &&
                    64 % (CH * R) == 0,
                "one item per element of the lowest 2^10");
#pragma unroll 1
  for (int i0 = 0; i0 < PER; i0 += CH) {
    float v[CH][R];
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int g = threadIdx.x + (i0 + k) * T;
#pragma unroll
      for (int j = 0; j < R; ++j) v[k][j] = tile[slot<1>(g + j * H, 0)];
    }
    const unsigned turn = sbits.from(i0 * R);   // this turn's CH R signs
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int g = threadIdx.x + (i0 + k) * T;
      butterflies<G>(v[k]);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if constexpr (TO_GLOBAL) {
          float r = post ? flip(v[k][j], turn, k * R + j) : v[k][j];
          if constexpr (ACC) {
            if (add) r += out[g + j * H];
          }
          out[g + j * H] = r;
        } else {
          tile[slot<1>(g + j * H, 0)] = v[k][j];
        }
      }
    }
  }
  if constexpr (!TO_GLOBAL) __syncthreads();
}

// Stages 0 to 9 of a 2^13 .. 2^15 tile, chunk by chunk: two radix-32
// groups on each chunk of 2^14, waiting first for the chunk's cp.async
// group when the row is streaming in (STREAMED). pre: the pre-signs, bits
// 32 q and up of sbits for this thread's item of chunk q.
template <int LOG_S, int T, bool STREAMED>
__device__ __forceinline__ void chunk_stages(float* tile, const SignBits& sbits,
                                             bool pre) {
  constexpr int LOG_Q = LOG_S > kChunkLog ? kChunkLog : LOG_S;
  constexpr int NQ = (1 << LOG_S) >> LOG_Q;
  constexpr int IA = (1 << LOG_Q) / 32;   // radix-32 items of a chunk
#pragma unroll 1
  for (int q = 0; q < NQ; ++q) {
    if constexpr (STREAMED) cp_async_wait(NQ - 1 - q);
    __syncthreads();
    float* ct = tile + slot<1>(q << LOG_Q, 0);
    // stages 0 to 4: 32 contiguous floats a thread
    if (threadIdx.x < IA) {
      float4* tp = reinterpret_cast<float4*>(ct + slot<1>(32 * threadIdx.x, 0));
      float v[32];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a = tp[i];
        v[4 * i] = a.x; v[4 * i + 1] = a.y; v[4 * i + 2] = a.z; v[4 * i + 3] = a.w;
      }
      if (pre) {
        const unsigned word = sbits.from(32 * q);
#pragma unroll
        for (int j = 0; j < 32; ++j) v[j] = flip(v[j], word, j);
      }
      butterflies<5>(v);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        tp[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
      }
    }
    __syncthreads();
    // stages 5 to 9: strides 32 to 512, inside each 2^10 floats
    group<5, 32, (1 << LOG_Q), 1, T, false, false>(ct, nullptr, nullptr, nullptr,
                                                   1, false, false);
  }
}

// Scatter mode in a cluster of 2^LC blocks, each with a finished 2^15
// segment in its tile: the top LC stages. Block c takes positions
// [c 2^15 / C, (c + 1) 2^15 / C) of every segment, four at a time: one
// 16-byte read from each block's tile, the butterflies across the C
// segments in registers, and then C 16-byte stores to device memory with
// the post-signs (bit (n C + m) 4 + l of sbits for segment m in the
// thread's n-th turn). No position is read by two blocks. Block c reads
// the tiles in the order j ^ c, so that the C blocks do not all ask the
// same one at once; the transform of the segments in that order is the
// wanted one times (-1)^popcount(m & c) at output m.
template <int LC>
__device__ __forceinline__ void top_stages(cg::cluster_group& cluster,
                                           float* tile, int c, float* yrow,
                                           const SignBits& sbits, bool post) {
  constexpr int Cn = 1 << LC;
  constexpr int PB = (1 << kSegMaxLog) >> LC;   // positions of this block
  int n = 0;
#pragma unroll 1
  for (int v = threadIdx.x; v < PB / 4; v += kSegThreads, ++n) {
    const int p = c * PB + 4 * v;
    const int sl = slot<1>(p, 0);
    float val[4][Cn];
#pragma unroll
    for (int j = 0; j < Cn; ++j) {
      const float4 t = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(tile, j ^ c) + sl);
      val[0][j] = t.x; val[1][j] = t.y; val[2][j] = t.z; val[3][j] = t.w;
    }
#pragma unroll
    for (int l = 0; l < 4; ++l) butterflies<LC>(val[l]);
#pragma unroll
    for (int m = 0; m < Cn; ++m) {
      // 4 bits: the post-signs, each xor the sign of the reading order
      unsigned neg = (__popc(m & c) & 1) ? 0xfu : 0u;
      if (post) neg ^= sbits.byte((n * Cn + m) / 2) >> (4 * (m & 1));
      *reinterpret_cast<float4*>(
          yrow + (static_cast<long long>(m) << kSegMaxLog) + p) =
          make_float4(flip(val[0][m], neg, 0), flip(val[1][m], neg, 1),
                      flip(val[2][m], neg, 2), flip(val[3][m], neg, 3));
    }
  }
}

// The post-signs top_stages<LC> will apply, in its order: bit (n C + m) 4 + l.
template <int LC>
__device__ __forceinline__ SignBits top_stage_signs(const float* sg, int c) {
  constexpr int Cn = 1 << LC;
  constexpr int PB = (1 << kSegMaxLog) >> LC;
  static_assert(PB / 4 / kSegThreads * Cn == 16, "64 signs a thread");
  float s[64];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float4 s4 = *reinterpret_cast<const float4*>(
        sg + (static_cast<long long>(i % Cn) << kSegMaxLog) + c * PB +
        4 * (threadIdx.x + (i / Cn) * kSegThreads));
    s[4 * i] = s4.x; s[4 * i + 1] = s4.y; s[4 * i + 2] = s4.z; s[4 * i + 3] = s4.w;
  }
  SignBits bits;
  set_signs(bits, s, std::make_integer_sequence<int, 64>{});
  return bits;
}

// One row of a launch on one block, or one 2^15 segment of a row in a
// cluster (CLUSTER, scatter mode only), in all three modes, with sign and
// index row e = re % E (fwht_onchip_kernel passes its row r; the modulo is
// taken only where signs or indices are given), or e = re for a row of
// fwht_blocks_kernel (BLOCKS), which knows its block:
//   kPlain  : the row's w inputs at x row rx -> its w outputs at y row ry
//   kScatter: the row's k values at x row rx, placed at idx[e] of a zero row
//             -> its w outputs at y row ry
//   kGather : the row's w inputs at x row rx -> its transform's entries at
//             idx[e], to y row ry (k floats)
// In a cluster of 2^log_c blocks, block c owns elements [c 2^15, (c + 1)
// 2^15) of the row (w = 2^(15 + log_c)), runs the local stages on what was
// scattered there and the top stages on the way out (top_stages). BLOCKS in
// scatter mode, with add: the w outputs are added to what y row ry holds,
// which this block stored there itself (fwht_blocks_kernel's sum).
template <int LOG_S, int MODE, bool CLUSTER, bool BLOCKS = false>
__device__ __forceinline__ void onchip_row(float* tile, const float* x,
                                           const float* signs, float* y,
                                           const int* idx, int k, long long rx,
                                           long long ry, long long re, int E,
                                           int c, int pre, int post, int log_c,
                                           bool add = false) {
  constexpr int S = 1 << LOG_S;
  constexpr int T = seg_threads<LOG_S>();
  static_assert(!CLUSTER || MODE == kScatter, "a cluster here only scatters");
  static_assert(!BLOCKS || (MODE != kPlain && !CLUSTER), "a block-indexed product");
  constexpr bool TO_GLOBAL = MODE != kGather && !CLUSTER;
  constexpr bool ACC = BLOCKS && TO_GLOBAL;   // the in-order sum
  constexpr bool CHUNKED = LOG_S > kSmallMaxLog;
  constexpr int LOG_Q = LOG_S > kChunkLog ? kChunkLog : LOG_S;   // chunk
  constexpr int NQ = S >> LOG_Q;
  constexpr int IA = (1 << LOG_Q) / 32;   // radix-32 items of a chunk
  const long long w = static_cast<long long>(S) << (CLUSTER ? log_c : 0);
  const long long seg0 = static_cast<long long>(c) << LOG_S;
  const float* sg = signs ? signs + (BLOCKS ? re : re % E) * w : nullptr;   // the row's
  const float* sgl = sg ? sg + seg0 : nullptr;   // the segment's signs
  const int* ix = idx ? idx + (BLOCKS ? re : re % E) * static_cast<long long>(k)
                      : nullptr;
  const bool pre_l = pre && MODE != kScatter;
  const bool post_l = post && TO_GLOBAL;
  SignBits sbits;
  // 1. the segment into shared memory
  if constexpr (MODE == kScatter) {
    if constexpr (CHUNKED) {   // the post-signs: nothing waits for them yet
      if constexpr (CLUSTER) {
        if (post) {
          switch (log_c) {
            case 1: sbits = top_stage_signs<1>(sg, c); break;
            case 2: sbits = top_stage_signs<2>(sg, c); break;
            case 3: sbits = top_stage_signs<3>(sg, c); break;
            default: sbits = top_stage_signs<4>(sg, c); break;
          }
        }
      } else {
        if (post) sbits = top_group_signs<LOG_S, T>(sgl);
      }
    }
    constexpr int TF = tile_floats<S, 1>();
    if constexpr (S >= 32) {
      for (int v = threadIdx.x; v < TF / 4; v += T) {
        reinterpret_cast<float4*>(tile)[v] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int v = threadIdx.x; v < TF; v += T) tile[v] = 0.f;
    }
    __syncthreads();
    const float* vals = x + rx * static_cast<long long>(k);
    for (int j = threadIdx.x; j < k; j += T) {
      const long long at = ix[j];
      const unsigned long long p = static_cast<unsigned long long>(at - seg0);
      if (p < static_cast<unsigned long long>(S)) {   // in this segment
        float v = vals[j];
        if (pre) v *= sg[at];
        tile[slot<1>(static_cast<int>(p), 0)] = v;
      }
    }
  } else {
    const float* src = x + rx * w + seg0;
    // the pre-signs are asked for first and packed once the copies are out
    // A warp's 32 items of a chunk are 2^10 contiguous floats, item l the
    // 32 from 32 l on. Lane l reads sign 32 i + l for i < 32, one 128-byte
    // line a warp a load; the ballot over the lanes of load i is then the 32
    // signs of item i.
    float raw[CHUNKED ? 32 * NQ : 1];
    const int lane = threadIdx.x & 31;
    if constexpr (CHUNKED) {
      static_assert(IA <= T && IA % 32 == 0 && NQ <= 2,
                    "one item a thread a chunk, 64 signs");
      if (pre_l && threadIdx.x < IA) {
#pragma unroll
        for (int i = 0; i < 32 * NQ; ++i) {
          raw[i] = sgl[((i / 32) << LOG_Q) + 32 * (threadIdx.x - lane) +
                        32 * (i % 32) + lane];
        }
      }
    }
    if constexpr (S >= 4) {
#pragma unroll 1
      for (int q = 0; q < NQ; ++q) {
        for (int v = threadIdx.x; v < (1 << LOG_Q) / 4; v += T) {
          const int i = (q << LOG_Q) + 4 * v;
          cp_async16(tile + slot<1>(i, 0), src + i);
        }
        cp_async_commit();
      }
    } else {
      for (int i = threadIdx.x; i < S; i += T) tile[i] = src[i];
    }
    if constexpr (CHUNKED) {
      if (pre_l && threadIdx.x < IA) {
#pragma unroll
        for (int i = 0; i < 32 * NQ; ++i) {
          const unsigned word = __ballot_sync(0xffffffffu, raw[i] < 0.f);
          if (lane == i % 32) (i < 32 ? sbits.lo : sbits.hi) = word;
        }
      }
    }
  }

  // 2. the LOG_S stages local to the segment
  float* outp = TO_GLOBAL ? y + ry * w + seg0 : nullptr;
  if constexpr (LOG_S == 0) {
    __syncthreads();
    if (threadIdx.x == 0) {
      float v = tile[0];
      if (pre_l || post_l) v *= sgl[0];
      if constexpr (TO_GLOBAL) {
        if constexpr (ACC) {
          if (add) v += outp[0];
        }
        outp[0] = v;
      } else {
        tile[0] = v;
      }
    }
    __syncthreads();
  } else if constexpr (!CHUNKED) {
    if constexpr (MODE != kScatter && S >= 4) cp_async_wait(0);
    __syncthreads();
    tile_transform<LOG_S, T, TO_GLOBAL, ACC>(tile, outp, sgl, pre_l, post_l, add);
  } else {
    chunk_stages<LOG_S, T, MODE != kScatter>(tile, sbits, pre_l);
    if constexpr (MODE == kPlain && !CLUSTER) {
      if (post_l) sbits = top_group_signs<LOG_S, T>(sgl);
    }
    top_group<LOG_S - kLowLog, S, T, TO_GLOBAL, ACC>(tile, outp, sbits, post_l,
                                                     add);
  }

  // 3. in a cluster: the top stages on the way out
  if constexpr (CLUSTER) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();   // every segment is finished before any remote read
    float* yrow = y + ry * w;
    switch (log_c) {
      case 1: top_stages<1>(cluster, tile, c, yrow, sbits, post); break;
      case 2: top_stages<2>(cluster, tile, c, yrow, sbits, post); break;
      case 3: top_stages<3>(cluster, tile, c, yrow, sbits, post); break;
      default: top_stages<4>(cluster, tile, c, yrow, sbits, post); break;
    }
    // no block leaves while another still reads its tile; its stores to
    // device memory drain behind it
    cluster_arrive_relaxed();
    cluster_wait();
  }

  // 4. gather mode: only the indexed outputs leave the chip
  if constexpr (MODE == kGather) {
    float* outk = y + ry * static_cast<long long>(k);
    for (int j = threadIdx.x; j < k; j += T) {
      const long long at = ix[j];
      const unsigned long long p = static_cast<unsigned long long>(at - seg0);
      if (p < static_cast<unsigned long long>(S)) {   // in this segment
        float v = tile[slot<1>(static_cast<int>(p), 0)];
        if (post) v *= sg[at];
        outk[j] = v;
      }
    }
  }
}

// One row per block (CLUSTER false, w = 2^LOG_S), in all three modes (x, y
// (R, w), or (R, k) on the index side; row r takes sign and index row r % E),
// or, in scatter mode, one row per cluster of 2^log_c blocks (CLUSTER true,
// LOG_S = 15, w = 2^(15 + log_c)): see onchip_row. Rows that come from
// device memory take fwht_cluster_rows_kernel in a cluster.
template <int LOG_S, int MODE, bool CLUSTER>
__global__ void __launch_bounds__(seg_threads<LOG_S>())
fwht_onchip_kernel(const float* __restrict__ x, const float* __restrict__ signs,
                   float* __restrict__ y, const int* __restrict__ idx, int k,
                   int E, int nb, int pre, int post, int log_c) {
  extern __shared__ __align__(16) float dyn_tile[];
  int c = 0;
  unsigned u = blockIdx.x;   // which row of the launch order
  if constexpr (CLUSTER) {
    c = static_cast<int>(blockIdx.x & ((1u << log_c) - 1u));
    u = blockIdx.x >> log_c;
  }
  // launch order: the nb rows that share sign (and index) row e run next to
  // each other, so that row is read from device memory once and then from L2
  const long long r = static_cast<long long>(u % nb) * E + u / nb;
  onchip_row<LOG_S, MODE, CLUSTER>(dyn_tile, x, signs, y, idx, k, r, r, r, E, c,
                                   pre, post, log_c);
}

// The block-indexed products of a design of E blocks whose window side, of
// width w = 2^LOG_S, is Lw blocks: window block s holds the design's blocks
// blocks[ptr[s]] .. blocks[ptr[s + 1] - 1], in ascending order (a segment
// table). The window side is addressed by block index, so no (B, E, w) copy
// of it exists in device memory. Each row runs onchip_row's steps.
//   kGather : x (B, Lw, w) -> y (B, E, k). Launch row u is (window block s,
//             codeword b, the j-th block e of s), in that order of nesting:
//             the omega blocks that read x[b, s] run next to each other (it is
//             read from device memory once, then from L2), and so do the
//             sign rows of s's blocks across b. Row (b, e) of y is the
//             gather at idx[e] of the transform of x[b, s] with signs[e].
//   kScatter: x (B, E, k) -> y (B, Lw, w). Block u owns row (b, s) of y,
//             u = s B + b, and walks the blocks e of s in ascending order:
//             it scatters x[b, e] at idx[e], transforms, applies signs[e]
//             and stores the first block's result, then adds each later
//             one to what it stored, so that the sum is
//             ((p0 + p1) + p2) + ... on every run: no float atomics, no
//             zero fill. A window block with no blocks is stored as zeros.
template <int LOG_S, int MODE>
__global__ void __launch_bounds__(seg_threads<LOG_S>())
fwht_blocks_kernel(const float* __restrict__ x, const float* __restrict__ signs,
                   float* __restrict__ y, const int* __restrict__ idx, int k,
                   int E, int B, int Lw, const int* __restrict__ ptr,
                   const int* __restrict__ blocks) {
  extern __shared__ __align__(16) float dyn_tile[];
  const int pre = MODE == kGather && signs != nullptr;
  const int post = MODE == kScatter && signs != nullptr;
  const long long u = blockIdx.x;
  if constexpr (MODE == kGather) {
    int s = 0, hi = Lw;   // the last s with B ptr[s] <= u
    while (hi - s > 1) {
      const int mid = (s + hi) >> 1;
      if (static_cast<long long>(ptr[mid]) * B <= u) {
        s = mid;
      } else {
        hi = mid;
      }
    }
    const int n = ptr[s + 1] - ptr[s];
    const long long at = u - static_cast<long long>(ptr[s]) * B;
    const long long b = at / n;
    const long long e = blocks[ptr[s] + static_cast<int>(at % n)];
    onchip_row<LOG_S, kGather, false, true>(dyn_tile, x, signs, y, idx, k,
                                            b * Lw + s, b * E + e, e, E, 0, pre,
                                            post, 0);
  } else {
    const int s = static_cast<int>(u / B);
    const long long b = u % B;
    const long long ry = b * Lw + s;
    const int j0 = ptr[s], j1 = ptr[s + 1];
    if (j0 == j1) {
      float* out = y + (ry << LOG_S);
      for (long long i = threadIdx.x; i < (1LL << LOG_S); i += blockDim.x) out[i] = 0.f;
      return;
    }
    for (int j = j0; j < j1; ++j) {
      const long long e = blocks[j];
      if (j > j0) __syncthreads();   // the last block's transform left the tile
      onchip_row<LOG_S, kScatter, false, true>(dyn_tile, x, signs, y, idx, k,
                                               b * E + e, ry, e, E, 0, pre, post,
                                               0, j > j0);
    }
  }
}

// ---- the cluster route with the top stages first: persistent clusters ---------

// Block c's share of a row held by 2^LC blocks, asked for from device
// memory: positions [c 2^15 / C, (c + 1) 2^15 / C) of all C segments, 64
// floats a thread as 16 pieces of 16 bytes, piece i = n C + kk for segment
// kk in the thread's n-th turn. The first 8 pieces go past the registers
// into a staging buffer in shared memory (cp.async), the other 8 into pf:
// 64 more registers would not stay free while the local stages run.
template <int LC>
__device__ __forceinline__ void ask_row(float* pf, float* stage,
                                        const float* xrow, int c) {
  constexpr int Cn = 1 << LC;
  constexpr int PB = (1 << kSegMaxLog) >> LC;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float* src = xrow + (static_cast<long long>(i % Cn) << kSegMaxLog) +
                       c * PB + 4 * (threadIdx.x + (i / Cn) * kSegThreads);
    if (i < 8) {
      cp_async16(stage + 4 * (i * kSegThreads + threadIdx.x), src);
    } else {
      const float4 t = *reinterpret_cast<const float4*>(src);
      pf[4 * (i - 8)] = t.x; pf[4 * (i - 8) + 1] = t.y;
      pf[4 * (i - 8) + 2] = t.z; pf[4 * (i - 8) + 3] = t.w;
    }
  }
  cp_async_commit();
}

// The top LC stages on the values ask_row brought (with the pre-signs, bits
// in the pieces' order), and result m into block m's tile by a remote store
// that nothing waits for. The stores go out in the order j ^ c (see
// top_stages); for that the inputs carry the factor (-1)^popcount(kk & c).
template <int LC>
__device__ __forceinline__ void cross_send(cg::cluster_group& cluster,
                                           float* tile, int c, const float* pf,
                                           const float* stage,
                                           const SignBits& sbits, bool pre) {
  constexpr int Cn = 1 << LC;
  constexpr int PB = (1 << kSegMaxLog) >> LC;
  cp_async_wait(0);   // this thread's own staged pieces
#pragma unroll
  for (int n = 0; n < 16 / Cn; ++n) {
    float val[4][Cn];
#pragma unroll
    for (int kk = 0; kk < Cn; ++kk) {
      const int i = n * Cn + kk;
      float4 t;
      if (i < 8) {
        t = *reinterpret_cast<const float4*>(
            stage + 4 * (i * kSegThreads + threadIdx.x));
      } else {
        t = make_float4(pf[4 * (i - 8)], pf[4 * (i - 8) + 1], pf[4 * (i - 8) + 2],
                        pf[4 * (i - 8) + 3]);
      }
      unsigned neg = (__popc(kk & c) & 1) ? 0xfu : 0u;
      if (pre) neg ^= sbits.byte(i / 2) >> (4 * (i & 1));
      val[0][kk] = flip(t.x, neg, 0); val[1][kk] = flip(t.y, neg, 1);
      val[2][kk] = flip(t.z, neg, 2); val[3][kk] = flip(t.w, neg, 3);
    }
#pragma unroll
    for (int l = 0; l < 4; ++l) butterflies<LC>(val[l]);
    const int sl = slot<1>(c * PB + 4 * (threadIdx.x + n * kSegThreads), 0);
#pragma unroll
    for (int j = 0; j < Cn; ++j) {
      *reinterpret_cast<float4*>(cluster.map_shared_rank(tile, j ^ c) + sl) =
          make_float4(val[0][j], val[1][j], val[2][j], val[3][j]);
    }
  }
}

// The cluster route for rows that come from device memory (kPlain, kGather),
// 2^16 <= w <= 2^19: as many clusters as the card holds at once, each
// taking rows q, q + Q, q + 2 Q, ... of the launch order. For a row, block
// c asks for its share of all C segments (ask_row), runs the top stages in
// registers and sends the results to their tiles (cross_send); after a
// cluster barrier every block finishes its own segment: the 15 local
// stages, and the stores to device memory or the gather. The next row's
// share is asked for before the local stages begin and arrives in
// registers while they run, so only the first row of a cluster waits for
// device memory. A second barrier (execution only) keeps the next row's
// remote stores off a tile its block still reads.
template <int MODE>
__global__ void __launch_bounds__(kSegThreads)
fwht_cluster_rows_kernel(const float* __restrict__ x,
                         const float* __restrict__ signs, float* __restrict__ y,
                         const int* __restrict__ idx, int k, int E, int nb,
                         int pre, int post, int log_c, int rows) {
  extern __shared__ __align__(16) float dyn_tile[];
  float* tile = dyn_tile;
  constexpr int S = 1 << kSegMaxLog;
  constexpr int T = kSegThreads;
  constexpr bool TO_GLOBAL = MODE == kPlain;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(blockIdx.x & ((1u << log_c) - 1u));
  const int q0 = static_cast<int>(blockIdx.x >> log_c);
  const int nq = static_cast<int>(gridDim.x >> log_c);
  const long long w = static_cast<long long>(S) << log_c;
  const long long seg0 = static_cast<long long>(c) << kSegMaxLog;
  // launch order: the nb rows that share sign (and index) row e run next to
  // each other
  auto row_of = [&](int u) {
    return static_cast<long long>(u % nb) * E + u / nb;
  };
  float pf[32];
  float* stage = tile + tile_floats<S, 1>();   // 8 x 512 pieces of 16 bytes
  auto ask = [&](int u) {
    const float* xrow = x + row_of(u) * w;
    switch (log_c) {
      case 1: ask_row<1>(pf, stage, xrow, c); break;
      case 2: ask_row<2>(pf, stage, xrow, c); break;
      case 3: ask_row<3>(pf, stage, xrow, c); break;
      default: ask_row<4>(pf, stage, xrow, c); break;
    }
  };
  SignBits pre_bits, post_bits;
  long long e_have = -1;
  ask(q0);
  // every block of the cluster runs before any remote store
  cluster_arrive_relaxed();
  cluster_wait();
  for (int u = q0; u < rows; u += nq) {
    const long long r = row_of(u);
    const long long e = r % E;
    const float* sg = signs ? signs + e * w : nullptr;
    if (sg != nullptr && e != e_have) {   // a new sign row: its bits
      e_have = e;
      if (pre) {
        switch (log_c) {
          case 1: pre_bits = top_stage_signs<1>(sg, c); break;
          case 2: pre_bits = top_stage_signs<2>(sg, c); break;
          case 3: pre_bits = top_stage_signs<3>(sg, c); break;
          default: pre_bits = top_stage_signs<4>(sg, c); break;
        }
      }
      if (TO_GLOBAL && post) {
        post_bits = top_group_signs<kSegMaxLog, T>(sg + seg0);
      }
    }
    switch (log_c) {
      case 1: cross_send<1>(cluster, tile, c, pf, stage, pre_bits, pre); break;
      case 2: cross_send<2>(cluster, tile, c, pf, stage, pre_bits, pre); break;
      case 3: cross_send<3>(cluster, tile, c, pf, stage, pre_bits, pre); break;
      default: cross_send<4>(cluster, tile, c, pf, stage, pre_bits, pre); break;
    }
    cluster.sync();   // every tile is whole
    if (u + nq < rows) ask(u + nq);
    chunk_stages<kSegMaxLog, T, false>(tile, pre_bits, false);
    top_group<kSegMaxLog - kLowLog, S, T, TO_GLOBAL>(
        tile, TO_GLOBAL ? y + r * w + seg0 : nullptr, post_bits,
        TO_GLOBAL && post);
    if constexpr (MODE == kGather) {
      const int* ix = idx + e * static_cast<long long>(k);
      float* outk = y + r * static_cast<long long>(k);
      for (int j = threadIdx.x; j < k; j += T) {
        const long long at = ix[j];
        const unsigned long long p = static_cast<unsigned long long>(at - seg0);
        if (p < static_cast<unsigned long long>(S)) {   // in this segment
          float v = tile[slot<1>(static_cast<int>(p), 0)];
          if (post) v *= sg[at];
          outk[j] = v;
        }
      }
    }
    // no remote store of the next row lands on a tile still being read
    cluster_arrive_relaxed();
    cluster_wait();
  }
}

template <int LOG_B>
cudaError_t launch_rows(long long segments, const float* x, const float* signs,
                        float* y, int log_w, int E, int pre, int post,
                        cudaStream_t st) {
  fwht_rows_kernel<LOG_B><<<static_cast<unsigned>(segments),
                            rows_threads<LOG_B>(), 0, st>>>(x, signs, y, log_w,
                                                            E, pre, post);
  return cudaGetLastError();
}

template <int LOG_A>
cudaError_t launch_cols(long long tiles, float* y, const float* signs,
                        int log_b, int E, int post, cudaStream_t st) {
  const int smem = static_cast<int>(sizeof(float)) * kCols << LOG_A;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fwht_cols_kernel<LOG_A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  fwht_cols_kernel<LOG_A><<<static_cast<unsigned>(tiles), kThreads, smem,
                            st>>>(y, signs, log_b, E, post);
  return cudaGetLastError();
}

cudaError_t run_rows(int log_b, long long segments, const float* x,
                     const float* signs, float* y, int log_w, int E, int pre,
                     int post, cudaStream_t st) {
  switch (log_b) {
#define LDPC_ROWS(L) \
  case L:            \
    return launch_rows<L>(segments, x, signs, y, log_w, E, pre, post, st);
    LDPC_ROWS(5) LDPC_ROWS(6) LDPC_ROWS(7) LDPC_ROWS(8) LDPC_ROWS(9)
    LDPC_ROWS(10) LDPC_ROWS(11) LDPC_ROWS(12)
#undef LDPC_ROWS
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t run_cols(int log_a, long long tiles, float* y, const float* signs,
                     int log_b, int E, int post, cudaStream_t st) {
  switch (log_a) {
#define LDPC_COLS(L) \
  case L:            \
    return launch_cols<L>(tiles, y, signs, log_b, E, post, st);
    LDPC_COLS(5) LDPC_COLS(6) LDPC_COLS(7) LDPC_COLS(8) LDPC_COLS(9)
    LDPC_COLS(10)
#undef LDPC_COLS
    default:
      return cudaErrorInvalidValue;
  }
}

template <int LOG_S, int MODE, bool CLUSTER>
cudaError_t launch_onchip(long long rows, int log_c, const float* x,
                          const float* signs, float* y, const int* idx, int k,
                          int E, int pre, int post, cudaStream_t st) {
  auto kernel = fwht_onchip_kernel<LOG_S, MODE, CLUSTER>;
  constexpr int smem =
      static_cast<int>(sizeof(float)) * tile_floats<(1 << LOG_S), 1>();
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  if (CLUSTER && log_c > 3) {   // 16 blocks: above the portable cluster size
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows << log_c), 1, 1);
  cfg.blockDim = dim3(seg_threads<LOG_S>(), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << log_c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CLUSTER ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, x, signs, y, idx, k, E,
                            static_cast<int>(rows / E), pre, post, log_c);
}

// Launches the persistent cluster kernel: as many clusters as the card holds
// at once (asked once per cluster size), at most one a row. When
// `active_clusters` is given it only reports that number.
template <int MODE>
cudaError_t launch_cluster_rows(long long rows, int log_c, const float* x,
                                const float* signs, float* y, const int* idx,
                                int k, int E, int pre, int post,
                                cudaStream_t st, int* active_clusters) {
  auto kernel = fwht_cluster_rows_kernel<MODE>;
  constexpr int smem = static_cast<int>(sizeof(float)) *
                       (tile_floats<(1 << kSegMaxLog), 1>() + 32 * kSegThreads);
  static int held[kClusterMaxLog + 1] = {0, 0, 0, 0, 0};
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kSegThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << log_c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (held[log_c] == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (log_c > 3) {   // 16 blocks: above the portable cluster size
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
    }
    cfg.gridDim = dim3(1u << log_c, 1, 1);
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorLaunchOutOfResources;
    held[log_c] = n;
  }
  if (active_clusters != nullptr) {
    *active_clusters = held[log_c];
    return cudaSuccess;
  }
  const long long clusters = rows < held[log_c] ? rows : held[log_c];
  cfg.gridDim = dim3(static_cast<unsigned>(clusters << log_c), 1, 1);
  return cudaLaunchKernelEx(&cfg, kernel, x, signs, y, idx, k, E,
                            static_cast<int>(rows / E), pre, post, log_c,
                            static_cast<int>(rows));
}

template <int MODE>
cudaError_t run_onchip(int route, long long rows, int log_w, const float* x,
                       const float* signs, float* y, const int* idx, int k,
                       int E, int pre, int post, cudaStream_t st,
                       int* active_clusters) {
  if (route == kRouteCluster) {
    const int log_c = log_w - kSegMaxLog;
    if (log_c < 1 || log_c > kClusterMaxLog) return cudaErrorInvalidValue;
    if constexpr (MODE == kScatter) {
      return launch_onchip<kSegMaxLog, kScatter, true>(rows, log_c, x, signs, y,
                                                       idx, k, E, pre, post, st);
    } else {
      return launch_cluster_rows<MODE>(rows, log_c, x, signs, y, idx, k, E, pre,
                                       post, st, active_clusters);
    }
  }
  if (route != kRouteBlock) return cudaErrorInvalidValue;
  switch (log_w) {
#define LDPC_BLOCK(L)                                                        \
  case L:                                                                    \
    return launch_onchip<L, MODE, false>(rows, 0, x, signs, y, idx, k, E, pre, \
                                         post, st);
    LDPC_BLOCK(0) LDPC_BLOCK(1) LDPC_BLOCK(2) LDPC_BLOCK(3) LDPC_BLOCK(4)
    LDPC_BLOCK(5) LDPC_BLOCK(6) LDPC_BLOCK(7) LDPC_BLOCK(8) LDPC_BLOCK(9)
    LDPC_BLOCK(10) LDPC_BLOCK(11) LDPC_BLOCK(12) LDPC_BLOCK(13)
    LDPC_BLOCK(14) LDPC_BLOCK(15)
#undef LDPC_BLOCK
    default:
      return cudaErrorInvalidValue;
  }
}

template <int LOG_S, int MODE>
cudaError_t launch_blocks(long long grid, const float* x, const float* signs,
                          float* y, const int* idx, int k, int E, int B, int Lw,
                          const int* ptr, const int* blocks, cudaStream_t st) {
  auto kernel = fwht_blocks_kernel<LOG_S, MODE>;
  constexpr int smem =
      static_cast<int>(sizeof(float)) * tile_floats<(1 << LOG_S), 1>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(grid), seg_threads<LOG_S>(), smem, st>>>(
      x, signs, y, idx, k, E, B, Lw, ptr, blocks);
  return cudaGetLastError();
}

// The block-indexed products (fwht_blocks_kernel), one launch: B E blocks
// in gather mode, B Lw in scatter mode; the block route's widths only.
template <int MODE>
cudaError_t run_blocks(long long B, int log_w, const float* x,
                       const float* signs, float* y, const int* idx, int k,
                       int E, int Lw, const int* ptr, const int* blocks,
                       cudaStream_t st) {
  const long long grid = B * (MODE == kGather ? E : Lw);
  if (B <= 0 || E <= 0 || Lw <= 0 || k < 0 || idx == nullptr ||
      ptr == nullptr || blocks == nullptr || grid > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  switch (log_w) {
#define LDPC_BLOCKS(L)                                                       \
  case L:                                                                    \
    return launch_blocks<L, MODE>(grid, x, signs, y, idx, k, E,              \
                                  static_cast<int>(B), Lw, ptr, blocks, st);
    LDPC_BLOCKS(0) LDPC_BLOCKS(1) LDPC_BLOCKS(2) LDPC_BLOCKS(3) LDPC_BLOCKS(4)
    LDPC_BLOCKS(5) LDPC_BLOCKS(6) LDPC_BLOCKS(7) LDPC_BLOCKS(8) LDPC_BLOCKS(9)
    LDPC_BLOCKS(10) LDPC_BLOCKS(11) LDPC_BLOCKS(12) LDPC_BLOCKS(13)
    LDPC_BLOCKS(14) LDPC_BLOCKS(15)
#undef LDPC_BLOCKS
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t run_two_pass(long long rows, int log_w, const float* x,
                         const float* signs, float* y, int E, int pre, int post,
                         cudaStream_t st) {
  if (log_w < 2 * kColMinLog || log_w > kRowMaxLog + kColMaxLog) {
    return cudaErrorInvalidValue;
  }
  const int log_b =
      log_w - kColMinLog < kRowMaxLog ? log_w - kColMinLog : kRowMaxLog;
  const int log_a = log_w - log_b;
  cudaError_t err =
      run_rows(log_b, rows << log_a, x, signs, y, log_w, E, pre, 0, st);
  if (err != cudaSuccess) return err;
  return run_cols(log_a, rows * ((1LL << log_b) / kCols), y, signs, log_b, E,
                  post, st);
}

bool bad_rows(long long rows, int E) {
  return rows <= 0 || E <= 0 || rows % E != 0;
}

}  // namespace

// y = FWHT(x * s) (apply_pre) or FWHT(x) * s over rows of length 2^log_w;
// signs may be null (no sign diagonal), else it is (E, 2^log_w) and row r
// uses sign row r % E. route: 0 block (log_w <= 15), 1 cluster (16 to 19),
// 2 two_pass (10 to 22); a route that does not take the width is an
// invalid value. x, y and signs must be 16-byte aligned, and x and y must
// not overlap. Returns the launch status (0 on success).
extern "C" int ldpc_fwht_signed(const float* x, const float* signs, float* y,
                                long long rows, int log_w, int E,
                                int apply_pre, int route, void* stream) {
  cudaGetLastError();  // clear a stale error of an earlier call
  if (bad_rows(rows, E)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pre = signs != nullptr && apply_pre;
  const int post = signs != nullptr && !apply_pre;
  if (route == kRouteTwoPass) {
    return static_cast<int>(
        run_two_pass(rows, log_w, x, signs, y, E, pre, post, st));
  }
  return static_cast<int>(run_onchip<kPlain>(route, rows, log_w, x, signs, y,
                                             nullptr, 0, E, pre, post, st,
                                             nullptr));
}

// The adjoint SRHT product without a full-width input: row r of y (R, w) is
// the signed FWHT of the zero row that holds vals[r, j] at idx[r % E, j]
// (j < k). idx is (E, k) int32 with entries in [0, w); an entry outside is
// skipped. route: 0 block or 1 cluster.
extern "C" int ldpc_srht_scatter_fwht(const float* vals, const int* idx,
                                      const float* signs, float* y,
                                      long long rows, int k, int log_w, int E,
                                      int apply_pre, int route, void* stream) {
  cudaGetLastError();
  if (bad_rows(rows, E) || k < 0 || idx == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int pre = signs != nullptr && apply_pre;
  const int post = signs != nullptr && !apply_pre;
  return static_cast<int>(run_onchip<kScatter>(
      route, rows, log_w, vals, signs, y, idx, k, E, pre, post,
      static_cast<cudaStream_t>(stream), nullptr));
}

// The forward SRHT product without a full-width output: out[r, j] (R, k) is
// entry idx[r % E, j] of the signed FWHT of row r of x (R, w). route: 0
// block or 1 cluster.
extern "C" int ldpc_srht_fwht_gather(const float* x, const float* signs,
                                     const int* idx, float* out, long long rows,
                                     int k, int log_w, int E, int apply_pre,
                                     int route, void* stream) {
  cudaGetLastError();
  if (bad_rows(rows, E) || k < 0 || idx == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int pre = signs != nullptr && apply_pre;
  const int post = signs != nullptr && !apply_pre;
  return static_cast<int>(run_onchip<kGather>(
      route, rows, log_w, x, signs, out, idx, k, E, pre, post,
      static_cast<cudaStream_t>(stream), nullptr));
}

// The forward SRHT product with the window side's select folded in:
// out[b, e, :] (B, E, k) is the gather at idx[e] of FWHT(x[b, s, :] * s_e)
// (x is (B, Lw, 2^log_w), s_e = signs[e] or none), for each block e of
// segment s of the table (ptr (Lw + 1), blocks (E), int32). log_w <= 15.
extern "C" int ldpc_srht_fwht_gather_blocks(const float* x, const float* signs,
                                            const int* idx, float* out,
                                            long long B, int k, int log_w,
                                            int E, int Lw, const int* ptr,
                                            const int* blocks, void* stream) {
  cudaGetLastError();
  return static_cast<int>(run_blocks<kGather>(
      B, log_w, x, signs, out, idx, k, E, Lw, ptr, blocks,
      static_cast<cudaStream_t>(stream)));
}

// The adjoint SRHT product with the window side's sum folded in: y[b, s, :]
// (B, Lw, 2^log_w) is the sum, over the blocks e of segment s in the table's
// ascending order, of FWHT(the zero row that holds vals[b, e, j] at
// idx[e, j]) * s_e; summed in that order on every run. log_w <= 15.
extern "C" int ldpc_srht_scatter_fwht_sum(const float* vals, const int* idx,
                                          const float* signs, float* y,
                                          long long B, int k, int log_w, int E,
                                          int Lw, const int* ptr,
                                          const int* blocks, void* stream) {
  cudaGetLastError();
  return static_cast<int>(run_blocks<kScatter>(
      B, log_w, vals, signs, y, idx, k, E, Lw, ptr, blocks,
      static_cast<cudaStream_t>(stream)));
}

// How many clusters of the cluster route's kernel the card holds at once
// at width 2^log_w (16 to 19); negative: minus the CUDA status.
extern "C" int ldpc_fwht_active_clusters(int log_w) {
  cudaGetLastError();
  int n = 0;
  const cudaError_t err = run_onchip<kPlain>(
      kRouteCluster, 1, log_w, nullptr, nullptr, nullptr, nullptr, 0, 1, 0, 0,
      nullptr, &n);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// The message of a status code returned by this library's entry points.
extern "C" const char* ldpc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
