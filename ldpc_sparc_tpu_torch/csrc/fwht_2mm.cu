// Signed FWHT as two tensor-core products, for sm_90a.
//
// Replaces ldpc_sparc_tpu/ops/wht_pallas.py::_kernel (through
// _fwht_signed_2mm and fwht_signed, mode "2mm"). With H_w = H_a (x) H_b
// (Sylvester Kronecker split, a = 2^floor(log2(w)/2), b = w / a) and X the
// (a, b) row-major view of one row of an (R, w) float32 array:
//
//   apply_pre: Y = H_a . bf16(bf16(X * S) . H_b)
//   else     : Y = (H_a . bf16(bf16(X) . H_b)) * S
//
// with S the row's +-1 sign window (sign row r % E), or no signs at all.
// Operands are bf16 and every product accumulates in float32, as the TPU
// kernel does with its default operand type; the intermediate T = X . H_b
// is rounded to bf16 before the second product, as `t.astype(mm)` does.
//
// Both products run on the tensor cores with mma.sync m16n8k16 (bf16 in,
// float32 accumulate). The Hadamard operand is never loaded: with
// i = 16 I + i', j = 16 J + j' (i', j' < 16), H[i][j] = (-1)^popcount(i & j)
// = (-1)^popcount(I & J) * H_16[i'][j'], so each lane builds its fragment of
// H_16 once, as bf16 +-1 bit patterns, and every other tile of H_a or H_b
// is that fragment with its sign bits flipped by one XOR.
//
// Two layouts:
//   (b) w <= 2^15 (a <= 128, b <= 256): one block per row. Each warp loads
//       its 16 rows of X straight from device memory into A fragments
//       (registers), computes its 16 rows of T and stores them as bf16 into
//       shared memory (a x (b + 8): 66 KB at 2^15, two blocks per SM); after
//       one barrier the warps compute Y = H_a . T strip by strip (T read
//       with ldmatrix.trans) and store it, post-signs applied, to device
//       memory. Device traffic: x and y once each, 8w bytes per row (plus
//       the sign plane, 25 MB for the SC design, which stays in L2).
//   (a) w > 2^15: a row's bf16 tile (256 KB at 2^16) exceeds the 227 KB a
//       block can use, so T crosses device memory in bf16. Launch 1 stages
//       16-row tiles of the (R a, b) view in shared memory (bf16) and
//       computes T; launch 2 stages a 16-column strip of T (a x 16) and
//       computes that strip of Y. 12w bytes per row.
//
// What bounds it: at w = 2^15 the two products are 2(a b^2 + a^2 b) =
// 25.2 MFLOP per row against 8w = 256 KB of traffic, 96 FLOP per byte,
// under the card's ~295 for bf16: memory-bound, if mma.sync reaches about
// two thirds of the dense tensor rate. At 2^19 (a = 512, b = 1024) it is
// 1.61 GFLOP per row against 12w = 6 MB, 256 FLOP per byte: near the
// tensor-core bound. The design keeps the tile on chip where it fits (b),
// reads x once with every 32-byte sector used, and spends no bytes or
// shared memory on the Hadamard operand. Each layout runs its phases in
// turn (load, first product, second product, store) with two to a few
// blocks per SM to overlap them; a pipelined ring of tiles is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kTileMaxLog = 15;   // layout (b) up to here
constexpr int kColWarps = 4;      // launch 2 of layout (a)
constexpr int kColStrip = 16;     // columns of T per block in launch 2
constexpr int kColMch = 4;        // m-tiles per warp pass in launch 2

// bf16x2 of (lo, hi), round to nearest even; lo in the low half.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// bf16 bit pattern of H[i][j] = (-1)^popcount(i & j).
__device__ __forceinline__ uint32_t hsign(int i, int j) {
  return 0x3F80u | ((static_cast<uint32_t>(__popc(i & j)) & 1u) << 15);
}

// bf16x2 of (H[i0][j], H[i1][j]).
__device__ __forceinline__ uint32_t hpair(int i0, int i1, int j) {
  return hsign(i0, j) | (hsign(i1, j) << 16);
}

// The XOR that flips both halves of a bf16x2 when popcount(i & j) is odd.
__device__ __forceinline__ uint32_t flip(int i, int j) {
  return (__popc(i & j) & 1) ? 0x80008000u : 0u;
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const uint16_t* p) {
  const uint32_t at = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(at)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const uint16_t* p) {
  const uint32_t at = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(at)
      : "memory");
}

// T = bf16(X . H_B) for the 16 rows of one warp's m-tile. load_a(kt, a)
// gives the A fragment of k-tile kt (columns 16 kt .. 16 kt + 15); each
// result pair goes out through store(row, col, bf16x2), row < 16, col even.
// NCH n-tiles (8 columns each) accumulate at once; NCH is even, so n-tile
// n0 + j has the parity of j.
template <int LOG_B, int NCH, class LoadA, class Store>
__device__ __forceinline__ void product1(LoadA load_a, Store store) {
  constexpr int KT = (1 << LOG_B) / 16;
  constexpr int NT = (1 << LOG_B) / 8;
  static_assert(NCH % 2 == 0 && NT % NCH == 0, "NCH must be even and divide NT");
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  // B fragments of H_16's columns 0-7 and 8-15: rows 2t, 2t+1 and 2t+8, 2t+9
  uint32_t hb[2][2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    hb[p][0] = hpair(2 * t, 2 * t + 1, 8 * p + g);
    hb[p][1] = hpair(2 * t + 8, 2 * t + 9, 8 * p + g);
  }
#pragma unroll 1
  for (int n0 = 0; n0 < NT; n0 += NCH) {
    float acc[NCH][4];
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    }
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t a[4];
      load_a(kt, a);
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        const uint32_t f = flip(kt, (n0 + j) >> 1);
        mma16816(acc[j], a, hb[j & 1][0] ^ f, hb[j & 1][1] ^ f);
      }
    }
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int col = 8 * (n0 + j) + 2 * t;
      store(g, col, bf16x2(acc[j][0], acc[j][1]));
      store(g + 8, col, bf16x2(acc[j][2], acc[j][3]));
    }
  }
}

// Y[16 mt + i][col0 + j] = sum_k H_A[16 mt + i][k] T[k][tcol0 + j] for the
// MCH m-tiles from mt0 and 16 columns j. T: A rows in shared memory, row
// stride ld. y and sg (post-signs, or null) point at element (0, 0) of the
// row's (A, ldy) view.
template <int LOG_A, int MCH>
__device__ __forceinline__ void product2(const uint16_t* ts, int ld, int tcol0,
                                         int mt0, float* y, const float* sg,
                                         long long ldy, long long col0) {
  constexpr int KT = (1 << LOG_A) / 16;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  // A fragment of H_16: (row g | g+8) x (columns 2t, 2t+1 | 2t+8, 2t+9)
  const uint32_t ha[4] = {hpair(2 * t, 2 * t + 1, g), hpair(2 * t, 2 * t + 1, g + 8),
                          hpair(2 * t + 8, 2 * t + 9, g),
                          hpair(2 * t + 8, 2 * t + 9, g + 8)};
  float acc[MCH][2][4];
#pragma unroll
  for (int i = 0; i < MCH; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;
    }
  }
  // lanes 0-15 address rows 0-15 of columns 0-7, lanes 16-31 of columns 8-15
  const uint16_t* src = ts + (lane & 15) * ld + tcol0 + (lane >> 4) * 8;
#pragma unroll 4
  for (int kt = 0; kt < KT; ++kt) {
    uint32_t b[4];   // b[0], b[1]: n-tile 0; b[2], b[3]: n-tile 1
    ldsm_x4_trans(b, src + 16 * kt * ld);
#pragma unroll
    for (int i = 0; i < MCH; ++i) {
      const uint32_t f = flip(mt0 + i, kt);
      const uint32_t a[4] = {ha[0] ^ f, ha[1] ^ f, ha[2] ^ f, ha[3] ^ f};
      mma16816(acc[i][0], a, b[0], b[1]);
      mma16816(acc[i][1], a, b[2], b[3]);
    }
  }
#pragma unroll
  for (int i = 0; i < MCH; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = 16LL * (mt0 + i) + g + 8 * h;
        const long long at = row * ldy + col0 + 8 * j + 2 * t;
        float2 v = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        if (sg != nullptr) {
          const float2 s = *reinterpret_cast<const float2*>(sg + at);
          v.x *= s.x;
          v.y *= s.y;
        }
        *reinterpret_cast<float2*>(y + at) = v;
      }
    }
  }
}

// Layout (b): one block of A/16 warps per row; warp m owns rows 16m.. of
// the (A, B) view in the first product.
template <int LOG_A, int LOG_B>
__global__ void __launch_bounds__(2 << LOG_A, 2)
fwht2mm_tile_kernel(const float* __restrict__ x, const float* __restrict__ signs,
                    float* __restrict__ y, int E, int pre, int post) {
  constexpr int A = 1 << LOG_A;
  constexpr int B = 1 << LOG_B;
  constexpr int LD = B + 8;   // +16 bytes a row: ldmatrix rows hit distinct banks
  constexpr int KT = B / 16;
  constexpr int NT = B / 8;
  extern __shared__ __align__(16) uint16_t smem[];
  const long long w = static_cast<long long>(A) * B;
  const long long r = blockIdx.x;
  const float* xr = x + r * w;
  const float* sr = signs != nullptr ? signs + (r % E) * w : nullptr;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  // A fragments of the warp's 16 rows, all k-tiles, straight from x:
  // q = 0..3 is (row g | g+8) x (columns 2t | 2t+8) of the k-tile
  uint32_t afr[KT][4];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int at = (16 * warp + g + 8 * (q & 1)) * B + 16 * kt + 2 * t + 8 * (q >> 1);
      float2 v = *reinterpret_cast<const float2*>(xr + at);
      if (pre) {
        const float2 s = *reinterpret_cast<const float2*>(sr + at);
        v.x *= s.x;
        v.y *= s.y;
      }
      afr[kt][q] = bf16x2(v.x, v.y);
    }
  }
  uint16_t* trows = smem + 16 * warp * LD;
  product1<LOG_B, (NT < 4 ? NT : 4)>(
      [&](int kt, uint32_t* a) {
        a[0] = afr[kt][0];
        a[1] = afr[kt][1];
        a[2] = afr[kt][2];
        a[3] = afr[kt][3];
      },
      [&](int row, int col, uint32_t v) {
        *reinterpret_cast<uint32_t*>(trows + row * LD + col) = v;
      });
  __syncthreads();
  for (int s = warp; s < B / 16; s += A / 16) {
    product2<LOG_A, A / 16>(smem, LD, 16 * s, 0, y + r * w, post ? sr : nullptr, B,
                            16 * s);
  }
}

template <int LOG_B>
__host__ __device__ constexpr int rows_warps() {
  return LOG_B >= 10 ? 2 : 4;
}

// Layout (a), launch 1: T = bf16(bf16(X * S) . H_B) over 16 * NW rows of
// the (R A, B) view per block, staged in shared memory as bf16.
template <int LOG_B>
__global__ void __launch_bounds__(32 * rows_warps<LOG_B>())
fwht2mm_rows_kernel(const float* __restrict__ x, const float* __restrict__ signs,
                    uint16_t* __restrict__ tout, int log_a, int E, int pre) {
  constexpr int B = 1 << LOG_B;
  constexpr int LD = B + 8;
  constexpr int NW = rows_warps<LOG_B>();
  constexpr int ROWS = 16 * NW;
  extern __shared__ __align__(16) uint16_t smem[];
  const long long row0 = static_cast<long long>(blockIdx.x) * ROWS;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * B / 4; i += 32 * NW) {
    const int rr = i / (B / 4);
    const int c = 4 * (i % (B / 4));
    const long long gr = row0 + rr;
    float4 v = *reinterpret_cast<const float4*>(x + gr * B + c);
    if (pre) {
      const long long r = gr >> log_a;
      const float4 s = *reinterpret_cast<const float4*>(
          signs + (r % E) * (static_cast<long long>(B) << log_a) +
          (gr - (r << log_a)) * B + c);
      v.x *= s.x;
      v.y *= s.y;
      v.z *= s.z;
      v.w *= s.w;
    }
    *reinterpret_cast<uint2*>(smem + rr * LD + c) =
        make_uint2(bf16x2(v.x, v.y), bf16x2(v.z, v.w));
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint16_t* arow = smem + (16 * warp + (lane & 15)) * LD + (lane >> 4) * 8;
  uint16_t* trow = tout + (row0 + 16 * warp) * B;
  product1<LOG_B, 8>(
      [&](int kt, uint32_t* a) { ldsm_x4(a, arow + 16 * kt); },
      [&](int row, int col, uint32_t v) {
        *reinterpret_cast<uint32_t*>(trow + static_cast<long long>(row) * B + col) = v;
      });
}

// Layout (a), launch 2: one block per (row, 16-column strip of T);
// Y[:, strip] = H_A . T[:, strip], post-signs applied.
template <int LOG_A>
__global__ void __launch_bounds__(32 * kColWarps)
fwht2mm_cols_kernel(const uint16_t* __restrict__ tin, const float* __restrict__ signs,
                    float* __restrict__ y, int log_b, int E, int post) {
  constexpr int A = 1 << LOG_A;
  constexpr int LD = kColStrip + 8;
  extern __shared__ __align__(16) uint16_t smem[];
  const long long b = 1LL << log_b;
  const long long strips = b / kColStrip;
  const long long r = blockIdx.x / strips;
  const long long col0 = (blockIdx.x % strips) * kColStrip;
  const long long w = b << LOG_A;
  const uint16_t* tr = tin + r * w + col0;
  for (int i = threadIdx.x; i < 2 * A; i += 32 * kColWarps) {
    const int row = i >> 1;
    const int h = i & 1;
    *reinterpret_cast<uint4*>(smem + row * LD + 8 * h) =
        *reinterpret_cast<const uint4*>(tr + row * b + 8 * h);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const float* sg = post ? signs + (r % E) * w : nullptr;
  for (int mt = kColMch * warp; mt < A / 16; mt += kColWarps * kColMch) {
    product2<LOG_A, kColMch>(smem, LD, 0, mt, y + r * w, sg, b, col0);
  }
}

template <class... P, class... Q>
cudaError_t launch(void (*kernel)(P...), long long blocks, int threads, int smem,
                   cudaStream_t st, Q... args) {
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(blocks), threads, smem, st>>>(args...);
  return cudaGetLastError();
}

cudaError_t run_tile(int log_w, long long rows, const float* x, const float* signs,
                     float* y, int E, int pre, int post, cudaStream_t st) {
  switch (log_w) {
#define LDPC_TILE(LW, LA, LB)                                                     \
  case LW:                                                                        \
    return launch(fwht2mm_tile_kernel<LA, LB>, rows, 2 << LA,                     \
                  static_cast<int>(sizeof(uint16_t)) * (1 << LA) * ((1 << LB) + 8), \
                  st, x, signs, y, E, pre, post);
    LDPC_TILE(8, 4, 4) LDPC_TILE(9, 4, 5) LDPC_TILE(10, 5, 5) LDPC_TILE(11, 5, 6)
    LDPC_TILE(12, 6, 6) LDPC_TILE(13, 6, 7) LDPC_TILE(14, 7, 7) LDPC_TILE(15, 7, 8)
#undef LDPC_TILE
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t run_rows(int log_b, long long view_rows, const float* x,
                     const float* signs, uint16_t* t, int log_a, int E, int pre,
                     cudaStream_t st) {
  switch (log_b) {
#define LDPC_ROWS2(LB)                                                             \
  case LB:                                                                         \
    return launch(fwht2mm_rows_kernel<LB>, view_rows / (16 * rows_warps<LB>()),    \
                  32 * rows_warps<LB>(),                                           \
                  static_cast<int>(sizeof(uint16_t)) * 16 * rows_warps<LB>() *     \
                      ((1 << LB) + 8),                                             \
                  st, x, signs, t, log_a, E, pre);
    LDPC_ROWS2(8) LDPC_ROWS2(9) LDPC_ROWS2(10)
#undef LDPC_ROWS2
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t run_cols(int log_a, long long rows, const uint16_t* t, const float* signs,
                     float* y, int log_b, int E, int post, cudaStream_t st) {
  switch (log_a) {
#define LDPC_COLS2(LA)                                                             \
  case LA:                                                                         \
    return launch(fwht2mm_cols_kernel<LA>, rows * ((1LL << log_b) / kColStrip),    \
                  32 * kColWarps,                                                  \
                  static_cast<int>(sizeof(uint16_t)) * (1 << LA) * (kColStrip + 8), \
                  st, t, signs, y, log_b, E, post);
    LDPC_COLS2(8) LDPC_COLS2(9) LDPC_COLS2(10)
#undef LDPC_COLS2
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// y = H_a . bf16(bf16(x * s) . H_b) (apply_pre) or (H_a . bf16(bf16(x) . H_b)) * s
// over rows of length 2^log_w, 8 <= log_w <= 20, on the (a, b) view of each
// row. signs may be null (no sign diagonal), else it is (E, 2^log_w) and row
// r uses sign row r % E. scratch is a (rows, 2^log_w) bf16 buffer for the
// intermediate when log_w > 15 (null below). x, y, signs and scratch must be
// 16-byte aligned, and x and y must not overlap. Returns cudaGetLastError()
// after the launches (0 on success).
extern "C" int ldpc_fwht_2mm(const float* x, const float* signs, float* y,
                             uint16_t* scratch, long long rows, int log_w, int E,
                             int apply_pre, void* stream) {
  cudaGetLastError();  // clear a stale error of an earlier call
  if (rows <= 0 || E <= 0 || rows % E != 0 || log_w < 8 || log_w > 20) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pre = signs != nullptr && apply_pre;
  const int post = signs != nullptr && !apply_pre;
  if (log_w <= kTileMaxLog) {
    return static_cast<int>(run_tile(log_w, rows, x, signs, y, E, pre, post, st));
  }
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int log_a = log_w / 2;
  const int log_b = log_w - log_a;
  cudaError_t err = run_rows(log_b, rows << log_a, x, signs, scratch, log_a, E, pre, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(run_cols(log_a, rows, scratch, signs, y, log_b, E, post, st));
}
