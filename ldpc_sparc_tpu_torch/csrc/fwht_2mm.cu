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
// The Hadamard operand is never loaded: with i = 16 I + i', j = 16 J + j'
// (i', j' < 16), H[i][j] = (-1)^popcount(i & j) = (-1)^popcount(I & J) *
// H_16[i'][j'], so each lane builds its fragment of H_16 once, as bf16 +-1
// bit patterns, and every other tile of H_a or H_b is that fragment with
// its sign bits flipped.
//
// Two families of kernels; `ops/wht_cuda.py::k2_layout` sends a width to one:
//
//   wgmma (2^12 to 2^20, a and b at least 64). The Hadamard factor is the A
//   operand, from registers; the data is the B operand in shared memory:
//   since H is symmetric, T^T (b x a) = H_b . X^T and Y (a x b) = H_a . T,
//   and X stored row-major is X^T K-major, T^T stored row-major is T
//   K-major. The sign of a 64 x N x 16 instruction's A tile is split into a
//   part folded into four register fragments once and a part that is the
//   instruction's immediate scale of A, so a run of wgmma has no branch and
//   no register write in it (either makes ptxas run them one at a time,
//   which cost 2.5x). The signs travel as bits, packed once a call.
//     tile, 2^12 to 2^15: one block a row, two an SM. X goes to a bf16 tile
//       (64 KB at 2^15); each warpgroup takes 64-row chunks of H_b, and a
//       chunk of T^T never leaves it: product 1's accumulators are rounded
//       into the warpgroup's 16 KB buffer, which is product 2's B operand;
//       Y goes out from the accumulators. 8w bytes a row.
//     wide, 2^16 to 2^20: T crosses device memory in bf16 (12w bytes a
//       row), in the layout (r, b, a) so that launch 2 reads contiguous
//       64 KB tiles. Both launches are persistent, one block of four
//       warpgroups an SM, and bring the next tile in with cp.async while
//       they multiply this one. A factor of 512 or 1024 is H_2 or H_4 (x)
//       H_256: the tensor cores run H_256 on each block of 256 along K and
//       float32 adds in registers finish the butterfly, a half or a quarter
//       of the tensor work and the same float32 sums in another order.
//   mma.sync (2^8 to 2^15; the table uses it below 2^12, where a factor is
//   narrower than wgmma's 64 rows, and it stays the yardstick up to 2^15):
//   m16n8k16, one block per row, A fragments straight from device memory,
//   T in shared memory (a x (b + 8)), Y strip by strip, signs read as a
//   float plane.
//
// What bounds the bf16 kernels: at w = 2^15 the two products are
// 2(a b^2 + a^2 b) = 25.2 MFLOP per row against 8w = 256 KB of traffic, 96
// FLOP per byte, under the card's ~295 for bf16: memory-bound. At 2^19 (a = 512,
// b = 1024) it is 1.61 GFLOP per row against 12w = 6 MB, 256 FLOP per byte:
// the tensor cores bound the full products (0.417 ms at (256, 2^19)); with
// the radix split the wide layout is memory-bound too (0.48 ms for its
// 12w bytes). Measured on an NVIDIA H100 80GB HBM3, 700 W (`time_k2.py`),
// pre / post / no signs: (12288, 2^15), E=192: wgmma 1.20 / 1.25 / 1.15 ms,
// mma.sync 1.96 / 1.88 / 1.15 ms (its float sign plane cycles through L2),
// bound 0.97 ms, the cuBLAS bf16 pair 1.13 ms; (256, 2^19): wgmma 0.73 /
// 0.68 / 0.68 ms, the pair 0.57 ms (two mma.sync launches with 16-row and
// 16-column tiles, since removed, took 1.82 / 1.39 / 1.44 ms).
//
// Float32 operands (mm_dtype "float32"; replaces the same Pallas kernel,
// wht_pallas.py:103 `_kernel`, with dtype float32; ldpc_fwht_2mm_f32): Y =
// H_a . (X . H_b) with T = X . H_b kept in float32. Each float32 operand v
// is split into three bf16 planes, hi = bf16(v), mid = bf16(v - hi), lo =
// bf16(v - hi - mid), rounded to nearest with no contraction: each residual
// has at most 15, then 7 significant bits, so v = hi + mid + lo exactly for
// |v| above about 2^-100. H holds only +-1, so every partial product is
// exact; a product runs the three planes into one float32 accumulator, lo
// first, then mid, then hi (the small terms summed before the large), and
// differs from a float32 matmul only in the order of its float32 sums (the
// radix butterfly of the wide layout, after the three-plane H_256
// products, is such a reordering too). Three planes triple the tensor work
// and the shared memory of the bf16 kernels; what bounds a row is its bytes
// (8w at 2^15: 0.97 ms at (12288, 2^15), against 0.94 ms of three-plane
// tensor work) and, where T cannot stay on chip, T's float32 crossing (16w
// bytes a row: 0.64 ms at (256, 2^19), against 0.42 ms of tensor work with
// the radix split). So:
//   wgmma tile, 2^12 to 2^15: one launch, one block a row, X's three planes
//     in shared memory (192 KB at 2^15, one block an SM; 2^12 to 2^14 fit
//     two), T^T chunk by chunk in the warpgroups' float32 accumulators,
//     then its three planes over X's: T never leaves the SM, 8w bytes a row.
//     A block loads, multiplies and stores in turn; blocks on other SMs
//     overlap its bytes.
//   wgmma wide, 2^16 to 2^20: the bf16 wide layout's two persistent
//     launches on tiles of half its size (2^14 floats: 64 KB staged by
//     cp.async beside 96 KB of planes; N = 16 at 2^19 and 2^20), T in
//     float32 in the layout (r, b, a) between them.
//   Both read the signs as bits, packed once a call.
//   mma.sync passes (every width; the table's below 2^12, and the
//     yardstick the wgmma kernels are timed against): pass 1 applies H_b
//     along the rows of the (R a, b) view (pre-signs as X is read) and
//     writes T into y; pass 2 applies H_a along the columns of each row's
//     (a, b) view in place (post-signs as Y is written), reading its tile
//     whole before it writes it back; signs as a float plane, T through
//     device memory (16w bytes a row). Measured (NVIDIA H100 80GB HBM3,
//     700 W, time_k2.py): 3.91 / 4.01 ms pre / post at (12288, 2^15), 2.85
//     / 2.98 ms at (256, 2^19).

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kTileMaxLog = 15;   // T stays on chip, one launch, up to here

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
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// The mma.sync kernel: one block of A/16 warps per row; warp m owns rows
// 16m.. of the (A, B) view in the first product.
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

// ---- the wgmma kernels ------------------------------------------------------
//
// The Hadamard factor is the A operand, from registers; the data is the B
// operand in shared memory. B tiles are kept K-major in wgmma's layout
// without swizzle: core matrices of 8 rows (N) x 8 bf16 (K), 128 contiguous
// bytes each; element (n, k) of a tile lies at
//   (n / 8) * SBO + (k / 8) * LBO + (n % 8) * 16 + (k % 8) * 2.
// Core matrices that follow each other along K are contiguous (LBO = 128),
// so every one is a 128-byte line of shared memory. A warp fills such a tile
// 8 rows at a time: lane l takes row l % 8 and 16-byte piece l / 8, so that
// the lanes of a half-warp write one whole core matrix and no two share a
// bank, and reads 64 contiguous bytes of each of the 8 rows from device
// memory.

constexpr int kLbo = 128;

__device__ __forceinline__ uint64_t bdesc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t at = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((at & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void group_sync(int wg) {   // the 128 threads of a warpgroup
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

template <int SA>
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, %14, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(SA));
}

template <int SA>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, %22, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(SA));
}

template <int SA>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, %38, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(SA));
}

template <int SA>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, %70, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(SA));
}

// The four A fragments a warp ever needs. Row 64 mc + 16 wi + i, column
// 16 kt + j of a Sylvester matrix is (-1)^popcount((4 mc + wi) & kt) *
// H_16[i][j]; the part popcount(wi & kt & 3) is folded into fragment
// kt & 3 here, once, and the part popcount(mc & (kt >> 2)) becomes the
// instruction's scale of A, an immediate +-1: mc and kt are compile-time
// constants everywhere (a warpgroup's chunk comes from a template
// parameter), so a run of wgmma has no branch and no register write between
// its instructions, which ptxas would answer by running them one at a time.
// The fragments are never written again, so no wgmma in flight can see them
// change.
__device__ __forceinline__ void hfrags(uint32_t (&hq)[4][4]) {
  const int lane = threadIdx.x & 31;
  const int wi = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t ha[4] = {hpair(2 * t, 2 * t + 1, g), hpair(2 * t, 2 * t + 1, g + 8),
                          hpair(2 * t + 8, 2 * t + 9, g),
                          hpair(2 * t + 8, 2 * t + 9, g + 8)};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t f = flip(wi, q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hq[q][i] = ha[i] ^ f;
      // a value the compiler cannot make anew beside a wgmma: a register
      // written there would need a fence of its own
      asm volatile("" : "+r"(hq[q][i]));
    }
  }
}

__host__ __device__ constexpr int parity_c(int v) {
  int n = 0;
  for (; v != 0; v >>= 1) n ^= v & 1;
  return n;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Ends a run of wgmma into the R accumulators and waits for it; then acc
// may be read.
template <int R, int NACC>
__device__ __forceinline__ void wgmma_done(float (&acc)[R][NACC]) {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(acc[r][i])::"memory");
  }
}

// Starts acc (64 x N, float32) = H[64 MC .. 64 MC + 63][0 .. 16 KSTEPS) . B
// for the warpgroup, k-steps KT to KSTEPS - 1 (ACC: acc += ...); B is a
// K-major tile (LBO kLbo) whose descriptor for step KT is desc: a k-step is
// two core matrices further along K. Between wgmma_fence() and wgmma_done().
template <int MC, int N, int KT, int KSTEPS, bool ACC = false>
struct Hgemm {
  static __device__ __forceinline__ void run(float (&acc)[N / 2],
                                             const uint32_t (&hq)[4][4], uint64_t desc) {
    constexpr int SA = parity_c(MC & (KT >> 2)) ? -1 : 1;
    wgmma_rs<SA>(acc, hq[KT & 3], desc, ACC || KT != 0);
    if constexpr (KT + 1 < KSTEPS) {
      Hgemm<MC, N, KT + 1, KSTEPS, ACC>::run(acc, hq, desc + 2 * kLbo / 16);
    }
  }
};

// acc = H[64 MC ..][0 .. 16 KSTEPS) . (hi + mid + lo) for the three bf16
// planes of a K-major tile (SBO sbo), hi at tile, mid and lo one and two
// planes further: the lo plane first, then mid, then hi, into one float32
// accumulator, so that the small terms are summed before the large. Between
// wgmma_fence() and wgmma_done().
template <int MC, int N, int KSTEPS>
__device__ __forceinline__ void hgemm3(float (&acc)[N / 2], const uint32_t (&hq)[4][4],
                                       const unsigned char* tile, int plane, uint32_t sbo) {
  Hgemm<MC, N, 0, KSTEPS>::run(acc, hq, bdesc(tile + 2 * plane, kLbo, sbo));
  Hgemm<MC, N, 0, KSTEPS, true>::run(acc, hq, bdesc(tile + plane, kLbo, sbo));
  Hgemm<MC, N, 0, KSTEPS, true>::run(acc, hq, bdesc(tile, kLbo, sbo));
}

// (E, w) float signs -> one bit each (set where the sign is negative), 32 a
// word in the order of the row.
__global__ void pack_signs_kernel(const float* __restrict__ signs,
                                  uint32_t* __restrict__ bits, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const uint32_t word = __ballot_sync(0xFFFFFFFFu, i < n && signs[i] < 0.0f);
  if ((threadIdx.x & 31) == 0 && i < n) bits[i >> 5] = word;
}

__device__ __forceinline__ float flipf(float v, uint32_t bit) {
  return __uint_as_float(__float_as_uint(v) ^ (bit << 31));
}

// The three planes of the pair (a, b), each a bf16x2 with a in the low half:
// q[0] = hi, q[1] = mid, q[2] = lo, a = hi + mid + lo exactly.
__device__ __forceinline__ void split3(float a, float b, uint32_t (&q)[3]) {
  q[0] = bf16x2(a, b);
  const float ra = __fsub_rn(a, __uint_as_float(q[0] << 16));
  const float rb = __fsub_rn(b, __uint_as_float(q[0] & 0xFFFF0000u));
  q[1] = bf16x2(ra, rb);
  q[2] = bf16x2(__fsub_rn(ra, __uint_as_float(q[1] << 16)),
                __fsub_rn(rb, __uint_as_float(q[1] & 0xFFFF0000u)));
}

// NROWS rows of KW floats from x on (PITCH floats from one row to the next;
// device or shared memory), their signs applied (sb: the bit plane at the
// first row's first entry, or null), to bf16 in a K-major tile at xs; with
// PLANES 3, split into hi, mid and lo (split3), three such tiles `plane`
// bytes apart. All THREADS threads of the block. A warp's load takes 8 rows
// x 16 columns; successive loads walk along the rows.
template <int NROWS, int KW, int THREADS, int PITCH = KW, int PLANES = 1, int UNMAX = 8>
__device__ __forceinline__ void load_tile(const float* __restrict__ x,
                                          const uint32_t* __restrict__ sb,
                                          unsigned char* xs, int plane = 0) {
  constexpr int SBO = KW / 8 * kLbo;
  constexpr int WARPS = THREADS / 32;
  constexpr int PER = NROWS / 8 * (KW / 16) / WARPS;   // loads a thread
  constexpr int UN = PER < UNMAX ? PER : UNMAX;        // of them in flight
  static_assert(NROWS / 8 * (KW / 16) % WARPS == 0 && PER % UN == 0, "tile / warps");
  const int warp = threadIdx.x >> 5;
  const int row8 = threadIdx.x & 7;
  const int piece = (threadIdx.x >> 3) & 3;
  for (int i0 = 0; i0 < PER; i0 += UN) {
    float4 v[UN];
    uint32_t s[UN];
#pragma unroll
    for (int u = 0; u < UN; ++u) {
      const int unit = (i0 + u) * WARPS + warp;
      const int at = (8 * (unit / (KW / 16)) + row8) * KW + 16 * (unit % (KW / 16)) +
                     4 * piece;
      v[u] = *reinterpret_cast<const float4*>(x + at + (at / KW) * (PITCH - KW));
      s[u] = sb != nullptr ? (__ldg(sb + (at >> 5)) >> (at & 31)) & 0xFu : 0u;
    }
#pragma unroll
    for (int u = 0; u < UN; ++u) {
      const int unit = (i0 + u) * WARPS + warp;
      unsigned char* at = xs + (unit / (KW / 16)) * SBO +
                          (2 * (unit % (KW / 16)) + (piece >> 1)) * kLbo + row8 * 16 +
                          (piece & 1) * 8;
      const float a0 = flipf(v[u].x, s[u] & 1u);
      const float a1 = flipf(v[u].y, (s[u] >> 1) & 1u);
      const float a2 = flipf(v[u].z, (s[u] >> 2) & 1u);
      const float a3 = flipf(v[u].w, (s[u] >> 3) & 1u);
      if constexpr (PLANES == 1) {
        *reinterpret_cast<uint2*>(at) = make_uint2(bf16x2(a0, a1), bf16x2(a2, a3));
      } else {
        static_assert(PLANES == 3, "one plane, or hi, mid and lo");
        uint32_t p0[3], p1[3];
        split3(a0, a1, p0);
        split3(a2, a3, p1);
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          *reinterpret_cast<uint2*>(at + q * plane) = make_uint2(p0[q], p1[q]);
        }
      }
    }
  }
}

// Y[row0 + 16 wi + g + 8 h][col0 + 8 j + 2 t ..] = acc, post-signs applied
// (sb: the row's bit plane, or null). y and sb at element (0, 0) of the
// row's (A, ldy) view. (Swapping pairs between neighbouring lanes to store
// 16 bytes a thread measured slower: 0.65 against 0.35 ms for launch 2 at
// (256, 2^19) on an H100, 700 W.)
template <int N>
__device__ __forceinline__ void store_y(const float (&acc)[N / 2], int row0, float* y,
                                        const uint32_t* sb, int ldy, int col0) {
  const int lane = threadIdx.x & 31;
  const int wi = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // ldy is a multiple of 32, and so is col0 for N >= 32: a sign word
    // serves four steps of j; N = 16 takes half a word, from bit 0 or 16
    const long long at0 = static_cast<long long>(row0 + 16 * wi + g + 8 * h) * ldy + col0;
    const int bit0 = N < 32 ? static_cast<int>(at0 & 31) : 0;
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      if ((j & 3) == 0 && sb != nullptr) word = __ldg(sb + ((at0 + 8 * j) >> 5));
      const uint32_t sg = word >> (bit0 + 8 * (j & 3) + 2 * t);
      *reinterpret_cast<float2*>(y + at0 + 8 * j + 2 * t) =
          make_float2(flipf(acc[4 * j + 2 * h], sg & 1u),
                      flipf(acc[4 * j + 2 * h + 1], (sg >> 1) & 1u));
    }
  }
}

// The 64-row chunk CH of H_B for one row, by one warpgroup: T^T[chunk]
// (64 x A) = H_B[chunk] . X^T from the row's X tile xs, rounded to bf16 into
// the warpgroup's own buffer ts, is at once the K-major B operand of
// Y[:, chunk] (A x 64) = H_A . T[:, chunk], which goes to device memory from
// the accumulators.
template <int LOG_A, int LOG_B, int CH>
__device__ __forceinline__ void row_chunk(const uint32_t (&hq)[4][4],
                                          const unsigned char* xs, unsigned char* ts,
                                          float* yr, const uint32_t* sb_post) {
  constexpr int A = 1 << LOG_A;
  constexpr int B = 1 << LOG_B;
  constexpr int XS_SBO = B / 8 * kLbo;
  constexpr int TS_SBO = A / 8 * kLbo;
  const int lane = threadIdx.x & 31;
  const int wi = (threadIdx.x >> 5) & 3;
  const int wg = threadIdx.x >> 7;
  const int g = lane >> 2;
  const int t = lane & 3;
  {
    float acc1[1][A / 2];
    float(&acc)[A / 2] = acc1[0];
#pragma unroll
    for (int i = 0; i < A / 2; ++i) acc[i] = 0.0f;   // written before the fence
    wgmma_fence();
    Hgemm<CH, A, 0, B / 16>::run(acc, hq, bdesc(xs, kLbo, XS_SBO));
    wgmma_done(acc1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < A / 8; ++j) {
        *reinterpret_cast<uint32_t*>(ts + (2 * wi + h) * TS_SBO + j * kLbo + g * 16 +
                                     4 * t) =
            bf16x2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
  fence_async_smem();
  group_sync(wg);
  float acc[A / 64][32];
#pragma unroll
  for (int mc = 0; mc < A / 64; ++mc) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mc][i] = 0.0f;
  }
  wgmma_fence();
  Hgemm<0, 64, 0, A / 16>::run(acc[0], hq, bdesc(ts, kLbo, TS_SBO));
  if constexpr (A > 64) {
    Hgemm<1, 64, 0, A / 16>::run(acc[1], hq, bdesc(ts, kLbo, TS_SBO));
  }
  wgmma_done(acc);
  group_sync(wg);   // every warp's products have read ts: it may be rewritten
#pragma unroll
  for (int mc = 0; mc < A / 64; ++mc) {
    store_y<64>(acc[mc], 64 * mc, yr, sb_post, B, 64 * CH);
  }
}

// All chunks of one row: warpgroup WG of WGS takes chunks WG, WG + WGS, ...
template <int LOG_A, int LOG_B, int WGS, int WG>
__device__ __forceinline__ void row_chunks(const uint32_t (&hq)[4][4],
                                           const unsigned char* xs, unsigned char* ts,
                                           float* yr, const uint32_t* sb_post) {
  constexpr int CHUNKS = (1 << LOG_B) / 64;
  row_chunk<LOG_A, LOG_B, WG>(hq, xs, ts, yr, sb_post);
  if constexpr (WG + WGS < CHUNKS) {
    row_chunk<LOG_A, LOG_B, WG + WGS>(hq, xs, ts, yr, sb_post);
  }
  static_assert(CHUNKS <= 2 * WGS, "at most two chunks a warpgroup");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Widths 2^12 to 2^15: one block a row, the row's X on chip as bf16; two
// blocks an SM overlap one row's bytes with the other's products.
template <int LOG_A, int LOG_B>
__global__ void __launch_bounds__((LOG_B > 6 ? 256 : 128), 2)
fwht2mm_wg_tile_kernel(const float* __restrict__ x, const uint32_t* __restrict__ sbits,
                       float* __restrict__ y, int E, int pre, int post) {
  constexpr int A = 1 << LOG_A;
  constexpr int B = 1 << LOG_B;
  constexpr int WGS = LOG_B > 6 ? 2 : 1;
  constexpr int XS_BYTES = A / 8 * (B / 8) * kLbo;
  constexpr int TS_BYTES = A * 128;
  extern __shared__ __align__(128) unsigned char smem_wg[];
  const long long w = static_cast<long long>(A) * B;
  const long long r = blockIdx.x;
  const uint32_t* sb = sbits != nullptr ? sbits + (r % E) * (w / 32) : nullptr;
  uint32_t hq[4][4];
  hfrags(hq);
  load_tile<A, B, 128 * WGS>(x + r * w, pre ? sb : nullptr, smem_wg);
  fence_async_smem();
  __syncthreads();
  unsigned char* ts = smem_wg + XS_BYTES + (threadIdx.x >> 7) * TS_BYTES;
  if (WGS == 1 || threadIdx.x < 128) {
    row_chunks<LOG_A, LOG_B, WGS, 0>(hq, smem_wg, ts, y + r * w, post ? sb : nullptr);
  } else {
    row_chunks<LOG_A, LOG_B, WGS, WGS - 1>(hq, smem_wg, ts, y + r * w,
                                           post ? sb : nullptr);
  }
}

// out (D x N) = H_D . tile, D = BASE RAD, tile a K-major D x N bf16 tile.
// H_D = H_RAD (x) H_BASE: the warpgroup takes the 64-row chunk MC of
// H_BASE and runs it over each of the RAD blocks of BASE along K (RAD runs
// of wgmma, RAD accumulators of 64 x N); the RAD-point butterfly across the
// blocks is float32 adds in registers, a half or a quarter of the tensor
// work at RAD = 2 or 4 and the same sums in another order. acc[jb] ends as
// the rows BASE jb + 64 MC .. + 63 of the result. With PLANES 3 the tile is
// three planes (hi, mid, lo; `plane` bytes apart) and each block runs them
// lo first into one accumulator (hgemm3); the butterfly follows the
// three-plane products.
template <int RAD, int N, int MC, int PLANES, int BASE = 256>
__device__ __forceinline__ void radix_product(float (&acc)[RAD][N / 2],
                                              const uint32_t (&hq)[4][4],
                                              const unsigned char* tile, int plane = 0) {
  constexpr int SBO = BASE * RAD / 8 * kLbo;
#pragma unroll
  for (int kb = 0; kb < RAD; ++kb) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[kb][i] = 0.0f;   // written before the fence
  }
  wgmma_fence();
#pragma unroll
  for (int kb = 0; kb < RAD; ++kb) {
    const unsigned char* block = tile + kb * (BASE / 8) * kLbo;
    if constexpr (PLANES == 1) {
      Hgemm<MC, N, 0, BASE / 16>::run(acc[kb], hq, bdesc(block, kLbo, SBO));
    } else {
      hgemm3<MC, N, BASE / 16>(acc[kb], hq, block, plane, SBO);
    }
  }
  wgmma_done(acc);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    if constexpr (RAD == 2) {
      const float u = acc[0][i], v = acc[1][i];
      acc[0][i] = u + v;
      acc[1][i] = u - v;
    } else if constexpr (RAD == 4) {
      const float p0 = acc[0][i] + acc[1][i], p1 = acc[0][i] - acc[1][i];
      const float p2 = acc[2][i] + acc[3][i], p3 = acc[2][i] - acc[3][i];
      acc[0][i] = p0 + p2;
      acc[1][i] = p1 + p3;
      acc[2][i] = p0 - p2;
      acc[3][i] = p1 - p3;
    }
  }
}

// The wide layout's product, for both launches: radix_product over H_256,
// the warpgroup's chunk WG of its rows; emit(jb, acc) receives the rows
// 256 jb + 64 WG .. + 63 of the result.
template <int RAD, int N, int WG, int PLANES, class Emit>
__device__ __forceinline__ void wide_product(const uint32_t (&hq)[4][4],
                                             const unsigned char* tile, Emit emit,
                                             int plane = 0) {
  float acc[RAD][N / 2];
  radix_product<RAD, N, WG, PLANES>(acc, hq, tile, plane);
#pragma unroll
  for (int jb = 0; jb < RAD; ++jb) emit(jb, acc[jb]);
}

// Widths 2^16 to 2^20, launch 1: T^T = H_B . X^T over tiles of NV = 2^15 / B
// rows of the (R A, B) view (a tile lies inside one row r since NV <= A).
// Persistent blocks, one an SM, stream the tiles: cp.async stages the next
// tile's float32 while the four warpgroups run this tile's product. The
// tile is read once for all of H_B; T^T goes out as bf16 in the layout
// (r, B, A), so that launch 2 finds the K-major tile of a strip of T as one
// contiguous piece.
template <int LOG_B>
__global__ void __launch_bounds__(512, 1)
fwht2mm_wg_rows_kernel(const float* __restrict__ x, const uint32_t* __restrict__ sbits,
                       uint16_t* __restrict__ tout, long long tiles, int log_a, int E,
                       int pre) {
  constexpr int B = 1 << LOG_B;
  constexpr int NV = 32768 / B;
  constexpr int PITCH = B + 4;   // floats
  extern __shared__ __align__(128) unsigned char smem_wg[];
  const float* stage = reinterpret_cast<const float*>(smem_wg);
  unsigned char* xs = smem_wg + NV * PITCH * 4;
  const uint32_t stage_at = static_cast<uint32_t>(__cvta_generic_to_shared(smem_wg));
  const long long w = static_cast<long long>(B) << log_a;
  auto fetch = [&](long long tile) {
    const float* src = x + tile * 32768;
#pragma unroll 8
    for (int i = threadIdx.x; i < 32768 / 4; i += 512) {
      cp_async16(stage_at + (i / (B / 4)) * (PITCH * 4) + (i % (B / 4)) * 16, src + 4 * i);
    }
  };
  uint32_t hq[4][4];
  hfrags(hq);
  const int lane = threadIdx.x & 31;
  const int wi = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool odd = t & 1;
  long long tile = blockIdx.x;
  if (tile < tiles) fetch(tile);
  for (; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * NV;
    const long long r = row0 >> log_a;
    const int i0 = static_cast<int>(row0 - (r << log_a));
    const uint32_t* sb =
        pre ? sbits + (r % E) * (w / 32) + static_cast<long long>(i0) * (B / 32) : nullptr;
    cp_async_wait_all();
    __syncthreads();   // the tile is staged; the last tile's products have read xs
    load_tile<NV, B, 512, PITCH>(stage, sb, xs);
    fence_async_smem();
    __syncthreads();   // xs is whole; the staging area is free
    if (tile + gridDim.x < tiles) fetch(tile + gridDim.x);
    uint16_t* tr = tout + r * w + i0;
    auto body = [&](auto wg_c) {
      constexpr int WG = decltype(wg_c)::value;
      wide_product<B / 256, NV, WG, 1>(hq, xs, [&](int jb, const float(&acc)[NV / 2]) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long j = 256 * jb + 64 * WG + 16 * wi + g + 8 * h;
          uint16_t* trow = tr + (j << log_a);
          // a thread holds two neighbouring columns of every 8-column step;
          // lanes t and t ^ 1 swap one pair of steps 2 jp and 2 jp + 1, so
          // that each stores 8 bytes and a row gets 32 contiguous bytes
#pragma unroll
          for (int jp = 0; jp < NV / 16; ++jp) {
            const int e = 8 * jp + 2 * h;
            const uint32_t u0 = bf16x2(acc[e], acc[e + 1]);
            const uint32_t u1 = bf16x2(acc[e + 4], acc[e + 5]);
            const uint32_t rv = __shfl_xor_sync(0xFFFFFFFFu, odd ? u0 : u1, 1);
            *reinterpret_cast<uint2*>(trow + 16 * jp + (odd ? 8 : 0) + 4 * (t >> 1)) =
                odd ? make_uint2(rv, u1) : make_uint2(u0, rv);
          }
        }
      });
    };
    switch (threadIdx.x >> 7) {
      case 0: body(std::integral_constant<int, 0>{}); break;
      case 1: body(std::integral_constant<int, 1>{}); break;
      case 2: body(std::integral_constant<int, 2>{}); break;
      default: body(std::integral_constant<int, 3>{}); break;
    }
  }
}

// Launch 2: an item is (row r, strip of NB = 2^15 / A columns of T). The
// strip's K-major tile, NB x A bf16, is one contiguous 64 KB piece of the
// scratch. Persistent blocks, one an SM, hold two tiles: cp.async fills one
// with the next item while the four warpgroups run Y[:, strip] = H_A .
// T[:, strip] from the other; Y goes out from the accumulators, post-signs
// applied.
template <int LOG_A>
__global__ void __launch_bounds__(512, 1)
fwht2mm_wg_cols_kernel(const uint16_t* __restrict__ tin, const uint32_t* __restrict__ sbits,
                       float* __restrict__ y, long long items, int log_b, int E,
                       int post) {
  constexpr int A = 1 << LOG_A;
  constexpr int NB = 32768 / A;
  constexpr int SBO = A / 8 * kLbo;
  extern __shared__ __align__(128) unsigned char smem_wg[];
  const long long strips = (1LL << log_b) / NB;
  const long long w = static_cast<long long>(A) << log_b;
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem_wg));
  // a warp's copy takes 8 rows x 4 pieces: lane l row l % 8, piece l / 8
  const int row8 = threadIdx.x & 7;
  const int kq = (threadIdx.x >> 3) & 3;
  auto fetch = [&](long long item, int buf) {
    const uint16_t* src = tin + item * 32768;   // (r, strip) in order: r w + col0 A
#pragma unroll 4
    for (int unit = threadIdx.x >> 5; unit < NB / 8 * (A / 32); unit += 16) {
      const int nb = unit / (A / 32);
      const int k8 = 4 * (unit % (A / 32)) + kq;
      cp_async16(base + buf * 65536 + nb * SBO + k8 * kLbo + row8 * 16,
                 src + (8 * nb + row8) * A + 8 * k8);
    }
  };
  uint32_t hq[4][4];
  hfrags(hq);
  long long item = blockIdx.x;
  if (item < items) fetch(item, 0);
  for (int buf = 0; item < items; item += gridDim.x, buf ^= 1) {
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();   // this tile has landed; the other's products are done
    if (item + gridDim.x < items) fetch(item + gridDim.x, buf ^ 1);
    const long long r = item / strips;
    const int col0 = static_cast<int>(item % strips) * NB;
    const uint32_t* sb = post ? sbits + (r % E) * (w / 32) : nullptr;
    auto body = [&](auto wg_c) {
      constexpr int WG = decltype(wg_c)::value;
      wide_product<A / 256, NB, WG, 1>(
          hq, smem_wg + buf * 65536, [&](int jb, const float(&acc)[NB / 2]) {
            store_y<NB>(acc, 256 * jb + 64 * WG, y + r * w, sb, 1 << log_b, col0);
          });
    };
    switch (threadIdx.x >> 7) {
      case 0: body(std::integral_constant<int, 0>{}); break;
      case 1: body(std::integral_constant<int, 1>{}); break;
      case 2: body(std::integral_constant<int, 2>{}); break;
      default: body(std::integral_constant<int, 3>{}); break;
    }
  }
}

// The streaming kernels' grid: one block a multiprocessor.
cudaError_t sm_count(int* n) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
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

cudaError_t run_wg_tile(int log_w, long long rows, const float* x,
                        const uint32_t* sbits, float* y, int E, int pre, int post,
                        cudaStream_t st) {
  switch (log_w) {
#define LDPC_WG_TILE(LW, LA, LB)                                                  \
  case LW:                                                                        \
    return launch(fwht2mm_wg_tile_kernel<LA, LB>, rows, (LB > 6 ? 256 : 128),     \
                  (1 << LA) / 8 * ((1 << LB) / 8) * kLbo +                        \
                      (LB > 6 ? 2 : 1) * (1 << LA) * 128,                         \
                  st, x, sbits, y, E, pre, post);
    LDPC_WG_TILE(12, 6, 6) LDPC_WG_TILE(13, 6, 7) LDPC_WG_TILE(14, 7, 7)
    LDPC_WG_TILE(15, 7, 8)
#undef LDPC_WG_TILE
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t run_wg_rows(int log_b, long long view_rows, const float* x,
                        const uint32_t* sbits, uint16_t* t, int log_a, int E, int pre,
                        cudaStream_t st) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long tiles = view_rows >> (15 - log_b);
  switch (log_b) {
#define LDPC_WG_ROWS(LB)                                                          \
  case LB:                                                                        \
    return launch(fwht2mm_wg_rows_kernel<LB>, tiles < sms ? tiles : sms, 512,     \
                  (32768 >> LB) * ((1 << LB) + 4) * 4 + 65536, st, x, sbits, t,   \
                  tiles, log_a, E, pre);
    LDPC_WG_ROWS(8) LDPC_WG_ROWS(9) LDPC_WG_ROWS(10)
#undef LDPC_WG_ROWS
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t run_wg_cols(int log_a, long long rows, const uint16_t* t,
                        const uint32_t* sbits, float* y, int log_b, int E, int post,
                        cudaStream_t st) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long items = rows << (log_a + log_b - 15);
  switch (log_a) {
#define LDPC_WG_COLS(LA)                                                          \
  case LA:                                                                        \
    return launch(fwht2mm_wg_cols_kernel<LA>, items < sms ? items : sms, 512,     \
                  2 * 65536, st, t, sbits, y, items, log_b, E, post);
    LDPC_WG_COLS(8) LDPC_WG_COLS(9) LDPC_WG_COLS(10)
#undef LDPC_WG_COLS
    default:
      return cudaErrorInvalidValue;
  }
}

// ---- float32 operands: the mma.sync pass kernels ------------------------------

constexpr int kF32Threads = 256;

// A pass's tile in shared memory: three planes (hi, mid, lo) of OUTER rows
// of INNER bf16, INNER the direction that is contiguous in device memory
// (k for pass 1, the vectors for pass 2), 8 bf16 of padding a row so that
// the 8 rows of an ldmatrix hit distinct banks.
template <int LOG_N, int LOG_C, bool STRIDED>
struct F32Tile {
  static constexpr int N = 1 << LOG_N;
  static constexpr int C = 1 << LOG_C;
  static constexpr int OUTER = STRIDED ? N : C;
  static constexpr int INNER = STRIDED ? C : N;
  static constexpr int PITCH = INNER + 8;
  static constexpr int PLANE = OUTER * PITCH;
  static constexpr int SMEM = 3 * PLANE * static_cast<int>(sizeof(uint16_t));
};

// One pass of the float32-operand K2: out_v = H_N . in_v for vectors v of
// N = 2^LOG_N entries, a tile of C = 2^LOG_C vectors a block.
//   STRIDED false (pass 1): vector v is entries v N .. v N + N - 1 of x
//     (nvec vectors, the last tile may be short); sign entry of (v, k):
//     (v mod E a) N + k, with a = 2^log_q here.
//   STRIDED true (pass 2): in row r of 2^log_q N entries, vector (r, q) is
//     entries r N Q + k Q + q, k < N (Q = 2^log_q, C divides Q); sign entry
//     (r mod E) N Q + k Q + q.
// sign_in multiplies the entries by their signs as they are read, sign_out
// as they are written. x and y may be one array: a block reads its whole
// tile before it writes the same entries.
//
// The mma is D (vectors x outputs) = A (vectors x k, the data, ldmatrix
// from a plane; .trans where the vectors run along the plane's rows) . B (k
// x outputs, H_N, built in registers as in product1). A warp owns a 16-vector
// m-tile and up to 8 n-tiles of outputs, and runs the k loop three times,
// once a plane, lo first.
template <int LOG_N, int LOG_C, bool STRIDED>
__global__ void __launch_bounds__(kF32Threads)
fwht2mm_f32_pass_kernel(const float* x, const float* __restrict__ signs, float* y,
                        long long nvec, int log_q, int E, int sign_in, int sign_out) {
  using T = F32Tile<LOG_N, LOG_C, STRIDED>;
  constexpr int N = T::N;
  constexpr int C = T::C;
  constexpr int NT = N / 8;                   // n-tiles of 8 outputs
  constexpr int NCH = NT < 8 ? NT : 8;        // n-tiles a warp holds at once
  constexpr int MT = C / 16;
  constexpr int ITEMS = MT * (NT / NCH);
  constexpr int KU = N / 16 < 4 ? N / 16 : 4;   // k-tiles of a group, unrolled
  extern __shared__ __align__(16) uint16_t f32_smem[];
  __shared__ long long svec[STRIDED ? 1 : C];   // pass 1: sign offset of each vector
  const long long tile = blockIdx.x;
  const long long Q = 1LL << log_q;
  long long base, kstride, cstride, soff = 0;
  int nc = C;
  if (!STRIDED) {
    const long long v0 = tile * C;
    base = v0 * N;
    kstride = 1;
    cstride = N;
    nc = static_cast<int>(nvec - v0 < C ? nvec - v0 : C);
    if (sign_in | sign_out) {
      const long long period = static_cast<long long>(E) << log_q;   // E a vectors
      for (int c = threadIdx.x; c < C; c += kF32Threads) svec[c] = ((v0 + c) % period) * N;
    }
  } else {
    const long long per_row = Q / C;
    const long long r = tile / per_row;
    const long long q0 = (tile % per_row) * C;
    base = r * N * Q + q0;
    kstride = Q;
    cstride = 1;
    soff = (r % E) * N * Q + q0;
  }
  __syncthreads();
  // the sign entry of (vector c, entry k) of the tile
  auto sign_at = [&](int c, int k) -> long long {
    return STRIDED ? soff + k * Q + c : svec[c] + k;
  };

  // the tile, split into its three planes; float4 pieces along INNER
  for (int u = threadIdx.x; u < C * N / 4; u += kF32Threads) {
    const int o = (4 * u) / T::INNER;
    const int in = (4 * u) % T::INNER;
    const int c = STRIDED ? in : o;
    const int k = STRIDED ? o : in;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (c < nc) {
      v = *reinterpret_cast<const float4*>(x + base + c * cstride + k * kstride);
      if (sign_in) {
        const float4 sg = *reinterpret_cast<const float4*>(signs + sign_at(c, k));
        v.x *= sg.x;
        v.y *= sg.y;
        v.z *= sg.z;
        v.w *= sg.w;
      }
    }
    uint32_t p0[3], p1[3];
    split3(v.x, v.y, p0);
    split3(v.z, v.w, p1);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      *reinterpret_cast<uint2*>(f32_smem + q * T::PLANE + o * T::PITCH + in) =
          make_uint2(p0[q], p1[q]);
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  // B fragments of H_16's columns 0-7 and 8-15, as in product1
  uint32_t hb[2][2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    hb[p][0] = hpair(2 * t, 2 * t + 1, 8 * p + g);
    hb[p][1] = hpair(2 * t + 8, 2 * t + 9, 8 * p + g);
  }
  // this lane's ldmatrix row within a 16 x 16 piece of a plane
  const int lrow = STRIDED ? (lane & 7) + ((lane >> 4) << 3) : (lane & 15);
  const int lcol = STRIDED ? ((lane >> 3) & 1) * 8 : (lane >> 4) * 8;
  for (int item = warp; item < ITEMS; item += kF32Threads / 32) {
    const int mt = item % MT;
    const int n0 = (item / MT) * NCH;
    float acc[NCH][4];
#pragma unroll
    for (int j = 0; j < NCH; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll 1
    for (int q = 2; q >= 0; --q) {   // lo, mid, hi
      const uint16_t* plane = f32_smem + q * T::PLANE;
      const uint16_t* src = STRIDED ? plane + lrow * T::PITCH + 16 * mt + lcol
                                    : plane + (16 * mt + lrow) * T::PITCH + lcol;
#pragma unroll 1
      for (int kg = 0; kg < N / 16; kg += KU) {
        // H_N's 16 x 16 tile (kt, J) has the sign (-1)^popcount(kt & J), J =
        // (n0 + j) / 2 = n0 / 2 + j / 2 with n0 / 2 a multiple of 4 (or 0):
        // popcount(kg & n0 / 2), one a group, and popcount((kt - kg) & j / 2),
        // a constant of the unrolled loops; so an mma's B fragments cost two
        // XORs
        const uint32_t fg = flip(kg, n0 >> 1);
#pragma unroll
        for (int r = 0; r < KU; ++r) {
          uint32_t a[4];
          if (STRIDED) {
            ldsm_x4_trans(a, src + 16 * (kg + r) * T::PITCH);
          } else {
            ldsm_x4(a, src + 16 * (kg + r));
          }
#pragma unroll
          for (int j = 0; j < NCH; ++j) {
            const uint32_t f = fg ^ (parity_c(r & (j >> 1)) ? 0x80008000u : 0u);
            mma16816(acc[j], a, hb[j & 1][0] ^ f, hb[j & 1][1] ^ f);
          }
        }
      }
    }
    // D: rows are vectors (g, g + 8), columns outputs (2t, 2t + 1)
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int i = 8 * (n0 + j) + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 16 * mt + g + 8 * h;
        if (c >= nc) continue;
        float v0 = acc[j][2 * h], v1 = acc[j][2 * h + 1];
        if (sign_out) {
          v0 *= signs[sign_at(c, i)];
          v1 *= signs[sign_at(c, i + 1)];
        }
        if (STRIDED) {
          y[base + c + i * kstride] = v0;
          y[base + c + (i + 1) * kstride] = v1;
        } else {
          *reinterpret_cast<float2*>(y + base + c * cstride + i) = make_float2(v0, v1);
        }
      }
    }
  }
}

template <int LOG_N, int LOG_C, bool STRIDED>
cudaError_t launch_f32_pass(const float* x, const float* signs, float* y, long long nvec,
                            long long tiles, int log_q, int E, int sign_in, int sign_out,
                            cudaStream_t st) {
  return launch(fwht2mm_f32_pass_kernel<LOG_N, LOG_C, STRIDED>, tiles, kF32Threads,
                F32Tile<LOG_N, LOG_C, STRIDED>::SMEM, st, x, signs, y, nvec, log_q, E,
                sign_in, sign_out);
}

// Pass 1 at a row width 2^log_w: H_b along the R a rows of b entries, tiles
// of 2^min(14 - log b, 8) rows.
cudaError_t run_f32_pass1(int log_w, long long rows, const float* x, const float* signs,
                          float* y, int E, int pre, cudaStream_t st) {
  const int log_a = log_w / 2;
  const long long nvec = rows << log_a;
  switch (log_w - log_a) {
#define LDPC_F32_P1(LB)                                                             \
  case LB: {                                                                        \
    constexpr int LC = 14 - LB < 8 ? 14 - LB : 8;                                   \
    return launch_f32_pass<LB, LC, false>(x, signs, y, nvec,                        \
                                          (nvec + (1 << LC) - 1) >> LC, log_a, E,   \
                                          pre, 0, st);                              \
  }
    LDPC_F32_P1(4) LDPC_F32_P1(5) LDPC_F32_P1(6) LDPC_F32_P1(7) LDPC_F32_P1(8)
    LDPC_F32_P1(9) LDPC_F32_P1(10)
#undef LDPC_F32_P1
    default:
      return cudaErrorInvalidValue;
  }
}

// Pass 2: H_a along the columns of each row's (a, b) view, in place on y,
// tiles of 2^min(14 - log a, 8, log b) columns.
cudaError_t run_f32_pass2(int log_w, long long rows, const float* signs, float* y, int E,
                          int post, cudaStream_t st) {
  const int log_a = log_w / 2;
  const int log_b = log_w - log_a;
  switch (log_w) {
#define LDPC_F32_P2(LW)                                                             \
  case LW: {                                                                        \
    constexpr int LA = LW / 2, LB = LW - LW / 2;                                    \
    constexpr int LC0 = 14 - LA < 8 ? 14 - LA : 8;                                  \
    constexpr int LC = LC0 < LB ? LC0 : LB;                                         \
    return launch_f32_pass<LA, LC, true>(y, signs, y, 0, rows << (LB - LC), log_b, \
                                         E, 0, post, st);                           \
  }
    LDPC_F32_P2(8) LDPC_F32_P2(9) LDPC_F32_P2(10) LDPC_F32_P2(11) LDPC_F32_P2(12)
    LDPC_F32_P2(13) LDPC_F32_P2(14) LDPC_F32_P2(15) LDPC_F32_P2(16) LDPC_F32_P2(17)
    LDPC_F32_P2(18) LDPC_F32_P2(19) LDPC_F32_P2(20)
#undef LDPC_F32_P2
    default:
      return cudaErrorInvalidValue;
  }
}

// ---- float32 operands on wgmma ------------------------------------------------
//
// The same products as the bf16 wgmma kernels, each operand as its three
// bf16 planes (split3) and each product run lo, mid, hi into one float32
// accumulator (hgemm3). T = X . H_b is never rounded: it goes from the
// accumulators of product 1 into three planes again, or to device memory
// as float32.

// Widths 2^12 to 2^15, one launch, one block a row of B / 64 warpgroups.
// X's three planes (6w bytes: 192 KB at 2^15) fill the block's shared
// memory (one block an SM at 2^15, two from 2^12 to 2^14), so a block
// loads, multiplies and stores in turn; blocks on other SMs overlap its
// bytes. Both products take a factor of 128 or 256 as H_2 or H_4 (x) H_64
// (radix_product, BASE 64): a half or a quarter of the tensor work, the
// butterfly in float32. Product 1: warpgroup g takes X's rows N1 g .. N1 g
// + N1 - 1 (N1 = A / (B / 64)) and holds T^T (B x N1) for them in float32
// accumulators (64 a thread at 2^15); once every warpgroup has read X,
// T^T's three planes go over X's, as B / 64 K-major chunks of 64 x A.
// Product 2: warpgroup g runs Y[:, chunk g] = H_A . T[:, chunk g], and Y
// goes out from the accumulators. x in and y out, 8w bytes a row.
template <int LOG_A, int LOG_B>
__global__ void __launch_bounds__(2 << LOG_B, (LOG_B > 7 ? 1 : 2))
fwht2mm_f32_tile_kernel(const float* __restrict__ x, const uint32_t* __restrict__ sbits,
                        float* __restrict__ y, int E, int pre, int post) {
  constexpr int A = 1 << LOG_A;
  constexpr int B = 1 << LOG_B;
  constexpr int N1 = A / (B / 64);       // X's rows a warpgroup takes in product 1
  constexpr int XS = A * B * 2;          // one plane of X, bytes
  constexpr int XS_SBO = B / 8 * kLbo;
  constexpr int TS = A * 128;            // one plane of a chunk of T^T (64 x A)
  constexpr int TS_SBO = A / 8 * kLbo;
  extern __shared__ __align__(128) unsigned char smem_wg[];
  const long long w = static_cast<long long>(A) * B;
  const long long r = blockIdx.x;
  const uint32_t* sb = sbits != nullptr ? sbits + (r % E) * (w / 32) : nullptr;
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int wi = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2;
  const int tq = lane & 3;
  uint32_t hq[4][4];
  hfrags(hq);
  load_tile<A, B, 2 * B, B, 3>(x + r * w, pre ? sb : nullptr, smem_wg, XS);
  fence_async_smem();
  __syncthreads();
  float t[B / 64][N1 / 2];
  radix_product<B / 64, N1, 0, 3, 64>(t, hq, smem_wg + wg * (N1 / 8) * XS_SBO, XS);
  __syncthreads();   // every warpgroup has read X: T's planes go over it
#pragma unroll
  for (int jb = 0; jb < B / 64; ++jb) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < N1 / 8; ++j) {
        uint32_t q[3];
        split3(t[jb][4 * j + 2 * h], t[jb][4 * j + 2 * h + 1], q);
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          *reinterpret_cast<uint32_t*>(smem_wg + (3 * jb + p) * TS + (2 * wi + h) * TS_SBO +
                                       (wg * (N1 / 8) + j) * kLbo + g * 16 + 4 * tq) = q[p];
        }
      }
    }
  }
  fence_async_smem();
  __syncthreads();   // T's planes are whole
  float acc[A / 64][32];
  radix_product<A / 64, 64, 0, 3, 64>(acc, hq, smem_wg + wg * 3 * TS, TS);
#pragma unroll
  for (int jb = 0; jb < A / 64; ++jb) {
    store_y<64>(acc[jb], 64 * jb, y + r * w, post ? sb : nullptr, B, 64 * wg);
  }
}

// Widths 2^16 to 2^20, launch L (1 or 2) of two, persistent, one block of
// four warpgroups an SM. A tile is 2^14 contiguous float32 read as N =
// 2^14 / K vectors of K = 2^LOG_K, out = H_K . vectors, H_K = H_RAD (x)
// H_256 (wide_product, three planes): cp.async stages the next tile's
// float32 (64 KB) while this tile's three planes (96 KB) are multiplied.
//   L = 1: the vectors are rows of the (R A, B) view (K = B, log_o =
//     log A), pre-signs applied as they are split; T^T goes out in float32
//     in the layout (r, B, A), so that a strip of T is contiguous.
//   L = 2: a tile is row r's strip of N columns of T (K = A, log_o =
//     log B); Y[:, strip] goes out from the accumulators, post-signs
//     applied.
// T crosses device memory in float32, 16w bytes a row in all.
template <int LOG_K, int L>
__global__ void __launch_bounds__(512, 1)
fwht2mm_f32_wide_kernel(const float* __restrict__ in, const uint32_t* __restrict__ sbits,
                        float* __restrict__ out, long long tiles, int log_o, int E,
                        int sign) {
  constexpr int K = 1 << LOG_K;
  constexpr int N = 16384 / K;
  constexpr int PITCH = K + 4;   // floats a staged row: its 16-byte loads hit distinct banks
  constexpr int PLANE = N * K * 2;
  extern __shared__ __align__(128) unsigned char smem_wg[];
  const float* stage = reinterpret_cast<const float*>(smem_wg + 3 * PLANE);
  const uint32_t stage_at =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_wg + 3 * PLANE));
  const long long w = static_cast<long long>(K) << log_o;
  auto fetch = [&](long long tile) {
    const float* src = in + tile * 16384;
#pragma unroll 8
    for (int i = threadIdx.x; i < 16384 / 4; i += 512) {
      cp_async16(stage_at + (i / (K / 4)) * (PITCH * 4) + (i % (K / 4)) * 16, src + 4 * i);
    }
  };
  uint32_t hq[4][4];
  hfrags(hq);
  const int lane = threadIdx.x & 31;
  const int wi = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2;
  const int tq = lane & 3;
  long long tile = blockIdx.x;
  if (tile < tiles) fetch(tile);
  for (; tile < tiles; tile += gridDim.x) {
    long long r;
    int off;   // L = 1: the tile's first row of the (A, B) view; 2: its first column
    if constexpr (L == 1) {
      const long long row0 = tile * N;
      r = row0 >> log_o;
      off = static_cast<int>(row0 - (r << log_o));
    } else {
      const long long strips = (1LL << log_o) / N;
      r = tile / strips;
      off = static_cast<int>(tile % strips) * N;
    }
    const uint32_t* sb = sign ? sbits + (r % E) * (w / 32) : nullptr;
    cp_async_wait_all();
    __syncthreads();   // the tile is staged; the last tile's products have read the planes
    load_tile<N, K, 512, PITCH, 3, 4>(   // 4 loads in flight: 8 spill at K = 1024
        stage, L == 1 && sign ? sb + static_cast<long long>(off) * (K / 32) : nullptr,
        smem_wg, PLANE);
    fence_async_smem();
    __syncthreads();   // the planes are whole; the staging area is free
    if (tile + gridDim.x < tiles) fetch(tile + gridDim.x);
    auto body = [&](auto wg_c) {
      constexpr int WG = decltype(wg_c)::value;
      wide_product<K / 256, N, WG, 3>(
          hq, smem_wg,
          [&](int jb, const float(&acc)[N / 2]) {
            if constexpr (L == 1) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const long long j = 256 * jb + 64 * WG + 16 * wi + g + 8 * h;
                float* trow = out + r * w + (j << log_o) + off;
#pragma unroll
                for (int jj = 0; jj < N / 8; ++jj) {
                  *reinterpret_cast<float2*>(trow + 8 * jj + 2 * tq) =
                      make_float2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
                }
              }
            } else {
              store_y<N>(acc, 256 * jb + 64 * WG, out + r * w, sb, 1 << log_o, off);
            }
          },
          PLANE);
    };
    switch (threadIdx.x >> 7) {
      case 0: body(std::integral_constant<int, 0>{}); break;
      case 1: body(std::integral_constant<int, 1>{}); break;
      case 2: body(std::integral_constant<int, 2>{}); break;
      default: body(std::integral_constant<int, 3>{}); break;
    }
  }
}

cudaError_t run_f32_tile(int log_w, long long rows, const float* x, const uint32_t* sbits,
                         float* y, int E, int pre, int post, cudaStream_t st) {
  switch (log_w) {
#define LDPC_F32_TILE(LW, LA, LB)                                                  \
  case LW:                                                                         \
    return launch(fwht2mm_f32_tile_kernel<LA, LB>, rows, 2 << LB,                  \
                  3 * (1 << LA) * (1 << LB) * 2, st, x, sbits, y, E, pre, post);
    LDPC_F32_TILE(12, 6, 6) LDPC_F32_TILE(13, 6, 7) LDPC_F32_TILE(14, 7, 7)
    LDPC_F32_TILE(15, 7, 8)
#undef LDPC_F32_TILE
    default:
      return cudaErrorInvalidValue;
  }
}

// Launch L of the wide layout on vectors of 2^log_k: rows << (log_w - 14)
// tiles, whichever the launch.
cudaError_t run_f32_wide(int L, int log_k, int log_o, long long tiles, const float* in,
                         const uint32_t* sbits, float* out, int E, int sign,
                         cudaStream_t st) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long blocks = tiles < sms ? tiles : sms;
  switch (log_k) {
#define LDPC_F32_WIDE(LK)                                                          \
  case LK: {                                                                       \
    constexpr int N = 16384 >> LK;                                                 \
    constexpr int SMEM = 3 * N * (1 << LK) * 2 + N * ((1 << LK) + 4) * 4;          \
    return L == 1 ? launch(fwht2mm_f32_wide_kernel<LK, 1>, blocks, 512, SMEM, st, \
                           in, sbits, out, tiles, log_o, E, sign)                  \
                  : launch(fwht2mm_f32_wide_kernel<LK, 2>, blocks, 512, SMEM, st, \
                           in, sbits, out, tiles, log_o, E, sign);                 \
  }
    LDPC_F32_WIDE(8) LDPC_F32_WIDE(9) LDPC_F32_WIDE(10)
#undef LDPC_F32_WIDE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// y = H_a . (x * s . H_b) (apply_pre) or (H_a . (x . H_b)) * s with float32
// operands (three bf16 planes each) over rows of length 2^log_w, 8 <= log_w
// <= 20; signs null or (E, 2^log_w), row r using sign row r % E. kernel 0:
// the mma.sync pass kernels (every width, two launches, T in y between
// them); 1: the wgmma kernels (log_w >= 12), which take the signs as bits
// and need sign_bits, E * 2^log_w / 32 words that this call fills, when
// signs is not null, and scratch, a (rows, 2^log_w) float32 buffer for T,
// when log_w > 15. passes: 3 runs the transform; where there are two
// launches (kernel 0, or kernel 1 above 2^15), 1 runs the first alone and 2
// the second alone, for timing. x, y, signs and scratch must be 16-byte
// aligned, x and y must not overlap, and E * 2^log_w must stay below 2^31.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int ldpc_fwht_2mm_f32(const float* x, const float* signs, float* y,
                                 float* scratch, uint32_t* sign_bits, long long rows,
                                 int log_w, int E, int apply_pre, int kernel, int passes,
                                 void* stream) {
  cudaGetLastError();  // clear a stale error of an earlier call
  if (rows <= 0 || E <= 0 || rows % E != 0 || log_w < 8 || log_w > 20 ||
      passes < 1 || passes > 3 || (static_cast<long long>(E) << log_w) >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pre = signs != nullptr && apply_pre;
  const int post = signs != nullptr && !apply_pre;
  cudaError_t err = cudaSuccess;
  if (kernel == 0) {
    if (passes & 1) err = run_f32_pass1(log_w, rows, x, signs, y, E, pre, st);
    if (err == cudaSuccess && (passes & 2)) {
      err = run_f32_pass2(log_w, rows, signs, y, E, post, st);
    }
    return static_cast<int>(err);
  }
  if (kernel != 1 || log_w < 12 || (passes != 3 && log_w <= kTileMaxLog) ||
      (signs != nullptr && sign_bits == nullptr) ||
      (log_w > kTileMaxLog && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (signs != nullptr) {
    const long long n = static_cast<long long>(E) << log_w;
    err = launch(pack_signs_kernel, (n + 255) / 256, 256, 0, st, signs, sign_bits, n);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    sign_bits = nullptr;
  }
  if (log_w <= kTileMaxLog) {
    return static_cast<int>(run_f32_tile(log_w, rows, x, sign_bits, y, E, pre, post, st));
  }
  const int log_a = log_w / 2;
  const int log_b = log_w - log_a;
  const long long tiles = rows << (log_w - 14);
  if (passes & 1) {
    err = run_f32_wide(1, log_b, log_a, tiles, x, sign_bits, scratch, E, pre, st);
  }
  if (err == cudaSuccess && (passes & 2)) {
    err = run_f32_wide(2, log_a, log_b, tiles, scratch, sign_bits, y, E, post, st);
  }
  return static_cast<int>(err);
}

// y = H_a . bf16(bf16(x * s) . H_b) (apply_pre) or (H_a . bf16(bf16(x) . H_b)) * s
// over rows of length 2^log_w, 8 <= log_w <= 20, on the (a, b) view of each
// row. signs may be null (no sign diagonal), else it is (E, 2^log_w) and row
// r uses sign row r % E. kernel 0: the mma.sync kernel (log_w <= 15); 1: the
// wgmma kernels (log_w >= 12), which take the signs as bits and need
// sign_bits, E * 2^log_w / 32 words that this call fills, when signs is not
// null, and scratch, a (rows, 2^log_w) bf16 buffer for the intermediate,
// when log_w > 15. passes: 3 runs the whole transform; above 2^15, 1 runs
// the first launch alone (x -> scratch) and 2 the second (scratch -> y), for
// timing. x, y, signs and scratch must be 16-byte aligned, and x and y must
// not overlap. Returns cudaGetLastError() after the launches (0 on success).
extern "C" int ldpc_fwht_2mm(const float* x, const float* signs, float* y,
                             uint16_t* scratch, uint32_t* sign_bits, long long rows,
                             int log_w, int E, int apply_pre, int kernel, int passes,
                             void* stream) {
  cudaGetLastError();  // clear a stale error of an earlier call
  if (rows <= 0 || E <= 0 || rows % E != 0 || log_w < 8 || log_w > 20 ||
      passes < 1 || passes > 3 || (passes != 3 && log_w <= kTileMaxLog)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pre = signs != nullptr && apply_pre;
  const int post = signs != nullptr && !apply_pre;
  if (kernel == 0) {
    return static_cast<int>(run_tile(log_w, rows, x, signs, y, E, pre, post, st));
  }
  if (kernel != 1 || log_w < 12 || (signs != nullptr && sign_bits == nullptr) ||
      (log_w > kTileMaxLog && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSuccess;
  if (signs != nullptr) {
    const long long n = static_cast<long long>(E) << log_w;
    err = launch(pack_signs_kernel, (n + 255) / 256, 256, 0, st, signs, sign_bits, n);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    sign_bits = nullptr;
  }
  if (log_w <= kTileMaxLog) {
    return static_cast<int>(run_wg_tile(log_w, rows, x, sign_bits, y, E, pre, post, st));
  }
  const int log_a = log_w / 2;
  const int log_b = log_w - log_a;
  if (passes & 1) {
    err = run_wg_rows(log_b, rows << log_a, x, sign_bits, scratch, log_a, E, pre, st);
  }
  if (err == cudaSuccess && (passes & 2)) {
    err = run_wg_cols(log_a, rows, scratch, sign_bits, y, log_b, E, post, st);
  }
  return static_cast<int>(err);
}
