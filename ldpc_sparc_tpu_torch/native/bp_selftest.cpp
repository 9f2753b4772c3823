// Standalone self-test for the native BP oracle (bp_ref.cpp).
//
// Native-only counterpart of the reference kernel's __DEBUG__ main
// (ldpc_jossy/src/c_ldpc.c:404-449): transmit a baked 802.16 rate-1/2 z=81
// codeword over a binary symmetric channel, decode with every check rule,
// and require exact recovery plus the 0-iteration noiseless fixed point.
// Needs no Python: build and run with
//
//   g++ -O2 -std=c++17 -o bp_selftest bp_selftest.cpp bp_ref.cpp
//   ./bp_selftest        # prints PASS / FAIL, exit code 0 / 1
//
// (The graph/codeword header is generated from the framework's LDPC
// library — see bp_selftest_data.h.)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <vector>

#include "bp_selftest_data.h"

extern "C" {
int ref_sumprod(const double*, const int64_t*, const int64_t*,
                const int64_t*, int64_t, int64_t, int64_t, double*, int);
int ref_sumprod2(const double*, const int64_t*, const int64_t*,
                 const int64_t*, int64_t, int64_t, int64_t, double*, int);
int ref_minsum(const double*, const int64_t*, const int64_t*, const int64_t*,
               int64_t, int64_t, int64_t, double*, double, int);
}

namespace {

// xorshift64 — deterministic BSC flips without libc rand() variance
uint64_t rng_state = 0x9e3779b97f4a7c15ULL;
double uniform() {
  rng_state ^= rng_state << 13;
  rng_state ^= rng_state >> 7;
  rng_state ^= rng_state << 17;
  return (rng_state >> 11) * (1.0 / 9007199254740992.0);
}

bool run_case(const char* name,
              int (*decode)(const double*, const int64_t*, const int64_t*,
                            const int64_t*, int64_t, int64_t, int64_t,
                            double*, int),
              double flip_prob, bool expect_zero_iters) {
  const double p = 0.05;  // LLR magnitude assumes a 5% BSC
  const double llr_mag = std::log((1.0 - p) / p);
  std::vector<double> ch(kNv);
  int nflipped = 0;
  for (int64_t v = 0; v < kNv; ++v) {
    int bit = kCodeword[v];
    if (uniform() < flip_prob) {
      bit ^= 1;
      ++nflipped;
    }
    ch[v] = bit ? -llr_mag : llr_mag;  // LLR > 0 <=> bit 0
  }
  std::vector<double> app(kNv, 0.0);
  int iters = decode(ch.data(), kVdeg, kCdeg, kIntrlv, kNv, kNc, kNmsg,
                     app.data(), 200);
  int errs = 0;
  for (int64_t v = 0; v < kNv; ++v)
    if ((app[v] < 0.0) != (kCodeword[v] != 0)) ++errs;
  bool ok = (errs == 0) && (!expect_zero_iters || iters == 0);
  std::printf("%-10s flips=%-3d iters=%-3d bit errors=%-4d : %s\n", name,
              nflipped, iters, errs, ok ? "ok" : "FAIL");
  return ok;
}

int minsum_wrap(const double* ch, const int64_t* vdeg, const int64_t* cdeg,
                const int64_t* intrlv, int64_t nv, int64_t nc, int64_t nmsg,
                double* app, int max_iters) {
  return ref_minsum(ch, vdeg, cdeg, intrlv, nv, nc, nmsg, app, 0.7,
                    max_iters);
}

}  // namespace

int main() {
  bool ok = true;
  // noiseless fixed point: decode must detect satisfied parity at iter 0
  ok &= run_case("sumprod", ref_sumprod, 0.0, true);
  ok &= run_case("sumprod2", ref_sumprod2, 0.0, true);
  ok &= run_case("minsum", minsum_wrap, 0.0, true);
  // 5% BSC: all rules must fully correct (well inside the waterfall)
  ok &= run_case("sumprod", ref_sumprod, 0.05, false);
  ok &= run_case("sumprod2", ref_sumprod2, 0.05, false);
  ok &= run_case("minsum", minsum_wrap, 0.05, false);
  std::printf(ok ? "PASS\n" : "FAIL\n");
  return ok ? EXIT_SUCCESS : EXIT_FAILURE;
}
