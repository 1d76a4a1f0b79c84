// One lane of the classic Fano sequential decoder for the WSPR K=32 r=1/2
// code, shared by the host backend (fano_native.cc, one OpenMP iteration
// per lane) and the GPU kernel (fano_cuda.cu, one CUDA thread per lane),
// so the CPU tests of the host backend run the exact lane code the GPU
// runs. Semantics are matched to the reference decoder (see
// lib/Fano.cc:110-252 for the behavioral spec; this is a fresh
// array-based implementation, not a copy):
//   - per-step branch metrics from a (2,256) metric table
//   - best-first branch ordering (complementary branch symbols)
//   - threshold tighten/relax in `delta` steps
//   - all-zero 31-step tail, 0-branch only
//   - budget of maxcycles*nbits forward looks; finishing exactly on the
//     last allowed cycle still reports timeout (reference quirk).
// Metrics, thresholds and path metrics fit int32 for every budget the
// decoder accepts (|branch metric| <= 274, 81 steps, one delta per cycle).

#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define UWSPR_HD __host__ __device__
#else
#define UWSPR_HD
#endif

namespace uwspr {

constexpr int kMaxBits = 81;            // WSPR: 50 data bits + 31 tail
constexpr uint32_t kPoly1 = 0xF2D05351u;
constexpr uint32_t kPoly2 = 0xE4613C47u;

UWSPR_HD inline int parity(uint32_t v) {
#if defined(__CUDA_ARCH__)
  return __popc(v) & 1;
#else
  return __builtin_parity(v);
#endif
}

// 2-bit branch symbol: POLY1 parity in the 2s place, POLY2 parity in the 1s.
UWSPR_HD inline int branch_symbol(uint32_t state) {
  return (parity(state & kPoly1) << 1) | parity(state & kPoly2);
}

struct LaneResult {
  int32_t success;
  int32_t metric;
  int32_t cycles;
  int32_t maxnp;
};

// Decode one lane of 2*nbits soft symbols (coded-bit order, values
// 0..255). mettab is the (2, 256) metric table, flattened. Writes
// nbits/8 decoded bytes to out_bytes.
template <typename Sym>
UWSPR_HD LaneResult fano_lane(const Sym* symbols, int nbits,
                              const int32_t* mettab, int delta,
                              long long maxcycles, uint8_t* out_bytes) {
  const int tail = nbits - 31;
  int32_t gamma[kMaxBits + 1];
  uint32_t enc[kMaxBits + 1];
  int32_t tm0[kMaxBits + 1], tm1[kMaxBits + 1];
  int8_t branch[kMaxBits + 1];
  for (int n = 0; n <= nbits; ++n) {
    gamma[n] = 0;
    enc[n] = 0;
    tm0[n] = 0;
    tm1[n] = 0;
    branch[n] = 0;
  }
  // branch metric of hypothesis j = (poly1_bit << 1) | poly2_bit at step k
  auto metric = [&](int k, int j) {
    return mettab[(j >> 1) * 256 + static_cast<int>(symbols[2 * k])] +
           mettab[(j & 1) * 256 + static_cast<int>(symbols[2 * k + 1])];
  };
  auto expand = [&](int k) {
    const int lsym = branch_symbol(enc[k]);
    if (k >= tail) {
      tm0[k] = metric(k, lsym);
    } else {
      const int32_t a = metric(k, lsym);
      const int32_t b = metric(k, 3 ^ lsym);
      if (a > b) {
        tm0[k] = a;
        tm1[k] = b;
      } else {
        tm0[k] = b;
        tm1[k] = a;
        enc[k] += 1;  // 1-branch is better
      }
    }
    branch[k] = 0;
  };

  int k = 0;
  expand(0);
  int32_t t = 0;
  const long long budget = maxcycles * nbits;
  int32_t maxnp = 0;
  long long i = 1;
  for (; i <= budget; ++i) {
    if (k > maxnp) maxnp = k;
    const int32_t ngamma = gamma[k] + (branch[k] ? tm1[k] : tm0[k]);
    if (ngamma >= t) {
      if (gamma[k] < t + delta) {
        while (ngamma >= t + delta) t += delta;
      }
      gamma[k + 1] = ngamma;
      enc[k + 1] = enc[k] << 1;
      ++k;
      if (k == nbits) break;  // complete
      expand(k);
    } else {
      for (;;) {
        if (k == 0 || gamma[k - 1] < t) {
          t -= delta;
          if (branch[k] != 0) {
            branch[k] = 0;
            enc[k] ^= 1u;
          }
          break;
        }
        --k;
        if (k < tail && branch[k] != 1) {
          branch[k] += 1;
          enc[k] ^= 1u;
          break;
        }
      }
    }
  }

  const int nbytes = nbits >> 3;
  for (int b = 0; b < nbytes; ++b) out_bytes[b] = enc[7 + 8 * b] & 0xFF;
  LaneResult r;
  r.success = (i < budget) ? 1 : 0;
  r.metric = gamma[k];
  r.cycles = static_cast<int32_t>(i + 1);
  r.maxnp = maxnp;
  return r;
}

}  // namespace uwspr
