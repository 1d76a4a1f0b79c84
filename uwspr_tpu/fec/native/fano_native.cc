// Native batched Fano sequential decoder for the WSPR K=32 r=1/2 code.
//
// Host-side runtime component: decodes many independent soft-symbol lanes
// in parallel (OpenMP), one classic Fano threshold search per lane. The
// lane algorithm lives in fano_lane.h, shared with the GPU kernel
// (fano_cuda.cu).
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC fano_native.cc -o libuwspr_fano.so

#include <cstddef>
#include <cstdint>

#include "fano_lane.h"

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// symbols: (n_lanes, 2*nbits) uint8, coded-bit order (deinterleaved)
// mettab: (2, 256) int32
// out_data: (n_lanes, nbits>>3) uint8
// out_success/metric/cycles/maxnp: (n_lanes,) int32/uint32
void uwspr_fano_decode_batch(const uint8_t* symbols, int n_lanes, int nbits,
                             const int32_t* mettab, int delta, int maxcycles,
                             uint8_t* out_data, int32_t* out_success,
                             int32_t* out_metric, uint32_t* out_cycles,
                             uint32_t* out_maxnp) {
  const int nbytes = nbits >> 3;
#pragma omp parallel for schedule(dynamic, 1)
  for (int lane = 0; lane < n_lanes; ++lane) {
    uwspr::LaneResult r = uwspr::fano_lane(
        symbols + static_cast<size_t>(lane) * 2 * nbits, nbits, mettab,
        delta, maxcycles, out_data + static_cast<size_t>(lane) * nbytes);
    out_success[lane] = r.success;
    out_metric[lane] = r.metric;
    out_cycles[lane] = static_cast<uint32_t>(r.cycles);
    out_maxnp[lane] = static_cast<uint32_t>(r.maxnp);
  }
}

int uwspr_fano_num_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
