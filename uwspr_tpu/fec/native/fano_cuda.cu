// Batched Fano sequential decoder on the GPU, called from JAX through the
// XLA foreign function interface: one CUDA thread per lane, each running
// the classic sequential search of fano_lane.h (shared with the host
// backend) with its trellis in registers/local memory and the (2, 256)
// metric table in shared memory. Lanes finish independently; nothing
// leaves the card until the batch is done.
//
// Built at first use by uwspr_tpu/fec/fano_cuda.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I <jax.ffi.include_dir()> fano_cuda.cu

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "fano_lane.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kThreads = 128;           // lanes per CUDA block

__global__ void fano_lanes(const int32_t* symbols, const int32_t* mettab,
                           const int32_t* active, int n_lanes, int nbits,
                           int delta, int maxcycles, uint8_t* out_data,
                           int32_t* out_success, int32_t* out_metric,
                           int32_t* out_cycles, int32_t* out_maxnp) {
  __shared__ int32_t met[512];
  for (int i = threadIdx.x; i < 512; i += blockDim.x) met[i] = mettab[i];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  const int nbytes = nbits >> 3;
  uint8_t* data = out_data + static_cast<size_t>(lane) * nbytes;
  if (!active[lane]) {                  // skipped lane: reports failure
    for (int b = 0; b < nbytes; ++b) data[b] = 0;
    out_success[lane] = 0;
    out_metric[lane] = 0;
    out_cycles[lane] = 1;
    out_maxnp[lane] = 0;
    return;
  }
  uwspr::LaneResult r = uwspr::fano_lane(
      symbols + static_cast<size_t>(lane) * 2 * nbits, nbits, met, delta,
      maxcycles, data);
  out_success[lane] = r.success;
  out_metric[lane] = r.metric;
  out_cycles[lane] = r.cycles;
  out_maxnp[lane] = r.maxnp;
}

ffi::Error FanoImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> symbols,
                    ffi::Buffer<ffi::S32> mettab,
                    ffi::Buffer<ffi::S32> active, int32_t delta,
                    int32_t maxcycles, int32_t nbits,
                    ffi::ResultBuffer<ffi::U8> data,
                    ffi::ResultBuffer<ffi::S32> success,
                    ffi::ResultBuffer<ffi::S32> metric,
                    ffi::ResultBuffer<ffi::S32> cycles,
                    ffi::ResultBuffer<ffi::S32> maxnp) {
  auto dims = symbols.dimensions();
  if (dims.size() != 2 || dims[1] != 2 * nbits || nbits > uwspr::kMaxBits ||
      nbits < 32 || mettab.element_count() != 512 ||
      active.element_count() != static_cast<size_t>(dims[0])) {
    return ffi::Error::InvalidArgument("uwspr_fano: bad operand shapes");
  }
  const int n = static_cast<int>(dims[0]);
  if (n == 0) return ffi::Error::Success();
  const int blocks = (n + kThreads - 1) / kThreads;
  fano_lanes<<<blocks, kThreads, 0, stream>>>(
      symbols.typed_data(), mettab.typed_data(), active.typed_data(), n,
      nbits, delta, maxcycles, data->typed_data(), success->typed_data(),
      metric->typed_data(), cycles->typed_data(), maxnp->typed_data());
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(UwsprFano, FanoImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()  // symbols
                                  .Arg<ffi::Buffer<ffi::S32>>()  // mettab
                                  .Arg<ffi::Buffer<ffi::S32>>()  // active
                                  .Attr<int32_t>("delta")
                                  .Attr<int32_t>("maxcycles")
                                  .Attr<int32_t>("nbits")
                                  .Ret<ffi::Buffer<ffi::U8>>()   // data
                                  .Ret<ffi::Buffer<ffi::S32>>()  // success
                                  .Ret<ffi::Buffer<ffi::S32>>()  // metric
                                  .Ret<ffi::Buffer<ffi::S32>>()  // cycles
                                  .Ret<ffi::Buffer<ffi::S32>>()  // maxnp
);
