// Grid sizing from occupancy, shared by every launch of the port's Hopper
// kernels: the blocks an SM holds of one kernel instantiation and the SM
// count, cached per device; a grid of as many blocks as the card holds at
// once, or fewer where the work is smaller; and an instantiation's
// registers, shared and local bytes for the build logs.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace interp {

constexpr int kMaxDevices = 64;

// Blocks of one kernel instantiation that an SM holds at once with its
// route's reservation of dynamic shared memory (`regular.cuh::reserve_of`), and the SM
// count, per device: computed at the first launch on the device, after
// raising the instantiation's dynamic shared-memory limit to the
// reservation where that is above the default 48 KB. The limit is set to
// that one value only, under the lock, before any launch on the device
// reads the cache, so no launch finds it lowered; a launch's table may use
// less of it.
struct Occupancy {
  std::mutex mu;
  int per_sm[kMaxDevices] = {};  // 0: not computed yet
  int sms[kMaxDevices] = {};
};

template <typename Kernel>
cudaError_t occupancy_of(Kernel kernel, int threads, size_t reserve, int device, int* per_sm,
                         int* sms) {
  cudaError_t err = cudaSuccess;
  if (reserve > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(reserve));
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, reserve);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

template <typename Kernel>
cudaError_t occupancy(Occupancy& o, Kernel kernel, int threads, size_t reserve, int* per_sm,
                      int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(o.mu);
  if (o.per_sm[device] == 0) {
    int got = 0, count = 0;
    err = occupancy_of(kernel, threads, reserve, device, &got, &count);
    if (err != cudaSuccess) {
      cudaGetLastError();  // reported here; not again by the next launch's check
      return err;
    }
    o.sms[device] = count;
    o.per_sm[device] = got;
  }
  *per_sm = o.per_sm[device];
  *sms = o.sms[device];
  return cudaSuccess;
}

// min(ceil(n / threads) x groups, SMs x resident blocks): over the groups
// of tables of a staged stack (`block_group`), as many blocks as the card
// holds at once, at least one a table; an error where no block fits.
template <typename Kernel>
cudaError_t grid_blocks(Occupancy& o, Kernel kernel, int threads, size_t reserve, int64_t n,
                        int* blocks, int groups = 1, int nch = 1) {
  int per_sm = 0, sms = 0;
  const cudaError_t err = occupancy(o, kernel, threads, reserve, &per_sm, &sms);
  if (err != cudaSuccess) return err;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  const int64_t want = (n + threads - 1) / threads * groups;
  const int64_t most = static_cast<int64_t>(per_sm) * sms;
  int64_t b = want < most ? want : most;
  if (groups > 1 && b < nch) b = nch;
  *blocks = static_cast<int>(b);
  return *blocks > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

namespace {
// One cache per kernel, keyed by a type. Internal linkage: a static of an
// inline function with external linkage is one object per process, shared
// by every library built from this header (two builds of one source loaded
// side by side would share, and skip, each other's shared-memory opt-in).
template <typename Key>
Occupancy& occupancy_cache() {
  static Occupancy o;
  return o;
}
}  // namespace

// info[0..3] of one kernel instantiation: registers a thread, static shared
// bytes, local (spill) bytes a thread, blocks an SM holds at once with its
// route's reservation of dynamic shared memory.
template <typename Kernel>
cudaError_t kernel_info(Occupancy& o, Kernel kernel, int threads, size_t reserve, int* out) {
  cudaFuncAttributes attr{};
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = occupancy(o, kernel, threads, reserve, &out[3], &sms);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = static_cast<int>(attr.localSizeBytes);
  return err;
}

}  // namespace interp
