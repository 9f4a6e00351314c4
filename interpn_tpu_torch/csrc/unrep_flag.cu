// The regular-grid entries' unrepresentable-coordinate flag for Hopper
// (sm_90a): whether any query's cell index floor((x - start) / step) falls
// outside [-2^63, 2^63), the reference's "Unrepresentable coordinate value"
// error for NaN, inf and far-out coordinates. f32 and f64, 1-8 axes.
//
// Replaces no TPU kernel: the JAX package computes the flag with jnp ops
// (`interpn_tpu/raw.py::_unrep_flag`), which XLA fuses into one pass. The
// port computed it with PyTorch ops (`raw._unrep_passes`, the plain version
// here): about six elementwise passes a column with their intermediates
// written out and read back, 4.5 ms a step at 3 x 1e8 f32 queries on an
// H100, where the checked call's interpolation kernel takes 0.66 ms.
//
// What bounds it: bytes. Each query column is read once, ndims x n x
// itemsize bytes (1.2 GB at 3 x 1e8 f32, 0.358 ms at 3.35 TB/s), and one
// byte is written. The arithmetic is a subtract, an IEEE divide and two
// compares a value.
//
// What the design does about it: one launch reads every column once, a
// 16-byte vector load a column per iteration (a scalar head and tail where
// a column does not start on a 16-byte boundary), four loads in flight a
// thread, as many blocks as the card holds at once walking the columns
// grid-stride, and keeps nothing but a per-thread flag: no intermediate
// reaches memory. Each block joins its threads' flags with
// __syncthreads_or, and a block that found one stores 1 into the flag (the
// wrapper zeroes it first); every writer writes the same byte, so there is
// no atomic and no second pass. There is no early exit: real traffic is
// almost never unrepresentable, so every query is read anyway.
//
// The predicate is the plain version's, bit for bit: v = (x - s) / h by
// the _rn intrinsics (IEEE subtract and divide, never a reciprocal
// multiply; the build keeps --fmad=false and no fast math), and the flag
// is set where !(v >= -2^63 && v < 2^63), which NaN fails. The plain
// version takes floor(v) first; since +-2^63 are integers, floor(v) lies in
// that range exactly when v does, so the kernel skips the floor.

#include "interp_common.cuh"
#include "occupancy.cuh"

namespace {

using interp::kMaxDims;

constexpr int kFlagThreads = 256;
constexpr int kUnroll = 4;  // 16-byte loads in flight a thread

// 16 bytes of a column and its element count
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int kWidth = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int kWidth = 2;
};

// The column pointers, read in place from the kernel's parameters
// (__grid_constant__): indexed by the axis, a by-value copy would go to a
// local-memory frame.
template <typename T>
struct FlagCols {
  const T* p[kMaxDims];
};

// Whether x's cell index on the axis (start s, step h) is unrepresentable:
// the plain version's predicate, without its floor.
template <typename T>
__device__ __forceinline__ bool unrep(T x, T s, T h) {
  const T v = interp::div_rn(interp::sub_rn(x, s), h);
  constexpr T kTwo63 = static_cast<T>(9223372036854775808.0);  // exact in f32 and f64
  return !(v >= -kTwo63 && v < kTwo63);
}

__device__ __forceinline__ bool unrep_vec(float4 x, float s, float h) {
  return unrep(x.x, s, h) | unrep(x.y, s, h) | unrep(x.z, s, h) | unrep(x.w, s, h);
}

__device__ __forceinline__ bool unrep_vec(double2 x, double s, double h) {
  return unrep(x.x, s, h) | unrep(x.y, s, h);
}

template <typename T>
__global__ void __launch_bounds__(kFlagThreads)
    unrep_flag_kernel(const __grid_constant__ FlagCols<T> cols, const T* __restrict__ starts,
                      const T* __restrict__ steps, int ndims, int64_t n, bool* flag) {
  using V = typename Vec<T>::type;
  constexpr int kW = Vec<T>::kWidth;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kFlagThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kFlagThreads;
  bool bad = false;
  for (int k = 0; k < ndims; ++k) {
    const T* __restrict__ p = cols.p[k];
    const T s = starts[k];
    const T h = steps[k];
    // the scalar head up to the first 16-byte boundary, the vectors, the
    // scalar tail
    const int64_t off = static_cast<int64_t>(reinterpret_cast<uintptr_t>(p) / sizeof(T) % kW);
    const int64_t head = off == 0 ? 0 : (kW - off < n ? kW - off : n);
    const int64_t vecs = (n - head) / kW;
    const int64_t body = head + vecs * kW;
    if (g < head) bad |= unrep(__ldg(p + g), s, h);
    if (g < n - body) bad |= unrep(__ldg(p + body + g), s, h);
    const V* __restrict__ vp = reinterpret_cast<const V*>(p + head);
    int64_t i = g;
    for (; i + (kUnroll - 1) * stride < vecs; i += kUnroll * stride) {
      V x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) x[u] = __ldg(vp + i + u * stride);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) bad |= unrep_vec(x[u], s, h);
    }
    for (; i < vecs; i += stride) bad |= unrep_vec(__ldg(vp + i), s, h);
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) *flag = true;
}

template <typename T>
struct FlagKey {};

template <typename T>
cudaError_t launch(int ndims, const void* starts, const void* steps, const void* const* obs,
                   int64_t n, bool* flag, cudaStream_t stream) {
  FlagCols<T> cols{};
  for (int k = 0; k < ndims; ++k) cols.p[k] = static_cast<const T*>(obs[k]);
  // one thread a vector of the longest pass, up to what the card holds
  const auto kernel = unrep_flag_kernel<T>;
  const int64_t vecs = (n + Vec<T>::kWidth - 1) / Vec<T>::kWidth;
  int blocks = 0;
  const cudaError_t err = interp::grid_blocks(interp::occupancy_cache<FlagKey<T>>(), kernel,
                                              kFlagThreads, 0, vecs, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kFlagThreads, 0, stream>>>(
      cols, static_cast<const T*>(starts), static_cast<const T*>(steps), ndims, n, flag);
  return cudaGetLastError();
}

}  // namespace

// Sets the byte `flag` (a bool the caller zeroed) to 1 where some query of
// the `ndims` columns `obs` (a host array of device pointers, `n` values
// each) is unrepresentable on the grid `starts`, `steps` (device arrays of
// `ndims` values), else leaves it. All of the type selected by `is_f64`.
// Launched on `stream` without synchronising; returns cudaGetLastError()
// (0 on success), or the error that sizing the grid met. Nothing is
// launched for n == 0. The caller guarantees 1 <= ndims <= 8, n >= 0 and
// columns aligned to their element size.
extern "C" int interpn_unrep_flag(int is_f64, int ndims, const void* starts, const void* steps,
                                  const void* const* obs, long long n, void* flag, void* stream) {
  if (ndims < 1 || ndims > kMaxDims || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* f = static_cast<bool*>(flag);
  return static_cast<int>(is_f64 ? launch<double>(ndims, starts, steps, obs, n, f, s)
                                 : launch<float>(ndims, starts, steps, obs, n, f, s));
}

// Registers a thread, static shared bytes, local (spill) bytes a thread and
// blocks an SM of the kernel for `is_f64`, into out[0..3].
extern "C" int interpn_unrep_flag_info(int is_f64, int* out) {
  return static_cast<int>(
      is_f64 ? interp::kernel_info(interp::occupancy_cache<FlagKey<double>>(),
                                   unrep_flag_kernel<double>, kFlagThreads, 0, out)
             : interp::kernel_info(interp::occupancy_cache<FlagKey<float>>(),
                                   unrep_flag_kernel<float>, kFlagThreads, 0, out));
}
