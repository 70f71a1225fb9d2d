// String-grid gather kernels for Hopper (sm_90a), double and float.
//
// Built by auto_oo_tpu_torch/ops/grid_kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface (loaded with ctypes).
// Every entry point launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError() of its launch.
//
// Layouts (all row-major, contiguous):
//   x   (B, Ns, Nb)       operand rows
//   Y   (B, n2, Ns, Nb)   per-pair operand rows
//   src (n2, Na)  int32   source row of output row i for pair k
//   s   (n2, Na)          row scale (the same-spin sign; 0 = invalid entry,
//                         whose src is 0)
//   t   (n2, Nb)          column scale (the other-spin parity)
//
// gather_rows_scaled: out[b, k, i, j] = (x[b, src[k, i], j] * s[k, i]) * t[k, j]
//   Replaces auto_oo_tpu/ops/pallas_grid.py::gather_rows_scaled (Pallas
//   body _gather_rows_kernel).  The TPU kernel existed to keep x resident
//   in VMEM, because Mosaic has no legal row-granular HBM access.  On
//   Hopper that problem does not exist: at every fused-path size the
//   operand x (Ns * Nb * 8 bytes = 0.5 MB at (10e,10o)) sits in the 50 MB
//   L2, so the gathered reads are L2 hits and the bound is the write of
//   out (B * n2 * Na * Nb * itemsize bytes, 254 MB for B = 5 at (10e,10o)
//   f64).  Design: one warp per output row (b, k, i); the warp reads its
//   src/s once and its 32 lanes stride j, so the reads of the x row and
//   of t[k] and the write of the out row are coalesced.  The product is
//   taken as (x * s) * t, the order of the plain PyTorch version, so the
//   f64 results agree bit for bit.
//
// gather_reduce: out[b, i, j] = sum_k (Y[b, k, src[k, i], j] * s[k, i]) * t[k, j]
//   Replaces auto_oo_tpu/ops/pallas_grid.py::gather_reduce (Pallas body
//   _gather_reduce_kernel), whose VMEM-resident accumulator carried the
//   sum across the sequential pair grid.  Here each thread owns one
//   output element (b, i, j) and loops over k in a register: no atomics,
//   so the result is deterministic.  The bound is one read of Y plus one
//   write of out.  Each Y[k] row is read at most once over the whole
//   grid, because each pair's row map is a partial injection (an
//   excitation bijects occupation subsets); entries with s == 0 skip the
//   read entirely (about 70% of the off-diagonal pairs at half filling),
//   and the test is uniform across a warp (it depends on k and i only).
//   Neighbouring threads take neighbouring j, so every Y row read and the
//   out write are coalesced.  The sum runs k = 0 .. n2-1 in order, an
//   order that differs from the plain version's reduction: f64 results
//   agree to rounding (1e-13 relative), not bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;     // warps (output rows) per block
constexpr int kReduceThreads = 256;  // j-threads per block of gather_reduce

template <typename T>
__global__ void gather_rows_scaled_kernel(const T* __restrict__ x,
                                          const int* __restrict__ src,
                                          const T* __restrict__ s,
                                          const T* __restrict__ t,
                                          T* __restrict__ out,
                                          long long n_rows, int n2, int Ns,
                                          int Na, int Nb) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.y;
  if (row >= n_rows) return;
  const int i = static_cast<int>(row % Na);
  const long long bk = row / Na;
  const int k = static_cast<int>(bk % n2);
  const long long b = bk / n2;
  const int r = __ldg(src + static_cast<long long>(k) * Na + i);
  const T sv = __ldg(s + static_cast<long long>(k) * Na + i);
  const T* xr = x + (b * Ns + r) * static_cast<long long>(Nb);
  const T* tr = t + static_cast<long long>(k) * Nb;
  T* o = out + row * static_cast<long long>(Nb);
  for (int j = threadIdx.x; j < Nb; j += kWarp) {
    o[j] = (__ldg(xr + j) * sv) * __ldg(tr + j);
  }
}

template <typename T>
__global__ void gather_reduce_kernel(const T* __restrict__ Y,
                                     const int* __restrict__ src,
                                     const T* __restrict__ s,
                                     const T* __restrict__ t,
                                     T* __restrict__ out, int n2, int Ns,
                                     int Na, int Nb) {
  const int j = blockIdx.x * kReduceThreads + threadIdx.x;
  const int i = blockIdx.y;
  const long long b = blockIdx.z;
  if (j >= Nb) return;
  const long long pair_stride = static_cast<long long>(Ns) * Nb;
  const T* Yb = Y + b * n2 * pair_stride;
  T acc = T(0);
  for (int k = 0; k < n2; ++k) {
    const T sv = __ldg(s + static_cast<long long>(k) * Na + i);
    if (sv != T(0)) {
      const int r = __ldg(src + static_cast<long long>(k) * Na + i);
      acc += (__ldg(Yb + k * pair_stride + static_cast<long long>(r) * Nb + j)
              * sv) * __ldg(t + static_cast<long long>(k) * Nb + j);
    }
  }
  out[(b * Na + i) * static_cast<long long>(Nb) + j] = acc;
}

template <typename T>
int launch_gather_rows_scaled(const T* x, const int* src, const T* s,
                              const T* t, T* out, long long B, int n2,
                              int Ns, int Na, int Nb, cudaStream_t stream) {
  const long long n_rows = B * n2 * Na;
  if (n_rows == 0 || Nb == 0) return static_cast<int>(cudaSuccess);
  const long long n_blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (n_blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kWarp, kRowsPerBlock);
  const dim3 grid(static_cast<unsigned int>(n_blocks));
  gather_rows_scaled_kernel<T><<<grid, block, 0, stream>>>(
      x, src, s, t, out, n_rows, n2, Ns, Na, Nb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_gather_reduce(const T* Y, const int* src, const T* s, const T* t,
                         T* out, long long B, int n2, int Ns, int Na, int Nb,
                         cudaStream_t stream) {
  if (B == 0 || Na == 0 || Nb == 0) return static_cast<int>(cudaSuccess);
  if (B > 65535 || Na > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kReduceThreads);
  const dim3 grid((Nb + kReduceThreads - 1) / kReduceThreads,
                  static_cast<unsigned int>(Na),
                  static_cast<unsigned int>(B));
  gather_reduce_kernel<T><<<grid, block, 0, stream>>>(Y, src, s, t, out, n2,
                                                      Ns, Na, Nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int grid_gather_rows_scaled_f64(const double* x, const int* src,
                                const double* s, const double* t,
                                double* out, long long B, int n2, int Ns,
                                int Na, int Nb, void* stream) {
  return launch_gather_rows_scaled<double>(
      x, src, s, t, out, B, n2, Ns, Na, Nb,
      static_cast<cudaStream_t>(stream));
}

int grid_gather_rows_scaled_f32(const float* x, const int* src,
                                const float* s, const float* t, float* out,
                                long long B, int n2, int Ns, int Na, int Nb,
                                void* stream) {
  return launch_gather_rows_scaled<float>(
      x, src, s, t, out, B, n2, Ns, Na, Nb,
      static_cast<cudaStream_t>(stream));
}

int grid_gather_reduce_f64(const double* Y, const int* src, const double* s,
                           const double* t, double* out, long long B, int n2,
                           int Ns, int Na, int Nb, void* stream) {
  return launch_gather_reduce<double>(Y, src, s, t, out, B, n2, Ns, Na, Nb,
                                      static_cast<cudaStream_t>(stream));
}

int grid_gather_reduce_f32(const float* Y, const int* src, const float* s,
                           const float* t, float* out, long long B, int n2,
                           int Ns, int Na, int Nb, void* stream) {
  return launch_gather_reduce<float>(Y, src, s, t, out, B, n2, Ns, Na, Nb,
                                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
