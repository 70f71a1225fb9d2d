// Row-gather mechanism probes for Hopper (sm_90a), double and float.
//
// Built by auto_oo_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface (loaded with ctypes).
// Every entry point launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError() of its launch.
//
// Each kernel computes the same gather, one product per element:
//   out[k, i, j] = x[src[k, i], j] * s[k, i]
// with x (ns, nb), src (n2, na) int32, s (n2, na), out (n2, na, nb), all
// row-major and contiguous.  A single product is exact, so every kernel
// equals the plain PyTorch version x[src] * s[..., None] bit for bit.
// The kernels differ only in how a source row reaches the SM; they are
// the Hopper counterparts of the three mechanisms that
// scripts/experiment_gather_mechanisms.py probed on the TPU.  The bound
// of all three is the write of out (n2 * na * nb * itemsize bytes: 547 MB
// at ncas = 12 in f32); x (ns * nb * itemsize, 3.8 MB at ncas = 12 f32)
// stays in the 50 MB L2, so the source reads are L2 traffic.
//
// A: bulk row copies, double-buffered (gather_a_kernel with kBlockRows=1)
//   Replaces scripts/experiment_gather_mechanisms.py::gather_a (Pallas
//   body _kern_a): a 1-D DMA of nb lanes at the dynamic offset src*nb
//   into a 2-slot VMEM ring.  Here the TMA's 1-D bulk copy
//   (cp.async.bulk, no tensor map) brings each row into a 2-stage
//   shared-memory ring, completing on an mbarrier.  Bytes read: 1x out.
//   Design: a block walks row groups (R rows of one pair k) in a loop;
//   one elected thread issues the R row copies of group g+1 while all
//   threads scale and store group g, with coalesced writes of the R
//   contiguous out rows.  Rows must be 16-byte multiples at 16-byte
//   aligned addresses (the bulk copy's rule).
//
// B: x resident on chip (gather_b_kernel)
//   Replaces gather_b (Pallas body _kern_b), which held all of x in VMEM
//   and read rows at a dynamic sublane index.  This is the Hopper reading
//   of "x resident in VMEM": x does not fit one block's 227 KB of shared
//   memory even at ncas = 10 (256 x 256 x 4 B = 256 KB in f32), so each
//   block loads one column slab x[:, c0:c0+W] (ns x W, coalesced) once,
//   keeps it resident, and serves every (k, i) row it owns from shared
//   memory at the dynamic row src[k, i].  W (a power of two, 16..256) is
//   chosen by the wrapper so the slab fits the dynamic shared-memory
//   limit.  Bytes read: 1x out from shared memory, plus one slab load per
//   block from L2.  Writes are W-wide row segments (128 B at W = 16 f64).
//
// C: aligned 8-row block copies, the 8x-traffic control
//   (gather_a_kernel with kBlockRows=8)
//   Replaces gather_c (Pallas body _kern_c): a tile-aligned 8-row DMA of
//   rows [8*(r/8), 8*(r/8)+8), then selecting row r%8.  Here one 1-D bulk
//   copy brings the contiguous 8-row block into the ring and the threads
//   select row r%8 in shared memory.  Bytes read: 8x out.  At ncas = 12
//   f32 one output row's block is already 32 KB, so the ring holds fewer
//   rows per stage than the TPU's R = 8 (the wrapper chooses R).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 2;
constexpr int kBarrierBytes = 128;  // mbarriers at the head of the ring

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// a copy that never completes traps (a launch error) instead of hanging
constexpr uint32_t kMaxWaitPolls = 1u << 24;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == kMaxWaitPolls) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// 1-D bulk copy global -> shared, completing on an mbarrier (TMA, no map)
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A (kBlockRows = 1) and C (kBlockRows = 8): bulk copies into a ring
template <typename T, int kBlockRows>
__global__ void __launch_bounds__(kThreads)
    gather_a_kernel(const T* __restrict__ x, const int* __restrict__ src,
                    const T* __restrict__ s, T* __restrict__ out, int n2,
                    int na, int nb, int rows_per_stage) {
  extern __shared__ __align__(128) unsigned char ring_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_smem);
  T* ring = reinterpret_cast<T*>(ring_smem + kBarrierBytes);
  const int R = rows_per_stage;
  const long long unit = static_cast<long long>(kBlockRows) * nb;
  const int groups_per_pair = (na + R - 1) / R;
  const long long n_groups = static_cast<long long>(n2) * groups_per_pair;
  const long long first = blockIdx.x;
  const long long n_mine =
      first < n_groups ? (n_groups - first + gridDim.x - 1) / gridDim.x : 0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(&full[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0: copy the rows of the block's it-th group into its stage
  auto issue = [&](long long it) {
    const long long g = first + it * gridDim.x;
    const int k = static_cast<int>(g / groups_per_pair);
    const int i0 = static_cast<int>(g % groups_per_pair) * R;
    const int rows = min(R, na - i0);
    const int st = static_cast<int>(it % kStages);
    T* dst = ring + static_cast<long long>(st) * R * unit;
    const int* srow = src + static_cast<long long>(k) * na + i0;
    const uint32_t bytes = static_cast<uint32_t>(unit * sizeof(T));
    // order the threads' earlier generic reads of this stage before the
    // async-proxy writes that refill it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive_expect_tx(&full[st], bytes * rows);
    for (int r = 0; r < rows; ++r) {
      int row = __ldg(srow + r);
      if (kBlockRows > 1) row -= row % kBlockRows;
      bulk_copy_g2s(dst + r * unit, x + static_cast<long long>(row) * nb,
                    bytes, &full[st]);
    }
  };

  if (threadIdx.x == 0 && n_mine > 0) issue(0);
  for (long long it = 0; it < n_mine; ++it) {
    if (threadIdx.x == 0 && it + 1 < n_mine) issue(it + 1);
    const long long g = first + it * gridDim.x;
    const int k = static_cast<int>(g / groups_per_pair);
    const int i0 = static_cast<int>(g % groups_per_pair) * R;
    const int rows = min(R, na - i0);
    const int st = static_cast<int>(it % kStages);
    mbar_wait(&full[st], static_cast<uint32_t>((it / kStages) & 1));
    const T* buf = ring + static_cast<long long>(st) * R * unit;
    const long long q0 = static_cast<long long>(k) * na + i0;
    T* o = out + q0 * nb;
    for (int r = 0; r < rows; ++r) {
      const T sv = __ldg(s + q0 + r);
      const T* row = buf + r * unit;
      if (kBlockRows > 1) row += (__ldg(src + q0 + r) % kBlockRows) * nb;
      for (int j = threadIdx.x; j < nb; j += kThreads) {
        o[static_cast<long long>(r) * nb + j] = row[j] * sv;
      }
    }
    // every thread is done with this stage before it is refilled
    __syncthreads();
  }
}

// B: a column slab of x resident in shared memory
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gather_b_kernel(const T* __restrict__ x, const int* __restrict__ src,
                    const T* __restrict__ s, T* __restrict__ out, int ns,
                    int nb, long long n_rows, int W,
                    long long rows_per_block) {
  extern __shared__ __align__(128) unsigned char slab_smem[];
  T* slab = reinterpret_cast<T*>(slab_smem);
  const int c0 = blockIdx.x * W;
  const int w = min(W, nb - c0);
  for (long long e = threadIdx.x; e < static_cast<long long>(ns) * w;
       e += kThreads) {
    const int r = static_cast<int>(e / w);
    const int c = static_cast<int>(e - static_cast<long long>(r) * w);
    slab[r * W + c] = x[static_cast<long long>(r) * nb + c0 + c];
  }
  __syncthreads();
  // W divides kThreads: the block covers kThreads / W rows per pass
  const int col = threadIdx.x % W;
  const int rows_per_pass = kThreads / W;
  const long long q0 = static_cast<long long>(blockIdx.y) * rows_per_block;
  const long long q1 = min(n_rows, q0 + rows_per_block);
  if (col >= w) return;
  for (long long q = q0 + threadIdx.x / W; q < q1; q += rows_per_pass) {
    const int r = __ldg(src + q);
    out[q * nb + c0 + col] = slab[r * W + col] * __ldg(s + q);
  }
}

int blocks_to_fill(const void* kernel, int smem_bytes, long long work) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    smem_bytes) !=
          cudaSuccess ||
      per_sm < 1)
    return -1;
  const long long full = static_cast<long long>(sms) * per_sm;
  return static_cast<int>(work < full ? work : full);
}

template <typename T, int kBlockRows>
int launch_gather_a(const T* x, const int* src, const T* s, T* out, int n2,
                    int na, int nb, int rows_per_stage, cudaStream_t stream) {
  if (n2 == 0 || na == 0 || nb == 0) return static_cast<int>(cudaSuccess);
  if (rows_per_stage < 1 ||
      (static_cast<long long>(nb) * sizeof(T)) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long stage_bytes = static_cast<long long>(rows_per_stage) *
                                kBlockRows * nb * sizeof(T);
  const long long smem = kBarrierBytes + kStages * stage_bytes;
  if (smem > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const void* kern =
      reinterpret_cast<const void*>(&gather_a_kernel<T, kBlockRows>);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long groups = static_cast<long long>(n2) *
                           ((na + rows_per_stage - 1) / rows_per_stage);
  const int grid = blocks_to_fill(kern, static_cast<int>(smem), groups);
  if (grid < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  gather_a_kernel<T, kBlockRows><<<grid, kThreads, smem, stream>>>(
      x, src, s, out, n2, na, nb, rows_per_stage);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_gather_b(const T* x, const int* src, const T* s, T* out, int ns,
                    int n2, int na, int nb, int W, cudaStream_t stream) {
  const long long n_rows = static_cast<long long>(n2) * na;
  if (n_rows == 0 || nb == 0) return static_cast<int>(cudaSuccess);
  if (W < 1 || W > kThreads || kThreads % W != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = static_cast<long long>(ns) * W * sizeof(T);
  if (smem > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const void* kern = reinterpret_cast<const void*>(&gather_b_kernel<T>);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slabs = (nb + W - 1) / W;
  const int fill = blocks_to_fill(kern, static_cast<int>(smem), 1LL << 30);
  if (fill < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // split the rows so the grid is about one wave of resident blocks
  long long splits = (fill + slabs - 1) / slabs;
  if (splits > n_rows) splits = n_rows;
  if (splits > 65535) splits = 65535;
  const long long rows_per_block = (n_rows + splits - 1) / splits;
  splits = (n_rows + rows_per_block - 1) / rows_per_block;
  const dim3 grid(static_cast<unsigned int>(slabs),
                  static_cast<unsigned int>(splits));
  gather_b_kernel<T><<<grid, kThreads, smem, stream>>>(
      x, src, s, out, ns, nb, n_rows, W, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// the opt-in shared memory one block may use on the current device
int gm_smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
}

int gm_gather_a_f64(const double* x, const int* src, const double* s,
                    double* out, int n2, int na, int nb, int rows_per_stage,
                    void* stream) {
  return launch_gather_a<double, 1>(x, src, s, out, n2, na, nb,
                                    rows_per_stage,
                                    static_cast<cudaStream_t>(stream));
}

int gm_gather_a_f32(const float* x, const int* src, const float* s,
                    float* out, int n2, int na, int nb, int rows_per_stage,
                    void* stream) {
  return launch_gather_a<float, 1>(x, src, s, out, n2, na, nb,
                                   rows_per_stage,
                                   static_cast<cudaStream_t>(stream));
}

int gm_gather_c_f64(const double* x, const int* src, const double* s,
                    double* out, int n2, int na, int nb, int rows_per_stage,
                    void* stream) {
  return launch_gather_a<double, 8>(x, src, s, out, n2, na, nb,
                                    rows_per_stage,
                                    static_cast<cudaStream_t>(stream));
}

int gm_gather_c_f32(const float* x, const int* src, const float* s,
                    float* out, int n2, int na, int nb, int rows_per_stage,
                    void* stream) {
  return launch_gather_a<float, 8>(x, src, s, out, n2, na, nb,
                                   rows_per_stage,
                                   static_cast<cudaStream_t>(stream));
}

int gm_gather_b_f64(const double* x, const int* src, const double* s,
                    double* out, int ns, int n2, int na, int nb, int W,
                    void* stream) {
  return launch_gather_b<double>(x, src, s, out, ns, n2, na, nb, W,
                                 static_cast<cudaStream_t>(stream));
}

int gm_gather_b_f32(const float* x, const int* src, const float* s,
                    float* out, int ns, int n2, int na, int nb, int W,
                    void* stream) {
  return launch_gather_b<float>(x, src, s, out, ns, n2, na, nb, W,
                                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
