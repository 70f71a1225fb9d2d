// Row-gather mechanism probes for Hopper (sm_90a), double and float.
//
// Built by auto_oo_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface (loaded with ctypes).
// Every entry point launches on the stream it is given, allocates
// nothing, and returns the cudaError_t of its launch (or of the query or
// encode that refused it; nothing is launched then).
//
// Each kernel computes the same gather, one product per element:
//   out[k, i, j] = x[src[k, i], j] * s[k, i]
// with x (ns, nb), src (n2, na) int32, s (n2, na), out (n2, na, nb), all
// row-major and contiguous.  A single product is exact, so every kernel
// equals the plain PyTorch version x[src] * s[..., None] bit for bit.
// The kernels differ only in how a source row reaches the SM; they are
// the Hopper counterparts of the three mechanisms that
// scripts/experiment_gather_mechanisms.py probed on the TPU.  The floor
// of all three is the write of out (n2 * na * nb * itemsize bytes: 1.095
// GB at ncas = 12 in f64); x (ns * nb * itemsize, 7.6 MB at ncas = 12
// f64) stays in the 50 MB L2, so the source reads are L2 traffic.
//
// A: bulk row copies, double-buffered (gather_a_kernel)
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
// B: x on chip across a thread-block cluster (gather_b_kernel)
//   Replaces gather_b (Pallas body _kern_b), which held all of x in VMEM
//   and read rows at a dynamic sublane index.  Hopper's counterpart is
//   distributed shared memory: a cluster of C blocks holds a column slab
//   x[:, c0:c0+W], split by rows (block r holds rows [r*rpb, r*rpb+rpb),
//   rpb = ceil(ns / C)), and the block that writes output row q reads
//   row src[q] from the shared memory of its owner.  Bytes read: 1x out
//   over the SM-to-SM network ((C-1)/C of it remote), plus one slab load
//   per work item from L2.
//   Bound: the write of out and the DSMEM reads: 2.8 TB/s of out, 84% of
//   HBM peak, at ncas = 12 f64 on an H100 SXM (launches back to back).
//   The single-block design it replaces (a 16-column slab per block, one
//   dependent global load of src and s before every 128-byte row segment,
//   1.45 waves of blocks) was bound by latency: 409 GB/s there.
//   Design: W is the widest power of two (16..256, dividing nb) whose
//   per-block share fits shared memory, so output segments are W*itemsize
//   contiguous bytes (1 KB at ncas = 12).  The grid is persistent (as
//   many clusters as the card holds, launched with cudaLaunchKernelEx and
//   a cluster dimension); each cluster walks one contiguous range of
//   (slab, output row) work, so no wave tail is left.  src and s of the
//   next 256-row tile are loaded into registers one tile ahead and
//   published to a double-buffered shared table as (owner row pointer,
//   scale), so no global load precedes a row.  Each thread keeps 4
//   16-byte DSMEM loads in flight before its 16-byte streaming stores.
//   cluster.sync() runs after each slab load (before any remote read),
//   before a slab is overwritten, and before exit.
//
// C: 8-row aligned 2-D TMA boxes in a deep ring, the 8x-traffic control
//   (gather_c_kernel)
//   Replaces gather_c (Pallas body _kern_c): a tile-aligned 8-row DMA of
//   rows [8*(r/8), 8*(r/8)+8), then selecting row r%8.  Hopper's
//   counterpart of the (8, 128) tile-aligned DMA is a 2-D tensor-map TMA
//   box: 8 rows x Wc columns (Wc*itemsize <= 1 KB, an 8 KB box) at
//   {c0, 8*(r/8)}; the consumer selects row r%8.  Bytes read: 8x out,
//   from L2.
//   Bound: those L2 reads, about 8 TB/s on an H100 SXM with ~190 KB of
//   boxes in flight per SM (4-12 stages alike; a ring that leaves one
//   block per SM halves it).  The design it replaces copied the
//   full-width 8-row block (64 KB at ncas = 12 f64) into a 2-stage ring
//   of one row, with one block per SM, one copy in flight and a
//   __syncthreads after every row: 5.9 TB/s of L2 reads in f64.
//   Design: a ring of 4, 8, 12 or 16 stages of one box; warp 0 is the
//   producer (one lane waits the stage's empty mbarrier, writes the
//   row's selection and scale beside it, and issues the box with an L2
//   evict-last hint on x), warps 1-4 are consumers (each takes every
//   fourth stage: waits its full mbarrier, selects the row, releases the
//   stage, scales and writes 16-byte streaming stores).  There is no
//   block-wide barrier per row.  The ring is sized so that three blocks
//   fit one SM.  The grid is persistent; each block walks a contiguous
//   range of (column tile, output row) work, so its stores are Wc*itemsize
//   contiguous.  src and s reach the producer 32 rows at a time, loaded
//   one batch ahead.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 2;
constexpr int kBarrierBytes = 128;  // mbarriers at the head of A's ring

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
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

// order earlier generic accesses of shared memory before later
// async-proxy (TMA) writes to it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// an L2 policy that keeps the lines it touches resident longest
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// 2-D tensor-map box global -> shared, completing on an mbarrier
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int r0, uint64_t* bar,
                                            uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0),
      "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

// 16-byte vectors of T
template <typename T>
struct Vec;
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
  __device__ static double2 scale(double2 v, double s) {
    return make_double2(v.x * s, v.y * s);
  }
};
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
  __device__ static float4 scale(float4 v, float s) {
    return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
  }
};

// A: 1-D bulk row copies into a 2-stage ring
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gather_a_kernel(const T* __restrict__ x, const int* __restrict__ src,
                    const T* __restrict__ s, T* __restrict__ out, int n2,
                    int na, int nb, int rows_per_stage) {
  extern __shared__ __align__(128) unsigned char ring_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_smem);
  T* ring = reinterpret_cast<T*>(ring_smem + kBarrierBytes);
  const int R = rows_per_stage;
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
    T* dst = ring + static_cast<long long>(st) * R * nb;
    const int* srow = src + static_cast<long long>(k) * na + i0;
    const uint32_t bytes = static_cast<uint32_t>(nb * sizeof(T));
    // order the threads' earlier generic reads of this stage before the
    // async-proxy writes that refill it
    fence_proxy_async();
    mbar_arrive_expect_tx(&full[st], bytes * rows);
    for (int r = 0; r < rows; ++r) {
      bulk_copy_g2s(dst + r * nb,
                    x + static_cast<long long>(__ldg(srow + r)) * nb, bytes,
                    &full[st]);
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
    const T* buf = ring + static_cast<long long>(st) * R * nb;
    const long long q0 = static_cast<long long>(k) * na + i0;
    T* o = out + q0 * nb;
    for (int r = 0; r < rows; ++r) {
      const T sv = __ldg(s + q0 + r);
      const T* row = buf + r * nb;
      for (int j = threadIdx.x; j < nb; j += kThreads) {
        o[static_cast<long long>(r) * nb + j] = row[j] * sv;
      }
    }
    // every thread is done with this stage before it is refilled
    __syncthreads();
  }
}

// ---- B: a column slab of x across the shared memory of a cluster -------

constexpr int kTileRows = kThreads;  // output rows per index tile
constexpr int kUnrollB = 4;          // DSMEM loads in flight per thread

// bytes of B's double-buffered index tables (row pointer + scale)
template <typename T>
constexpr int b_table_bytes() {
  return 2 * kTileRows * static_cast<int>(sizeof(void*) + sizeof(T));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gather_b_kernel(const T* __restrict__ x, const int* __restrict__ src,
                    const T* __restrict__ s, T* __restrict__ out, int ns,
                    int nb, long long n_rows, int W, int rows_per_block,
                    long long per_cluster) {
  using V = typename Vec<T>::type;
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ __align__(16) unsigned char slab_smem[];
  V* slab = reinterpret_cast<V*>(slab_smem);
  const int vpr = W / Vec<T>::n;  // 16-byte vectors per slab row
  const int vshift = __ffs(vpr) - 1;
  const V** rowp = reinterpret_cast<const V**>(
      slab_smem + static_cast<long long>(rows_per_block) * W * sizeof(T));
  T* scl = reinterpret_cast<T*>(rowp + 2 * kTileRows);

  // where output row q finds its source: row src[q] of its owner's share
  auto source = [&](int r) {
    const int owner = r / rows_per_block;
    return cluster.map_shared_rank(slab, owner) +
           static_cast<long long>(r - owner * rows_per_block) * vpr;
  };

  const int r_lo = rank * rows_per_block;
  const int my_rows = max(0, min(ns, r_lo + rows_per_block) - r_lo);
  const long long total = static_cast<long long>(nb / W) * n_rows;
  long long pos = static_cast<long long>(blockIdx.x / csize) * per_cluster;
  const long long end = min(total, pos + per_cluster);

  while (pos < end) {
    // the next work item: rows [q_lo, q_hi) of slab c0 / W
    const long long q_lo = pos % n_rows;
    const long long q_hi = min(n_rows, q_lo + (end - pos));
    const int c0 = static_cast<int>(pos / n_rows) * W;
    pos += q_hi - q_lo;

    cluster.sync();  // no peer still reads the slab this load replaces
    for (int e = threadIdx.x; e < (my_rows << vshift); e += kThreads) {
      const int r = e >> vshift;
      slab[e] = __ldg(reinterpret_cast<const V*>(
                          x + static_cast<long long>(r_lo + r) * nb + c0) +
                      (e & (vpr - 1)));
    }
    cluster.sync();  // every share is loaded before any remote read

    // this block's part of the item's rows, walked in tiles of kTileRows
    const long long n = q_hi - q_lo;
    const long long part = (n + csize - 1) / csize;
    const long long b_lo = q_lo + min(n, rank * part);
    const long long b_hi = q_lo + min(n, (rank + 1) * part);
    int buf = 0;
    if (b_lo + threadIdx.x < b_hi) {
      const long long q = b_lo + threadIdx.x;
      rowp[threadIdx.x] = source(__ldg(src + q));
      scl[threadIdx.x] = __ldg(s + q);
    }
    __syncthreads();
    for (long long t0 = b_lo; t0 < b_hi; t0 += kTileRows, buf ^= 1) {
      // the next tile's row and scale, loaded while this tile is written
      const long long qn = t0 + kTileRows + threadIdx.x;
      int rn = 0;
      T sn = T(0);
      if (qn < b_hi) {
        rn = __ldg(src + qn);
        sn = __ldg(s + qn);
      }
      const V* const* rp = rowp + buf * kTileRows;
      const T* sp = scl + buf * kTileRows;
      const int n_el =
          static_cast<int>(min(static_cast<long long>(kTileRows), b_hi - t0))
          << vshift;
      T* o = out + t0 * nb + c0;
      for (int e0 = threadIdx.x; e0 < n_el; e0 += kUnrollB * kThreads) {
        V v[kUnrollB];
#pragma unroll
        for (int u = 0; u < kUnrollB; ++u) {
          const int e = e0 + u * kThreads;
          if (e < n_el) v[u] = rp[e >> vshift][e & (vpr - 1)];
        }
#pragma unroll
        for (int u = 0; u < kUnrollB; ++u) {
          const int e = e0 + u * kThreads;
          if (e < n_el) {
            const int row = e >> vshift;
            __stcs(reinterpret_cast<V*>(o + static_cast<long long>(row) * nb) +
                       (e & (vpr - 1)),
                   Vec<T>::scale(v[u], sp[row]));
          }
        }
      }
      // publish the next tile's table; the barrier also ends this tile's
      // reads of the table that the tile after it refills
      if (qn < b_hi) {
        rowp[(buf ^ 1) * kTileRows + threadIdx.x] = source(rn);
        scl[(buf ^ 1) * kTileRows + threadIdx.x] = sn;
      }
      __syncthreads();
    }
  }
  cluster.sync();  // no block exits while a peer still reads its share
}

// ---- C: 8-row aligned 2-D TMA boxes in a deep ring ----------------------

constexpr int kConsumerWarps = 4;
constexpr int kThreadsC = 32 * (1 + kConsumerWarps);  // warp 0 produces
constexpr int kMaxStagesC = 16;
constexpr int kMaxRowBytesC = 1024;  // one box row: at most 2 vectors a lane
// mbarriers, per-stage selection and scale, the producer's index batch;
// the ring starts 1024-aligned after them
constexpr int kHeadBytesC = 1024;

template <typename T>
__global__ void __launch_bounds__(kThreadsC)
    gather_c_kernel(const __grid_constant__ CUtensorMap xmap,
                    const int* __restrict__ src, const T* __restrict__ s,
                    T* __restrict__ out, int nb, long long n_rows, int Wc,
                    int stages, long long per_block) {
  using V = typename Vec<T>::type;
  extern __shared__ __align__(1024) unsigned char box_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(box_smem);
  uint64_t* empty = full + kMaxStagesC;
  T* scale = reinterpret_cast<T*>(empty + kMaxStagesC);
  T* batch_s = scale + kMaxStagesC;
  int* sel = reinterpret_cast<int*>(batch_s + 32);
  int* batch_r = sel + kMaxStagesC;
  T* ring = reinterpret_cast<T*>(box_smem + kHeadBytesC);
  const int box = 8 * Wc;  // elements of one stage
  const long long total = static_cast<long long>(nb / Wc) * n_rows;
  const long long first = static_cast<long long>(blockIdx.x) * per_block;
  const long long n_mine = max(0LL, min(total, first + per_block) - first);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    // producer: rows arrive 32 at a time, one batch ahead
    const uint64_t policy = l2_evict_last();
    auto fetch = [&](long long it0, int& r, T& sv) {
      r = 0;
      sv = T(0);
      if (it0 + lane < n_mine) {
        const long long q = (first + it0 + lane) % n_rows;
        r = __ldg(src + q);
        sv = __ldg(s + q);
      }
    };
    int r_cur;
    T s_cur;
    fetch(0, r_cur, s_cur);
    int st = 0;
    uint32_t phase = 0;  // of the stage's empty barrier, from round 1 on
    long long q = first % n_rows;
    int c0 = static_cast<int>(first / n_rows) * Wc;
    for (long long it0 = 0; it0 < n_mine; it0 += 32) {
      int r_nxt;
      T s_nxt;
      fetch(it0 + 32, r_nxt, s_nxt);
      batch_r[lane] = r_cur;
      batch_s[lane] = s_cur;
      __syncwarp();
      if (lane == 0) {
        const int n = static_cast<int>(min(32LL, n_mine - it0));
        for (int j = 0; j < n; ++j) {
          if (it0 + j >= stages) mbar_wait(&empty[st], phase);
          const int r = batch_r[j];
          sel[st] = r & 7;
          scale[st] = batch_s[j];
          fence_proxy_async();
          mbar_arrive_expect_tx(&full[st], box * sizeof(T));
          tma_load_2d(ring + static_cast<long long>(st) * box, &xmap, c0,
                      r & ~7, &full[st], policy);
          if (++st == stages) {
            st = 0;
            if (it0 + j >= stages) phase ^= 1;
          }
          if (++q == n_rows) {
            q = 0;
            c0 += Wc;
          }
        }
      }
      __syncwarp();
      r_cur = r_nxt;
      s_cur = s_nxt;
    }
  } else {
    // consumers: warp w takes rows w-1, w-1+4, ...; with stages a multiple
    // of 4 that is every round of the stages st = w-1 (mod 4), so a warp
    // waits each stage's rounds in order and no parity is ever ambiguous
    const int vpr = Wc * static_cast<int>(sizeof(T)) / 16;
    long long it = warp - 1;
    int st = static_cast<int>(it % stages);
    uint32_t phase = static_cast<uint32_t>((it / stages) & 1);
    long long q = (first + it) % n_rows;
    int c0 = static_cast<int>((first + it) / n_rows) * Wc;
    for (; it < n_mine; it += kConsumerWarps) {
      mbar_wait(&full[st], phase);
      const V* row = reinterpret_cast<const V*>(
          ring + static_cast<long long>(st) * box + sel[st] * Wc);
      const T sv = scale[st];
      V v[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (lane + 32 * u < vpr) v[u] = row[lane + 32 * u];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      V* o = reinterpret_cast<V*>(out + q * nb + c0);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (lane + 32 * u < vpr)
          __stcs(o + lane + 32 * u, Vec<T>::scale(v[u], sv));
      }
      for (st += kConsumerWarps; st >= stages; st -= stages) phase ^= 1;
      for (q += kConsumerWarps; q >= n_rows; q -= n_rows) c0 += Wc;
    }
  }
}

// ---- launchers -----------------------------------------------------------

// return a refused call's error and clear it, so that no later
// cudaGetLastError() (ours or PyTorch's) reports it again
int refuse(cudaError_t err) {
  cudaGetLastError();
  return static_cast<int>(err);
}

int blocks_to_fill(const void* kernel, int threads, int smem_bytes,
                   long long work) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem_bytes) !=
          cudaSuccess ||
      per_sm < 1)
    return -1;
  const long long full = static_cast<long long>(sms) * per_sm;
  return static_cast<int>(work < full ? work : full);
}

template <typename T>
int launch_gather_a(const T* x, const int* src, const T* s, T* out, int n2,
                    int na, int nb, int rows_per_stage, cudaStream_t stream) {
  if (n2 == 0 || na == 0 || nb == 0) return static_cast<int>(cudaSuccess);
  if (rows_per_stage < 1 ||
      (static_cast<long long>(nb) * sizeof(T)) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long stage_bytes =
      static_cast<long long>(rows_per_stage) * nb * sizeof(T);
  const long long smem = kBarrierBytes + kStages * stage_bytes;
  if (smem > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const void* kern = reinterpret_cast<const void*>(&gather_a_kernel<T>);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return refuse(err);
  const long long groups = static_cast<long long>(n2) *
                           ((na + rows_per_stage - 1) / rows_per_stage);
  const int grid = blocks_to_fill(kern, kThreads, static_cast<int>(smem),
                                  groups);
  if (grid < 1) return refuse(cudaErrorInvalidConfiguration);
  gather_a_kernel<T><<<grid, kThreads, smem, stream>>>(
      x, src, s, out, n2, na, nb, rows_per_stage);
  return static_cast<int>(cudaGetLastError());
}

// B's cluster launch: sets the kernel's attributes and returns how many
// clusters of `cluster` blocks with `smem` bytes each the card holds at
// once (0 or an error where it holds none: the size is refused)
template <typename T>
cudaError_t b_cluster_config(int cluster, int smem, cudaLaunchConfig_t* cfg,
                             cudaLaunchAttribute* attr, int* max_clusters) {
  const void* kern = reinterpret_cast<const void*>(&gather_b_kernel<T>);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             cluster > 8 ? 1 : 0);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned int>(cluster), 1, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = static_cast<size_t>(smem);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned int>(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  *max_clusters = 0;
  return cudaOccupancyMaxActiveClusters(max_clusters, kern, cfg);
}

template <typename T>
long long b_smem(int ns, int cluster, int W) {
  const long long rows = (ns + cluster - 1) / cluster;
  return rows * W * static_cast<long long>(sizeof(T)) + b_table_bytes<T>();
}

template <typename T>
int launch_gather_b(const T* x, const int* src, const T* s, T* out, int ns,
                    int n2, int na, int nb, int cluster, int W,
                    cudaStream_t stream) {
  const long long n_rows = static_cast<long long>(n2) * na;
  if (n_rows == 0 || nb == 0) return static_cast<int>(cudaSuccess);
  if (cluster < 1 || ns < 1 || W < 16 || W > 256 || (W & (W - 1)) != 0 ||
      nb % W != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = b_smem<T>(ns, cluster, W);
  if (smem > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int max_clusters = 0;
  cudaError_t err = b_cluster_config<T>(cluster, static_cast<int>(smem), &cfg,
                                        &attr, &max_clusters);
  if (err != cudaSuccess) return refuse(err);
  if (max_clusters < 1) return refuse(cudaErrorInvalidClusterSize);
  // persistent: at most the clusters the card holds, each with at least
  // one tile of rows per block
  const long long total = static_cast<long long>(nb / W) * n_rows;
  const long long per_tile = static_cast<long long>(cluster) * kTileRows;
  long long clusters = (total + per_tile - 1) / per_tile;
  if (clusters > max_clusters) clusters = max_clusters;
  const long long per_cluster = (total + clusters - 1) / clusters;
  clusters = (total + per_cluster - 1) / per_cluster;
  cfg.gridDim = dim3(static_cast<unsigned int>(clusters * cluster), 1, 1);
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, gather_b_kernel<T>, x, src, s, out, ns, nb,
                           n_rows, W, (ns + cluster - 1) / cluster,
                           per_cluster);
  if (err != cudaSuccess) return refuse(err);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled, reached through the runtime so that nothing
// links against libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      cudaGetLastError();
      return nullptr;
    }
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <typename T>
int c_smem(int Wc, int stages) {
  return kHeadBytesC + stages * 8 * Wc * static_cast<int>(sizeof(T));
}

template <typename T>
int launch_gather_c(const T* x, const int* src, const T* s, T* out, int ns,
                    int n2, int na, int nb, int Wc, int stages,
                    cudaStream_t stream) {
  const long long n_rows = static_cast<long long>(n2) * na;
  if (n_rows == 0 || nb == 0) return static_cast<int>(cudaSuccess);
  // the tensor map's rules: 16-byte aligned base and row stride, at most
  // 256 elements per box dimension, an inner box of 16-byte multiples
  const long long row_bytes = static_cast<long long>(nb) * sizeof(T);
  if (ns < 8 || ns % 8 != 0 || row_bytes % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || Wc < 1 || Wc > 256 ||
      nb % Wc != 0 || (Wc * sizeof(T)) % 16 != 0 ||
      Wc * sizeof(T) > kMaxRowBytesC || stages < kConsumerWarps ||
      stages > kMaxStagesC || stages % kConsumerWarps != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(nb),
                              static_cast<cuuint64_t>(ns)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(Wc), 8};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = encode(
      &map,
      sizeof(T) == 8 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT64
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<T*>(x), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = c_smem<T>(Wc, stages);
  const void* kern = reinterpret_cast<const void*>(&gather_c_kernel<T>);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return refuse(err);
  const long long total = static_cast<long long>(nb / Wc) * n_rows;
  const int grid = blocks_to_fill(kern, kThreadsC, smem, total);
  if (grid < 1) return refuse(cudaErrorInvalidConfiguration);
  const long long per_block = (total + grid - 1) / grid;
  gather_c_kernel<T><<<grid, kThreadsC, smem, stream>>>(
      map, src, s, out, nb, n_rows, Wc, stages, per_block);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int occupancy(int variant, int a, int b, int c, int* out) {
  *out = 0;
  if (variant == 'b') {  // (ns, cluster, W) -> clusters held at once
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    const long long smem = b_smem<T>(a, b, c);
    if (smem > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = b_cluster_config<T>(b, static_cast<int>(smem),
                                                &cfg, &attr, out);
    return err == cudaSuccess ? 0 : refuse(err);
  }
  if (variant == 'c') {  // (Wc, stages, -) -> blocks per SM
    const int smem = c_smem<T>(a, b);
    const void* kern = reinterpret_cast<const void*>(&gather_c_kernel<T>);
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kern,
                                                          kThreadsC, smem);
    return err == cudaSuccess ? 0 : refuse(err);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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

// what the card holds of a plan: for variant 'b' with (ns, cluster, W),
// the clusters resident at once; for 'c' with (Wc, stages, 0), the
// blocks per SM
int gm_occupancy(int variant, int f64, int a, int b, int c, int* out) {
  return f64 ? occupancy<double>(variant, a, b, c, out)
             : occupancy<float>(variant, a, b, c, out);
}

int gm_gather_a_f64(const double* x, const int* src, const double* s,
                    double* out, int n2, int na, int nb, int rows_per_stage,
                    void* stream) {
  return launch_gather_a<double>(x, src, s, out, n2, na, nb, rows_per_stage,
                                 static_cast<cudaStream_t>(stream));
}

int gm_gather_a_f32(const float* x, const int* src, const float* s,
                    float* out, int n2, int na, int nb, int rows_per_stage,
                    void* stream) {
  return launch_gather_a<float>(x, src, s, out, n2, na, nb, rows_per_stage,
                                static_cast<cudaStream_t>(stream));
}

int gm_gather_b_f64(const double* x, const int* src, const double* s,
                    double* out, int ns, int n2, int na, int nb, int cluster,
                    int W, void* stream) {
  return launch_gather_b<double>(x, src, s, out, ns, n2, na, nb, cluster, W,
                                 static_cast<cudaStream_t>(stream));
}

int gm_gather_b_f32(const float* x, const int* src, const float* s,
                    float* out, int ns, int n2, int na, int nb, int cluster,
                    int W, void* stream) {
  return launch_gather_b<float>(x, src, s, out, ns, n2, na, nb, cluster, W,
                                static_cast<cudaStream_t>(stream));
}

int gm_gather_c_f64(const double* x, const int* src, const double* s,
                    double* out, int ns, int n2, int na, int nb, int Wc,
                    int stages, void* stream) {
  return launch_gather_c<double>(x, src, s, out, ns, n2, na, nb, Wc, stages,
                                 static_cast<cudaStream_t>(stream));
}

int gm_gather_c_f32(const float* x, const int* src, const float* s,
                    float* out, int ns, int n2, int na, int nb, int Wc,
                    int stages, void* stream) {
  return launch_gather_c<float>(x, src, s, out, ns, n2, na, nb, Wc, stages,
                                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
