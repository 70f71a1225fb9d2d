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
//   body _gather_rows_kernel), which kept x resident in VMEM because
//   Mosaic has no legal row-granular HBM access.  It builds one spin
//   component of Phi (the spin-resolved RDMs), both Phi halves of the
//   hosted x row-sharded engine's segments and the probes' variant L.
//   Bound: bytes.  out written once, each distinct source row of the
//   valid (s != 0) entries read once, the tables once
//   (grid_kernels.rows_scaled_bytes); where x exceeds half the L2 every
//   valid entry's row read again past its first read gives the re-read
//   floor: 5.55 ms bound and 7.09 ms floor for the (14e,14o) one-spin Phi
//   in f64 (18.47 GB of out), 0.134 / 0.149 ms for a (16e,16o) segment's
//   alpha half, 0.122 ms for its beta half.
//   What bounded the first version (one warp per output row, scalar
//   loads and stores of one element from column 0, default write-back
//   stores; scripts/sweep_rows_scaled.py --baseline on an H100): short
//   and odd rows.  On the segment's 14-element rows 18 of a warp's 32
//   lanes idled and every warp stored one partial line: 0.567 ms, 22% of
//   the bound; on the (16e,16o) chunk's beta half (rows of 495 f64, 3,960
//   bytes) warps split sectors with their neighbours: 10.74 ms, 37%.
//   Elsewhere it ran at 55-74%.
//   Design.  A pair's output slab out[b, k] is Na * Nb contiguous
//   elements; blocks take it in chunks of slots (VEC elements, 16 bytes)
//   counted from the 128-byte line at or before its start, so each
//   warp's store instruction covers whole lines whatever the row length,
//   and rows of 14 elements pack 4.6 to a warp.  Stores are streaming
//   (evict-first), so out does not push x out of the L2.  Where Nb and
//   the pointers allow, loads are vectors of a slot too (8-byte slots
//   for f32 rows of an even Nb); else (an odd Nb) the slot's elements are
//   decoded and loaded one by one and stored as one vector.  Each lane
//   reads its slots' (src, s), then starts all its x and t loads (none
//   of x where s = 0), then stores.  Index arithmetic is 32-bit inside a
//   slab, the row division one multiply-high by constants of Nb, the
//   grid (pair, chunk, state) so a block divides nothing.  Block order
//   (swept): where x exceeds half the L2 but n2 of its rows fit a
//   quarter of it ((14e,14o), x 94 MB), the pairs of one chunk index run
//   together, so the source rows of nearby strings stay in the L2;
//   elsewhere each slab's chunks run together (on the (16e,16o) x of
//   1.33 GB the other order took 10.6 against 5.6 ms).  No shared memory.
//   The product is (x * s) * t in the plain version's order, so results
//   equal it as values in f64 and f32 (for finite x).  On an H100 80GB
//   HBM3 at 700 W (f64, sweep_rows_scaled.py, the first version timed
//   in turns): (10e,10o) one-spin Phi 0.0186 ms (83%, the rate of zero_
//   on as many bytes; was 0.0279), (12e,12o) 0.330 (90%; was 0.421),
//   (14e,14o) 7.75 (72%, 92% of the floor; was 9.75), the (16e,16o)
//   segment 0.168 alpha (80%; was 0.240) and 0.146 beta (84%; was
//   0.567), the (16e,16o) chunk 5.57 alpha (73%; was 6.52) and 5.14 beta
//   (76%; was 10.73).

// gather_two_spin (both spin halves of Phi = E_pq x, grid rows [r0, r0+R)):
//   out[b, k, m, j] = (x[b, srcA[k, r0+m], j] * sgnA[k, r0+m]) * tB[k, j]
//                   + (x[b, r0+m, srcB[k, j]] * sgnB[k, j]) * tA[k, r0+m]
//   with x (B, Na, Nb), out (B, n2, R, Nb), read from compact tables built
//   once per maps (grid_kernels.two_spin_tables): srcA (n2, Na) int32,
//   srcB (n2, Nbp) int16 (int32 past 32,767 columns; rows padded to
//   Nbp, a multiple of 16 columns), and an int8 code per entry, (sign + 1)
//   | (parity + 1) << 2, of (sgnA, tA) and of (sgnB, tB): 3 bytes per beta
//   entry where the dense tables take 6.
//   Replaces gather_rows_scaled (auto_oo_tpu/ops/pallas_grid.py:110) on
//   both halves together with its callers' transposed copy of the grid
//   rows and transposed add (pallas_grid.py:259-262, :354-357;
//   auto_oo_tpu/ops/grid.py:560-575): Mosaic gathers only whole rows, so
//   the TPU builds the beta half as a row gather of a transposed copy.
//   Bound: bytes.  Phi written once, the rows of x it needs once, the
//   compact tables once: 4.09 ms for a (16e,16o) chunk of 495 rows in
//   f64 (13.05 GB of Phi), 0.95 ms for the Gram route's 15 f32 states of
//   14 rows.  Every valid alpha entry reads its source row again, and
//   where x exceeds the L2 those rows do not stay there (one wave of 132
//   window rows reads ~2,170 distinct source rows, 223 MB in f64), so
//   the floor a kernel reading each entry's row from memory can reach is
//   the re-read floor (grid_kernels.two_spin_bytes): 4.99 ms and 1.06 ms
//   there.
//   What bounded the first version of this kernel (one or two staged rows
//   a block, the dense tables read per output row, stores from column 0;
//   timed apart on an H100 with the variants of
//   csrc/two_spin_attribution.cu of commit dba141a): its stores.  A
//   (16e,16o) row of Phi is 102,960 bytes in f64 (51,480 in f32), no
//   multiple of 32, so
//   a warp's stores from column 0 straddled 32-byte sectors that another
//   warp finished: writing Phi's bytes alone took 6.54 ms (2.0 TB/s),
//   the same stores started on 128-byte lines 4.20 ms.  After the stores:
//   the alpha re-reads (1.1 ms), the dense tables' L2 reads (0.65 ms); the
//   staging (0.16 ms alone) and the beta gather's bank conflicts (none)
//   were small.
//   Design.  A block owns one row (b, m) and a range of pairs.  It
//   stages the row of x in shared memory, so every beta read x[b, r0+m,
//   srcB[k, j]] is a shared-memory read and nothing is transposed, and
//   the row's alpha entries (source row, code; the staged row itself
//   where the source is the row) for its pairs.  For each pair its
//   threads take the row's columns in VEC-element slots that start on the
//   32-byte sector (rows of whole sectors) or 128-byte line (else) at or
//   before the row's start in out, so every warp's streaming
//   (evict-first) stores cover whole sectors or lines and no sector is
//   written by two warps; slots before column 0 or past Nb stay idle.
//   Loads and stores are 16 bytes wide where Nb and the pointers allow (8
//   for f32 at (16e,16o), Nb even), else one element.  Each warp owns a
//   contiguous run of slots.  In f32 where a pair's tables pass 16 KB
//   ((16e,16o): an f32 row has twice the columns per byte written, so
//   its tables are twice the share of the traffic) each warp copies its
//   columns of the next pair's beta tables into its own two buffers in
//   shared memory (cp.async) while it works on the current pair, so no
//   block barrier follows the staging; elsewhere the tables are read in
//   memory, where they stay in L1 and L2.  Each lane starts the alpha
//   loads of its slots (the source row of a valid entry only: sign 0
//   writes the beta term alone) before the first product.  Two or four
//   rows a block, sharing each beta table entry, did not pay in the sweep
//   of an intermediate design, and were dropped.  The two products and
//   their sum are rounded separately (__dmul_rn / __dadd_rn: nvcc would
//   otherwise contract a * b + c into an FMA), in the plain version's
//   order, so the results equal it as values in f64 and f32 on every
//   plan.  64-bit element offsets throughout.  On an H100 80GB HBM3 at
//   700 W (scripts/sweep_two_spin.py): 5.80 ms on the (16e,16o) f64 chunk
//   (86% of its re-read floor), 1.41 ms on the Gram stack (75%).
//
// gather_reduce (the row form):
//   out[b, i, j] = sum_k (Y[b, k, src[k, i], j] * s[k, i]) * t[k, j]
//   Replaces auto_oo_tpu/ops/pallas_grid.py::gather_reduce (Pallas body
//   _gather_reduce_kernel), whose VMEM-resident accumulator carried the
//   sum across the sequential pair grid.  Bound: the bytes it must move,
//   the Y rows of the valid (s != 0) entries once, the tables once and out
//   once.  On the real maps 30.0% ((10e,10o)) and 29.2% ((12e,12o)) of
//   the (pair, row) entries are valid, so at (12e,12o) f64, B = 1, that is
//   287 MB of Y rows + 2.7 MB of tables + 6.8 MB of out: 0.0885 ms at
//   3.35 TB/s.
//   Design.  A block owns a tile of output rows i, all B tangents of them
//   and the whole width j.  It first compacts each row's valid pairs into
//   a list of (Y row offset, t row offset, s) in shared memory, in
//   increasing k (one warp ballot per 32 pairs, two passes), so no Y load
//   waits on an index load and no invalid pair costs a branch.  Its
//   threads then walk flattened (row, tangent, j-vector) tasks; each task
//   issues kUnroll independent Y loads (streaming, 16-byte vectors along
//   j where the row stride and the pointers allow, else scalars) and the
//   matching t loads (read-only path, reused across rows and tangents)
//   before it adds them in list order.  The launch plan (vector width,
//   rows per block, threads) comes from the wrapper, which sizes a block
//   to a whole number of warps with no more than one partial warp per
//   round, so Nb = 924 leaves no block mostly idle.  The sum runs over the
//   valid k in increasing order with the product (Y * s) * t, as the
//   first version of this kernel did: f64 results agree with the plain
//   version to rounding (1e-13 relative), not bit for bit.
//
// gather_reduce_cols (the column form, the beta half read in place):
//   out[b, a, c] (+)= sum_k (Y[b, k, a, src[k, c]] * s[k, c]) * t[k, a]
//   with Y (B, n2, Na, Ns), src/s (n2, Nc), t (n2, Na), out (B, Na, Nc).
//   It equals gather_reduce(Y^T, src, s, t)^T over the last two axes, the
//   beta half of the TPU wrapper's epq_sum, which pays for one transposed
//   copy of Y first (auto_oo_tpu/ops/pallas_grid.py:270): Mosaic gathers
//   only whole rows.  Here the gather runs inside the rows of Y in its
//   natural grid layout, so that copy (983.5 MB read + 983.5 MB written
//   at (12e,12o) f64) is gone.  With add != 0 the sum over k is added to
//   out once (out + sum, the bits of the callers' earlier out += result),
//   so no temporary of out's size is written and read again.
//   Bound: bytes, the Y elements of the valid (s != 0) entries once, the
//   tables once and out once (0.0885 ms at (12e,12o) f64 B = 1; 1.12 ms on
//   a (16e,16o) Y chunk of 495 rows).  A valid element is an 8-byte piece
//   of a row, and in sorted string order the valid sources of one pair
//   come in runs, so the 32-byte sectors they touch are 45-57% of Y where
//   28-30% of its elements are valid: the sector floor (0.1513 ms at
//   (12e,12o), 1.74 ms on the (16e,16o) chunk).  On an H100 the card
//   fetches the whole 128-byte line of a missed sector (setting
//   cudaLimitMaxL2FetchGranularity to 32, 64 or 128 changes nothing), so
//   the floor that bounds this kernel is the 128-byte lines the valid
//   elements touch, 57-76% of Y (0.198 ms at (12e,12o), 2.20 ms on the
//   (16e,16o) chunk); every plan swept runs at 84-95% of it, about the
//   rate of a streaming copy on the same card.
//   Design.  The valid entries depend on the maps only, so the wrapper
//   compacts them once per maps (cached on GridMaps) into lists, one per
//   tile of output columns: (source column int32, output column in the
//   tile int16, sign int8) in increasing pair k, each pair's run padded
//   to whole groups of 32 entries with sign 0, and the pair of each group.
//   Each warp owns RW output rows a of one column tile and walks the
//   tile's list in order: lane l takes entry l of a group, so every Y load
//   issued is live but for the padding (16-21% of the lanes at a tile of
//   256 columns, against ~70% predicated-off loads when lanes were output
//   columns).  A group's loads fall on its pair's runs of src inside one
//   row of Y, so they share sectors; one table entry serves the warp's RW
//   rows, and t[k, a] is one broadcast load per group and row.  The terms
//   land in the warp's RW x tile accumulators in shared memory, group
//   after group (a pair's output columns are distinct, so a group's lanes
//   never collide; __syncwarp orders the groups).  Each thread issues the
//   Y loads of U groups (U * RW live loads) before the first add, and the
//   next U groups' entries are loaded while they are in flight.  Each
//   output element is summed over its valid k in increasing order, with
//   the products and sums rounded one by one ((y * s) * t, no FMA), so the
//   result does not depend on the plan, and add mode equals out + result
//   bit for bit.  The wrapper's plan (rows per warp, unroll, warps per
//   block) and the list tile were swept on an H100
//   (scripts/sweep_reduce_cols.py).  The signs must be +-1 or 0 (the
//   maps' own); t may be any value.

// scatter_rows (the alpha half of the hosted H-apply, accumulated):
//   acc[b, i, j] += sum_k (Y[b, k, src[k, i] - r0, j] * s[k, i]) * t[k, j]
//   over the k whose src[k, i] lies in the window [r0, r0 + Ns), with
//   Y (B, n2, Ns, Nb) the H-apply's Y of the grid rows [r0, r0 + Ns) in
//   SOURCE rows, src/s (n2, Na) the full alpha maps, acc (B, Na, Nb).
//   Replaces the XLA scatter acc.at[dst].add(Y * dsg * t) of
//   auto_oo_tpu/ops/grid_hosted.py::_ham_segment (no Pallas kernel there;
//   it is the windowed, accumulating form of kernel 2 above).  Each pair's
//   row map is a partial injection, so the scatter through the inverse
//   maps (dst, dsg) equals this gather through the forward maps: every
//   output row reads the Y rows of its valid pairs inside the window.
//   It is the row form's kernel with two changes: a pair is staged only if
//   its source row lies in the window, and the block adds its sum to acc
//   (a row with no pair in the window is neither read nor written).  No
//   atomics: the terms are summed in increasing k and then added to acc
//   once, so two launches give the same bits.  Bound: the Y rows of the
//   staged pairs once, each acc row with a staged pair read and written
//   once, the tables once; per (16e,16o) chunk of ~477 rows that is ~3.8
//   GB of Y and ~2.5 GB of acc, where index_add_ through the inverse maps
//   would write every Y element to acc with an atomic add.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsThreads = 512;  // gather_rows_scaled: largest block
constexpr int kMaxThreads = 512;   // gather_reduce: largest block the plan asks
constexpr int kUnroll = 4;         // gather_reduce: Y loads in flight per task
constexpr int kColsThreads = 256;  // gather_reduce_cols: largest block
constexpr int kTwoSpinThreads = 1024;  // gather_two_spin: largest block
// the most dynamic shared memory one block can use on Hopper (227 KB)
constexpr size_t kMaxBlockSmem = 232448;

// ---- gather_reduce: vectors of VEC elements along j ----------------------

template <typename T, int VEC> struct Vec;
template <> struct Vec<double, 2> { using type = double2; };
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<float, 2> { using type = float2; };
template <> struct Vec<double, 1> { using type = double; };
template <> struct Vec<float, 1> { using type = float; };

__device__ __forceinline__ void zero(double& a) { a = 0.0; }
__device__ __forceinline__ void zero(float& a) { a = 0.0f; }
__device__ __forceinline__ void zero(double2& a) { a.x = a.y = 0.0; }
__device__ __forceinline__ void zero(float4& a) {
  a.x = a.y = a.z = a.w = 0.0f;
}

// acc += (y * s) * t, elementwise, in the order of the plain version
__device__ __forceinline__ void add_term(double& acc, double y, double s,
                                         double t) {
  acc += (y * s) * t;
}
__device__ __forceinline__ void add_term(float& acc, float y, float s,
                                         float t) {
  acc += (y * s) * t;
}
__device__ __forceinline__ void add_term(double2& acc, double2 y, double s,
                                         double2 t) {
  acc.x += (y.x * s) * t.x;
  acc.y += (y.y * s) * t.y;
}
__device__ __forceinline__ void add_term(float4& acc, float4 y, float s,
                                         float4 t) {
  acc.x += (y.x * s) * t.x;
  acc.y += (y.y * s) * t.y;
  acc.z += (y.z * s) * t.z;
  acc.w += (y.w * s) * t.w;
}

__device__ __forceinline__ void add_to(double& o, double a) { o += a; }
__device__ __forceinline__ void add_to(float& o, float a) { o += a; }
__device__ __forceinline__ void add_to(double2& o, double2 a) {
  o.x += a.x;
  o.y += a.y;
}
__device__ __forceinline__ void add_to(float4& o, float4 a) {
  o.x += a.x;
  o.y += a.y;
  o.z += a.z;
  o.w += a.w;
}

// One block: rows [blockIdx.x * rows, +rows) of out, all B tangents, all j.
// Dynamic shared memory: off[rows][n2] (long long), sv[rows][n2] (T),
// toff[rows][n2] (int), cnt[rows][n_chunks] (int), len[rows] (int).
// kAdd: scatter_rows, the window [r0, r0 + Ns) and out += (see the header);
// otherwise gather_reduce (r0 is 0 and every src lies in [0, Ns)).
template <typename T, int VEC, bool kAdd>
__global__ void __launch_bounds__(kMaxThreads)
gather_reduce_kernel(const T* __restrict__ Y, const int* __restrict__ src,
                     const T* __restrict__ s, const T* __restrict__ t,
                     T* __restrict__ out, int B, int n2, int Ns, int Na,
                     int Nb, int rows, int r0) {
  using V = typename Vec<T, VEC>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_chunks = (n2 + kWarp - 1) / kWarp;
  long long* off = reinterpret_cast<long long*>(smem);
  T* sv = reinterpret_cast<T*>(off + rows * n2);
  int* toff = reinterpret_cast<int*>(sv + rows * n2);
  int* cnt = toff + rows * n2;
  int* len = cnt + rows * n_chunks;

  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int n_warps = blockDim.x / kWarp;
  const int i0 = blockIdx.x * rows;
  const int n_rows = min(rows, Na - i0);

  // stage: compact each row's valid pairs, in increasing k
  for (int r = tid; r < n_rows; r += blockDim.x) len[r] = 0;
  for (int w = warp; w < n_rows * n_chunks; w += n_warps) {
    const int r = w / n_chunks;
    const int k = (w % n_chunks) * kWarp + lane;
    const long long e_k = static_cast<long long>(k) * Na + i0 + r;
    bool valid = k < n2 && __ldg(s + e_k) != T(0);
    if (kAdd && valid) {
      const int m = __ldg(src + e_k) - r0;
      valid = m >= 0 && m < Ns;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, valid);
    if (lane == 0) cnt[w] = __popc(mask);
  }
  __syncthreads();
  for (int w = warp; w < n_rows * n_chunks; w += n_warps) {
    const int r = w / n_chunks;
    const int c = w % n_chunks;
    const int k = c * kWarp + lane;
    const long long e_k = static_cast<long long>(k) * Na + i0 + r;
    T sk = k < n2 ? __ldg(s + e_k) : T(0);
    int m = 0;
    if (kAdd && sk != T(0)) {
      m = __ldg(src + e_k) - r0;
      if (m < 0 || m >= Ns) sk = T(0);
    }
    const unsigned mask = __ballot_sync(0xffffffffu, sk != T(0));
    int base = 0;
    for (int cc = 0; cc < c; ++cc) base += cnt[r * n_chunks + cc];
    if (sk != T(0)) {
      if (!kAdd) m = __ldg(src + e_k);
      const int e = r * n2 + base + __popc(mask & ((1u << lane) - 1u));
      off[e] = (static_cast<long long>(k) * Ns + m) * Nb;
      sv[e] = sk;
      toff[e] = k * Nb;
    }
    if (c == n_chunks - 1 && lane == 0) len[r] = base + __popc(mask);
  }
  __syncthreads();

  // reduce: flattened (row, tangent, j-vector) tasks
  const int Nv = Nb / VEC;
  const int per_row = B * Nv;
  const long long tangent = static_cast<long long>(n2) * Ns * Nb;
  for (int task = tid; task < n_rows * per_row; task += blockDim.x) {
    const int r = task / per_row;
    const int b = (task - r * per_row) / Nv;
    const int j = (task - r * per_row - b * Nv) * VEC;
    const T* Yb = Y + b * tangent + j;
    const T* tj = t + j;
    const long long* eo = off + r * n2;
    const T* es = sv + r * n2;
    const int* et = toff + r * n2;
    const int n = len[r];
    if (kAdd && n == 0) continue;
    V acc;
    zero(acc);
    // groups of kUnroll entries; the last group is predicated, so its
    // loads are in flight together too
    for (int e = 0; e < n; e += kUnroll) {
      V y[kUnroll], tt[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (e + u < n) y[u] = __ldcs(reinterpret_cast<const V*>(Yb + eo[e + u]));
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (e + u < n) tt[u] = __ldg(reinterpret_cast<const V*>(tj + et[e + u]));
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (e + u < n) add_term(acc, y[u], es[e + u], tt[u]);
    }
    V* o = reinterpret_cast<V*>(
        out + (static_cast<long long>(b) * Na + i0 + r) * Nb + j);
    if (kAdd) {
      V prev = *o;
      add_to(prev, acc);
      *o = prev;
    } else {
      *o = acc;
    }
  }
}

// ---- gather_two_spin ------------------------------------------------------

// VEC consecutive beta source columns (int16 where Nb <= 32767, else int32;
// aligned to VEC entries)
__device__ __forceinline__ void load_idx(const short* p, int (&o)[1]) {
  o[0] = __ldg(p);
}
__device__ __forceinline__ void load_idx(const short* p, int (&o)[2]) {
  const short2 v = __ldg(reinterpret_cast<const short2*>(p));
  o[0] = v.x;
  o[1] = v.y;
}
__device__ __forceinline__ void load_idx(const short* p, int (&o)[4]) {
  const short4 v = __ldg(reinterpret_cast<const short4*>(p));
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void load_idx(const int* p, int (&o)[1]) {
  o[0] = __ldg(p);
}
__device__ __forceinline__ void load_idx(const int* p, int (&o)[2]) {
  const int2 v = __ldg(reinterpret_cast<const int2*>(p));
  o[0] = v.x;
  o[1] = v.y;
}
__device__ __forceinline__ void load_idx(const int* p, int (&o)[4]) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

// VEC consecutive int8 codes, each (sign + 1) | (parity + 1) << 2, kept
// packed in one register
template <int VEC> struct Codes;
template <> struct Codes<1> {
  signed char v;
  __device__ __forceinline__ void load(const signed char* p) { v = __ldg(p); }
  __device__ __forceinline__ int operator[](int) const { return v; }
};
template <> struct Codes<2> {
  char2 v;
  __device__ __forceinline__ void load(const signed char* p) {
    v = __ldg(reinterpret_cast<const char2*>(p));
  }
  __device__ __forceinline__ int operator[](int u) const {
    return u == 0 ? v.x : v.y;
  }
};
template <> struct Codes<4> {
  char4 v;
  __device__ __forceinline__ void load(const signed char* p) {
    v = __ldg(reinterpret_cast<const char4*>(p));
  }
  __device__ __forceinline__ int operator[](int u) const {
    return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
  }
};
// the sign (low two bits) and the parity (next two) of a code
__device__ __forceinline__ int code_sign(int c) { return (c & 3) - 1; }
__device__ __forceinline__ int code_parity(int c) { return ((c >> 2) & 3) - 1; }

// VEC consecutive elements of x (read-only path) or of a staged row, and
// streaming stores
__device__ __forceinline__ void load_x(const double* p, double (&o)[1]) {
  o[0] = __ldg(p);
}
__device__ __forceinline__ void load_x(const double* p, double (&o)[2]) {
  const double2 v = __ldg(reinterpret_cast<const double2*>(p));
  o[0] = v.x;
  o[1] = v.y;
}
__device__ __forceinline__ void load_x(const float* p, float (&o)[1]) {
  o[0] = __ldg(p);
}
__device__ __forceinline__ void load_x(const float* p, float (&o)[2]) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  o[0] = v.x;
  o[1] = v.y;
}
__device__ __forceinline__ void load_x(const float* p, float (&o)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
template <typename T, int VEC>
__device__ __forceinline__ void load_staged(const T* p, T (&o)[VEC]) {
  using V = typename Vec<T, VEC>::type;
  const V v = *reinterpret_cast<const V*>(p);
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int u = 0; u < VEC; ++u) o[u] = e[u];
}
__device__ __forceinline__ void store_cs(double* p, const double (&o)[1]) {
  __stcs(p, o[0]);
}
__device__ __forceinline__ void store_cs(double* p, const double (&o)[2]) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(o[0], o[1]));
}
__device__ __forceinline__ void store_cs(float* p, const float (&o)[1]) {
  __stcs(p, o[0]);
}
__device__ __forceinline__ void store_cs(float* p, const float (&o)[2]) {
  __stcs(reinterpret_cast<float2*>(p), make_float2(o[0], o[1]));
}
__device__ __forceinline__ void store_cs(float* p, const float (&o)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(o[0], o[1], o[2], o[3]));
}

// products and sums rounded one by one (no FMA contraction)
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}

// ---- gather_rows_scaled ---------------------------------------------------

// The operands of one launch: x, src, s, t, out; B, n2, Ns, Na, Nb; the
// blocks each pair slab out[b, k] (Na * Nb contiguous elements) takes
// (chunks); the constants of the division by Nb (e / Nb = (umulhi(e,
// div_m) + e) >> div_l for 0 <= e < 2^31); the order of the blocks (0:
// the slabs of one chunk index run together, 1: the chunks of one slab).
template <typename T>
struct RowsArgs {
  const T* x;
  const int* src;
  const T* s;
  const T* t;
  T* out;
  int B, n2, Ns, Na, Nb, chunks;
  unsigned div_m;
  int div_l, order;
};

// Block (threads): chunk c of the slab out[b, k], (blockIdx.x, y) = (k,
// c) in order 0 and (c, k) in order 1, for y = blockIdx.y, + gridDim.y,
// ..., and b = blockIdx.z, + gridDim.z, ...  The slots (VEC elements, one
// store each) on out's VEC-element boundaries that hold elements of the
// slab are counted from the 128-byte line at or before the first; chunk
// c is slots [c * threads * U, (c + 1) * threads * U) of them, warp w
// takes the run of 32 * U from w * 32 * U, and lane l its U slots l, l +
// 32, ... of that run, so every store instruction of a warp covers whole
// lines.  Elements outside the slab stay idle.  Each lane first reads
// its slots' (src, s) entries, then starts every x and t load of its U
// slots (no x load where s = 0: x * 0 is 0 for finite x), then takes the
// products in the plain version's order and stores them streaming
// (evict-first).  ELEM false: Nb is a multiple of VEC and x, t lie on
// VEC elements, so a slot lies in one row and loads are vectors too.
// ELEM true: a slot may straddle rows (and, at its ends, two slabs): its
// elements are decoded and loaded one by one and stored as one vector
// where the slot lies in the slab.  Index arithmetic is 32-bit inside a
// slab (Na * Nb < 2^31) and the division by Nb one multiply-high.
template <typename T, int VEC, int U, bool ELEM>
__global__ void __launch_bounds__(kRowsThreads)
gather_rows_scaled_kernel(const RowsArgs<T> a) {
  constexpr int kLine = 128 / (VEC * static_cast<int>(sizeof(T)));
  const int L = a.Na * a.Nb;  // elements of a slab
  const int off = (threadIdx.x / kWarp) * (kWarp * U) + threadIdx.x % kWarp;
  const int ny = a.order == 0 ? a.chunks : a.n2;
  for (int b = blockIdx.z; b < a.B; b += gridDim.z) {
    const T* xb = a.x + static_cast<long long>(b) * a.Ns * a.Nb;
    for (int y = blockIdx.y; y < ny; y += gridDim.y) {
      const int k = a.order == 0 ? static_cast<int>(blockIdx.x) : y;
      const int c = a.order == 0 ? y : static_cast<int>(blockIdx.x);
      const long long base = (static_cast<long long>(b) * a.n2 + k) * L;
      const long long g0 = base / VEC;  // the slot of its first element
      const int lead = static_cast<int>(g0 % kLine);
      const int head = static_cast<int>(base - g0 * VEC);  // 0 unless ELEM
      const int n_slots = (head + L + VEC - 1) / VEC;
      const int* srck = a.src + static_cast<long long>(k) * a.Na;
      const T* sk = a.s + static_cast<long long>(k) * a.Na;
      const T* tk = a.t + static_cast<long long>(k) * a.Nb;
      T* ob = a.out + g0 * VEC;
      const int q0 = c * static_cast<int>(blockDim.x) * U + off - lead;
      // e[u]: the slab's element index of slot u's first element
      int e[U];
      bool live[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int q = q0 + u * kWarp;
        live[u] = q >= 0 && q < n_slots;
        e[u] = q * VEC - head;
      }
      // (src, s) and the column of each element
      int r[U][VEC], j[U][VEC];
      T sv[U][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e0 = e[u] > 0 ? e[u] : 0;
        const unsigned ue = static_cast<unsigned>(e0);
        int i = static_cast<int>((__umulhi(ue, a.div_m) + ue) >> a.div_l);
        int jj = e0 - i * a.Nb;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          r[u][v] = 0;
          sv[u][v] = T(0);
          j[u][v] = 0;
          if (!ELEM && v > 0) continue;
          const int el = e[u] + v;
          if (live[u] && el >= 0 && el < L) {
            if (el > e0) {
              ++jj;
              while (jj >= a.Nb) {
                jj -= a.Nb;
                ++i;
              }
            }
            j[u][v] = jj;
            r[u][v] = __ldg(srck + i);
            sv[u][v] = __ldg(sk + i);
          }
        }
      }
      // vector slots: every t load first (none waits on an (src, s)
      // entry), then every x load; element slots: t and x element by
      // element (fewer registers live, as the sweep preferred)
      T xv[U][VEC], tv[U][VEC];
      if (!ELEM) {
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (live[u]) load_x(tk + j[u][0], tv[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!ELEM) {
          if (live[u]) {
            if (sv[u][0] != T(0)) {
              load_x(xb + static_cast<long long>(r[u][0]) * a.Nb + j[u][0],
                     xv[u]);
            } else {
#pragma unroll
              for (int v = 0; v < VEC; ++v) xv[u][v] = T(0);
            }
          }
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            const int el = e[u] + v;
            xv[u][v] = T(0);
            tv[u][v] = T(0);
            if (live[u] && el >= 0 && el < L) {
              tv[u][v] = __ldg(tk + j[u][v]);
              if (sv[u][v] != T(0))
                xv[u][v] = __ldg(xb + static_cast<long long>(r[u][v]) * a.Nb +
                                 j[u][v]);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!live[u]) continue;
        T o[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          o[v] = mul_rn(mul_rn(xv[u][v], sv[u][ELEM ? v : 0]), tv[u][v]);
        if (!ELEM || (e[u] >= 0 && e[u] + VEC <= L)) {
          store_cs(ob + static_cast<long long>(e[u] + head), o);
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            const int el = e[u] + v;
            if (el >= 0 && el < L)
              __stcs(ob + static_cast<long long>(el + head), o[v]);
          }
        }
      }
    }
  }
}

// column slots one lane takes per step: 64 bytes of the row in flight
__host__ __device__ constexpr int two_spin_unroll(int vec, int itemsize) {
  return 64 / (vec * itemsize) > 1 ? 64 / (vec * itemsize) : 1;
}

// table columns a warp of `cols` columns copies: its own and the line
// before them, from a multiple of 16, in whole 16-column pieces
__host__ __device__ constexpr int two_spin_width(int cols, int line) {
  return (cols + line + 16 + 15) / 16 * 16;
}

// 16-byte asynchronous copies from device memory into shared memory
// (cp.async, completion by commit group)
__device__ __forceinline__ void cp_async16(void* to, const void* from) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(to));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(from));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// The operands of one launch: x, the alpha tables (srcA int32, codeA),
// the beta tables (srcB, codeB; rows of Nbp entries, Nbp a multiple of 16),
// out; n2, Na, Nb, Nbp, r0, R; pairs per block; the bytes of the lines
// each row's stores start on.
template <typename T, typename Idx>
struct TwoSpinArgs {
  const T* x;
  const int* srcA;
  const signed char* codeA;
  const Idx* srcB;
  const signed char* codeB;
  T* out;
  int n2, Na, Nb, Nbp, r0, R, pairs, line;
};

// The calling warp's columns [c0, c0 + n) of pair k's beta tables into
// its buffer in shared memory, 16 bytes per copy (c0 and n multiples of
// 16); one commit group per call.
template <typename Idx>
__device__ __forceinline__ void two_spin_slice_async(
    const Idx* srcB, const signed char* codeB, int Nbp, int k, int c0, int n,
    Idx* s_idx, signed char* s_code, int lane) {
  const long long at = static_cast<long long>(k) * Nbp + c0;
  const int n_idx = n * static_cast<int>(sizeof(Idx)) / 16;
  for (int e = lane; e < n_idx + n / 16; e += kWarp) {
    if (e < n_idx)
      cp_async16(reinterpret_cast<char*>(s_idx) + 16 * e,
                 reinterpret_cast<const char*>(srcB + at) + 16 * e);
    else
      cp_async16(s_code + 16 * (e - n_idx), codeB + at + 16 * (e - n_idx));
  }
  cp_async_commit();
}

// Block (threads): the row (b, m) = blockIdx.x (b-major) and the pairs
// [k0, k1) of blockIdx.y.  It stages the row of x and its alpha entries
// for its pairs in shared memory.  For each pair the threads take the
// row's columns in VEC-element slots that start on the line (p.line
// bytes) at or before the row's start in out, so every warp's stores
// cover whole lines (slots before column 0 or past Nb stay idle).  Warp w
// owns the slots [w * S, (w + 1) * S), S = 32 * U * rounds, and each step
// of a lane takes U of them 32 apart, with all their alpha loads started
// before the first product.  With STAGED each warp copies its columns of
// the next pair's beta tables into its own two buffers (cp.async) while
// it works on the current pair, so the warps meet at no block barrier
// after the staging; without, the threads read the tables in memory,
// where they stay in L1 and L2 at the small grids.  Dynamic shared
// memory: the row (Nb elements), the alpha entries (int, pairs): source *
// 16 + codeA, the source a grid row of x or -1 for the staged row itself,
// and with STAGED two buffers of `width` columns per warp (Idx, then int8
// codes).
template <typename T, typename Idx, int VEC, bool STAGED>
__global__ void __launch_bounds__(kTwoSpinThreads, 1)
gather_two_spin_kernel(const TwoSpinArgs<T, Idx> p) {
  constexpr int U = two_spin_unroll(VEC, sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  const int n2 = p.n2, Nb = p.Nb, Nbp = p.Nbp, R = p.R, r0 = p.r0;
  const int P = p.pairs;
  const int line = p.line / static_cast<int>(sizeof(T));
  const int slots = Nb / VEC + line / VEC;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int rounds = (slots + U * blockDim.x - 1) / (U * blockDim.x);
  const int S = kWarp * U * rounds;  // slots of a warp
  const int width = two_spin_width(S * VEC, line);
  T* xs = reinterpret_cast<T*>(smem);
  int* s_alpha = reinterpret_cast<int*>(
      smem + ((static_cast<size_t>(Nb) * sizeof(T) + 15) & ~size_t(15)));
  Idx* s_idx = reinterpret_cast<Idx*>(
      smem + ((static_cast<size_t>(Nb) * sizeof(T) + 15) & ~size_t(15)) +
      ((4 * static_cast<size_t>(P) + 15) & ~size_t(15)));
  signed char* s_code = reinterpret_cast<signed char*>(
      s_idx + 2 * width * (blockDim.x / kWarp));
  Idx* w_idx = s_idx + 2 * width * warp;
  signed char* w_code = s_code + 2 * width * warp;
  const long long b = blockIdx.x / R;
  const int m = static_cast<int>(blockIdx.x - b * R);
  const long long plane = static_cast<long long>(p.Na) * Nb;
  const T* xb = p.x + b * plane;
  T* ob = p.out + (b * n2 * R + m) * static_cast<long long>(Nb);
  const int k0 = blockIdx.y * P;
  const int np = min(n2, k0 + P) - k0;
  // the warp's table columns: from the line before its first slot
  const int c0 = max(0, (warp * S * VEC - line) & ~15);
  const int cn = max(0, min(Nbp - c0, width));

  if (STAGED)
    two_spin_slice_async(p.srcB, p.codeB, Nbp, k0, c0, cn, w_idx, w_code,
                         lane);
  // the row of x
  {
    using V = typename Vec<T, VEC>::type;
    const V* from = reinterpret_cast<const V*>(
        xb + static_cast<long long>(r0 + m) * Nb);
    V* to = reinterpret_cast<V*>(xs);
    for (int e = threadIdx.x; e < Nb / VEC; e += blockDim.x)
      to[e] = __ldg(from + e);
  }
  // the alpha entries of the block's pairs; no source row of an invalid
  // entry is read
  for (int i = threadIdx.x; i < np; i += blockDim.x) {
    const long long at = static_cast<long long>(k0 + i) * p.Na + r0 + m;
    const int c = __ldg(p.codeA + at);
    int src = 0;
    if (code_sign(c) != 0) {
      src = __ldg(p.srcA + at);
      if (src == r0 + m) src = -1;
    }
    s_alpha[i] = src * 16 + c;
  }
  __syncthreads();

  for (int i = 0; i < np; ++i) {
    const int k = k0 + i;
    const Idx* tidx;
    const signed char* tcode;
    if (STAGED) {
      // the lanes are done with the other buffer: copy the next pair's
      // columns into it; then this pair's have landed
      __syncwarp();
      if (i + 1 < np)
        two_spin_slice_async(p.srcB, p.codeB, Nbp, k + 1, c0, cn,
                             w_idx + ((i + 1) & 1) * width,
                             w_code + ((i + 1) & 1) * width, lane);
      else
        cp_async_commit();
      cp_async_wait_one();
      __syncwarp();
      tidx = w_idx + (i & 1) * width - c0;
      tcode = w_code + (i & 1) * width - c0;
    } else {
      tidx = p.srcB + static_cast<long long>(k) * Nbp;
      tcode = p.codeB + static_cast<long long>(k) * Nbp;
    }
    const long long ko = static_cast<long long>(k) * R * Nb;
    const int ae = s_alpha[i];
    const int c = ae & 15;
    const int src = (ae - c) / 16;
    const T sa = T(code_sign(c)), ta = T(code_parity(c));
    const T* xa_row = src >= 0 ? xb + static_cast<long long>(src) * Nb : xs;
    // the column of slot 0: the line at or before the row's start
    const int first = -static_cast<int>(
        (reinterpret_cast<size_t>(ob + ko) / sizeof(T)) % line);
    for (int r = 0; r < rounds; ++r) {
      const int s0 = warp * S + r * U * kWarp + lane;
      T xa[U][VEC];
      int sb[U][VEC];
      Codes<VEC> cb[U];
      if (!STAGED) {
#pragma unroll
        for (int q = 0; q < U; ++q) {
          const int j = first + (s0 + q * kWarp) * VEC;
          if (j >= 0 && j < Nb) {
            load_idx(tidx + j, sb[q]);
            cb[q].load(tcode + j);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < U; ++q) {
        const int j = first + (s0 + q * kWarp) * VEC;
        if (j >= 0 && j < Nb && code_sign(c) != 0) {
          if (src >= 0)
            load_x(xa_row + j, xa[q]);
          else
            load_staged<T, VEC>(xs + j, xa[q]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) xa[q][e] = T(0);
        }
      }
#pragma unroll
      for (int q = 0; q < U; ++q) {
        const int j = first + (s0 + q * kWarp) * VEC;
        if (j < 0 || j >= Nb) continue;
        T o[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int cj = STAGED ? tcode[j + e] : cb[q][e];
          const int sj = STAGED ? tidx[j + e] : sb[q][e];
          const T alpha = code_sign(c) != 0
                              ? mul_rn(mul_rn(xa[q][e], sa),
                                       T(code_parity(cj)))
                              : T(0);
          const T beta = mul_rn(mul_rn(xs[sj], T(code_sign(cj))), ta);
          o[e] = add_rn(alpha, beta);
        }
        store_cs(ob + ko + j, o);
      }
    }
  }
}

// ---- gather_reduce_cols ---------------------------------------------------

// The list entries of U groups from group g on (sign 0 and pair 0 at and
// past the tile's end g1): lane's source column, output column in the
// tile and sign, and each group's pair.
template <int U>
__device__ __forceinline__ void cols_entries(
    const int* __restrict__ lsrc, const short* __restrict__ lcol,
    const signed char* __restrict__ lsgn, const int* __restrict__ lpair,
    int g, int g1, int lane, int (&src)[U], int (&col)[U], int (&sgn)[U],
    int (&k)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool in = g + u < g1;
    const long long e = static_cast<long long>(g + u) * kWarp + lane;
    sgn[u] = in ? __ldg(lsgn + e) : 0;
    src[u] = in ? __ldg(lsrc + e) : 0;
    col[u] = in ? __ldg(lcol + e) : 0;
    k[u] = in ? __ldg(lpair + g + u) : 0;
  }
}

// The column form's operands: Y, the lists (source column, output column
// in the tile, sign; each group's pair; each tile's first group), t, out;
// B tangents; n2, Na, Ns, Nc; the list tile; add (out += the sum).
template <typename T>
struct ColsArgs {
  const T* Y;
  const int* lsrc;
  const short* lcol;
  const signed char* lsgn;
  const int* lpair;
  const int* lstart;
  const T* t;
  T* out;
  long long B;
  int n2, Na, Ns, Nc, tile, add;
};

// Block (32 * warps): column tile blockIdx.x (list groups [lstart[x],
// lstart[x + 1])), RW output rows per warp from blockIdx.y * warps * RW,
// tangent blockIdx.z.  Dynamic shared memory: each warp's RW x tile
// accumulators.  The warps share nothing but the list (read through L1).
template <typename T, int RW, int U>
__global__ void __launch_bounds__(kColsThreads, 2)
gather_reduce_cols_kernel(const ColsArgs<T> p) {
  const int n2 = p.n2, Na = p.Na, Ns = p.Ns, tile = p.tile;
  const T* __restrict__ t = p.t;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int a0 = (blockIdx.y * (blockDim.x / kWarp) + warp) * RW;
  if (a0 >= Na) return;
  const int n_a = min(RW, Na - a0);
  T* acc = reinterpret_cast<T*>(smem) + warp * RW * tile;
  for (int e = lane; e < RW * tile; e += kWarp) acc[e] = T(0);
  const long long b = blockIdx.z;
  const T* __restrict__ Yb = p.Y + b * n2 * static_cast<long long>(Na) * Ns;
  const int g0 = __ldg(p.lstart + blockIdx.x);
  const int g1 = __ldg(p.lstart + blockIdx.x + 1);

  int nsrc[U], ncol[U], nsgn[U], nk[U];
  cols_entries<U>(p.lsrc, p.lcol, p.lsgn, p.lpair, g0, g1, lane, nsrc, ncol,
                  nsgn, nk);
  for (int g = g0; g < g1; g += U) {
    int src[U], col[U], sgn[U], k[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      src[u] = nsrc[u];
      col[u] = ncol[u];
      sgn[u] = nsgn[u];
      k[u] = nk[u];
    }
    // every Y load of the U groups, then their t, before the first add
    T y[U][RW], tt[U][RW];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const T* Yk =
          Yb + (static_cast<long long>(k[u]) * Na + a0) * Ns + src[u];
#pragma unroll
      for (int r = 0; r < RW; ++r)
        y[u][r] = (sgn[u] != 0 && r < n_a)
                      ? __ldcs(Yk + static_cast<long long>(r) * Ns)
                      : T(0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const T* tk = t + static_cast<long long>(k[u]) * Na + a0;
#pragma unroll
      for (int r = 0; r < RW; ++r) tt[u][r] = r < n_a ? __ldg(tk + r) : T(0);
    }
    cols_entries<U>(p.lsrc, p.lcol, p.lsgn, p.lpair, g + U, g1, lane, nsrc,
                    ncol, nsgn, nk);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      // the previous group's adds (other lanes, maybe the same column)
      // are visible before this group's
      __syncwarp();
      if (sgn[u] != 0) {
        const T sv = T(sgn[u]);
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          if (r < n_a) {
            T* a = acc + r * tile + col[u];
            *a = add_rn(*a, mul_rn(mul_rn(y[u][r], sv), tt[u][r]));
          }
        }
      }
    }
  }
  __syncwarp();
  const int c0 = blockIdx.x * tile;
  const int n_c = min(tile, p.Nc - c0);
  T* o = p.out + (b * Na + a0) * static_cast<long long>(p.Nc) + c0;
  for (int r = 0; r < n_a; ++r) {
    for (int c = lane; c < n_c; c += kWarp) {
      const T v = acc[r * tile + c];
      T* q = o + static_cast<long long>(r) * p.Nc + c;
      *q = p.add ? add_rn(*q, v) : v;
    }
  }
}

template <typename T, int VEC, int U>
int launch_rows(const RowsArgs<T>& a, bool elem, int threads,
                cudaStream_t stream) {
  const int nx = a.order == 0 ? a.n2 : a.chunks;
  const int ny = a.order == 0 ? a.chunks : a.n2;
  const dim3 grid(static_cast<unsigned int>(nx),
                  static_cast<unsigned int>(ny < 65535 ? ny : 65535),
                  static_cast<unsigned int>(a.B < 65535 ? a.B : 65535));
  if (elem)
    gather_rows_scaled_kernel<T, VEC, U, true>
        <<<grid, threads, 0, stream>>>(a);
  else
    gather_rows_scaled_kernel<T, VEC, U, false>
        <<<grid, threads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// unroll U in {1, 2, 4, 8}
template <typename T, int VEC>
int launch_rows_vec(const RowsArgs<T>& a, bool elem, int threads,
                    int unroll, cudaStream_t stream) {
  switch (unroll) {
    case 1:
      return launch_rows<T, VEC, 1>(a, elem, threads, stream);
    case 2:
      return launch_rows<T, VEC, 2>(a, elem, threads, stream);
    case 4:
      return launch_rows<T, VEC, 4>(a, elem, threads, stream);
    case 8:
      return launch_rows<T, VEC, 8>(a, elem, threads, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// gather_rows_scaled: vec elements a store (16, 8 or 4 bytes, out on
// vec elements); loads of vec elements too where Nb is a multiple of vec
// and x, t lie on vec elements, else one element at a time (ELEM)
template <typename T>
int launch_gather_rows_scaled(const T* x, const int* src, const T* s,
                              const T* t, T* out, long long B, int n2,
                              int Ns, int Na, int Nb, int vec, int threads,
                              int unroll, int order, long long div_m,
                              int div_l, cudaStream_t stream) {
  if (B == 0 || n2 == 0 || Na == 0 || Nb == 0)
    return static_cast<int>(cudaSuccess);
  const long long L = static_cast<long long>(Na) * Nb;
  const size_t width = static_cast<size_t>(vec) * sizeof(T);
  if (B < 0 || B > 2147483647LL || n2 < 0 || Ns < 1 || Na < 0 || Nb < 0 ||
      L > 2147483647LL - 16 || vec < 1 || width > 16 ||
      (vec & (vec - 1)) != 0 || threads < kWarp || threads > kRowsThreads ||
      threads % kWarp != 0 || (order != 0 && order != 1) ||
      (order == 1 && n2 > 65535) || div_m < 0 || div_m > 4294967295LL ||
      div_l < 0 || div_l > 31 || reinterpret_cast<size_t>(out) % width != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool elem = Nb % vec != 0 ||
                    reinterpret_cast<size_t>(x) % width != 0 ||
                    reinterpret_cast<size_t>(t) % width != 0;
  const long long line = 128 / static_cast<long long>(width);
  const long long chunk = static_cast<long long>(threads) * unroll;
  const long long slots = (L + 2 * vec - 2) / vec;  // most slots a slab holds
  const long long chunks = (line - 1 + slots + chunk - 1) / chunk;
  if (chunks * chunk * vec > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const RowsArgs<T> a{x,
                      src,
                      s,
                      t,
                      out,
                      static_cast<int>(B),
                      n2,
                      Ns,
                      Na,
                      Nb,
                      static_cast<int>(chunks),
                      static_cast<unsigned>(div_m),
                      div_l,
                      order};
  if (vec == 1)
    return launch_rows_vec<T, 1>(a, elem, threads, unroll, stream);
  if (vec == 2)
    return launch_rows_vec<T, 2>(a, elem, threads, unroll, stream);
  if constexpr (sizeof(T) == 4) {
    if (vec == 4)
      return launch_rows_vec<T, 4>(a, elem, threads, unroll, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int VEC, bool kAdd>
int launch_reduce_vec(const T* Y, const int* src, const T* s, const T* t,
                      T* out, int B, int n2, int Ns, int Na, int Nb,
                      int rows, int threads, int r0, cudaStream_t stream) {
  const int n_chunks = (n2 + kWarp - 1) / kWarp;
  const size_t smem =
      static_cast<size_t>(rows) * n2 * (sizeof(long long) + sizeof(T) + 4) +
      static_cast<size_t>(rows) * (n_chunks + 1) * 4;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Na + rows - 1) / rows);
  gather_reduce_kernel<T, VEC, kAdd><<<grid, threads, smem, stream>>>(
      Y, src, s, t, out, B, n2, Ns, Na, Nb, rows, r0);
  return static_cast<int>(cudaGetLastError());
}

// gather_reduce (kAdd false, r0 0) and scatter_rows (kAdd true)
template <typename T, bool kAdd>
int launch_gather_reduce(const T* Y, const int* src, const T* s, const T* t,
                         T* out, long long B, int n2, int Ns, int Na, int Nb,
                         int vec, int rows, int threads, int r0,
                         cudaStream_t stream) {
  if (B == 0 || Na == 0 || Nb == 0) return static_cast<int>(cudaSuccess);
  constexpr int kVec = 16 / sizeof(T);
  if (B * Nb > 2147483647LL || rows < 1 || threads < kWarp ||
      threads > kMaxThreads || threads % kWarp != 0 ||
      (vec != 1 && vec != kVec) || Nb % vec != 0 || r0 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int b = static_cast<int>(B);
  if (vec == 1)
    return launch_reduce_vec<T, 1, kAdd>(Y, src, s, t, out, b, n2, Ns, Na,
                                         Nb, rows, threads, r0, stream);
  return launch_reduce_vec<T, kVec, kAdd>(Y, src, s, t, out, b, n2, Ns, Na,
                                          Nb, rows, threads, r0, stream);
}

template <typename T, int RW, int U>
int launch_cols(const ColsArgs<T>& p, int warps, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(warps) * RW * p.tile * sizeof(T);
  const long long gy = (p.Na + warps * RW - 1) / (warps * RW);
  const long long gx = (p.Nc + p.tile - 1) / p.tile;
  if (smem > kMaxBlockSmem || gy > 65535 || gx > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = gather_reduce_cols_kernel<T, RW, U>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned int>(gx),
                  static_cast<unsigned int>(gy),
                  static_cast<unsigned int>(p.B));
  kern<<<grid, warps * kWarp, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// unroll U in {2, 4, 8}, at most 32 Y loads in flight per thread
template <typename T, int RW>
int launch_cols_rows(const ColsArgs<T>& p, int unroll, int warps,
                     cudaStream_t stream) {
  switch (unroll) {
    case 2:
      return launch_cols<T, RW, 2>(p, warps, stream);
    case 4:
      return launch_cols<T, RW, 4>(p, warps, stream);
    case 8:
      if constexpr (RW <= 4) return launch_cols<T, RW, 8>(p, warps, stream);
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_gather_reduce_cols(const ColsArgs<T>& p, int rows, int unroll,
                              int warps, cudaStream_t stream) {
  if (p.B == 0 || p.Na == 0 || p.Nc == 0)
    return static_cast<int>(cudaSuccess);
  if (p.B < 0 || p.B > 65535 || p.tile < 1 || p.tile > 32767 || warps < 1 ||
      warps * kWarp > kColsThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (rows) {
    case 1:
      return launch_cols_rows<T, 1>(p, unroll, warps, stream);
    case 2:
      return launch_cols_rows<T, 2>(p, unroll, warps, stream);
    case 4:
      return launch_cols_rows<T, 4>(p, unroll, warps, stream);
    case 8:
      return launch_cols_rows<T, 8>(p, unroll, warps, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// gather_two_spin's dynamic shared memory: the row, the alpha entries
// and, staged, two buffers of a warp's table columns per warp
template <typename T, typename Idx>
size_t two_spin_smem(int Nb, int line, int vec, int threads, int pairs,
                     bool staged) {
  const int line_e = line / static_cast<int>(sizeof(T));
  const int slots = Nb / vec + line_e / vec;
  const int u = two_spin_unroll(vec, sizeof(T));
  const int rounds = (slots + u * threads - 1) / (u * threads);
  const size_t width = two_spin_width(kWarp * u * rounds * vec, line_e);
  return ((static_cast<size_t>(Nb) * sizeof(T) + 15) & ~size_t(15)) +
         ((4 * static_cast<size_t>(pairs) + 15) & ~size_t(15)) +
         (staged ? 2 * width * (threads / kWarp) * (sizeof(Idx) + 1) : 0);
}

template <typename T, typename Idx, int VEC>
int launch_two_spin_vec(const TwoSpinArgs<T, Idx>& a, long long rows,
                        int threads, bool staged, cudaStream_t stream) {
  const size_t smem = two_spin_smem<T, Idx>(a.Nb, a.line, VEC, threads,
                                            a.pairs, staged);
  if (smem > kMaxBlockSmem || rows > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = staged ? gather_two_spin_kernel<T, Idx, VEC, true>
                     : gather_two_spin_kernel<T, Idx, VEC, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned int>(rows),
                  (a.n2 + a.pairs - 1) / a.pairs);
  kern<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Idx>
int launch_two_spin_idx(const TwoSpinArgs<T, Idx>& a, long long rows,
                        int vec, int threads, bool staged,
                        cudaStream_t stream) {
  if (vec == 1)
    return launch_two_spin_vec<T, Idx, 1>(a, rows, threads, staged, stream);
  if (vec == 2)
    return launch_two_spin_vec<T, Idx, 2>(a, rows, threads, staged, stream);
  if constexpr (sizeof(T) == 4) {
    if (vec == 4)
      return launch_two_spin_vec<T, Idx, 4>(a, rows, threads, staged,
                                            stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_gather_two_spin(const T* x, const int* srcA,
                           const signed char* codeA, const void* srcB,
                           const signed char* codeB, T* out, long long B,
                           int n2, int Na, int Nb, int Nbp, int r0, int R,
                           int idx_bytes, int vec, int threads, int pairs,
                           int staged, int line, cudaStream_t stream) {
  if (B == 0 || n2 == 0 || Nb == 0) return static_cast<int>(cudaSuccess);
  if (B < 0 || n2 < 0 || Nb < 0 || R < 1 || r0 < 0 ||
      r0 + static_cast<long long>(R) > Na || Na >= (1 << 27) || vec < 1 ||
      Nb % vec != 0 || Nbp < Nb || Nbp % 16 != 0 || threads < kWarp ||
      threads > kTwoSpinThreads || threads % kWarp != 0 || pairs < 1 ||
      (n2 + pairs - 1) / pairs > 65535 || (staged != 0 && staged != 1) ||
      line < 16 || line > 1024 || (line & (line - 1)) != 0 ||
      (idx_bytes != 2 && idx_bytes != 4) || (idx_bytes == 2 && Nb > 32767))
    return static_cast<int>(cudaErrorInvalidValue);
  if (idx_bytes == 2) {
    const TwoSpinArgs<T, short> a{
        x,  srcA, codeA, static_cast<const short*>(srcB), codeB, out,
        n2, Na,   Nb,    Nbp, r0, R, pairs, line};
    return launch_two_spin_idx<T, short>(a, B * R, vec, threads, staged != 0,
                                         stream);
  }
  const TwoSpinArgs<T, int> a{
      x,  srcA, codeA, static_cast<const int*>(srcB), codeB, out,
      n2, Na,   Nb,    Nbp, r0, R, pairs, line};
  return launch_two_spin_idx<T, int>(a, B * R, vec, threads, staged != 0,
                                     stream);
}

}  // namespace

extern "C" {

int grid_gather_two_spin_f64(const double* x, const int* srcA,
                             const signed char* codeA, const void* srcB,
                             const signed char* codeB, double* out,
                             long long B, int n2, int Na, int Nb, int Nbp,
                             int r0, int R, int idx_bytes, int vec,
                             int threads, int pairs, int staged, int line,
                             void* stream) {
  return launch_gather_two_spin<double>(
      x, srcA, codeA, srcB, codeB, out, B, n2, Na, Nb, Nbp, r0, R, idx_bytes,
      vec, threads, pairs, staged, line, static_cast<cudaStream_t>(stream));
}

int grid_gather_two_spin_f32(const float* x, const int* srcA,
                             const signed char* codeA, const void* srcB,
                             const signed char* codeB, float* out,
                             long long B, int n2, int Na, int Nb, int Nbp,
                             int r0, int R, int idx_bytes, int vec,
                             int threads, int pairs, int staged, int line,
                             void* stream) {
  return launch_gather_two_spin<float>(
      x, srcA, codeA, srcB, codeB, out, B, n2, Na, Nb, Nbp, r0, R, idx_bytes,
      vec, threads, pairs, staged, line, static_cast<cudaStream_t>(stream));
}

int grid_gather_rows_scaled_f64(const double* x, const int* src,
                                const double* s, const double* t,
                                double* out, long long B, int n2, int Ns,
                                int Na, int Nb, int vec, int threads,
                                int unroll, int order, long long div_m,
                                int div_l, void* stream) {
  return launch_gather_rows_scaled<double>(
      x, src, s, t, out, B, n2, Ns, Na, Nb, vec, threads, unroll, order,
      div_m, div_l, static_cast<cudaStream_t>(stream));
}

int grid_gather_rows_scaled_f32(const float* x, const int* src,
                                const float* s, const float* t, float* out,
                                long long B, int n2, int Ns, int Na, int Nb,
                                int vec, int threads, int unroll, int order,
                                long long div_m, int div_l, void* stream) {
  return launch_gather_rows_scaled<float>(
      x, src, s, t, out, B, n2, Ns, Na, Nb, vec, threads, unroll, order,
      div_m, div_l, static_cast<cudaStream_t>(stream));
}

int grid_gather_reduce_f64(const double* Y, const int* src, const double* s,
                           const double* t, double* out, long long B, int n2,
                           int Ns, int Na, int Nb, int vec, int rows,
                           int threads, void* stream) {
  return launch_gather_reduce<double, false>(
      Y, src, s, t, out, B, n2, Ns, Na, Nb, vec, rows, threads, 0,
      static_cast<cudaStream_t>(stream));
}

int grid_gather_reduce_f32(const float* Y, const int* src, const float* s,
                           const float* t, float* out, long long B, int n2,
                           int Ns, int Na, int Nb, int vec, int rows,
                           int threads, void* stream) {
  return launch_gather_reduce<float, false>(
      Y, src, s, t, out, B, n2, Ns, Na, Nb, vec, rows, threads, 0,
      static_cast<cudaStream_t>(stream));
}

int grid_scatter_rows_f64(const double* Y, const int* src, const double* s,
                          const double* t, double* acc, long long B, int n2,
                          int Ns, int Na, int Nb, int vec, int rows,
                          int threads, int r0, void* stream) {
  return launch_gather_reduce<double, true>(
      Y, src, s, t, acc, B, n2, Ns, Na, Nb, vec, rows, threads, r0,
      static_cast<cudaStream_t>(stream));
}

int grid_scatter_rows_f32(const float* Y, const int* src, const float* s,
                          const float* t, float* acc, long long B, int n2,
                          int Ns, int Na, int Nb, int vec, int rows,
                          int threads, int r0, void* stream) {
  return launch_gather_reduce<float, true>(
      Y, src, s, t, acc, B, n2, Ns, Na, Nb, vec, rows, threads, r0,
      static_cast<cudaStream_t>(stream));
}

int grid_gather_reduce_cols_f64(
    const double* Y, const int* lsrc, const short* lcol,
    const signed char* lsgn, const int* lpair, const int* lstart,
    const double* t, double* out, long long B, int n2, int Na, int Ns, int Nc,
    int tile, int rows, int unroll, int warps, int add, void* stream) {
  const ColsArgs<double> p{Y,  lsrc, lcol, lsgn, lpair, lstart, t,   out,
                           B,  n2,   Na,   Ns,   Nc,    tile,   add};
  return launch_gather_reduce_cols<double>(p, rows, unroll, warps,
                                           static_cast<cudaStream_t>(stream));
}

int grid_gather_reduce_cols_f32(
    const float* Y, const int* lsrc, const short* lcol,
    const signed char* lsgn, const int* lpair, const int* lstart,
    const float* t, float* out, long long B, int n2, int Na, int Ns, int Nc,
    int tile, int rows, int unroll, int warps, int add, void* stream) {
  const ColsArgs<float> p{Y,  lsrc, lcol, lsgn, lpair, lstart, t,   out,
                          B,  n2,   Na,   Ns,   Nc,    tile,   add};
  return launch_gather_reduce_cols<float>(p, rows, unroll, warps,
                                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"
