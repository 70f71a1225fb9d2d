// Timing-only variants of the first gather_two_spin kernel (the one of
// commit 35542d0, before its redesign), for attributing its time on the
// card.  Built only by auto_oo_tpu_torch/scripts/sweep_two_spin.py
// (--attribute), never by a route; every variant but MODE 0 writes wrong
// values on purpose.
//
// The kernel: a block stages up to two grid rows of one state in shared
// memory, walks a range of pairs k, and for each (k, column vector) loads
// the beta tables (srcB int32, sgnB and tB int8), the alpha source row
// x[b, srcA[k, m], :] of each valid (k, m), reads the beta element inside
// the staged row, and writes Phi with streaming stores.  The variants,
// each on the same grid and plan:
//   0 as it ran (the reference the others are read against);
//   1 alpha_staged: the alpha loads read the block's staged row from
//     shared memory instead of x[b, srcA[k, m], :] (no re-read of source
//     rows from L2 or memory: cost 2);
//   2 no_tables: no beta table loads; the beta element of column j is the
//     staged row's element j, with signs +1 (costs 1 and 4 together);
//   3 no_conflicts: the tables are loaded as in 0, but the beta element is
//     read at column j, so the shared-memory reads are free of bank
//     conflicts (cost 4 alone);
//   4 staging_only: each block stages its rows and stops (cost 3);
//   5 write_only: no loads at all; every thread stores zeros with the
//     kernel's stores (the floor of writing Phi's bytes);
//   6 aligned_writes: as 5, but each row's stores shifted to start on a
//     128-byte line (the row's head left unwritten);
//   7 write_back: as 5, with default (write-back) stores in place of the
//     streaming ones.
//
// Built like grid_gather.cu (nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 -shared -Xcompiler -fPIC), plain C interface.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 512;
constexpr int kRows = 2;
constexpr size_t kMaxBlockSmem = 232448;

template <typename T, int VEC> struct Vec;
template <> struct Vec<double, 2> { using type = double2; };
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<double, 1> { using type = double; };
template <> struct Vec<float, 1> { using type = float; };

__device__ __forceinline__ void load_tab(const int* p, int (&o)[1]) {
  o[0] = __ldg(p);
}
__device__ __forceinline__ void load_tab(const int* p, int (&o)[2]) {
  const int2 v = __ldg(reinterpret_cast<const int2*>(p));
  o[0] = v.x;
  o[1] = v.y;
}
__device__ __forceinline__ void load_tab(const int* p, int (&o)[4]) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

template <int VEC> struct Signs;
template <> struct Signs<1> {
  signed char v;
  __device__ __forceinline__ void load(const signed char* p) { v = __ldg(p); }
  __device__ __forceinline__ void one() { v = 1; }
  __device__ __forceinline__ int operator[](int) const { return v; }
};
template <> struct Signs<2> {
  char2 v;
  __device__ __forceinline__ void load(const signed char* p) {
    v = __ldg(reinterpret_cast<const char2*>(p));
  }
  __device__ __forceinline__ void one() { v.x = v.y = 1; }
  __device__ __forceinline__ int operator[](int u) const {
    return u == 0 ? v.x : v.y;
  }
};
template <> struct Signs<4> {
  char4 v;
  __device__ __forceinline__ void load(const signed char* p) {
    v = __ldg(reinterpret_cast<const char4*>(p));
  }
  __device__ __forceinline__ void one() { v.x = v.y = v.z = v.w = 1; }
  __device__ __forceinline__ int operator[](int u) const {
    return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
  }
};

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
__device__ __forceinline__ void load_x(const float* p, float (&o)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
// VEC elements of a staged row in shared memory
template <typename T, int VEC>
__device__ __forceinline__ void load_s(const T* p, T (&o)[VEC]) {
#pragma unroll
  for (int u = 0; u < VEC; ++u) o[u] = p[u];
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
__device__ __forceinline__ void store_cs(float* p, const float (&o)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(o[0], o[1], o[2], o[3]));
}
// default (write-back) stores
__device__ __forceinline__ void store_wb(double* p, const double (&o)[1]) {
  *p = o[0];
}
__device__ __forceinline__ void store_wb(double* p, const double (&o)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(o[0], o[1]);
}
__device__ __forceinline__ void store_wb(float* p, const float (&o)[1]) {
  *p = o[0];
}
__device__ __forceinline__ void store_wb(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}

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

__host__ __device__ constexpr int two_spin_unroll(int vec, int rows) {
  return 8 / (vec * rows) > 1 ? 8 / (vec * rows) : 1;
}

template <int ROWS>
__device__ __forceinline__ void two_spin_scalars(
    const int* __restrict__ srcA, const signed char* __restrict__ sgnA,
    const signed char* __restrict__ tA, long long e, int n,
    int (&src)[ROWS], int (&sgn)[ROWS], int (&tt)[ROWS]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    sgn[r] = r < n ? __ldg(sgnA + e + r) : 0;
    src[r] = sgn[r] != 0 ? __ldg(srcA + e + r) : 0;
    tt[r] = r < n ? __ldg(tA + e + r) : 0;
  }
}

template <typename T, int VEC, int ROWS, int MODE>
__global__ void __launch_bounds__(kThreads, 2)
two_spin_variant(const T* __restrict__ x, const int* __restrict__ srcA,
                 const signed char* __restrict__ sgnA,
                 const signed char* __restrict__ tB,
                 const int* __restrict__ srcB,
                 const signed char* __restrict__ sgnB,
                 const signed char* __restrict__ tA, T* __restrict__ out,
                 int n2, int Na, int Nb, int r0, int R, int pairs) {
  constexpr int U = two_spin_unroll(VEC, ROWS);
  using V = typename Vec<T, VEC>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  const int groups = (R + ROWS - 1) / ROWS;
  const long long b = blockIdx.x / groups;
  const int m0 = static_cast<int>(blockIdx.x % groups) * ROWS;
  const int n_m = min(ROWS, R - m0);
  const int k0 = blockIdx.y * pairs;
  const int k1 = min(n2, k0 + pairs);
  const T* xb = x + b * Na * static_cast<long long>(Nb);

  if (MODE < 5) {
    const V* from = reinterpret_cast<const V*>(
        xb + static_cast<long long>(r0 + m0) * Nb);
    V* to = reinterpret_cast<V*>(xs);
    const int n = n_m * (Nb / VEC);
    for (int e = threadIdx.x; e < n; e += blockDim.x) to[e] = __ldg(from + e);
    __syncthreads();
  }
  if (MODE == 4) {
    // keep the staging: a value no random row holds
    if (xs[threadIdx.x % Nb] == T(-12345.678)) out[0] = xs[0];
    return;
  }

  int sa[ROWS], ga[ROWS], ta[ROWS], nsa[ROWS], nga[ROWS], nta[ROWS];
  const long long rowA = r0 + m0;
  if (MODE < 5)
    two_spin_scalars<ROWS>(srcA, sgnA, tA,
                           k0 * static_cast<long long>(Na) + rowA, n_m, nsa,
                           nga, nta);

  const int Nv = Nb / VEC;
  for (int k = k0; k < k1; ++k) {
    if (MODE < 5) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        sa[r] = nsa[r];
        ga[r] = nga[r];
        ta[r] = nta[r];
      }
      two_spin_scalars<ROWS>(srcA, sgnA, tA,
                             (k + 1) * static_cast<long long>(Na) + rowA,
                             k + 1 < k1 ? n_m : 0, nsa, nga, nta);
    }
    const long long kb = static_cast<long long>(k) * Nb;
    T* ok = out + ((b * n2 + k) * R + m0) * static_cast<long long>(Nb);
    for (int v0 = threadIdx.x; v0 < Nv; v0 += U * blockDim.x) {
      if (MODE >= 5) {
#pragma unroll
        for (int q = 0; q < U; ++q) {
          const int v = v0 + q * blockDim.x;
          if (v >= Nv) continue;
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            if (r >= n_m) continue;
            T o[VEC];
#pragma unroll
            for (int u = 0; u < VEC; ++u) o[u] = T(0);
            T* row = ok + static_cast<long long>(r) * Nb;
            if (MODE == 6) {
              // the row's stores shifted to start on a 128-byte line
              const int h = static_cast<int>(
                  ((128 - (reinterpret_cast<size_t>(row) & 127)) & 127) /
                  sizeof(T));
              if (h + (v + 1) * VEC <= Nb) store_cs(row + h + v * VEC, o);
            } else if (MODE == 7) {
              store_wb(row + v * VEC, o);
            } else {
              store_cs(row + v * VEC, o);
            }
          }
        }
        continue;
      }
      int sb[U][VEC];
      Signs<VEC> gb[U], tb[U];
      T xa[U][ROWS][VEC];
#pragma unroll
      for (int q = 0; q < U; ++q) {
        const int v = v0 + q * blockDim.x;
        if (MODE == 2) {
#pragma unroll
          for (int u = 0; u < VEC; ++u) sb[q][u] = v * VEC + u;
          gb[q].one();
          tb[q].one();
        } else if (v < Nv) {
          load_tab(srcB + kb + v * VEC, sb[q]);
          gb[q].load(sgnB + kb + v * VEC);
          tb[q].load(tB + kb + v * VEC);
          if (MODE == 3) {
            // keep the table load, read the staged row at column j
#pragma unroll
            for (int u = 0; u < VEC; ++u)
              sb[q][u] = sb[q][u] == -7 ? 0 : v * VEC + u;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < U; ++q) {
        const int v = v0 + q * blockDim.x;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (v < Nv && r < n_m && ga[r] != 0) {
            if (MODE == 1)
              load_s<T, VEC>(xs + r * Nb + v * VEC, xa[q][r]);
            else
              load_x(xb + static_cast<long long>(sa[r]) * Nb + v * VEC,
                     xa[q][r]);
          } else {
#pragma unroll
            for (int u = 0; u < VEC; ++u) xa[q][r][u] = T(0);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < U; ++q) {
        const int v = v0 + q * blockDim.x;
        if (v >= Nv) continue;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (r >= n_m) continue;
          const T* xr = xs + r * Nb;
          const T gar = T(ga[r]), tar = T(ta[r]);
          T o[VEC];
#pragma unroll
          for (int u = 0; u < VEC; ++u) {
            const T alpha = ga[r] != 0
                                ? mul_rn(mul_rn(xa[q][r][u], gar),
                                         T(tb[q][u]))
                                : T(0);
            const T beta = mul_rn(mul_rn(xr[sb[q][u]], T(gb[q][u])), tar);
            o[u] = add_rn(alpha, beta);
          }
          store_cs(ok + static_cast<long long>(r) * Nb + v * VEC, o);
        }
      }
    }
  }
}

template <typename T, int VEC, int ROWS, int MODE>
int launch_mode(const T* x, const int* srcA, const signed char* sgnA,
                const signed char* tB, const int* srcB,
                const signed char* sgnB, const signed char* tA, T* out,
                long long B, int n2, int Na, int Nb, int r0, int R,
                int threads, int pairs, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(ROWS) * Nb * sizeof(T);
  const long long gx = B * ((R + ROWS - 1) / ROWS);
  if (smem > kMaxBlockSmem || gx > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = two_spin_variant<T, VEC, ROWS, MODE>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned int>(gx), (n2 + pairs - 1) / pairs);
  kern<<<grid, threads, smem, stream>>>(x, srcA, sgnA, tB, srcB, sgnB, tA,
                                        out, n2, Na, Nb, r0, R, pairs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC, int ROWS>
int launch_rows(int mode, const T* x, const int* srcA,
                const signed char* sgnA, const signed char* tB,
                const int* srcB, const signed char* sgnB,
                const signed char* tA, T* out, long long B, int n2, int Na,
                int Nb, int r0, int R, int threads, int pairs,
                cudaStream_t s) {
#define TWO_SPIN_MODE(M)                                                    \
  case M:                                                                   \
    return launch_mode<T, VEC, ROWS, M>(x, srcA, sgnA, tB, srcB, sgnB, tA, \
                                        out, B, n2, Na, Nb, r0, R, threads, \
                                        pairs, s);
  switch (mode) {
    TWO_SPIN_MODE(0)
    TWO_SPIN_MODE(1)
    TWO_SPIN_MODE(2)
    TWO_SPIN_MODE(3)
    TWO_SPIN_MODE(4)
    TWO_SPIN_MODE(5)
    TWO_SPIN_MODE(6)
    TWO_SPIN_MODE(7)
  }
#undef TWO_SPIN_MODE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_variant(int mode, const T* x, const int* srcA,
                   const signed char* sgnA, const signed char* tB,
                   const int* srcB, const signed char* sgnB,
                   const signed char* tA, T* out, long long B, int n2,
                   int Na, int Nb, int r0, int R, int vec, int rows,
                   int threads, int pairs, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  if (B < 1 || R < 1 || r0 < 0 || r0 + static_cast<long long>(R) > Na ||
      (vec != 1 && vec != kVec) || Nb % vec != 0 ||
      (rows != 1 && rows != kRows) || threads < kWarp || threads > kThreads ||
      threads % kWarp != 0 || pairs < 1 || (n2 + pairs - 1) / pairs > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 1) {
    if (rows == 1)
      return launch_rows<T, 1, 1>(mode, x, srcA, sgnA, tB, srcB, sgnB, tA,
                                  out, B, n2, Na, Nb, r0, R, threads, pairs,
                                  s);
    return launch_rows<T, 1, kRows>(mode, x, srcA, sgnA, tB, srcB, sgnB, tA,
                                    out, B, n2, Na, Nb, r0, R, threads, pairs,
                                    s);
  }
  if (rows == 1)
    return launch_rows<T, kVec, 1>(mode, x, srcA, sgnA, tB, srcB, sgnB, tA,
                                   out, B, n2, Na, Nb, r0, R, threads, pairs,
                                   s);
  return launch_rows<T, kVec, kRows>(mode, x, srcA, sgnA, tB, srcB, sgnB, tA,
                                     out, B, n2, Na, Nb, r0, R, threads,
                                     pairs, s);
}

}  // namespace

extern "C" {

int two_spin_variant_f64(int mode, const double* x, const int* srcA,
                         const signed char* sgnA, const signed char* tB,
                         const int* srcB, const signed char* sgnB,
                         const signed char* tA, double* out, long long B,
                         int n2, int Na, int Nb, int r0, int R, int vec,
                         int rows, int threads, int pairs, void* stream) {
  return launch_variant<double>(mode, x, srcA, sgnA, tB, srcB, sgnB, tA, out,
                                B, n2, Na, Nb, r0, R, vec, rows, threads,
                                pairs, static_cast<cudaStream_t>(stream));
}

int two_spin_variant_f32(int mode, const float* x, const int* srcA,
                         const signed char* sgnA, const signed char* tB,
                         const int* srcB, const signed char* sgnB,
                         const signed char* tA, float* out, long long B,
                         int n2, int Na, int Nb, int r0, int R, int vec,
                         int rows, int threads, int pairs, void* stream) {
  return launch_variant<float>(mode, x, srcA, sgnA, tB, srcB, sgnB, tA, out,
                               B, n2, Na, Nb, r0, R, vec, rows, threads,
                               pairs, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
