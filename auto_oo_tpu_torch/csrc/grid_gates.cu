// String-grid gate kernels for Hopper (sm_90a), double and float: the
// gate steps of the sector circuits' sweeps, in place.
//
// Built by auto_oo_tpu_torch/ops/gate_kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface (loaded with ctypes).
// Every entry point launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError() of its launches.
//
// A gate of simulator/grid_program.py rotates ka x kb element pairs of a
// grid X (Na, Nb), row-major: pair (k, l) joins
//   X[rs[k], cs[l]]  and  X[rd[k], cd[l]]      with sign sA[k] * sB[l],
// rs/rd (ka) and cs/cd (kb) int32 tables.  On an identity axis the table
// is null and pair k's row (l's column) is k (l): a beta-identity gate
// moves whole rows (kb = Nb), an alpha-identity gate pairs columns inside
// every row (ka = Na), a subgrid gate has both tables.  Operands are
// batches of grids (L lanes x M grids a lane, strided); a lane's (cos,
// sin) is read from device memory, so no host value enters a launch.
//
// gate_rotate:  (a, b) <- (c a - ss b, ss a + c b), ss = sA sB s, on the
//   gate's pairs of every grid of X (s negated for the inverse rotation).
//   Subgrid gates take the rotation as an added delta, a + ((c - 1) a -
//   ss b), as the functional step of grid_program.py does.
// gate_generator_add:  Dst += coef G Src, G the rotation's generator,
//   (a, b) -> (-sg b, sg a): Dst_a += (-sg coef) Src_b, Dst_b += (sg coef)
//   Src_a, coef read from device memory (times +-1).
// gate_adjoint_step:  one reverse-sweep step of simulator/program.py's
//   pair_row and hessian_dot over (P, Q) and, where live, (D, E): P and E
//   one grid a lane, D and Q nt grids a lane.  In one pass over the pairs
//   it sums, per lane and tangent t, <Q_t, G P> + <E, G D_t> at the
//   post-gate states and adds h times it to out[lane, t]; applies the
//   inverse rotation to every operand; and for the tangent ti adds coef G
//   P' into D_ti and coef G E' into Q_ti (P', E' rotated).
//
// Replaces no TPU kernel: the JAX package runs these steps as XLA gathers
// and scatters inside one lax.scan (auto_oo_tpu/simulator/program.py,
// grid_program.py), and the port's functional step (index_select,
// elementwise temporaries, then two out-of-place index_copy / index_add,
// each a clone of the whole operand) made two copies of the operand per
// step.
//
// Bound: bytes.  Every touched element of every operand read once and
// written once, the read-only operand of gate_generator_add read once, the
// tables once: 2 x touched x itemsize per rotated operand
// (gate_kernels.gate_bytes).  An np_fabric layer touches 0.40 of the grid
// per gate on average ((14e,14o): 39 gates, 15.9 grids; (16e,16o): 45
// gates, 18.1 grids).
// Design.  A block owns one row pair k of one lane (one grid of a batch in
// gate_rotate), its 256 threads take the kb column pairs, one thread per
// pair: the pairs of a gate are disjoint (GridGateProgram checks it at
// construction), so the update in place races with nothing.  On a
// beta-identity gate the columns are the row itself and each thread moves
// a 16-byte vector of contiguous elements of both rows (8 bytes where Nb
// or the pointers allow no more); elsewhere each thread gathers its pair's
// two elements through the column tables, which run in long ascending
// stretches, so a warp's loads stay coalesced.  gate_adjoint_step loads
// P and E once per pair and walks the tangents t inside the thread (up to
// 16 at a time, re-reading P and E for each further 16), so P and E cross
// memory once on the cells' shapes (nt = 14).  Its dot products add up in
// one shared-memory slot per thread and tangent, then a fixed-order tree
// per block writes one partial sum per (lane, t, k); a second launch sums
// a (lane, t)'s partials in a fixed order and adds h times the sum to out.
// No atomics: a sweep gives the same bits on every run.  Products and sums
// of the rotations and generator terms are rounded one by one (__dmul_rn
// / __dadd_rn: nvcc would otherwise contract them into FMAs) in the
// functional step's order, so they equal the plain versions as values.
// 64-bit element offsets throughout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
// tangents a gate_adjoint_step block accumulates at once (shared memory
// CHUNK x THREADS elements: 32 KB in f64)
constexpr int CHUNK = 16;

template <typename T>
struct R;

template <>
struct R<double> {
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
};

template <>
struct R<float> {
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
};

template <typename T, int V>
struct __align__(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> ld(const T* p) {
  return *reinterpret_cast<const Vec<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void st(T* p, const Vec<T, V>& x) {
  *reinterpret_cast<Vec<T, V>*>(p) = x;
}

struct Gate {
  const int* rs;
  const int* rd;
  const int* cs;
  const int* cd;
  const int8_t* sA;
  const int8_t* sB;
  int kb;
  int Nb;
};

// the row offsets of row pair k (elements from the grid's start)
__device__ __forceinline__ void rows_of(const Gate& g, int k, long long& oa,
                                        long long& ob) {
  oa = static_cast<long long>(g.rs ? g.rs[k] : k) * g.Nb;
  ob = static_cast<long long>(g.rd ? g.rd[k] : k) * g.Nb;
}

// the columns of slot j (V > 1 only on an identity column axis)
template <int V>
__device__ __forceinline__ void cols_of(const Gate& g, int j, int& ca,
                                        int& cb) {
  const int l = j * V;
  ca = g.cs ? g.cs[l] : l;
  cb = g.cd ? g.cd[l] : l;
}

// rotate one pair: direct, or as an added delta (subgrid gates)
template <typename T>
__device__ __forceinline__ void rot(T& a, T& b, T c, T cm, T ss, bool delta) {
  if (delta) {
    const T da = R<T>::sub(R<T>::mul(cm, a), R<T>::mul(ss, b));
    const T db = R<T>::add(R<T>::mul(ss, a), R<T>::mul(cm, b));
    a = R<T>::add(a, da);
    b = R<T>::add(b, db);
  } else {
    const T na = R<T>::sub(R<T>::mul(c, a), R<T>::mul(ss, b));
    const T nb = R<T>::add(R<T>::mul(ss, a), R<T>::mul(c, b));
    a = na;
    b = nb;
  }
}

// Dst += coef G Src on one pair (cs = sign * coef)
template <typename T>
__device__ __forceinline__ void gen(T& da, T& db, T sa, T sb, T cs) {
  da = R<T>::add(da, R<T>::mul(-cs, sb));
  db = R<T>::add(db, R<T>::mul(cs, sa));
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    rotate_kernel(T* X, long long ls, long long ms, int M, Gate g,
                  const T* cp, const T* sp, int cstride, int sdir) {
  const int k = blockIdx.x;
  const int lane = blockIdx.y / M, m = blockIdx.y - lane * M;
  const T c = cp[static_cast<long long>(lane) * cstride];
  const T s0 = sp[static_cast<long long>(lane) * cstride];
  const T s = sdir < 0 ? -s0 : s0;
  const T cm = R<T>::sub(c, T(1));
  const bool delta = g.rs != nullptr && g.cs != nullptr;
  const T sa = T(g.sA[k]);
  long long oa, ob;
  rows_of(g, k, oa, ob);
  T* base = X + lane * ls + m * ms;
  for (int j = threadIdx.x; j < g.kb / V; j += THREADS) {
    int ca, cb;
    cols_of<V>(g, j, ca, cb);
    Vec<T, V> a = ld<T, V>(base + oa + ca);
    Vec<T, V> b = ld<T, V>(base + ob + cb);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const T ss = R<T>::mul(R<T>::mul(sa, T(g.sB[j * V + i])), s);
      rot(a.v[i], b.v[i], c, cm, ss, delta);
    }
    st<T, V>(base + oa + ca, a);
    st<T, V>(base + ob + cb, b);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    generator_kernel(T* Dst, long long dls, const T* Src, long long sls,
                     Gate g, const T* coefp, int scale) {
  const int k = blockIdx.x, lane = blockIdx.y;
  const T coef = scale < 0 ? -coefp[0] : coefp[0];
  const T sa = T(g.sA[k]);
  long long oa, ob;
  rows_of(g, k, oa, ob);
  T* D = Dst + lane * dls;
  const T* S = Src + lane * sls;
  for (int j = threadIdx.x; j < g.kb / V; j += THREADS) {
    int ca, cb;
    cols_of<V>(g, j, ca, cb);
    const Vec<T, V> xa = ld<T, V>(S + oa + ca), xb = ld<T, V>(S + ob + cb);
    Vec<T, V> a = ld<T, V>(D + oa + ca), b = ld<T, V>(D + ob + cb);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const T cs = R<T>::mul(R<T>::mul(sa, T(g.sB[j * V + i])), coef);
      gen(a.v[i], b.v[i], xa.v[i], xb.v[i], cs);
    }
    st<T, V>(D + oa + ca, a);
    st<T, V>(D + ob + cb, b);
  }
}

template <typename T>
struct Adjoint {
  T* P;
  long long Pl;
  T* E;  // null with D
  long long El;
  T* D;
  long long Dl, Dt;
  T* Q;
  long long Ql, Qt;
  int nt;
  const T* cp;
  const T* sp;
  int cstride;
  T* part;  // (L, nt, ka) partial sums; null: no dot product
  int ti;   // the generator's tangent, -1 for none
  const T* coefp;
  int scale;
};

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    adjoint_kernel(Adjoint<T> a, Gate g) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* acc = reinterpret_cast<T*>(smem);
  const int k = blockIdx.x, lane = blockIdx.y, tid = threadIdx.x;
  const int ka = gridDim.x;
  const T c = a.cp[static_cast<long long>(lane) * a.cstride];
  const T s = -a.sp[static_cast<long long>(lane) * a.cstride];
  const T cm = R<T>::sub(c, T(1));
  const bool delta = g.rs != nullptr && g.cs != nullptr;
  const bool dot = a.part != nullptr;
  T coef = T(0);
  if (a.ti >= 0) coef = a.scale < 0 ? -a.coefp[0] : a.coefp[0];
  const T sa = T(g.sA[k]);
  long long oa, ob;
  rows_of(g, k, oa, ob);
  T* P = a.P + lane * a.Pl;
  T* E = a.E ? a.E + lane * a.El : nullptr;
  T* D = a.D ? a.D + lane * a.Dl : nullptr;
  T* Q = a.Q + lane * a.Ql;
  const int slots = g.kb / V;
  int t0 = 0;
  do {
    const int n = min(CHUNK, a.nt - t0);
    const bool last = t0 + n >= a.nt;
    if (dot)
      for (int t = 0; t < n; ++t) acc[t * THREADS + tid] = T(0);
    for (int j = tid; j < slots; j += THREADS) {
      int ca, cb;
      cols_of<V>(g, j, ca, cb);
      T sg[V], ss[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        sg[i] = R<T>::mul(sa, T(g.sB[j * V + i]));
        ss[i] = R<T>::mul(sg[i], s);
      }
      const Vec<T, V> pa = ld<T, V>(P + oa + ca), pb = ld<T, V>(P + ob + cb);
      Vec<T, V> ea, eb;
      if (E) {
        ea = ld<T, V>(E + oa + ca);
        eb = ld<T, V>(E + ob + cb);
      }
      // the rotated P and E, which the generator terms read
      Vec<T, V> pa2 = pa, pb2 = pb, ea2 = ea, eb2 = eb;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        rot(pa2.v[i], pb2.v[i], c, cm, ss[i], delta);
        if (E) rot(ea2.v[i], eb2.v[i], c, cm, ss[i], delta);
      }
      for (int t = t0; t < t0 + n; ++t) {
        T* Qt = Q + t * a.Qt;
        Vec<T, V> qa = ld<T, V>(Qt + oa + ca), qb = ld<T, V>(Qt + ob + cb);
        T d = T(0);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if (dot) d += sg[i] * (qb.v[i] * pa.v[i] - qa.v[i] * pb.v[i]);
          rot(qa.v[i], qb.v[i], c, cm, ss[i], delta);
        }
        if (D) {
          T* Dt = D + t * a.Dt;
          Vec<T, V> da = ld<T, V>(Dt + oa + ca), db = ld<T, V>(Dt + ob + cb);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            if (dot) d += sg[i] * (eb.v[i] * da.v[i] - ea.v[i] * db.v[i]);
            rot(da.v[i], db.v[i], c, cm, ss[i], delta);
            if (t == a.ti)
              gen(da.v[i], db.v[i], pa2.v[i], pb2.v[i],
                  R<T>::mul(sg[i], coef));
          }
          st<T, V>(Dt + oa + ca, da);
          st<T, V>(Dt + ob + cb, db);
        }
        if (E && t == a.ti) {
#pragma unroll
          for (int i = 0; i < V; ++i)
            gen(qa.v[i], qb.v[i], ea2.v[i], eb2.v[i], R<T>::mul(sg[i], coef));
        }
        st<T, V>(Qt + oa + ca, qa);
        st<T, V>(Qt + ob + cb, qb);
        if (dot) acc[(t - t0) * THREADS + tid] += d;
      }
      if (last) {
        st<T, V>(P + oa + ca, pa2);
        st<T, V>(P + ob + cb, pb2);
        if (E) {
          st<T, V>(E + oa + ca, ea2);
          st<T, V>(E + ob + cb, eb2);
        }
      }
    }
    if (dot) {
      __syncthreads();
      for (int half = THREADS / 2; half > 0; half >>= 1) {
        for (int i = tid; i < n * half; i += THREADS) {
          const int t = i / half, r = i - t * half;
          acc[t * THREADS + r] += acc[t * THREADS + r + half];
        }
        __syncthreads();
      }
      if (tid < n)
        a.part[(static_cast<long long>(lane) * a.nt + t0 + tid) * ka + k] =
            acc[tid * THREADS];
      __syncthreads();
    }
    t0 += n;
  } while (t0 < a.nt);
}

// out[lane, t] += h * sum_k part[lane, t, k], summed in a fixed order
template <typename T>
__global__ void __launch_bounds__(THREADS)
    finish_kernel(const T* part, int ka, int nt, T* out, long long ol,
                  long long ot, T h) {
  __shared__ T red[THREADS];
  const int tid = threadIdx.x;
  const int lane = blockIdx.x / nt, t = blockIdx.x - lane * nt;
  const T* p = part + (static_cast<long long>(lane) * nt + t) * ka;
  T sum = T(0);
  for (int k = tid; k < ka; k += THREADS) sum += p[k];
  red[tid] = sum;
  __syncthreads();
  for (int half = THREADS / 2; half > 0; half >>= 1) {
    if (tid < half) red[tid] += red[tid + half];
    __syncthreads();
  }
  if (tid == 0) {
    T* o = out + lane * ol + t * ot;
    *o = R<T>::add(*o, R<T>::mul(h, red[0]));
  }
}

Gate make_gate(const int* rs, const int* rd, const int* cs, const int* cd,
               const int8_t* sA, const int8_t* sB, int kb, int Nb) {
  return Gate{rs, rd, cs, cd, sA, sB, kb, Nb};
}

template <typename T, int V>
int rotate_v(T* X, long long ls, long long ms, int L, int M, Gate g, int ka,
             const T* c, const T* s, int cstride, int sdir,
             cudaStream_t stream) {
  rotate_kernel<T, V><<<dim3(ka, L * M), THREADS, 0, stream>>>(
      X, ls, ms, M, g, c, s, cstride, sdir);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int rotate(T* X, long long ls, long long ms, int L, int M, Gate g, int ka,
           const T* c, const T* s, int cstride, int sdir, int vec,
           cudaStream_t stream) {
  switch (vec) {
    case 1:
      return rotate_v<T, 1>(X, ls, ms, L, M, g, ka, c, s, cstride, sdir,
                            stream);
    case 2:
      return rotate_v<T, 2>(X, ls, ms, L, M, g, ka, c, s, cstride, sdir,
                            stream);
    case 4:
      if constexpr (sizeof(T) == 4)
        return rotate_v<T, 4>(X, ls, ms, L, M, g, ka, c, s, cstride, sdir,
                              stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int V>
int generator_v(T* Dst, long long dls, const T* Src, long long sls, int L,
                Gate g, int ka, const T* coef, int scale,
                cudaStream_t stream) {
  generator_kernel<T, V><<<dim3(ka, L), THREADS, 0, stream>>>(
      Dst, dls, Src, sls, g, coef, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int generator(T* Dst, long long dls, const T* Src, long long sls, int L,
              Gate g, int ka, const T* coef, int scale, int vec,
              cudaStream_t stream) {
  switch (vec) {
    case 1:
      return generator_v<T, 1>(Dst, dls, Src, sls, L, g, ka, coef, scale,
                               stream);
    case 2:
      return generator_v<T, 2>(Dst, dls, Src, sls, L, g, ka, coef, scale,
                               stream);
    case 4:
      if constexpr (sizeof(T) == 4)
        return generator_v<T, 4>(Dst, dls, Src, sls, L, g, ka, coef, scale,
                                 stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int V>
int adjoint_v(const Adjoint<T>& a, int L, Gate g, int ka,
              cudaStream_t stream) {
  const size_t smem = a.part ? sizeof(T) * CHUNK * THREADS : 0;
  adjoint_kernel<T, V><<<dim3(ka, L), THREADS, smem, stream>>>(a, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int adjoint(T* P, long long Pl, T* E, long long El, T* D, long long Dl,
            long long Dt, T* Q, long long Ql, long long Qt, int L, int nt,
            Gate g, int ka, const T* c, const T* s, int cstride, T* part,
            T* out, long long ol, long long ot, double h, int ti,
            const T* coef, int scale, int vec, cudaStream_t stream) {
  const Adjoint<T> a{P,  Pl, E,       D ? El : 0, D,    Dl,        Dt,
                     Q,  Ql, Qt,      nt,         c,    s,         cstride,
                     out ? part : nullptr,        ti,   coef,      scale};
  int code;
  switch (vec) {
    case 1:
      code = adjoint_v<T, 1>(a, L, g, ka, stream);
      break;
    case 2:
      code = adjoint_v<T, 2>(a, L, g, ka, stream);
      break;
    case 4:
      if constexpr (sizeof(T) == 4) {
        code = adjoint_v<T, 4>(a, L, g, ka, stream);
        break;
      }
      return static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (code != 0 || out == nullptr || L * nt == 0) return code;
  finish_kernel<T><<<L * nt, THREADS, 0, stream>>>(part, ka, nt, out, ol, ot,
                                                     static_cast<T>(h));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define GATE_PARAMS                                                     \
  const int *rs, const int *rd, const int *cs, const int *cd,           \
      const int8_t *sA, const int8_t *sB, int ka, int kb, int Nb
#define GATE make_gate(rs, rd, cs, cd, sA, sB, kb, Nb)

#define ENTRY_POINTS(T, SFX)                                                 \
  extern "C" int grid_gate_rotate_##SFX(                                     \
      T* X, long long ls, long long ms, int L, int M, GATE_PARAMS,           \
      const T* c, const T* s, int cstride, int sdir, int vec,                \
      void* stream) {                                                        \
    return rotate<T>(X, ls, ms, L, M, GATE, ka, c, s, cstride, sdir, vec,    \
                     static_cast<cudaStream_t>(stream));                     \
  }                                                                          \
  extern "C" int grid_gate_generator_add_##SFX(                              \
      T* Dst, long long dls, const T* Src, long long sls, int L,             \
      GATE_PARAMS, const T* coef, int scale, int vec, void* stream) {        \
    return generator<T>(Dst, dls, Src, sls, L, GATE, ka, coef, scale, vec,   \
                        static_cast<cudaStream_t>(stream));                  \
  }                                                                          \
  extern "C" int grid_gate_adjoint_step_##SFX(                               \
      T* P, long long Pl, T* E, long long El, T* D, long long Dl,            \
      long long Dt, T* Q, long long Ql, long long Qt, int L, int nt,         \
      GATE_PARAMS, const T* c, const T* s, int cstride, T* part, T* out,     \
      long long ol, long long ot, double h, int ti, const T* coef,           \
      int scale, int vec, void* stream) {                                    \
    return adjoint<T>(P, Pl, E, El, D, Dl, Dt, Q, Ql, Qt, L, nt, GATE, ka,   \
                      c, s, cstride, part, out, ol, ot, h, ti, coef, scale,  \
                      vec, static_cast<cudaStream_t>(stream));               \
  }

ENTRY_POINTS(double, f64)
ENTRY_POINTS(float, f32)
