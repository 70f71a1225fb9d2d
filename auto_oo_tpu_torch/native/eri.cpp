// Native two-electron-integral engine (McMurchie-Davidson).
//
// This is the framework's replacement for the libcint (C) capability the
// reference consumed through PySCF: cartesian (ab|cd) shell-quartet ERIs
// over contracted Gaussians, exposed through a C ABI consumed via ctypes
// (auto_oo_tpu/native/__init__.py).  The Python engine in
// moldata/integrals.py is the always-available reference implementation;
// this one is the production path for polarized bases.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libaoeri.so eri.cpp
//
// Conventions match the Python engine exactly:
//  * cartesian components of shell l ordered (lx descending, then ly),
//  * contraction coefficients passed in PRE-NORMALIZED form (primitive
//    norms folded in by the caller),
//  * output written as the full cartesian tensor with 8-fold symmetry
//    scatter, chemist ordering (ab|cd).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int LMAX = 6;         // max total angular momentum per pair
constexpr double PI = 3.14159265358979323846;

// ---------------------------------------------------------------- Boys --
// F_n(x) for n = 0..nmax.  Series + downward recursion for small x,
// asymptotic + upward recursion for large x.
void boys(int nmax, double x, double* out) {
    if (x < 1e-13) {
        for (int n = 0; n <= nmax; ++n) out[n] = 1.0 / (2 * n + 1);
        return;
    }
    if (x < 35.0) {
        // F_nmax by series: e^{-x} sum_k (2x)^k / (2nmax+1)(2nmax+3)...(2nmax+2k+1)
        double s = 1.0 / (2 * nmax + 1);
        double term = s;
        for (int k = 1; k < 200; ++k) {
            term *= 2.0 * x / (2 * nmax + 2 * k + 1);
            s += term;
            if (term < 1e-17 * s) break;
        }
        double ex = std::exp(-x);
        out[nmax] = s * ex;
        for (int n = nmax - 1; n >= 0; --n)
            out[n] = (2.0 * x * out[n + 1] + ex) / (2 * n + 1);
    } else {
        double ex = std::exp(-x);
        out[0] = 0.5 * std::sqrt(PI / x) * std::erf(std::sqrt(x));
        for (int n = 0; n < nmax; ++n)
            out[n + 1] = ((2 * n + 1) * out[n] - ex) / (2.0 * x);
    }
}

// ------------------------------------------------- Hermite E coefficients
// E[i][j][t] for one dimension; i <= la, j <= lb, t <= i + j.
struct ETable {
    double e[LMAX + 1][LMAX + 1][2 * LMAX + 1];
    void build(int la, int lb, double a, double b, double AB) {
        double p = a + b;
        double mu = a * b / p;
        double Xpa = -b * AB / p;
        double Xpb = a * AB / p;
        std::memset(e, 0, sizeof(e));
        e[0][0][0] = std::exp(-mu * AB * AB);
        for (int i = 0; i <= la; ++i) {
            for (int j = 0; j <= lb; ++j) {
                if (i == 0 && j == 0) continue;
                int src_i = i, src_j = j;
                double X;
                if (j == 0) { src_i = i - 1; X = Xpa; }
                else { src_j = j - 1; X = Xpb; }
                double* dst = e[i][j];
                double* src = e[src_i][src_j];
                int nt_src = src_i + src_j;
                for (int t = 0; t <= nt_src + 1; ++t) {
                    double v = 0.0;
                    if (t >= 1) v += src[t - 1] / (2.0 * p);
                    if (t <= nt_src) v += X * src[t];
                    if (t + 1 <= nt_src) v += (t + 1) * src[t + 1];
                    dst[t] = v;
                }
            }
        }
    }
};

struct CartComp { int lx, ly, lz; };

int cart_components(int l, CartComp* out) {
    int n = 0;
    for (int lx = l; lx >= 0; --lx)
        for (int ly = l - lx; ly >= 0; --ly)
            out[n++] = {lx, ly, l - lx - ly};
    return n;
}

// R_{tuv}(alpha, PQ) for t+u+v <= L, via downward recursion in the Boys
// order n.
struct RTensor {
    int L;
    double r[2 * LMAX + 1][2 * LMAX + 1][2 * LMAX + 1];
    void build(int Lmax, double alpha, const double* PQ) {
        L = Lmax;
        double r2 = PQ[0] * PQ[0] + PQ[1] * PQ[1] + PQ[2] * PQ[2];
        double F[4 * LMAX + 1];
        boys(Lmax, alpha * r2, F);
        // R^n stored per level; level n holds entries with t+u+v <= L-n
        static thread_local double buf[2][2 * LMAX + 1][2 * LMAX + 1]
                                      [2 * LMAX + 1];
        int cur = 0;
        double pref = 1.0;
        // start from n = Lmax downward
        std::vector<double> base(Lmax + 1);
        for (int n = 0; n <= Lmax; ++n) {
            base[n] = pref * F[n];
            pref *= -2.0 * alpha;
        }
        // wrong: pref applies before F; fix below
        pref = 1.0;
        for (int n = 0; n <= Lmax; ++n) { base[n] = pref * F[n]; pref *= -2.0 * alpha; }
        buf[cur][0][0][0] = base[Lmax];
        for (int n = Lmax - 1; n >= 0; --n) {
            int nxt = 1 - cur;
            int lim = Lmax - n;
            for (int t = 0; t <= lim; ++t)
                for (int u = 0; u <= lim - t; ++u)
                    for (int v = 0; v <= lim - t - u; ++v) {
                        double val;
                        if (t == 0 && u == 0 && v == 0) {
                            val = base[n];
                        } else if (t > 0) {
                            val = PQ[0] * buf[cur][t - 1][u][v];
                            if (t > 1) val += (t - 1) * buf[cur][t - 2][u][v];
                        } else if (u > 0) {
                            val = PQ[1] * buf[cur][t][u - 1][v];
                            if (u > 1) val += (u - 1) * buf[cur][t][u - 2][v];
                        } else {
                            val = PQ[2] * buf[cur][t][u][v - 1];
                            if (v > 1) val += (v - 1) * buf[cur][t][u][v - 2];
                        }
                        buf[nxt][t][u][v] = val;
                    }
            cur = nxt;
        }
        for (int t = 0; t <= Lmax; ++t)
            for (int u = 0; u <= Lmax - t; ++u)
                for (int v = 0; v <= Lmax - t - u; ++v)
                    r[t][u][v] = buf[cur][t][u][v];
    }
};

struct Shell {
    int l, nprim;
    const double* exps;
    const double* coefs;   // pre-normalized
    const double* center;
    int cart_off;          // offset into the cartesian AO index space
    int ncart;
};

}  // namespace

extern "C" {

// shells: packed arrays; out: ncart_tot^4 buffer (caller-zeroed).
void aoeri_compute(
    int n_shells,
    const int32_t* ls,
    const int32_t* nprims,
    const int32_t* prim_offsets,
    const double* exps,
    const double* coefs,
    const double* centers,      // 3 * n_shells
    const int32_t* cart_offsets,
    int ncart_tot,
    double* out) {

    std::vector<Shell> sh(n_shells);
    for (int i = 0; i < n_shells; ++i) {
        CartComp tmp[28];
        sh[i] = {ls[i], nprims[i], exps + prim_offsets[i],
                 coefs + prim_offsets[i], centers + 3 * i,
                 cart_offsets[i], cart_components(ls[i], tmp)};
    }

    const int64_t N = ncart_tot;
    auto put = [&](int64_t a, int64_t b, int64_t c, int64_t d, double v) {
        out[((a * N + b) * N + c) * N + d] = v;
    };

    CartComp ca[28], cb[28], cc[28], cd[28];
    // per-pair Hermite tables: theta[ci*ncb+cj][k][t][u][v] flattened
    struct PairData {
        std::vector<double> theta;  // (nc1*nc2) * K * n1^3
        std::vector<double> p, Px, Py, Pz, cpair;
        int n1, K, ncart2;
    };

    auto build_pair = [&](const Shell& A, const Shell& B, PairData& pd) {
        int la = A.l, lb = B.l;
        int L = la + lb, n1 = L + 1;
        int K = A.nprim * B.nprim;
        int nca = cart_components(la, ca);
        int ncb = cart_components(lb, cb);
        pd.n1 = n1; pd.K = K; pd.ncart2 = nca * ncb;
        pd.theta.assign((size_t)nca * ncb * K * n1 * n1 * n1, 0.0);
        pd.p.resize(K); pd.Px.resize(K); pd.Py.resize(K); pd.Pz.resize(K);
        pd.cpair.resize(K);
        ETable ex, ey, ez;
        int k = 0;
        for (int ia = 0; ia < A.nprim; ++ia)
            for (int ib = 0; ib < B.nprim; ++ib, ++k) {
                double a = A.exps[ia], b = B.exps[ib];
                double p = a + b;
                pd.p[k] = p;
                pd.Px[k] = (a * A.center[0] + b * B.center[0]) / p;
                pd.Py[k] = (a * A.center[1] + b * B.center[1]) / p;
                pd.Pz[k] = (a * A.center[2] + b * B.center[2]) / p;
                pd.cpair[k] = A.coefs[ia] * B.coefs[ib];
                ex.build(la, lb, a, b, A.center[0] - B.center[0]);
                ey.build(la, lb, a, b, A.center[1] - B.center[1]);
                ez.build(la, lb, a, b, A.center[2] - B.center[2]);
                for (int ci = 0; ci < nca; ++ci)
                    for (int cj = 0; cj < ncb; ++cj) {
                        double* th = &pd.theta[
                            (((size_t)(ci * ncb + cj)) * K + k)
                            * n1 * n1 * n1];
                        for (int t = 0; t <= ca[ci].lx + cb[cj].lx; ++t)
                            for (int u = 0; u <= ca[ci].ly + cb[cj].ly; ++u)
                                for (int v = 0; v <= ca[ci].lz + cb[cj].lz;
                                     ++v)
                                    th[(t * n1 + u) * n1 + v] =
                                        ex.e[ca[ci].lx][cb[cj].lx][t]
                                        * ey.e[ca[ci].ly][cb[cj].ly][u]
                                        * ez.e[ca[ci].lz][cb[cj].lz][v];
                    }
            }
    };

    // cache pair data for all (i >= j)
    std::vector<PairData> pairs;
    std::vector<int> pair_idx(n_shells * n_shells, -1);
    for (int i = 0; i < n_shells; ++i)
        for (int j = 0; j <= i; ++j) {
            pair_idx[i * n_shells + j] = (int)pairs.size();
            pairs.emplace_back();
            build_pair(sh[i], sh[j], pairs.back());
        }

    RTensor R;
    std::vector<double> blk;
    for (int i = 0; i < n_shells; ++i)
    for (int j = 0; j <= i; ++j) {
        const PairData& ab = pairs[pair_idx[i * n_shells + j]];
        int Lab = sh[i].l + sh[j].l, n1a = Lab + 1;
        int ij = i * (i + 1) / 2 + j;
        for (int kk = 0; kk <= i; ++kk)
        for (int ll = 0; ll <= kk; ++ll) {
            int kl = kk * (kk + 1) / 2 + ll;
            if (kl > ij) continue;
            const PairData& cdp = pairs[pair_idx[kk * n_shells + ll]];
            int Lcd = sh[kk].l + sh[ll].l, n1c = Lcd + 1;
            int Ltot = Lab + Lcd;
            int nca = cart_components(sh[i].l, ca);
            int ncb = cart_components(sh[j].l, cb);
            int ncc = cart_components(sh[kk].l, cc);
            int ncd = cart_components(sh[ll].l, cd);
            blk.assign((size_t)nca * ncb * ncc * ncd, 0.0);

            for (int k1 = 0; k1 < ab.K; ++k1)
            for (int k2 = 0; k2 < cdp.K; ++k2) {
                double p = ab.p[k1], q = cdp.p[k2];
                double alpha = p * q / (p + q);
                double PQ[3] = {ab.Px[k1] - cdp.Px[k2],
                                ab.Py[k1] - cdp.Py[k2],
                                ab.Pz[k1] - cdp.Pz[k2]};
                R.build(Ltot, alpha, PQ);
                double pref = ab.cpair[k1] * cdp.cpair[k2]
                    * 2.0 * std::pow(PI, 2.5)
                    / (p * q * std::sqrt(p + q));
                for (int c1 = 0; c1 < nca * ncb; ++c1) {
                    const double* th1 = &ab.theta[
                        (((size_t)c1) * ab.K + k1) * n1a * n1a * n1a];
                    for (int c2 = 0; c2 < ncc * ncd; ++c2) {
                        const double* th2 = &cdp.theta[
                            (((size_t)c2) * cdp.K + k2) * n1c * n1c * n1c];
                        double acc = 0.0;
                        for (int t = 0; t < n1a; ++t)
                        for (int u = 0; u < n1a; ++u)
                        for (int v = 0; v < n1a; ++v) {
                            double e1 = th1[(t * n1a + u) * n1a + v];
                            if (e1 == 0.0) continue;
                            double inner = 0.0;
                            for (int tt = 0; tt < n1c; ++tt)
                            for (int uu = 0; uu < n1c; ++uu)
                            for (int vv = 0; vv < n1c; ++vv) {
                                double e2 = th2[(tt * n1c + uu) * n1c + vv];
                                if (e2 == 0.0) continue;
                                double sgn = ((tt + uu + vv) & 1) ? -1.0
                                                                  : 1.0;
                                inner += sgn * e2
                                    * R.r[t + tt][u + uu][v + vv];
                            }
                            acc += e1 * inner;
                        }
                        blk[(size_t)c1 * ncc * ncd + c2] += pref * acc;
                    }
                }
            }

            // scatter with 8-fold symmetry
            int oa = sh[i].cart_off, ob = sh[j].cart_off;
            int oc = sh[kk].cart_off, od = sh[ll].cart_off;
            for (int a = 0; a < nca; ++a)
            for (int b = 0; b < ncb; ++b)
            for (int c = 0; c < ncc; ++c)
            for (int d = 0; d < ncd; ++d) {
                double v = blk[(((size_t)a * ncb + b) * ncc + c) * ncd + d];
                put(oa + a, ob + b, oc + c, od + d, v);
                put(ob + b, oa + a, oc + c, od + d, v);
                put(oa + a, ob + b, od + d, oc + c, v);
                put(ob + b, oa + a, od + d, oc + c, v);
                put(oc + c, od + d, oa + a, ob + b, v);
                put(od + d, oc + c, oa + a, ob + b, v);
                put(oc + c, od + d, ob + b, oa + a, v);
                put(od + d, oc + c, ob + b, oa + a, v);
            }
        }
    }
}

}  // extern "C"
