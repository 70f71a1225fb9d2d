"""Where the time goes in one (16e,16o) damped-Newton iteration on the card.

    python -m auto_oo_tpu_torch.scripts.profile_16e16o

Builds the H16 chain of scripts/demo_16e16o.py (sto-3g, np_fabric L=1,
freeze_active, f64, D = 165,636,900; the hosted route) and takes one NR
iteration from the demo's theta0 = 0.02 * arange(n_theta) apart on the
host clock (each part ends in a synchronize): the whole iteration
(grad_hess, then the Newton update with its line-search energies), its
peak and reserved device memory and its kernel launches; then the parts
of a grad_hess one at a time: the state sweep, the (H psi, RDMs) pass,
and per tangent the pair sweep, the H-apply pass and the reverse pair
sweep, each summed over the tangents.  Then it runs the iteration again
under torch.profiler (device time by kernel and by op, and the busy share
against the unprofiled wall).  Needs a card; prints the card's name and
power limit first.
"""

import subprocess
import sys
import time

import torch

import auto_oo_tpu_torch as P
from auto_oo_tpu_torch.ops import cuda_build
from auto_oo_tpu_torch.ops import grid_hosted as _gh
from auto_oo_tpu_torch.ops import grid_kernels as _gk
from auto_oo_tpu_torch.ops import hamiltonian as _ham
from auto_oo_tpu_torch.ops import transforms as _tr
from auto_oo_tpu_torch.scripts.demo_16e16o import GEOMETRY, STEP
from auto_oo_tpu_torch.scripts.profile_14e14o import _timed, device_profile


def parts_of_grad_hess(oo, theta, parts):
    """The hosted grad_hess's parts (n_kappa = 0 here: the per-tangent
    pass is the H-apply alone), each tangent's summed by kind."""
    pqc, plan, maps, ncas = oo.pqc, oo._core["plan"], oo.pqc.sector_maps, \
        oo.ncas
    mo = oo.oao_coeff @ oo.oao_mo_coeff
    h1 = _tr.int1e_transform(oo.int1e_ao, mo)
    g2 = _tr.int2e_transform(oo.int2e_ao, mo)
    _, c1, c2 = _tr.molecular_hamiltonian_coefficients(
        oo.nuc, h1, g2, oo._occ, oo._act)
    c1eff = _ham.c1_effective(c1, c2)
    psi = _timed("state sweep", lambda: pqc._state_impl_grid(theta), parts)
    Hpsi = _timed("(H psi, RDMs) pass", lambda: _gh.ham_and_rdms_hosted(
        c1eff, c2, psi, maps, ncas, plan.row_chunk)[0], parts)
    sums = {"pair sweeps (J_i)": 0.0, "H J_i passes": 0.0,
            "reverse pair sweeps (rows)": 0.0}
    peaks = dict.fromkeys(sums, 0)
    for i in range(pqc.theta_shape):
        v = torch.zeros_like(theta)
        v[i] = 1.0
        each = []

        def part(fn):
            torch.cuda.reset_peak_memory_stats()
            out = _timed("", fn, each)
            each[-1] = (each[-1][1], torch.cuda.max_memory_allocated())
            return out

        Ji = part(lambda: pqc._pair_state_grid(theta, v)[1])
        HJi = part(lambda: _gh.ham_apply_hosted(c1eff, c2, Ji, maps,
                                                plan.row_chunk))
        part(lambda: pqc._pair_row_grid(theta, v, HJi, Hpsi, psi, Ji))
        del Ji, HJi
        for key, (sec, peak) in zip(sums, each):
            sums[key] += sec
            peaks[key] = max(peaks[key], peak)
    parts.extend(sums.items())
    print("  peak device memory by part: " + ", ".join(
        f"{key} {peak / 1e9:.3f} GB" for key, peak in peaks.items()))


def chunk_memory(oo, x):
    """Device memory allocated after each step of one scatter-form chunk
    (the middle one) of an H-apply of x, and the step's peak above the
    memory before the chunk (no c1eff x term: the buffers are what
    counts)."""
    from auto_oo_tpu_torch.ops import grid as _grid

    maps = oo.pqc.sector_maps
    chunks = _grid._row_chunks(maps.Na, oo._core["plan"].row_chunk)
    r0, r1 = chunks[len(chunks) // 2]
    xg = x.reshape(maps.Na, maps.Nb)
    acc = torch.zeros_like(xg)
    C2 = torch.eye(maps.n2, dtype=x.dtype, device=x.device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    steps = []

    def mark(label):
        torch.cuda.synchronize()
        now = torch.cuda.memory_allocated() - base
        peak = torch.cuda.max_memory_allocated() - base
        steps.append(f"{label} {now / 1e9:.2f} (peak {peak / 1e9:.2f})")

    phi_c = _grid._phi_chunk(xg, maps, r0, r1)
    mark("Phi chunk")
    yc = torch.matmul(C2, phi_c.reshape(maps.n2, -1))
    mark("Y = C2 Phi")
    del phi_c
    yc = yc.reshape(maps.n2, r1 - r0, maps.Nb)
    srcA, sgnA, tB, srcB, sgnB, _ = maps.tables(yc)
    _gk.scatter_rows(acc, yc, srcA, sgnA, tB,
                     *_gh._inverse_tables(maps, yc), r0)
    _gk.gather_reduce_cols(yc, srcB, sgnB,
                           _grid._row_tables(maps, yc, r0, r1)[2],
                           out=acc[r0:r1], lists=maps.col_lists())
    mark("scatter + column form")
    del yc, acc
    print(f"  one chunk [{r0}, {r1}), GB above the resident set: "
          + "; ".join(steps))


def main(argv=None):
    if not torch.cuda.is_available():
        print("profile_16e16o: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    t0 = time.perf_counter()
    mol = P.Moldata(GEOMETRY, "sto-3g")
    pqc = P.Parameterized_circuit(16, 16, ansatz="np_fabric", n_layers=1,
                                  sector=True)
    oo = P.OO_pqc(pqc, mol, 16, 16, freeze_active=True)
    torch.cuda.synchronize()
    print(f"setup {time.perf_counter() - t0:.2f} s, route "
          f"{oo._core['route']}, plan {oo._core['plan']}")
    theta = 0.02 * torch.arange(pqc.theta_shape, dtype=torch.float64,
                                device=pqc.device)
    core, args = oo._core, oo._mol_args
    print(f"kernel build + load {cuda_build.load_all([_gk.LIBRARY]):.2f} s "
          "(before any timing)")

    def iteration():
        e0, grad, hess = core["grad_hess"](theta, oo.oao_mo_coeff, *args)
        return core["newton_update"](theta, oo.oao_mo_coeff, *args, e0,
                                     grad, hess, *STEP)

    parts = []
    torch.cuda.reset_peak_memory_stats()
    _gk.reset_launches()
    energy = _timed("NR iteration", iteration, parts)[3]
    launches = dict(_gk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    parts_of_grad_hess(oo, theta, parts)
    for label, sec in parts:
        print(f"  {label:28s} {sec * 1e3:10.1f} ms")
    print(f"  peak device memory of the iteration {peak / 1e9:.3f} GB "
          f"allocated, {reserved / 1e9:.3f} GB reserved; launches "
          f"{launches}; energy after it {float(energy):.12f}")
    torch.cuda.empty_cache()
    chunk_memory(oo, pqc._state_impl_grid(theta))
    device_profile(iteration, parts[0][1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
