#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (auto_oo_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero); each
prints its seconds:

1. the card's name and power limit (nvidia-smi), and the build of both
   CUDA kernel libraries from auto_oo_tpu_torch/csrc/ (one nvcc per
   source, started together);
2. each grid-gather kernel against its plain PyTorch version on the card,
   on the (10e,10o) and (12e,12o) sectors' real grid maps (B = 1, 3, 5 and
   1; float64 and float32) and two ragged random shapes (Nb = 17 and 20,
   n2 = 5 and 70, a row with no valid pair), each time beside its bound
   (the bytes it must move at 3.35 TB/s) and its share of it:
   gather_two_spin, both spin halves of Phi in one launch (full grid,
   and a middle and a ragged last window for the last B; the ragged
   shapes on random maps), equal to its plain version and to the
   composite it replaced (two gather_rows_scaled launches, the transposed
   copy and the transposed add) as values, and timed against that
   composite in turns (composite, kernel, kernel, composite);
   gather_rows_scaled and the row form of gather_reduce on both spin
   halves (the beta half on a transposed copy), the column form
   gather_reduce_cols on the beta half in place, on the compacted lists of
   its tables built once (with the 32- and 128-byte pieces of Y its valid
   elements touch, and its shares of those floors; random tables with
   signs in s: the kernel's lists hold int8 signs); epq_sum in place
   against the composite it replaced (transposed copy, two row-form launches,
   transposed add), equal to rounding and timed in the same call in
   turns, with the transposed copy alone; the hosted route's alpha
   scatter scatter_rows on two windows of the maps' rows (the second
   ragged), the same bits on two launches and within 1e-14 of max |out|
   of its plain version (index_add_) in f64, 1e-6 in f32.  A time is the
   device time of one call: 10 calls back to back behind a spin kernel
   that hides the host's launch time, median of 5 rounds; each grid
   kernel also prints one launch on an idle card, host launch included
   (the method of the earliest kernel times in PERF.md);
3. the row-gather mechanism probes A, B and C against the plain gather on
   the card, bit for bit, at the ncas = 10 and ncas = 12 shapes of their
   entry point, float32 and float64, and one ragged shape (src reaching
   row ns - 1), with times and GB/s of each; B's plan (cluster size,
   slab width W) and C's (box width Wc, stages, blocks per SM), C's L2
   read rate (8 x out bytes over its time), and B at cluster sizes 2, 4,
   8 and 16 where the card holds them (bit for bit, timed);
4. their entry point (auto_oo_tpu_torch.scripts.experiment_gather_mechanisms)
   once at ncas = 10, K = 4: every variant must run and A, B and C match
   plain exactly, and each probe's launch counter must grow;
5. the (10e,10o) slice: 4 damped-Newton iterations of formaldimine sto-3g
   (10e,10o) sector np_fabric L=2 in float64 from init_zeros, through
   Parameterized_circuit / OO_pqc.full_optimization; every energy must
   match the JAX package's CPU trajectory within 1e-8 Ha, and the fused
   route's three grid kernels must be launched during the run; its
   objects are built with no device=, so the port's default device (the
   card) runs it;
6. the (12e,12o) sector np_fabric L=1 f64 path of formaldimine 6-31G
   (D = 853,776, the JAX package's staged regime; STO-3G has 13 orbitals,
   too few for 2 core + 12 active): 3 iterations the same way, within
   1e-8 Ha of the JAX package's CPU energies, every fused-route kernel
   launched; its setup time, iteration times and peak device memory are
   printed;
7. the (10e,10o) slice in precision="mixed" (the Hessian blocks in f32,
   the fused route): at init_zeros e0 and the gradient within 1e-12 of
   the f64 ones and the Hessian within 1e-5 relative (Frobenius), then 4
   NR iterations, each energy held to the JAX package's CPU mixed
   trajectory (ANCHORS_10E10O_MIXED: iteration 1 within 1e-6 Ha, 2-4
   within 1e-5 Ha, the f32 noise of a mixed trajectory), the fused
   route's kernels launched; then streamed and hosted equal fused: the slice's grad_hess
   at a seeded theta on the streamed route (a small row chunk and pair
   block forced, so every H-apply, RDM and transition-RDM row streams Phi
   over grid rows) and on the hosted route (the hosting threshold forced
   to 1 byte, the same row chunk) in its per-tangent form (scatter-form
   H-applies, per-tangent pair sweeps, transition RDMs from two Phi
   chunks) and in its Gram form (the cross sweep over the stack of psi
   and its 28 tangent columns, one H psi pass, the term2 rows) against
   the fused route, f64: e0 and gradient within 1e-11, the Hessian within
   1e-9, and each route's grid kernels launched;
8. the (14e,14o) H14 chain (scripts/bench_14e14o.py's configuration:
   sto-3g, np_fabric L=1, freeze_active, f64, D = 11,778,624), built on
   the default device: the route must be "streamed"; its row chunk and
   pair block (sized from the free device memory) are printed; then each
   grid kernel at the streamed shapes against its plain version, f64 and
   f32, timed beside its bound: the alpha half of a Phi chunk (x
   (3432, 3432), row-sliced tables), the beta half (the chunk's
   transposed rows), gather_two_spin on the whole chunk (against plain
   a slab of pairs at a time and against the composite, timed in turns),
   and both forms of gather_reduce on a (pair block, 3432, 3432) Y; each
   kernel once more on all 196 pairs in one f32 launch (2.31e9 elements,
   beyond 2^31) against its plain version a slab of pairs at a time;
   then 2 NR iterations through full_optimization,
   each energy within 1e-8 Ha of its JAX anchor (ANCHORS_14E14O), the final
   state's norm within 1e-12 of 1 and tr(gamma) = 14 within 1e-10, with
   the setup time, iteration times, peak device memory and kernel
   launches printed; then one grad_hess at the final theta on the hosted
   route (forced, its row chunk from the free memory; the JAX rule's form
   there, the Gram form: the (15, D) f64 stack is 1.4 GB) against the
   streamed one, timed in turns (streamed, hosted, hosted, streamed): e0
   and gradient within 1e-10, the Hessian within 1e-8; then 2 NR
   iterations in precision="mixed" (the streamed route, its f32 rows on
   their own plan), iteration 2 within 1e-7 Ha of the JAX package's mixed
   -7.3342933466 and of the port's f64 iteration 2;
9. convergence: (2e,2o) sector ucc full_optimization, built on the
   default device, must end within 1e-8 Ha of CASSCF; and (2e,2o) ucc in
   the full space with freeze_active=False to convergence in f64 and in
   mixed precision: within 1e-9 Ha of each other, the mixed one within
   1e-8 Ha of CASSCF;
10. the (16e,16o) H16 chain (scripts/demo_16e16o.py's configuration:
   sto-3g, np_fabric L=1, freeze_active, f64, D = 165,636,900): the route
   must be "hosted", its setup seconds and row chunk are printed; the
   hosted route's kernels at its chunk shapes against their plain
   versions (a slab of pairs at a time), timed beside their bounds: both
   halves of a Phi chunk through gather_rows_scaled, then gather_two_spin
   on the chunk (f64, against the composite in turns, beside its bound
   and its re-read floor; f32 on the ragged last window), the column form
   on the chunk's Y (and its add mode into a window of an accumulator,
   the same bits as acc + the result), and the
   scatter on it (f64 and f32, the middle and the ragged last window, the
   same bits on two launches) beside index_add_ of its contributions;
   then E(0) within 1e-8 Ha of the RHF energy, one grad_hess at the
   demo's theta0 = 0.02 * arange(14) (|grad| within 1e-5 of the JAX
   package's 5.379e-02) and one damped-Newton update from it: the energy
   below E(theta0) and within 5e-5 Ha of the JAX package's
   mixed-precision iteration 1, -8.3671002296, with the step length, the
   iteration's time, peak device memory and kernel launches, then the new
   state's norm within 1e-12 of 1 and tr(gamma) = 16 within 1e-10; then
   the same chain in precision="mixed", which takes the hosted route's
   Gram form as in the JAX package (its (15, D) f32 stack is 9.9 GB, under
   the 11e9-byte budget): one f32 gather_two_spin launch over a (15, Na,
   Nb) stack at the cross sweep's chunk shape (a middle and the ragged
   last window) and one on a single f32 state at the mixed hosted pass's
   row chunk (990 rows), each equal to plain and timed beside its bound
   and its re-read floor (grid_kernels.two_spin_bytes), and the pass's f32
   column form and scatter at that chunk against their plain versions,
   timed beside their bounds and index_add_, then one NR
   iteration from theta0: |grad| within 1e-4 relative of 5.379e-02, the
   energy below E(theta0) and within 5e-5 Ha of -8.3671002296, with the
   step length, the iteration's time, peak memory and launches;
11. the full space (sector=False, the default), formaldimine sto-3g f64
   on the flat route, every object built with no sector= and no device=:
   (2e,2o) np_fabric L=1 with freeze_active (the README quick start) and
   ucc without it, each to convergence within 1e-8 Ha of CASSCF; the
   (3e,3o) doublet (the cation, nelecas=(2, 1), ucc with singles), 3
   iterations; (6e,6o) np_fabric L=2 (bench.py's headline tier) to
   convergence, iterations 1-HELD_6E6O held to the JAX trajectory and
   the end a converged minimum (positive lowest Hessian eigenvalue) above
   the CASSCF energy; (8e,8o) np_fabric L=2, 3 iterations with its
   iteration taken apart on the host clock.  Each energy held to its CPU
   JAX anchor within 1e-8 Ha; each phase prints its s/NR-iter (median of
   iterations 2-4, or 2-3), peak device memory and the device's busy and
   idle share over one more iteration under torch.profiler (with its top
   kernels and ops), beside the card's name and power limit; the final
   state's norm within 1e-12 of 1 and tr(gamma) equal to the electron
   count within 1e-10; the flat route launches no grid kernel;
12. a prebuilt (4e,4o) kupccd GateProgram through sector=True (projected
   onto the sector and factorized onto the string grid) against the
   built-in sector circuit: grad_hess e0, gradient and Hessian within
   1e-12, 1e-11 and 1e-9 at a seeded theta, the fused route's grid kernels
   launched by the prebuilt circuit's grad_hess;
13. the gradient-only pipeline (``OO_pqc.energy_and_gradient``: the
   state, one H-apply, one adjoint reverse sweep and the RDMs; and
   ``gradient_optimization``: Adam in optax's order, with damped-Newton
   orbital relaxations), each run with its launches counted, s/gradient
   step and peak memory: after phase 7, the (10e,10o) slice 10 steps
   from init_zeros (relaxations after steps 4 and 9) in f64 and mixed,
   against the CPU JAX trajectories: f64 steps 0-4 to 1e-8 Ha and mixed
   step 0 to 1e-5 Ha, the rest to 1e-3 Ha (the relaxations amplify last
   bits: the JAX package's own run from theta = 1e-13 leaves it by up to
   4.8e-4 Ha; and Adam scales the f32 error of small gradient entries to
   steps of the learning rate);
   after phase 8, (14e,14o) on the streamed route: one
   energy_and_gradient at theta0 = 0.02 * arange(14) with its parts
   (E = E(theta0) to 1e-9) and 3 Adam steps from init_zeros (dE within
   1e-4 Ha of the JAX package's -5.3 mHa), then the same in mixed (E and
   gradient against the f64 ones within 1e-5 Ha and 1e-4 (max|g| + 1),
   descending); after phase 9, (2e,2o) ucc in the full space, 60 steps
   (a relaxation every 5), every energy within 1e-8 Ha of CPU JAX and
   the last within 2e-4 Ha of CASSCF; after phase 10's f64 iteration,
   (16e,16o) on the hosted route: energy_and_gradient at theta0 with its
   parts (E equal to the grad_hess e0 and to E(theta0) to 1e-9, the
   gradient equal to grad_hess's to 1e-12 relative, |grad| = 5.379e-02
   to 4 digits) and 2 Adam steps from init_zeros (dE within 1e-5 Ha of
   the JAX package's -2.57e-3); after its mixed iteration, the same in
   mixed (|grad| within 1e-4 relative of the JAX package's 5.378922e-02;
   3 steps descending to 1e-5, E(0) = RHF to 1e-4);
14. (a) the Berry-phase workflow, the reference tutorial's loop:
   BerryPhaseLoop around the formaldimine conical intersection (origin
   (130, 89.9) deg, radius 10 deg), (2e,2o) np_fabric L=1 in the full
   space, 21 points, run(conv_tol=1e-10, track_steps=12,
   track_tol=1e-10), built with no device=: every point's energy and
   lowest Hessian eigenvalue and every overlap (the Thouless transfer on
   the card) within 1e-8 of the CPU JAX anchors, the Berry phase within
   1e-8 of JAX's and within 0.05 of +-pi, no grid kernel launched; each
   loop phase prints s per point, its NR iterations with their mean
   seconds, s per overlaps() and per transfer_state;
15. (b) the same loop in sector mode, 11 points: the same anchors' checks
   and the fused route's three kernels launched by the run;
16. (c) the (6e,6o) sector arc (np_fabric L=2, three geometries 0.25 deg
   apart): finite energies, overlaps real and above 0.97 (the JAX
   test's contract: the JAX package's own run from theta = 1e-13 leaves
   its unperturbed one by 1.4e-4 Ha), printed beside both JAX runs; the
   fused kernels launched;
17. (d) newton_method="iterative": the 6-point (2e,2o) loop on both
   solvers, each within 1e-8 of its CPU JAX anchors, energies within
   1e-8 of each other and lowest Hessian eigenvalues within 2e-2
   relative; newton_dir_iterative on seeded symmetric indefinite H at
   n = 128 and 362 against the eigh direction (lowest within 1e-9, dp
   within 1e-7 relative), both solvers' times and the guard's
   fallbacks printed;
18. (e) S^2 at scale: after phase 8, the (14e,14o) demo's s2 stage at
   theta0 (|<S^2>| < 1e-8) and a seeded random state's grid <S^2>
   against the flat cross-sector tables within 1e-10; after phase 13,
   a seeded random (10e,10o) sector state's grid <S^2> against the
   host's scipy S^2 restricted to the sector within 1e-10 and the
   (16e,16o) demo's s2 stage at theta0; each with seconds and peak
   device memory;
19. (f) Noisy_OO_pqc on (2e,2o) np_fabric L=1: variance 0 equals
   full_optimization within 1e-12, variance 1e-10 reaches CASSCF within
   1e-4, and one seed twice gives the same trajectory on the card's
   generator;
20. spin-resolved RDMs on the sector grid, after phase 10: formaldimine
   (10e,10o) np_fabric L=2 and (12e,12o) np_fabric L=1, sector=True, at
   theta = 0.07 * arange + 0.1: gather_rows_scaled on both halves of the
   one-spin Phi (the alpha half on the grid state, the beta half on its
   transposed copy) against its plain version on the card (1e-15
   relative), timed beside its bound; the cross-sector pair maps built on
   the card (seconds, GB); one get_rdms(restricted=False), which must
   launch gather_rows_scaled twice and no other kernel, its spin sums
   equal to the restricted RDMs within 1e-12; a complex state (a seeded
   per-determinant phase) through get_rdms_from_state, restricted
   (gather_two_spin twice: real and imaginary parts) and spin-resolved
   (gather_rows_scaled four times), its spin sums equal to its restricted
   RDMs within 1e-12; psi e^(0.7i) equal to psi's RDMs within 1e-12; at
   (10e,10o) the CPU JAX anchors' functionals (||gamma||_F, ||Gamma||_F,
   sum(M * Gamma)) of the real and the phased state within 1e-10;
21. spin-resolved RDMs in the full space, (8e,8o) np_fabric L=2 at the
   same theta: the CPU JAX anchor's functionals within 1e-10, spin sums
   within 1e-12 of the restricted RDMs, no grid kernel;
22. user-defined states in the full space: the prebuilt (6e,6o)
   np_fabric L=2 GateProgram read up_then_down=True, 3 NR iterations; the
   JAX test's complex (2e,2o) ansatz (UCCD times an occupation-dependent
   phase) by full_optimization to CASSCF within 1e-7; the same
   construction on the (6e,6o) program, 3 NR iterations from a seeded
   theta; a real callable wrapping the built-in (6e,6o) program, 3 NR
   iterations, timed beside the built-in circuit's sweeps; each energy
   within 1e-8 Ha of CPU JAX, s/NR-iter printed; the callables' J,
   circuit-Hessian term and rows come from torch.func on the card.
23. (a) GeometryBatch.newton_steps at full width: (10e,10o) sector
   np_fabric L=2, freeze_active, 8 points of the tutorial's loop from
   init_zeros in one batched step: equal to 8 sequential _nr_iteration
   calls (energy, theta and OAO 1e-12, lowest eigenvalue 1e-9) and to
   CPU JAX at points 0 and 4 (1e-10); the fused route's three kernels
   launched with more than one geometry in their batch (launches per
   batched step under "batch_10e10o"); the batched Newton direction and
   lowest eigenvalue equal to the per-lane solves (1e-12) on the step's
   Hessians and on a random 32 x 32 stack; s per batched step against 8
   sequential iterations, the device busy share and the host syncs of a
   step (torch.cuda.set_sync_debug_mode("warn"), by the port's line);
24. (b) BerryPhaseLoop.run_batched (track_steps=12) on the tutorial's
   loop, 21 points in the full space and 11 in sector mode: energies and
   lowest eigenvalues within 1e-8 of CPU JAX run_batched, the Berry phase
   +-pi; the sector loop launches the fused kernels at n2 = 4; s per
   point against run();
25. (c) full_optimization(device_loop=True) against the host loop on the
   card: (2e,2o) np_fabric L=1, full space, to CASSCF (eigh and
   newton_method="iterative"), (6e,6o) 12 iterations, (10e,10o) sector 4
   iterations at conv_tol=0 (launches per device-loop iteration under
   "device_loop_10e10o"): the same iteration count, energies 1e-11,
   theta, kappa, OAO and lowest eigenvalues 1e-9, the anchors to 1e-8;
   each loop's wall time and host syncs by the port's line (fewer in the
   device loop); phase 6 checks that (12e,12o) 6-31G (D = 853,776)
   raises the staged ValueError;
26. (d) GeometryBatch.optimize_device_loop against optimize, (2e,2o) at
   two geometries: 8 steps at conv_tol=0 equal (1e-11, 1e-9), and with
   conv_tol=1e-10 it stops before 20 steps at each CASSCF (1e-8).

The distributed engines (auto_oo_tpu_torch.parallel) run on a one-rank
NCCL group of this process (the card's machine has one card): two
DeviceMeshes, (1, 1) ("tp", "row") and (1,) ("dp",), made before phase
2; every collective is issued at one rank.  Each call prints its wall
time, peak device memory, the collectives with the bytes of their
inputs and its kernel launches:
27. (a), after phase 10's gradient pipeline: row_sharded_sector_fns at
   the (16e,16o) H16 chain from the demo's theta0 (rdms_grid, ham_apply,
   energy_gradient): e0 and the gradient within 1e-10 of the single-card
   hosted energy_and_gradient of the same run, the RDMs and H psi within
   1e-12 relative of the hosted passes;
28. (b) hosted_sharded_fns at (16e,16o) (its default row chunk): rdms
   and ham_apply within 1e-12 relative of grid_hosted's passes; one
   segment's two gather_rows_scaled launches on the engine's shapes (the
   alpha half on the whole grid, the beta half on the segment's 14
   transposed rows) equal to plain and timed beside their bounds, and
   the kernel's share of the rdms pass's device time (torch.profiler);
29. (c), after phase 6: grid2d_nr_fns on the (1, 1) (tangent, row) mesh
   at the (12e,12o) 6-31G sector (phase 6's objects): its first nr_step
   equal to phase 6's iteration 1 within 1e-10 Ha and to the CPU JAX
   anchor within 1e-8;
30. GeometryBatch on the staged route (ROADMAP queue 1 item 11): 2
   geometries of the (12e,12o) 6-31G sector, one newton_steps, lane 0
   within 1e-8 of the CPU JAX anchor, both lanes within 1e-10 of their
   sequential iterations, its peak memory;
31. (d), after phase 23: sharded_nr_step_fn at the (10e,10o) sector and
   the (8e,8o) full space, both equal to the single card within 1e-10
   Ha, (8e,8o) within 1e-9 of the JAX package's 8-device -92.6688074620
   (MULTICHIP_r05.json);
32. (e) GeometryBatch(mesh=, axis="dp") over phase 23's 8 (10e,10o)
   geometries, equal to mesh=None within 1e-12.
33. after phase 8's gradient pipeline (its Newton core freed), the
   spin-resolved RDMs of the (14e,14o) H14 chain at phase 8's theta after
   iteration 2: the pair maps built on the card (30.2 GB), one
   get_rdms(restricted=False) launching gather_rows_scaled exactly twice
   and no other kernel, its spin sums equal to the restricted streamed
   RDMs within 1e-12 relative, gamma_alpha = gamma_beta (a singlet), its
   wall time and peak device memory.
34. after phase 30, the FLOP count (auto_oo_tpu_torch/utils/flops.py)
   against torch.utils.flop_counter.FlopCounterMode: one f64 NR
   iteration from init_zeros, outside any timed call, at (10e,10o) on
   the fused route and at phase 6's (12e,12o) on the staged route; the
   counter's matmul FLOPs (mm, bmm, addmm, baddbmm) of grad_hess and of
   the update (its Armijo trials read from the step it took) beside the
   count; the count must lie within FLOP_BAND (0.5x-2x) of the counter's
   total.  Phases 5, 6, 8 and 10 print each timed NR iteration's count,
   its achieved FLOP/s and its share of the card's 67 TFLOP/s (the f64
   and f32 peaks are equal); the count phase's ratios are printed again
   after the phases;
35. after the (2e,2o) phases, the OO-VQE tutorial
   (auto_oo_tpu_torch.scripts.tutorial_oo_vqe, examples/tutorial_oo_vqe.py)
   at full length on the default device: formaldimine (4e,3o) np_fabric
   L=2 by full_optimization(conv_tol=1e-10) to CASSCF within 1e-8 Ha,
   every iteration printed beside the JAX example's CPU trajectory, then
   300 circuit-only Adam steps on <psi|H|psi> at the RHF orbitals, the
   last energy within 1e-8 Ha of the JAX example's (TUTORIAL_ADAM_E) and
   printed beside CASCI; no grid kernel;
36. the noise study (auto_oo_tpu_torch.scripts.noise_study,
   examples/noise_study.py), cut from 5 variances x 5 seeds to 1e-8 and
   1e-3 x 2 seeds (NOISE_VARIANCES, NOISE_SEEDS): its JSON rows, the
   basin fraction a share of the seeds and 1 at 1e-8; its noiseless limit,
   a variance-0 row, equal to the plain Newton run of the same 30
   iterations; no grid kernel;
37. after phase 20, simulator.sector.rdms_from_sector_state at (10e,10o)
   np_fabric L=2 over the circuit's GridMaps, a real state and one with a
   seeded per-determinant phase: gather_two_spin launched and no other
   kernel, equal within 1e-12 to its plain version (the flat sector
   tables, element gathers, no kernel) and to the circuit's get_rdms.
The phases that time gather_rows_scaled print its first version (one
warp per output row) at the same shape ("was", WAS_ROWS_MS, from
scripts/sweep_rows_scaled.py --baseline) beside its time, its bound
and, where x does not fit half the L2, its re-read floor
(grid_kernels.rows_scaled_bytes).
Phase 25 also runs the (10e,10o) device loop in precision="mixed"
(item 11): the host loop's values, iteration 1 within 1e-6 of CPU JAX
mixed and 2-4 within 1e-5.

The line before the last is {"kernels": [...]} (per kernel: launches in
its main path's run, which is the (16e,16o) iteration of phase 10 for
the hosted route's kernels (gather_two_spin among them), phase 8's
(14e,14o) iterations for the row form of gather_reduce, phase 4 for the
probes, and phase 20's (12e,12o) get_rdms(restricted=False) for
gather_rows_scaled (the spin-resolved sector route; no restricted route
launches it since gather_two_spin, and every route phase checks that),
with each path's launches under "launches_by_path" (phase 20's under
"*_unrestricted", "*_complex" and "*_unrestricted_complex", phase
33's under "14e14o_unrestricted"; the probes'
variant L under "probes"; 0 on the flat paths; the mixed
paths' f32 launches under "10e10o_mixed", "14e14o_mixed" and
"16e16o_mixed"; the gradient-only pipeline's under "*_grad*", one
energy_and_gradient, and "*_adam*", a whole Adam run; the Berry loops'
under "berry_*", a whole loop's run; one batched step of 8 (10e,10o)
geometries under "batch_10e10o", the sector run_batched under
"run_batched_2e2o_sector", 4 device-loop iterations at (10e,10o) under
"device_loop_10e10o"; phase 37's call under
"rdms_from_sector_state_10e10o", and 0 under "tutorial_oo_vqe" and
"noise_study"; the distributed engines' calls under
"row_sharded_16e16o", "hosted_sharded_16e16o", "grid2d_12e12o",
"tangent_sharded_10e10o" and "batch_mesh_10e10o", the staged batch
under "batch_12e12o"); max abs error
against the
plain version over every comparison; kernel and plain times and the
bound at the (16e,16o) f64 chunk shapes for the hosted route's kernels
(gather_two_spin on the chunk and gather_rows_scaled on its alpha half;
the column form and the scatter on the chunk's Y), at the (12e,12o)
one-spin Phi's alpha half for gather_rows_scaled, at the (14e,14o)
streamed shape for the row form and at the probes' ncas = 12 f64 shape;
library_ms is the time of index_add_ of the scatter's contributions,
and null for the others, which no single PyTorch call computes); the
last line is {"ok": true, "device": {...}}.
Without a CUDA device the script exits non-zero before printing any
result.
"""

import collections
import contextlib
import json
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

# CPU JAX trajectory of the (10e,10o) slice (energies after NR
# iterations 1-4 from init_zeros with alpha=1e-4, beta=0.5, mu=1e-6,
# rho=1.1, lambda_min=1e-6)
ANCHORS_10E10O = [-92.71490202342721, -92.74063367923337,
                  -92.74294363549987, -92.74381293885381]
# CPU JAX energies of the (12e,12o) sector np_fabric L=1 path of
# formaldimine 6-31G after NR iterations 1-3 from init_zeros (same step
# parameters)
# the JAX package's energy after one (8e,8o) sharded NR step on 8 devices
# (MULTICHIP_r05.json; np_fabric L=1 from init_zeros)
E_NR_8E8O = -92.6688074620
ANCHORS_12E12O = [-93.87081413001067, -93.87231829137146,
                  -93.87365505167503]
# JAX energies of the (14e,14o) H14 chain (scripts/bench_14e14o.py's
# configuration) from init_zeros (same step parameters), by NR iteration:
# the JAX package's own f64 value in BASELINE.md:364 ("iter-1 energy"
# there is bench_14e14o.py's 0-based "iter 1" line, the second
# iteration).  No JAX value of iteration 1 is on record; iteration 2
# starts from its result.
ANCHORS_14E14O = {2: -7.3342933449}
ITERATIONS_14E14O = 2
H14_GEOMETRY = "; ".join(f"H 0 0 {0.9 * i:.2f}" for i in range(14))
# the JAX package's (16e,16o) H16 chain (scripts/demo_16e16o.py) from its
# theta0 = 0.02 * arange(14): |grad| of its f64 hosted energy+gradient
# (BASELINE.md:552, given to 4 digits), and the energy after its first
# mixed-precision NR iteration (BASELINE.md:532; that pass carries ~1e-6
# relative noise, so the port's f64 iteration is held to 5e-5 Ha)
H16_GEOMETRY = "; ".join(f"H 0 0 {0.9 * i:.2f}" for i in range(16))
GRAD_NORM_16E16O = 5.379e-02
E_NR1_16E16O = -8.3671002296
# precision="mixed" anchors.  (10e,10o): CPU JAX energies after NR
# iterations 1-4 of the slice's configuration in mixed precision
# (PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/full_space_anchors.py
# 10e10o_mixed, the JAX package of commit 03c9325).  Iteration 1 is held
# to 1e-6 Ha; from iteration 2 on each trajectory carries its own f32
# noise: the circuit block 2 J H J^T + d2<2 H psi, psi> sums two terms
# of norm ~52 to ~0.57 at this slice (python -m
# auto_oo_tpu_torch.scripts.mixed_hessian_terms), so its f32 rounding
# is ~1e-5 relative in either package, and the JAX mixed trajectory
# itself leaves the f64 one by 4.6e-7, 7.3e-7 and 1.6e-6 Ha at
# iterations 2-4: iterations 2-4 are held to 1e-5 Ha, the JAX package's
# bound on an f32-affected energy (tests/test_grid.py:772)
# (14e,14o): the JAX package's mixed second iteration (BASELINE.md:365,
# "iter-1" there being the second, as for ANCHORS_14E14O), held to 1e-7
# Ha, as is the port's own f64 iteration 2.  (16e,16o): E_NR1_16E16O is
# itself the JAX package's mixed iteration 1, held to 5e-5 Ha (its pass
# carries ~1e-6 relative noise), |grad| to 1e-4 relative.
ANCHORS_10E10O_MIXED = [-92.71490192892506, -92.74063322179997,
                        -92.74294436652184, -92.74381132021185]
TOL_10E10O_MIXED = [1e-6, 1e-5, 1e-5, 1e-5]
E_ITER2_14E14O_MIXED = -7.3342933466
# the gradient-only pipeline (OO_pqc.energy_and_gradient and Adam's
# gradient_optimization).  (16e,16o) from theta0: the JAX package's mixed
# |grad|, 5.378922e-02 (BASELINE.md:553), held to 1e-4 relative; 2 f64
# Adam steps from init_zeros lower E by 2.57e-3 Ha (BASELINE.md:446, held
# to 1e-5 Ha); (14e,14o): 3 steps by 5.3 mHa (BASELINE.md:342, 1e-4 Ha)
GRAD_NORM_16E16O_MIXED = 5.378922e-02
ADAM_DE_16E16O = -2.57e-3
ADAM_DE_14E14O = -5.3e-3
# CPU JAX energies at every step of gradient_optimization from init_zeros
# with conv_tol=0 (PYTHONPATH=. JAX_PLATFORMS=cpu python
# scripts/full_space_anchors.py 10e10o_adam 10e10o_adam_mixed 2e2o_adam).
# (10e,10o), the slice's configuration, 10 steps at learning rate 0.05
# with an orbital relaxation after steps 4 and 9: the relaxation's
# augmented Newton iterations amplify last-bit differences, so the JAX
# package's own run from theta = 1e-13 (--perturb 1e-13) leaves this one
# by up to 4.8e-4 Ha (f64) and 5.3e-5 Ha (mixed) after the first
# relaxation.  In mixed precision Adam's g / (|g| + eps) also scales the
# f32 error of every gradient entry below ~1e-6 to a step of order the
# learning rate, so two mixed trajectories part from step 1 on (by 9e-5
# Ha at step 2 on the card).
# f64 steps 0-4 are held to 1e-8 Ha and mixed step 0 (E(0) through an
# f32 pass) to 1e-5 Ha, the JAX package's bound on such an energy
# (tests/test_grid.py:686); the other steps to 1e-3 Ha, printed beside
# the anchors.
ANCHORS_10E10O_ADAM = [
    -92.66372180882314, -92.66797692060042, -92.67175521438807,
    -92.67731445524758, -92.68361386543269, -92.73097339876335,
    -92.73735889932263, -92.74105930006615, -92.74134864463566,
    -92.74053636476124]
ANCHORS_10E10O_ADAM_MIXED = [
    -92.66371951747232, -92.66796397610099, -92.67185676288611,
    -92.67734813681686, -92.68361610157189, -92.73131329323446,
    -92.73780827927416, -92.74144218926529, -92.7416398196448,
    -92.74083248102117]
HELD_10E10O_ADAM = {"f64": (5, 1e-8), "mixed": (1, 1e-5)}
TOL_10E10O_ADAM_SPREAD = 1e-3
# (2e,2o) ucc in the full space, freeze_active=False, 60 steps at 0.1 with
# a relaxation every 5 (tests/test_oo_pqc.py:189-203): a 1e-13 start moves
# it by 6e-14 Ha, so every step is held to 1e-8 Ha, and the end to 2e-4
# Ha of CASSCF (the JAX test's bound)
ANCHORS_2E2O_ADAM = [
    -92.66372180882317, -92.66781936912368, -92.67020580292842,
    -92.67099972083778, -92.67062730116064, -92.72750480528924,
    -92.73392780242432, -92.73971579220996, -92.74400319394292,
    -92.7463511926893, -92.74902277705291, -92.74860869215374,
    -92.74718485089444, -92.74552462251536, -92.74429054963053,
    -92.74624249798225, -92.74625044765898, -92.74649911556875,
    -92.74690278761881, -92.74735339945613, -92.74794400105036,
    -92.74834067235871, -92.74856434209252, -92.74860269183162,
    -92.74849159069365, -92.74921370472433, -92.74912901662034,
    -92.74901311320001, -92.74891208029061, -92.74885960609363,
    -92.74895108284571, -92.74899429014948, -92.74905724862782,
    -92.74912030621749, -92.74916659646519, -92.74921721060672,
    -92.7492231656799, -92.74920711704206, -92.74917998632618,
    -92.74915440675412, -92.74918357538097, -92.74918155351145,
    -92.7491872521066, -92.74919811389195, -92.74921016484106,
    -92.74922149464783, -92.74922728102699, -92.74922749923435,
    -92.74922347961171, -92.74921781679117, -92.74922560144536,
    -92.74922378285008, -92.74922359404044, -92.74922498249198,
    -92.74922729258577, -92.74922955848007, -92.74923102535553,
    -92.7492313762446, -92.74923076227412, -92.74922968156379]
STEP = dict(alpha=1e-4, beta=0.5, mu=1e-6, rho=1.1, lambda_min=1e-6)
# the grid kernels each route launches (the hosted route adds its alpha
# half with scatter_rows where the others run the row form); every route
# builds Phi with gather_two_spin, and only the probes' entry point
# launches gather_rows_scaled besides the spin-resolved RDMs
FUSED_KERNELS = ("gather_two_spin", "gather_reduce", "gather_reduce_cols")
HOSTED_KERNELS = ("gather_two_spin", "gather_reduce_cols", "scatter_rows")
E_CASSCF_2E2O = -92.74923230445957
# CPU JAX trajectories of the full-space cells, formaldimine sto-3g f64
# from init_zeros with STEP's parameters and freeze_active=True
# (scripts/full_space_anchors.py on the JAX package of commit 6a9ea9f):
# the (3e,3o) doublet, (6e,6o) to convergence and (8e,8o), by iteration
ANCHORS_3E3O = [-92.51745437073947, -92.54145670915005, -92.55181115638135]
ANCHORS_6E6O = [-92.70446478216726, -92.73380097454339, -92.74277238394593,
                -92.74712759174129, -92.74818590775784, -92.748876016738,
                -92.7497130616656, -92.75082142127079, -92.75263191682166,
                -92.75921366074664, -92.7603240076009, -92.76076102015165,
                -92.76126688199123, -92.7616380382401, -92.76303366571479,
                -92.7631268730031, -92.76576564015811, -92.7661364869268,
                -92.76687932711428, -92.76719844660202, -92.76728138442752,
                -92.76764009017123, -92.76771525872152, -92.76924849420224,
                -92.7693388867086, -92.7695327476724, -92.77038693023916,
                -92.7706751667173, -92.77086718231205, -92.77117903428424,
                -92.77130908190833, -92.77148779236006, -92.7715943271201,
                -92.77188428340047, -92.77198737395302, -92.77207216077838,
                -92.77207852170653, -92.77207903582347, -92.77207903857753,
                -92.77207903870999, -92.77207903872626]
ANCHORS_8E8O = [-92.72082866088444, -92.72961785304307, -92.73840872357711]
# the (6e,6o) trajectory amplifies a difference in its last bits about
# tenfold per iteration from iteration 7 on (its lowest Hessian
# eigenvalue is negative at 30 of its first 33 iterations): the JAX
# package's own run from theta = 1e-13 (full_space_anchors.py --perturb
# 1e-13) leaves it by 7.2e-10 Ha at iteration 13 and 1.5e-5 Ha at
# iteration 21, and converges to another minimum, 1.1e-5 Ha away.  So
# iterations 1-12 are held to it, and the rest are printed beside it
HELD_6E6O = 12
E_CASSCF_6E6O = -92.80039255291021
# the Berry-phase workflow (BerryPhaseLoop around the formaldimine
# conical intersection, loop origin (130, 89.9) deg, radius 10 deg): CPU JAX
# energies, lowest Hessian eigenvalues and overlaps (their imaginary parts
# are 0) of each loop point and its Berry phase
# (PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/full_space_anchors.py
# berry_2e2o berry_2e2o_sector berry_6e6o_sector berry_2e2o_iterative, the
# JAX package of commit a7899a1).  (2e,2o) np_fabric L=1, 21 points in the
# full space and 11 in sector mode, run(conv_tol=1e-10, track_steps=12,
# track_tol=1e-10): every number held to 1e-8.
BERRY_PHASE_2E2O = 3.141592653589793
BERRY_2E2O_E = [-92.7460274949789, -92.74662641379699, -92.74788853927173,
    -92.74984867606385, -92.75236773765307, -92.75491104466575,
    -92.75683144832725, -92.75784323525257, -92.75811630887158,
    -92.7580899614661, -92.75812854323136, -92.75822512164939,
    -92.75800578921697, -92.75702922491564, -92.75512630241805,
    -92.75257899370209, -92.75002649853126, -92.74801336784941,
    -92.74669784353226, -92.74605053929204, -92.74602749497895]
BERRY_2E2O_EIG = [0.029872808280386957, 0.027935451407869905,
    0.02440008718310475, 0.021057116093127853, 0.02145702813326973,
    0.025338400663136258, 0.029493017411168217, 0.032458599535690164,
    0.03410395800317955, 0.03479513185828776, 0.03486038311428854,
    0.034295953166190586, 0.03276632672102658, 0.029903636015061213,
    0.025841078927181533, 0.022000624454500264, 0.021439685110409577,
    0.02454962481116443, 0.027978558463809575, 0.029881670454537594,
    0.02987292384668172]
BERRY_2E2O_OVERLAP = [0.9891188053938871, 0.9839753831890736,
    0.9747944871027614, 0.9705747259140594, 0.9789025545335472,
    0.9858108667493914, 0.9879021490845219, 0.9874950537261764,
    0.9863466793950039, 0.9858035305494349, 0.9864406125943265,
    0.9876573459296848, 0.988135008314454, 0.9862286971882369,
    0.9798642826208769, 0.9720178458002355, 0.9754175004835253,
    0.9840498200513075, 0.9891083780246919, 0.990608171885586,
    -1.0000000000000027]
BERRY_2E2O_SECTOR_E = [-92.74602749497889, -92.74788853927171,
    -92.75236773765305, -92.75683144832729, -92.7581163088716,
    -92.75812854323145, -92.75800578921704, -92.75512630241808,
    -92.7500264985312, -92.74669784353219, -92.74602749497888]
BERRY_2E2O_SECTOR_EIG = [0.02987280828035408, 0.02440001261900618,
    0.021451541891604, 0.0294945713031463, 0.034103951394520125,
    0.0348604545716888, 0.032766745823226535, 0.025840969076204617,
    0.021439674364119688, 0.02797854217484576, 0.02987813584081496]
BERRY_2E2O_SECTOR_OVERLAP = [0.9474099637526119, 0.8941212841940925,
    0.9316084581735018, 0.9516002059714107, 0.9453691897610424,
    0.9491269579615293, 0.94965190716631, 0.906994407383057,
    0.9215539513539353, 0.9598964095177582, -1.0]
# the (6e,6o) sector arc (np_fabric L=2, get_formal_geo(140 + 0.25 k,
# 80 + 0.25 k), k = 0-2; run(conv_tol=1e-9, max_iterations=30,
# track_steps=6, track_tol=1e-9)): the JAX package's own run from
# theta = 1e-13 (--perturb 1e-13) leaves this one by 1.4e-4 Ha at point 0
# (its 30 iterations end before convergence, at a negative lowest Hessian
# eigenvalue) and its overlaps by 7.2e-3, so the port is held to the JAX
# test's contract (tests/test_berry.py:191-195: overlaps real, above 0.97)
# and its energies are printed beside both runs
BERRY_6E6O_E = [-92.77093983051361, -92.77189036009138, -92.77175319588298]
BERRY_6E6O_OVERLAP = [0.9969059095496771, 0.999756615043637,
    0.9971098424254423]
BERRY_6E6O_PERTURBED_E = [-92.77079945085833, -92.7718926263457,
    -92.77176930763295]
BERRY_6E6O_PERTURBED_OVERLAP = [0.9897470002675715, 0.9997269171575556,
    0.9918067552422292]
# the 6-point (2e,2o) loop (track_steps=8) on newton_method="eigh" and
# "iterative" (tests/test_berry.py:196-222): each run's energies held to
# its CPU JAX anchor to 1e-8, the two solvers' energies to each other to
# 1e-8 and their lowest Hessian eigenvalues to 2e-2 relative (the
# iterative solver's contract on clustered spectra)
BERRY_ITER_EIGH_E = [-92.7460274949789, -92.75236773765309, -92.7581163088716,
    -92.75800578921697, -92.75002649853123, -92.74602749497889]
BERRY_ITER_EIGH_EIG = [0.029872808280386957, 0.021453495243711176,
    0.03410396301519038, 0.03276634230965717, 0.02143967860013974,
    0.029872920192852537]
BERRY_ITER_ITERATIVE_E = [-92.74602749497893, -92.75236773765309,
    -92.75811630887155, -92.75800578921704, -92.75002649853124,
    -92.74602749497889]
BERRY_ITER_ITERATIVE_EIG = [0.029872808280356485, 0.021453495243713823,
    0.03410396301518555, 0.0327663423096675, 0.021439678600148813,
    0.029872920192851017]
# the geometry batches and the device loop (scripts/full_space_anchors.py
# batch_10e10o batched_2e2o batched_2e2o_sector, CPU JAX of commit
# 64f1078): one damped-Newton iteration from init_zeros at points 0 and 4
# of the tutorial's loop at 9 points, (10e,10o) sector np_fabric L=2,
# freeze_active (the JAX package's per-geometry _nr_iteration_jit, which
# its GeometryBatch step equals): (energy, lowest Hessian eigenvalue,
# |theta|), held to 1e-10; and run_batched(track_steps=12) on the loop at
# 21 points (full space) and 11 (sector), (2e,2o) np_fabric L=1:
# energies and lowest Hessian eigenvalues, held to 1e-8
BATCH_10E10O = {
    0: (-92.69362068664566, -0.07409815127610266,
        0.9246933697481987),
    4: (-92.67862979968457, -0.06469207587108043,
        0.7663060403202787),
}
BATCHED_2E2O_E = [-92.7460274949789, -92.74662641379697, -92.74788853927166,
    -92.74984867606382, -92.75236773765307, -92.75491104466576,
    -92.75683144832733, -92.75784323525266, -92.7581163088716,
    -92.75808996146618, -92.75812854323144, -92.75822512164945,
    -92.758005789217, -92.75702922491563, -92.75512630241802,
    -92.75257899370199, -92.75002649853116, -92.74801336784932,
    -92.74669784353216, -92.74605053929201, -92.74602749497892]
BATCHED_2E2O_EIG = [0.029872808280386957, 0.027935439202164854,
    0.02440001093478927, 0.021056497165021313, 0.021453028635691124,
    0.025336029580807818, 0.029492734700352744, 0.03245855587480353,
    0.03410394772578015, 0.03479512961875965, 0.03486038260637878,
    0.03429595312379342, 0.032766326673201056, 0.02990363358474838,
    0.025841062402896218, 0.022000547216393395, 0.021439672354066006,
    0.024549548131161295, 0.02797854397456618, 0.029881667939201065,
    0.029872920676393862]
BATCHED_2E2O_SECTOR_E = [-92.74602749497889, -92.74788853927173,
    -92.75236773765309, -92.75683144832739, -92.7581163088716,
    -92.75812854323144, -92.75800578921702, -92.75512630241802,
    -92.7500264985312, -92.74669784353222, -92.74602749497892]
BATCHED_2E2O_SECTOR_EIG = [0.02987280828035408, 0.02440001093476864,
    0.021453028635699683, 0.029492734700362976, 0.03410394772578278,
    0.03486038260638778, 0.03276632667320287, 0.025841062402897932,
    0.02143967235406292, 0.027978543974565385, 0.029872920676415716]
# a batched step equals the sequential one (tests/test_parallel.py:78-98)
TOL_BATCH = 1e-12
TOL_BATCH_EIG = 1e-9
TOL_BATCH_ANCHOR = 1e-10
# the device loops against the host loops (tests/test_oo_pqc.py:206-240)
TOL_LOOP_E = 1e-11
TOL_LOOP_PARAMS = 1e-9
# the user-defined states (scripts/full_space_anchors.py 10e10o_unrestricted
# 8e8o_unrestricted 6e6o_utd 6e6o_complex 6e6o_callable, CPU JAX of commit
# 9ec90ac).  RDM cells: the state at theta = 0.07 * arange + 0.1, and
# (10e,10o) that state times a per-determinant phase exp(i phi), phi from
# numpy's default_rng(10).uniform(0, 2 pi) in canonical order; each RDM
# pair as (||gamma||_F, ||Gamma||_F, sum(M * Gamma)), M standard normal
# from default_rng(14) in Gamma's shape, held to 1e-10.  (12e,12o) has no
# CPU JAX anchor (a full-size run on a shared CPU): it is held to its own
# restricted RDMs through the spin sums, to the phase invariance and to
# its complex state's spin sums, each to 1e-12
RDM_ANCHORS = {
    "10e10o": {"unrestricted": [3.0326264871114974, 12.421691739810006,
                                11.034830066958754],
               "phased_restricted": [4.188503268701189, 17.907045240102978,
                                     9.757184533747925],
               "phased_unrestricted": [2.9830890651289046,
                                       11.955641429983835,
                                       11.607208643575207]},
    "8e8o": {"unrestricted": [2.6558680527439167, 9.449207803052952,
                              0.3991157827345679]},
}
TOL_RDM_ANCHOR = 1e-10
TOL_SPIN_SUM = 1e-12
# 3 NR iterations: the prebuilt (6e,6o) np_fabric L=2 program read
# up_then_down=True from init_zeros; the JAX test's complex construction
# on it (psi(theta[:16]) exp(i theta[16] n_0)) from theta0 = 0.1 *
# default_rng(6).standard_normal(17); a real callable wrapping the
# built-in program from init_zeros, whose JAX anchor is ANCHORS_6E6O[:3]
# to the last digit
ANCHORS_6E6O_UTD = [-91.65213123340516, -91.67450124881832,
                    -91.68654414164386]
ANCHORS_6E6O_COMPLEX = [-92.69605638258138, -92.70554994398806,
                        -92.73732758538263]
# the complex (2e,2o) ansatz to CASSCF (tests/test_custom_complex.py:121's
# bound)
TOL_COMPLEX_CASSCF = 1e-7
TOL_ENERGY = 1e-8
# the OO-VQE tutorial (examples/tutorial_oo_vqe.py): formaldimine (140, 80)
# sto-3g (4e,3o) np_fabric L=2, freeze_active, full_optimization
# (conv_tol=1e-10) from init_zeros, then 300 circuit-only Adam steps at
# 5e-2 on <psi|H|psi> at the RHF orbitals.  The JAX example's CPU run
# (python examples/tutorial_oo_vqe.py --platform cpu, JAX package of
# commit 83e22f3) printed the energies after NR iterations 1-22 (12
# decimals; the trajectory amplifies last bits: the port on the CPU
# leaves it by up to 9.5e-10 Ha at iteration 18, so it is printed beside
# the port's, and the end is held to CASSCF) and the last Adam energy
# (10 decimals), equal to CASCI of any spin, held to 1e-8
TUTORIAL_NEWTON_E = [
    -92.703322092633, -92.726525233319, -92.729054235118, -92.735940422369,
    -92.748376886661, -92.748595293148, -92.749178257388, -92.749205620669,
    -92.749220603642, -92.749245541605, -92.749262184941, -92.749295600726,
    -92.749351775536, -92.749452797047, -92.749580508069, -92.749779594056,
    -92.749909258366, -92.749949556349, -92.749951694599, -92.749953608450,
    -92.749953613727, -92.749953613727]
TUTORIAL_ADAM_E = -92.7367063372
# the noise study (examples/noise_study.py), cut from 5 variances x 5 seeds
# to its two ends x 2 seeds
NOISE_VARIANCES = (1e-8, 1e-3)
NOISE_SEEDS = range(2)
# the FLOP count (utils/flops.py) against the matmul FLOPs that
# torch.utils.flop_counter.FlopCounterMode sees one NR iteration run: a
# factor 2 either way catches a units error and is never widened
FLOP_BAND = (0.5, 2.0)
# cycles of the spin kernel that holds the card while the host queues a
# timed run (~5 ms at the H100's clocks)
SPIN_CYCLES = 10_000_000
# The first gather_rows_scaled (one warp per output row), the kernel the
# present one replaced: device ms of one launch at the shapes the phases
# time it, f64 unless marked, on an H100 80GB HBM3 at 700 W (python -m
# auto_oo_tpu_torch.scripts.sweep_rows_scaled --baseline SRC, SRC the
# grid_gather.cu of commit 5dc38cf; the faster of two turns), printed as
# "was" beside the new time
WAS_ROWS_MS = {
    "10e10o alpha float64": 0.0279, "10e10o beta float64": 0.0279,
    "12e12o alpha float64": 0.4208, "12e12o beta float64": 0.4205,
    "14e alpha 1716 float64": 4.8442, "14e beta 1716 float64": 4.4789,
    "14e alpha 1716 float32": 2.1591, "14e beta 1716 float32": 2.2589,
    "16e alpha 495@6435 float64": 6.5032,
    "16e beta 495@6435 float64": 10.7331,
    "16e alpha 14@6440 float64": 0.2390, "16e beta 14@6440 float64": 0.5673}

_MECH_SCRIPT = "scripts/experiment_gather_mechanisms.py"
SOURCE = {"gather_two_spin": "auto_oo_tpu_torch/csrc/grid_gather.cu",
          "gather_rows_scaled": "auto_oo_tpu_torch/csrc/grid_gather.cu",
          "gather_reduce": "auto_oo_tpu_torch/csrc/grid_gather.cu",
          "gather_reduce_cols": "auto_oo_tpu_torch/csrc/grid_gather.cu",
          "scatter_rows": "auto_oo_tpu_torch/csrc/grid_gather.cu",
          "gather_a": "auto_oo_tpu_torch/csrc/gather_mechanisms.cu",
          "gather_b": "auto_oo_tpu_torch/csrc/gather_mechanisms.cu",
          "gather_c": "auto_oo_tpu_torch/csrc/gather_mechanisms.cu"}
REPLACES = {"gather_two_spin": "auto_oo_tpu/ops/pallas_grid.py:110 on both "
                               "spin halves, with the callers' transposed "
                               "copies and adds at "
                               "auto_oo_tpu/ops/pallas_grid.py:259-262, "
                               ":354-357 and auto_oo_tpu/ops/grid.py:560-575",
            "gather_rows_scaled": "auto_oo_tpu/ops/pallas_grid.py:110",
            "gather_reduce": "auto_oo_tpu/ops/pallas_grid.py:194",
            "gather_reduce_cols": "auto_oo_tpu/ops/pallas_grid.py:194 with "
                                  "the caller's transpose at :270",
            "scatter_rows": "auto_oo_tpu/ops/pallas_grid.py:194 windowed, "
                            "for the XLA scatter at "
                            "auto_oo_tpu/ops/grid_hosted.py:260-262",
            "gather_a": f"{_MECH_SCRIPT}:119",
            "gather_b": f"{_MECH_SCRIPT}:152",
            "gather_c": f"{_MECH_SCRIPT}:190"}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def check_route_kernels(launches, kernels, what):
    """Each of a route's grid kernels was launched in ``what``, and
    gather_rows_scaled (which built Phi before gather_two_spin) was not."""
    for name in kernels:
        check(launches[name] > 0, f"kernel {name} was not launched by {what}")
    check(launches["gather_rows_scaled"] == 0,
          f"gather_rows_scaled was launched by {what}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, torch, reps=10, rounds=5):
    """Device time of one fn() in ms: CUDA events around ``reps`` calls
    back to back, queued behind a spin kernel so that the host's launch
    time does not show; median over ``rounds`` after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def launch_ms(fn, torch, reps=20):
    """Time of one fn() on an idle card in ms, host launch included (CUDA
    events around each call, median after warm-up): the method of the
    earliest kernel times in PERF.md."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def bound_ms(nbytes):
    """Least time to move nbytes at the H100's published HBM rate
    (utils/flops.py), ms."""
    from auto_oo_tpu_torch.utils.flops import HBM_BYTES_PER_S

    return nbytes / HBM_BYTES_PER_S * 1e3


@contextlib.contextmanager
def armijo_steps_taken():
    """The step length t of every damped-Newton update run inside the
    block: the Newton core's damped_newton_step_pure, wrapped for the
    block and restored after it."""
    from auto_oo_tpu_torch.models import oo_pqc as core

    step_fn = core.damped_newton_step_pure
    steps = []

    def spy(*args, **kwargs):
        out = step_fn(*args, **kwargs)
        steps.append(out[2])
        return out

    core.damped_newton_step_pure = spy
    try:
        yield steps
    finally:
        core.damped_newton_step_pure = step_fn


def armijo_trials(t):
    """The trials a host Armijo search of STEP's beta ran to take step t
    (utils/flops.armijo_trials)."""
    from auto_oo_tpu_torch.utils.flops import armijo_trials as trials

    return trials(t, STEP["beta"])


def flop_rates(label, pqc, oo, iter_s, steps, precision="f64"):
    """Prints per NR iteration the count of utils/flops.py (with the
    Armijo trials of its step), the achieved FLOP/s over its wall time
    and the share of the card's peak for ``precision``, beside the
    card."""
    from auto_oo_tpu_torch.utils import flops

    check(len(steps) == len(iter_s),
          f"{label}: {len(steps)} Newton steps for {len(iter_s)} times")
    for n, (sec, t) in enumerate(zip(iter_s, steps), 1):
        count = flops.nr_iteration_flops(pqc, oo,
                                         n_trials=armijo_trials(t))["total"]
        achieved, share = flops.mfu(count, sec, precision)
        print(f"  {label} iter {n}: {count / 1e9:.3f} GFLOP "
              f"({armijo_trials(t)} Armijo trials) in {sec:.4f} s: "
              f"{achieved / 1e12:.3f} TFLOP/s, {100 * share:.2f}% of "
              f"{flops.PEAKS[precision] / 1e12:.0f} TFLOP/s ({card_line()})")


def _nbytes(*tensors):
    return sum(v.numel() * v.element_size() for v in tensors)


def reduce_bytes(Y, src, s, t, cols):
    """Bytes gather_reduce (cols=False) or gather_reduce_cols (cols=True)
    must move: the Y elements of the valid (s != 0) entries once (whole
    rows of Nb for the row form, Na rows of one column each for the column
    form), the tables once and the output once."""
    n_valid = int((s != 0).sum())
    width = Y.shape[-2] if cols else Y.shape[-1]
    B = Y.numel() // (Y.shape[-3] * Y.shape[-2] * Y.shape[-1])
    out = B * src.shape[1] * width * Y.element_size()
    return (B * n_valid * width * Y.element_size() + _nbytes(src, s, t)
            + out)


_COLS_LISTS = {}


def cols_kernel(gk, Y, src, s, t, out=None):
    """gk.gather_reduce_cols with the compacted lists of (src, s) built
    once per pair of tables, as GridMaps.col_lists builds them once per
    maps on the routes (so a timed call times the kernel alone)."""
    hit = _COLS_LISTS.get((id(src), id(s)))
    if hit is None or hit[0] is not src or hit[1] is not s:
        hit = _COLS_LISTS[(id(src), id(s))] = (
            src, s, gk.reduce_cols_lists(src, s))
    return gk.gather_reduce_cols(Y, src, s, t, out=out, lists=hit[2])


def floor_share(ms, Y, src, s):
    """The column form's 32-byte sector floor and 128-byte line floor, and
    their shares of ``ms``."""
    out = ""
    for size in (32, 128):
        sec = sector_floor_bytes(Y, src, s, size)
        out += (f" {size}-byte floor {sec / 1e6:.1f} MB {bound_ms(sec):.4f}"
                f" ms (share {100 * bound_ms(sec) / ms:5.1f}%)")
    return out


def sector_floor_bytes(Y, src, s, sector=32):
    """The column form's sector floor: the ``sector``-byte pieces of Y
    that its valid elements touch (each valid (k, c) reads
    Y[k, a, src[k, c]] for every row a)."""
    import torch

    per_sector = sector // Y.element_size()
    B = Y.numel() // (Y.shape[-3] * Y.shape[-2] * Y.shape[-1])
    n2 = src.shape[0]
    piece = src.long() // per_sector
    key = (torch.arange(n2, device=src.device)[:, None]
           * (Y.shape[-1] // per_sector + 1) + piece)[s != 0]
    return B * int(torch.unique(key).numel()) * Y.shape[-2] * sector


def epq_bytes(Y, gm):
    """Bytes epq_sum must move: every Y element that either half needs
    (per pair, the union of the alpha half's source rows and the beta
    half's source columns), the tables of both halves and the output."""
    import torch

    srcA, sgnA, tB, srcB, sgnB, tA = gm.tables(Y)
    n_el = 0
    for k in range(gm.n2):
        rows = int(torch.unique(srcA[k][sgnA[k] != 0]).numel())
        cols = int(torch.unique(srcB[k][sgnB[k] != 0]).numel())
        n_el += rows * gm.Nb + gm.Na * cols - rows * cols
    B = Y.numel() // (gm.n2 * gm.dim)
    return (B * n_el + B * gm.dim) * Y.element_size() + _nbytes(
        srcA, sgnA, tB, srcB, sgnB, tA)


def epq_composite(gk, Y, gm):
    """epq_sum as it ran before the column form: the beta half through a
    transposed copy of Y, two row-form launches and a transposed add."""
    srcA, sgnA, tB, srcB, sgnB, tA = gm.tables(Y)
    Yg = Y.reshape(Y.shape[:-1] + (gm.Na, gm.Nb))
    outA = gk.gather_reduce(Yg, srcA, sgnA, tB)
    outBt = gk.gather_reduce(Yg.transpose(-1, -2).contiguous(), srcB, sgnB,
                             tA)
    return (outA + outBt.transpose(-1, -2)).reshape(Y.shape[:-2]
                                                    + (gm.dim,))


def _share(ms, nbytes):
    b = bound_ms(nbytes)
    return f"bound={b:.4f} ms share={100 * b / ms:5.1f}%"


def rows_share(gk, ms, args):
    """gather_rows_scaled's bound and re-read floor
    (grid_kernels.rows_scaled_bytes) with their shares of ``ms``; returns
    (text, bound ms)."""
    nb = gk.rows_scaled_bytes(*args)
    text = _share(ms, nb.bound)
    if nb.reread is not None:
        fl = bound_ms(nb.reread)
        text += f" re-read floor={fl:.4f} ms ({100 * fl / ms:5.1f}%)"
    return text, bound_ms(nb.bound)


def was(key):
    """The replaced kernel's time at this shape (WAS_ROWS_MS), for the
    printed line."""
    ms = WAS_ROWS_MS.get(key)
    return "" if ms is None else f" (was {ms:.4f} ms)"


def kernel_phase(torch, gk, gh, grid, dev):
    """Kernels against their plain versions; returns per-kernel stats."""
    tol = {("gather_rows_scaled", torch.float64): 1e-15,
           ("gather_rows_scaled", torch.float32): 1e-6,
           ("gather_reduce", torch.float64): 1e-13,
           ("gather_reduce", torch.float32): 1e-5,
           ("gather_reduce_cols", torch.float64): 1e-13,
           ("gather_reduce_cols", torch.float32): 1e-5}
    kern = {"gather_rows_scaled": (gk.gather_rows_scaled,
                                   gk.gather_rows_scaled_plain),
            "gather_reduce": (gk.gather_reduce, gk.gather_reduce_plain),
            "gather_reduce_cols": (lambda *a: cols_kernel(gk, *a),
                                   gk.gather_reduce_cols_plain)}
    stats = {k: {"max_abs_err": 0.0, "ms": None, "plain_ms": None,
                 "bound_ms": None, "library_ms": None}
             for k in ["gather_two_spin"] + list(kern) + ["scatter_rows"]}
    gen = torch.Generator(device="cpu").manual_seed(1234)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen,
                           dtype=torch.float64).to(device=dev, dtype=dtype)

    def compare(name, dtype, args, label):
        fn, plain = kern[name]
        out = fn(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        check(out.shape == ref.shape, f"{name} {label}: shape "
              f"{tuple(out.shape)} != {tuple(ref.shape)}")
        check(bool(torch.isfinite(out).all()), f"{name} {label}: non-finite")
        err = float((out - ref).abs().max())
        rel = err / max(float(ref.abs().max()), 1e-300)
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
        check(rel <= tol[(name, dtype)],
              f"{name} {label}: relative error {rel:.3e} > "
              f"{tol[(name, dtype)]:.0e}")
        return err, rel

    # (10e,10o): B = 1, 3, 5 tangents per call; (12e,12o): one (chunk 1)
    for ncas, batches in ((10, (1, 3, 5)), (12, (1,))):
        gm = grid.build_grid_maps(ncas, ncas, device=dev)
        Na, Nb, n2 = gm.Na, gm.Nb, gm.n2
        valid = float((gm.sgnA != 0).float().mean())
        print(f"({ncas}e,{ncas}o) grid: Na={Na} Nb={Nb} n2={n2} D={gm.dim} "
              f"valid (pair, row) entries {100 * valid:.1f}%")
        for dtype in (torch.float64, torch.float32):
            sgnA, tB, sgnB, tA = gm.scales(dtype)
            halves = {"alpha": (gm.srcA, sgnA, tB, Na, Nb),
                      "beta": (gm.srcB, sgnB, tA, Nb, Na)}
            for B in batches:
                # Y in the grid's layout; the beta half's row form reads
                # its transposed copy, its column form Y itself
                Y = rand((B, n2, Na, Nb), dtype)
                calls = []
                for half, (src, s, t, rows, cols) in halves.items():
                    x = rand((B, rows, cols), dtype)
                    Yh = Y if half == "alpha" else \
                        Y.transpose(-1, -2).contiguous()
                    calls += [
                        ("gather_rows_scaled", half, (x, src, s, t),
                         _nbytes(x, src, s, t) + B * n2 * rows * cols
                         * x.element_size()),
                        ("gather_reduce", half, (Yh, src, s, t),
                         reduce_bytes(Yh, src, s, t, False))]
                calls.append(("gather_reduce_cols", "beta",
                              (Y, gm.srcB, sgnB, tA),
                              reduce_bytes(Y, gm.srcB, sgnB, tA, True)))
                for name, half, args, nbytes in calls:
                    label = f"{ncas}e {half} B={B} {str(dtype)[6:]}"
                    err, rel = compare(name, dtype, args, label)
                    fn, plain = kern[name]
                    ms = time_ms(lambda: fn(*args), torch)
                    one = launch_ms(lambda: fn(*args), torch)
                    pms = time_ms(lambda: plain(*args), torch)
                    extra = (floor_share(ms, *args[:3])
                             if name == "gather_reduce_cols" else "")
                    print(f"  {name:18s} {label:26s} "
                          f"max_abs_err={err:.3e} rel={rel:.3e} "
                          f"kernel={ms:.4f} ms (one launch {one:.4f}) "
                          f"plain={pms:.4f} ms {_share(ms, nbytes)}{extra}")
                    if ((ncas == 10 and dtype == torch.float64 and B == 5)
                            and (half == "alpha"
                                 or name == "gather_reduce_cols")):
                        stats[name].update(ms=ms, plain_ms=pms,
                                           bound_ms=bound_ms(nbytes))
                    del args
                del calls
                # both spin halves of Phi in one launch, the full grid
                # (and, for the last B, a middle and a ragged last window)
                x = rand((B, Na, Nb), dtype)
                tag = f"{ncas}e B={B} {str(dtype)[6:]}"
                two_spin_check(torch, gk, grid, x, gm, 0, Na, tag, stats)
                if B == batches[-1]:
                    for r0, r1 in ((Na // 3, 2 * Na // 3), (Na - 30, Na)):
                        two_spin_check(torch, gk, grid, x, gm, r0, r1,
                                       f"{tag} [{r0}, {r1})", stats,
                                       timed=False)
                del x
                if B == batches[-1]:
                    epq_compare(torch, gk, grid, gm, Y, f"{ncas}e B={B} "
                                f"{str(dtype)[6:]}", tol[("gather_reduce",
                                                          dtype)])
                del Y
            # the hosted scatter on two windows of the maps' rows (the
            # second ragged), on B states
            B = batches[-1]
            for r0, r1 in ((0, Na // 3), (Na // 3, Na)):
                label = f"{ncas}e [{r0}, {r1}) B={B} {str(dtype)[6:]}"
                err, rel = scatter_check(
                    torch, gk, gh, gm, rand((B, n2, r1 - r0, Nb), dtype),
                    rand((B, Na, Nb), dtype), r0, label)
                st = stats["scatter_rows"]
                st["max_abs_err"] = max(st["max_abs_err"], err)
                print(f"  {'scatter_rows':18s} {label:26s} "
                      f"max_abs_err={err:.3e} rel={rel:.3e} bit-identical "
                      f"over two launches")
    # ragged random shapes with leading batch dims and invalid entries:
    # Nb = 17 (scalar loads of the row form), Nb = 20 (16-byte vectors)
    g2 = torch.Generator(device="cpu").manual_seed(7)
    for ns, na, nb, k2 in ((11, 13, 17, 5), (9, 10, 20, 70)):
        src = torch.randint(0, ns, (k2, na), generator=g2, dtype=torch.int32)
        invalid = torch.rand((k2, na), generator=g2) < 0.3
        invalid[:, 3] = True
        src[invalid] = 0
        for dtype in (torch.float64, torch.float32):
            s = torch.randn((k2, na), generator=g2, dtype=torch.float64)
            s[invalid] = 0.0
            t = torch.randn((k2, nb), generator=g2, dtype=torch.float64)
            s, t = s.to(dev, dtype), t.to(dev, dtype)
            srcd = src.to(dev)
            x = rand((2, 3, ns, nb), dtype)
            Y = rand((2, 3, k2, ns, nb), dtype)
            Yc = Y.transpose(-1, -2).contiguous()
            for name, args in (("gather_rows_scaled", (x, srcd, s, t)),
                               ("gather_reduce", (Y, srcd, s, t)),
                               ("gather_reduce_cols",
                                (Yc, srcd, torch.sign(s), t))):
                err, rel = compare(name, dtype, args,
                                   f"ragged {str(dtype)[6:]}")
                print(f"  {name:18s} ragged (2,3)x({ns},{na},{nb}) n2={k2} "
                      f"{str(dtype)[6:]} max_abs_err={err:.3e} "
                      f"rel={rel:.3e}")
            # gather_two_spin on random maps over an (na, nb) grid
            rm = random_maps(torch, grid, na, nb, k2, g2, dev)
            x = rand((2, 3, na, nb), dtype)
            for r0, r1 in ((0, na), (na // 3, na), (3, 4)):
                two_spin_check(torch, gk, grid, x, rm, r0, r1,
                               f"ragged (2,3)x({na},{nb}) n2={k2} "
                               f"[{r0}, {r1}) {str(dtype)[6:]}", stats,
                               timed=False, composite=False)
    return stats


def random_maps(torch, grid, na, nb, n2, gen, dev):
    """Port GridMaps of random tables over an (na, nb) grid: +-1 signs
    with ~30% invalid (src 0, sign 0) entries, grid row 3 with no valid
    alpha pair."""
    def half(n, empty):
        src = torch.randint(0, n, (n2, n), generator=gen, dtype=torch.int32)
        sgn = 2 * torch.randint(0, 2, (n2, n), generator=gen) - 1
        invalid = torch.rand((n2, n), generator=gen) < 0.3
        invalid[:, empty] = True
        src[invalid], sgn[invalid] = 0, 0
        t = 2 * torch.randint(0, 2, (n2, n), generator=gen) - 1
        return src.numpy(), sgn.numpy(), t.numpy()

    srcA, sgnA, tA = half(na, 3)
    srcB, sgnB, tB = half(nb, 2)
    perm = np.arange(na * nb)
    return grid.GridMaps(srcA, sgnA, tB, srcB, sgnB, tA, perm, perm,
                         device=dev)


def epq_compare(torch, gk, grid, gm, Yg, label, tol):
    """epq_sum in place (row form + column form) against the composite
    it replaced, on the same Y: equal to rounding, and both timed in the
    same call, in turns (composite, in place, in place, composite)."""
    Y = Yg.reshape(Yg.shape[:-2] + (gm.dim,))
    new = grid.epq_sum(Y, gm)
    old = epq_composite(gk, Y, gm)
    torch.cuda.synchronize()
    err = float((new - old).abs().max())
    rel = err / max(float(old.abs().max()), 1e-300)
    check(rel <= tol, f"epq_sum {label}: in place vs composite relative "
          f"error {rel:.3e} > {tol:.0e}")
    del new, old
    o1 = time_ms(lambda: epq_composite(gk, Y, gm), torch)
    n1 = time_ms(lambda: grid.epq_sum(Y, gm), torch)
    n2 = time_ms(lambda: grid.epq_sum(Y, gm), torch)
    o2 = time_ms(lambda: epq_composite(gk, Y, gm), torch)
    Yt = Yg.transpose(-1, -2)
    copy = time_ms(Yt.contiguous, torch)
    nbytes = epq_bytes(Y, gm)
    print(f"  epq_sum {label:16s} in place {n1:.4f}, {n2:.4f} ms  "
          f"composite {o1:.4f}, {o2:.4f} ms (its transposed copy of Y "
          f"alone {copy:.4f} ms, bound {bound_ms(2 * _nbytes(Y)):.4f})  "
          f"{_share(0.5 * (n1 + n2), nbytes)} "
          f"(Y needed {nbytes / 1e6:.1f} MB)  in place/composite "
          f"{(n1 + n2) / (o1 + o2):.3f}  max|diff|={err:.3e} "
          f"bitwise={'yes' if err == 0 else 'no'}")


def two_spin_share(gk, ms, x, gm, r0, r1):
    """gather_two_spin's bound and, where x does not fit half the L2, its
    re-read floor for grid rows [r0, r1) of x
    (grid_kernels.two_spin_bytes), with their shares of ``ms``; returns
    (the printed text, the bound in ms)."""
    nb = gk.two_spin_bytes(x, gm.two_spin_tables(), r0, r1)
    b = bound_ms(nb.bound)
    text = (f"bound={b:.4f} ms share={100 * b / ms:5.1f}% "
            f"({nb.bound / 1e9:.3f} GB), ")
    if nb.reread is None:
        return text + "no re-read floor (x fits half the L2)", b
    f = bound_ms(nb.reread)
    return (text + f"re-read floor={f:.4f} ms share={100 * f / ms:5.1f}% "
            f"({nb.reread / 1e9:.3f} GB)"), b


def two_spin_composite(gk, grid, x, gm, r0, r1):
    """Phi over grid rows [r0, r1) as it ran before gather_two_spin: two
    gather_rows_scaled launches (the beta half on a transposed copy of the
    rows) and the transposed add."""
    srcA_k, sgnA_k, tA_k = grid._row_tables(gm, x, r0, r1)
    _, _, tB, srcB, sgnB, _ = gm.tables(x)
    pa = gk.gather_rows_scaled(x, srcA_k, sgnA_k, tB)
    zt = x[..., r0:r1, :].transpose(-1, -2).contiguous()
    pb = gk.gather_rows_scaled(zt, srcB, sgnB, tA_k)
    return pa.add_(pb.transpose(-1, -2))


def _two_spin_plain(gk, x, tabs, r0, r1, step):
    """The plain version on ``step`` pairs at a time (all at once for
    None): yields (first pair, its slab of Phi)."""
    n2 = tabs[0].shape[0]
    step = step or n2
    for k0 in range(0, n2, step):
        yield k0, gk.gather_two_spin_plain(
            x, *(t[k0:k0 + step] for t in tabs), r0, r1)


def two_spin_check(torch, gk, grid, x, gm, r0, r1, label, stats,
                   step=None, timed=True, composite=True):
    """gather_two_spin over grid rows [r0, r1) of x (..., Na, Nb) against
    its plain version (``step`` pairs at a time) and against the composite
    it replaced (two gather_rows_scaled launches, the transposed copy and
    add), equal as values; with ``timed``, the kernel and the composite in
    turns (composite, kernel, kernel, composite), the plain version, the
    bound and the re-read floor.  Returns the timings (or None)."""
    tabs = gm.phi_tables(x)
    compact = gm.two_spin_tables()

    def kernel():
        return gk.gather_two_spin(x, compact, r0, r1)

    out = kernel()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"gather_two_spin {label}: "
          "non-finite")
    err = 0.0
    for k0, ref in _two_spin_plain(gk, x, tabs, r0, r1, step):
        sl = out[..., k0:k0 + ref.shape[-3], :, :]
        check(sl.shape == ref.shape, f"gather_two_spin {label}: shape "
              f"{tuple(sl.shape)} != {tuple(ref.shape)}")
        err = max(err, float((sl - ref).abs().max()))
        check(torch.equal(sl, ref), f"gather_two_spin {label}: not equal "
              f"to plain (max abs err {err:.3e})")
        del ref, sl
    st = stats["gather_two_spin"]
    st["max_abs_err"] = max(st["max_abs_err"], err)
    same = ""
    if composite:
        old = two_spin_composite(gk, grid, x, gm, r0, r1)
        torch.cuda.synchronize()
        check(torch.equal(out, old), f"gather_two_spin {label}: not equal "
              "to the composite it replaced")
        del old
        same = " equal to the composite"
    del out
    if not timed:
        print(f"  gather_two_spin {label:28s} equal to plain{same}")
        return None
    c1 = time_ms(lambda: two_spin_composite(gk, grid, x, gm, r0, r1), torch)
    k1 = time_ms(kernel, torch)
    k2 = time_ms(kernel, torch)
    c2 = time_ms(lambda: two_spin_composite(gk, grid, x, gm, r0, r1), torch)
    pms = time_ms(lambda: list(_two_spin_plain(gk, x, tabs, r0, r1, step)),
                  torch, reps=2 if step else 10, rounds=3 if step else 5)
    ms = 0.5 * (k1 + k2)
    shares, bms = two_spin_share(gk, ms, x, gm, r0, r1)
    plan = gk.plan_two_spin(x.numel() // (gm.Na * gm.Nb), gm.Na, r1 - r0,
                            gm.Nb, gm.n2, x.element_size())
    print(f"  gather_two_spin {label:28s} equal to plain{same}; kernel "
          f"{k1:.4f}, {k2:.4f} ms  composite {c1:.4f}, {c2:.4f} ms  "
          f"kernel/composite {(k1 + k2) / (c1 + c2):.3f}  plain {pms:.4f} ms"
          f"{f' ({step} pairs at a time)' if step else ''}  {shares}  "
          f"plan {tuple(plan)}")
    return {"ms": ms, "plain_ms": pms, "bound_ms": bms,
            "composite_ms": 0.5 * (c1 + c2)}


def _plans(gm, x, dtype):
    """B's and C's launch plans for x on this card, with what the card
    holds of each; returns the line that prints them."""
    ns, nb = x.shape
    item, limit = x.element_size(), gm.smem_limit()
    pb = gm.plan_b(ns, nb, item, limit)
    pc = gm.plan_c(ns, nb, item, limit)
    return (f"B cluster={pb.cluster} W={pb.W} rows/block={pb.rows_per_block}"
            f" smem={pb.smem} clusters held={gm.held('b', dtype, ns, pb)}; "
            f"C Wc={pc.Wc} stages={pc.stages} smem={pc.smem} "
            f"blocks/SM={gm.held('c', dtype, ns, pc)}")


def _cluster_sweep(torch, gm, x, src, s, ref, gb):
    """B at each cluster size the card holds, bit for bit against ref and
    timed; returns the printed line."""
    ns, nb = x.shape
    parts = []
    for c in (2, 4, 8, 16):
        plan = gm.plan_b(ns, nb, x.element_size(), gm.smem_limit(),
                         cluster=c)
        held = gm.held("b", x.dtype, ns, plan)
        if held == 0:
            parts.append(f"C={c}: not held")
            continue
        out = gm.gather_b(x, src, s, cluster=c)
        torch.cuda.synchronize()
        check(torch.equal(out, ref), f"gather_b cluster={c}: not "
              f"bit-identical to plain")
        del out
        ms = time_ms(lambda: gm.gather_b(x, src, s, cluster=c), torch)
        parts.append(f"C={c} W={plan.W} x{held}: {ms:.4f} ms "
                     f"({gb / ms * 1e3:.1f} GB/s)")
    return "  ".join(parts)


def mechanism_phase(torch, gm, exp, dev):
    """The probes A, B, C against the plain gather, bit for bit; returns
    per-kernel stats."""
    names = ("gather_a", "gather_b", "gather_c")
    stats = {k: {"max_abs_err": 0.0, "ms": None, "plain_ms": None,
                 "bound_ms": None} for k in names}
    rng = np.random.default_rng(11)
    ns, nb, n2, na = 24, 384, 7, 40
    ragged_src = rng.integers(0, ns, (n2, na)).astype(np.int32)
    ragged_src[0, 0] = ragged_src[-1, -1] = ns - 1
    ragged = (rng.standard_normal((ns, nb)), ragged_src,
              rng.standard_normal((n2, na)))
    cases = [(f"ncas={ncas}", ncas) for ncas in (10, 12)] + [
        (f"ragged ({ns},{nb})x({n2},{na})", None)]
    for label, ncas in cases:
        for dtype in (torch.float32, torch.float64):
            if ncas is None:
                x, src, s = (torch.from_numpy(a).to(
                    dev, torch.int32 if a.dtype == np.int32 else dtype)
                    for a in ragged)
            else:
                x, src, s, _ = exp.make_inputs(ncas, 1, dtype, dev)
            ref = gm.gather_rows_plain(x, src, s)
            gb = ref.numel() * ref.element_size() / 1e9
            nbytes = _nbytes(x, src, s, ref)

            def plain():
                return gm.gather_rows_plain(x, src, s)

            p0 = time_ms(plain, torch)
            row = {}
            for name in names:
                fn = getattr(gm, name)
                out = fn(x, src, s)
                torch.cuda.synchronize()
                check(out.shape == ref.shape and out.dtype == ref.dtype,
                      f"{name} {label}: shape/dtype")
                err = float((out - ref).abs().max())
                stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"],
                                                 err)
                check(torch.equal(out, ref),
                      f"{name} {label} {dtype}: not bit-identical to plain "
                      f"(max abs err {err:.3e})")
                del out
                row[name] = time_ms(lambda: fn(x, src, s), torch)
            pms = 0.5 * (p0 + time_ms(plain, torch))
            tag = f"{label} {str(dtype)[6:]}"
            print(f"  {tag:30s} out {gb:.3f} GB  bound "
                  f"{bound_ms(nbytes):.4f} ms  plain {pms:.4f} ms "
                  f"({gb / pms * 1e3:7.1f} GB/s)  " + "  ".join(
                      f"{n[-1].upper()} {ms:.4f} ms ({gb / ms * 1e3:7.1f} "
                      f"GB/s)" for n, ms in row.items()))
            # C reads its whole 8-row box for every output row
            print(f"    {_plans(gm, x, dtype)}; C reads "
                  f"{8 * gb:.3f} GB from L2: "
                  f"{8 * gb / row['gather_c']:.1f} TB/s")
            if ncas is not None:
                print(f"    B cluster sweep: "
                      f"{_cluster_sweep(torch, gm, x, src, s, ref, gb)}")
            if ncas == 12 and dtype == torch.float64:
                for name, ms in row.items():
                    stats[name].update(ms=ms, plain_ms=pms,
                                       bound_ms=bound_ms(nbytes))
            del ref
    return stats


def entry_point_phase(gm, gk, exp):
    """The probes' entry point once at ncas = 10, K = 4; returns the
    launches counted during it (the probes' and, for its variant L,
    gather_rows_scaled's)."""
    gm.reset_launches()
    gk.reset_launches()
    res = exp.main(["10", "4"])
    launches = dict(gm.LAUNCHES,
                    gather_rows_scaled=gk.LAUNCHES["gather_rows_scaled"])
    for key, r in res.items():
        check(r is not None, f"entry point: variant {key} failed")
        if key != "plain":
            check(r["relerr"] == 0.0,
                  f"entry point: variant {key} relerr {r['relerr']}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched by the entry point")
    print(f"  launches: {launches}")
    return launches


def slice_phase(torch, P, gk):
    """4 NR iterations of the (10e,10o) slice, built on the port's
    default device (no device=); returns the kernel launches counted
    during them."""
    from auto_oo_tpu_torch.utils.misc import get_formal_geo

    t0 = time.perf_counter()
    mol = P.Moldata(get_formal_geo(140, 80), "sto-3g")
    pqc = P.Parameterized_circuit(10, 10, ansatz="np_fabric", n_layers=2,
                                  sector=True)
    check(pqc.init_zeros().device.type == "cuda",
          f"default device is {pqc.init_zeros().device}, not the card")
    oo = P.OO_pqc(pqc, mol, 10, 10, freeze_active=True)
    print(f"(10e,10o) setup: {time.perf_counter() - t0:.2f} s "
          f"(n_theta={pqc.theta_shape}, n_kappa={oo.n_kappa}, "
          f"D={pqc.state_dim}, nao={oo.nao})")

    stamps = []

    class Stamp:
        def log(self, n, energy, **kw):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

    theta0 = pqc.init_zeros()
    torch.cuda.synchronize()
    gk.reset_launches()
    with armijo_steps_taken() as steps:
        t_start = time.perf_counter()
        energies, thetas, _, oaos, eigs = oo.full_optimization(
            theta0, max_iterations=4, alpha=1e-4, beta=0.5, mu=1e-6,
            rho=1.1, lambda_min=1e-6, monitor=Stamp())
    launches = dict(gk.LAUNCHES)
    iter_s = [b - a for a, b in zip([t_start] + stamps[:-1], stamps)]
    for i, (e, ref) in enumerate(zip(energies, ANCHORS_10E10O)):
        print(f"  iter {i + 1}: E = {e:.14f}  JAX-CPU {ref:.14f}  "
              f"diff {e - ref:+.3e}  wall {iter_s[i]:.3f} s  "
              f"lowest eig {eigs[i]:+.6e}")
    check(len(energies) == 4, f"ran {len(energies)} iterations, not 4")
    for i, (e, ref) in enumerate(zip(energies, ANCHORS_10E10O)):
        check(abs(e - ref) <= TOL_ENERGY,
              f"(10e,10o) iteration {i + 1}: |{e} - {ref}| > {TOL_ENERGY}")
    check_route_kernels(launches, FUSED_KERNELS, "the slice")
    psi = pqc.state(thetas[-1])
    torch.cuda.synchronize()
    check(psi.shape == (pqc.state_dim,), f"state shape {tuple(psi.shape)}")
    check(bool(torch.isfinite(psi).all()), "non-finite final state")
    norm = float(psi @ psi)
    check(abs(norm - 1.0) < 1e-12, f"final state norm {norm}")
    check(bool(torch.isfinite(oaos[-1]).all()), "non-finite OAO-MO")
    print(f"  launches: {launches}; median wall of iterations 2-4: "
          f"{statistics.median(iter_s[1:]):.4f} s")
    flop_rates("(10e,10o)", pqc, oo, iter_s, steps)
    return launches


def sector12_phase(torch, P, gk, dev):
    """3 NR iterations of the (12e,12o) sector path; returns the grid
    kernel launches counted during them and (mol, pqc, oo, the initial
    OAO matrix, the energies) for the phases that reuse them."""
    from auto_oo_tpu_torch.utils.misc import get_formal_geo

    t0 = time.perf_counter()
    mol = P.Moldata(get_formal_geo(140, 80), "6-31g")
    pqc = P.Parameterized_circuit(12, 12, ansatz="np_fabric", n_layers=1,
                                  sector=True, device=dev)
    oo = P.OO_pqc(pqc, mol, 12, 12, freeze_active=True)
    torch.cuda.synchronize()
    print(f"(12e,12o) setup: {time.perf_counter() - t0:.2f} s "
          f"(n_theta={pqc.theta_shape}, n_kappa={oo.n_kappa}, "
          f"D={pqc.state_dim}, route={oo._core['route']})")
    check(oo._core["route"] == "staged",
          f"(12e,12o) route {oo._core['route']}, expected staged")

    stamps = []

    class Stamp:
        def log(self, n, energy, **kw):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

    theta0 = pqc.init_zeros()
    oao0 = oo.oao_mo_coeff.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gk.reset_launches()
    with armijo_steps_taken() as steps:
        t_start = time.perf_counter()
        energies, thetas, _, oaos, eigs = oo.full_optimization(
            theta0, max_iterations=len(ANCHORS_12E12O), alpha=1e-4,
            beta=0.5, mu=1e-6, rho=1.1, lambda_min=1e-6, monitor=Stamp())
    launches = dict(gk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    iter_s = [b - a for a, b in zip([t_start] + stamps[:-1], stamps)]
    for i, (e, ref) in enumerate(zip(energies, ANCHORS_12E12O)):
        print(f"  iter {i + 1}: E = {e:.14f}  JAX-CPU {ref:.14f}  "
              f"diff {e - ref:+.3e}  wall {iter_s[i]:.3f} s  "
              f"lowest eig {eigs[i]:+.6e}")
    check(len(energies) == len(ANCHORS_12E12O),
          f"ran {len(energies)} iterations, not {len(ANCHORS_12E12O)}")
    for i, (e, ref) in enumerate(zip(energies, ANCHORS_12E12O)):
        check(abs(e - ref) <= TOL_ENERGY,
              f"(12e,12o) iteration {i + 1}: |{e} - {ref}| > {TOL_ENERGY}")
    check_route_kernels(launches, FUSED_KERNELS, "the (12e,12o) run")
    flop_rates("(12e,12o)", pqc, oo, iter_s, steps)
    # the device loop refuses the staged sizes, as the JAX package does
    try:
        oo.full_optimization(theta0, device_loop=True)
    except ValueError as exc:
        check("staged" in str(exc), f"(12e,12o) device_loop refusal: {exc}")
        print(f"  device_loop=True refused: {exc}")
    else:
        check(False, "(12e,12o) device_loop=True ran")
    psi = pqc.state(thetas[-1])
    torch.cuda.synchronize()
    check(psi.shape == (pqc.state_dim,), f"state shape {tuple(psi.shape)}")
    check(bool(torch.isfinite(psi).all()), "non-finite final state")
    norm = float(psi @ psi)
    check(abs(norm - 1.0) < 1e-12, f"final state norm {norm}")
    check(bool(torch.isfinite(oaos[-1]).all()), "non-finite OAO-MO")
    # peaks of the parts: the tangent-batched sweeps (state + J forward,
    # circuit-Hessian reverse) and one line-search energy
    theta = thetas[-1]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    psi_g, J = pqc._state_and_jacobian_grid(theta)
    pqc._state_hessian_dot_grid(theta, 2.0 * psi_g, psi_g, J)
    torch.cuda.synchronize()
    sweeps = torch.cuda.max_memory_allocated() - base
    del psi_g, J
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    oo.energy_from_parameters(theta)
    torch.cuda.synchronize()
    energy_peak = torch.cuda.max_memory_allocated() - base
    print(f"  launches: {launches}; peak device memory of the "
          f"iterations {peak / 1e9:.3f} GB (max_memory_allocated); above "
          f"the resident set: J + Hessian sweeps {sweeps / 1e9:.3f} GB, "
          f"one energy {energy_peak / 1e9:.3f} GB")
    return launches, (mol, pqc, oo, oao0, energies)


@contextlib.contextmanager
def forced_hosting(gh):
    """The hosting threshold at 1 byte while OO_pqc objects are built (the
    route is chosen at construction), restored after."""
    saved = gh._HOSTED_MIN_BYTES
    gh._HOSTED_MIN_BYTES = 1
    try:
        yield
    finally:
        gh._HOSTED_MIN_BYTES = saved


def routes_equal_fused_phase(torch, P, gk, gh, grid):
    """grad_hess of the (10e,10o) slice at a seeded theta on the streamed
    route (row chunk 37 of 252, pair block 23 of 100: ragged last pieces)
    and on the hosted route forced, in its per-tangent form (row chunk 37;
    18 where its per-tangent pass builds two Phi chunks) and in its Gram
    form (the cross sweep over the 29-state stack in chunks of 37 rows,
    one H psi pass), against the fused route, all on the card, f64."""
    from auto_oo_tpu_torch.utils.misc import get_formal_geo

    mol = P.Moldata(get_formal_geo(140, 80), "sto-3g")
    out, launches = {}, {}
    plan = grid.StreamPlan(37, 23, None)
    for name, kw, force in (
            ("fused", {}, False),
            ("streamed", {"stream_plan": plan}, False),
            ("hosted", {"stream_plan": plan, "hosted_form": "per_tangent"},
             True),
            ("gram", {"stream_plan": plan, "hosted_form": "gram"}, True)):
        pqc = P.Parameterized_circuit(10, 10, ansatz="np_fabric",
                                      n_layers=2, sector=True)
        with (forced_hosting(gh) if force else contextlib.nullcontext()):
            oo = P.OO_pqc(pqc, mol, 10, 10, freeze_active=True, **kw)
        route = "hosted" if force else name
        check(oo._core["route"] == route,
              f"(10e,10o) route {oo._core['route']}, expected {route}")
        check(oo._core["hosted_form"] == kw.get("hosted_form"),
              f"(10e,10o) hosted form {oo._core['hosted_form']}")
        theta = 0.1 * np.random.default_rng(21).standard_normal(
            pqc.theta_shape)
        torch.cuda.synchronize()
        gk.reset_launches()
        t0 = time.perf_counter()
        out[name] = oo._grad_hess(theta)
        torch.cuda.synchronize()
        launches[name] = dict(gk.LAUNCHES)
        print(f"  {name:8s} grad_hess {time.perf_counter() - t0:.3f} s "
              f"(n_kappa={oo.n_kappa}), launches {launches[name]}")
    e_f, g_f, h_f = out["fused"]
    for route, kernels in (("streamed", FUSED_KERNELS),
                           ("hosted", HOSTED_KERNELS),
                           ("gram", HOSTED_KERNELS)):
        e_r, g_r, h_r = out[route]
        de = abs(float(e_r - e_f))
        dg = float((g_r - g_f).abs().max())
        dh = float((h_r - h_f).abs().max())
        print(f"  {route}: |de0| {de:.3e}  max|dgrad| {dg:.3e}  max|dhess| "
              f"{dh:.3e}")
        check(de <= 1e-11, f"{route} e0 differs by {de}")
        check(dg <= 1e-11, f"{route} gradient differs by {dg}")
        check(dh <= 1e-9, f"{route} Hessian differs by {dh}")
        check_route_kernels(launches[route], kernels, f"the {route} route")


def sector14_setup(torch, P):
    """The (14e,14o) problem on the default device; returns (pqc, oo)."""
    t0 = time.perf_counter()
    mol = P.Moldata(H14_GEOMETRY, "sto-3g")
    pqc = P.Parameterized_circuit(14, 14, ansatz="np_fabric", n_layers=1,
                                  sector=True)
    oo = P.OO_pqc(pqc, mol, 14, 14, freeze_active=True)
    torch.cuda.synchronize()
    plan = oo._core["plan"]
    print(f"(14e,14o) setup: {time.perf_counter() - t0:.2f} s "
          f"(n_theta={pqc.theta_shape}, n_kappa={oo.n_kappa}, "
          f"D={pqc.state_dim}, route={oo._core['route']}, row chunk "
          f"{plan and plan.row_chunk}, pair block {plan and plan.pair_block})")
    check(oo._core["route"] == "streamed",
          f"(14e,14o) route {oo._core['route']}, expected streamed")
    return mol, pqc, oo


def _slab_err(out, plain, args, step=28):
    """Max abs error of gather_rows_scaled's out against its plain version,
    made a slab of pairs at a time (the plain temporaries of a whole
    (n2, rows, Nb) chunk would crowd the card); returns (err, rel)."""
    x, src, s, t = args
    err = scale = 0.0
    for k0 in range(0, src.shape[0], step):
        ref = plain(x, src[k0:k0 + step], s[k0:k0 + step], t[k0:k0 + step])
        err = max(err, float((out[..., k0:k0 + step, :, :] - ref)
                             .abs().max()))
        scale = max(scale, float(ref.abs().max()))
        del ref
    return err, err / max(scale, 1e-300)


def streamed_kernel_phase(torch, gk, grid, oo, stats):
    """Each grid kernel at the (14e,14o) streamed shapes of ``oo``'s plan
    against its plain version, f64 and f32, timed beside its bound; the
    f64 figures go into ``stats``."""
    gm = oo.pqc.sector_maps
    plan = oo._core["plan"]
    Na, Nb, n2, rows, pb = gm.Na, gm.Nb, gm.n2, plan.row_chunk, \
        plan.pair_block
    dev = gm.device
    tol = {("rows", torch.float64): 1e-15, ("rows", torch.float32): 1e-6,
           ("reduce", torch.float64): 1e-13, ("reduce", torch.float32): 1e-5}
    gen = torch.Generator(device=dev).manual_seed(14)
    blk = grid.pair_slice(gm, 0, pb)
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype)[6:]
        like = torch.zeros((), dtype=dtype, device=dev)
        _, _, tB, srcB, sgnB, _ = gm.tables(like)
        srcA_k, sgnA_k, tA_k = grid._row_tables(gm, like, 0, rows)
        x = torch.randn((Na, Nb), generator=gen, dtype=dtype, device=dev)
        for half, args in (
                ("alpha", (x, srcA_k, sgnA_k, tB)),
                ("beta", (x[:rows].T.contiguous(), srcB, sgnB, tA_k))):
            out = gk.gather_rows_scaled(*args)
            torch.cuda.synchronize()
            err, rel = _slab_err(out, gk.gather_rows_scaled_plain, args)
            del out
            check(rel <= tol[("rows", dtype)],
                  f"gather_rows_scaled 14e {half} {tag}: relative error "
                  f"{rel:.3e}")
            ms = time_ms(lambda: gk.gather_rows_scaled(*args), torch)
            pms = time_ms(lambda: gk.gather_rows_scaled_plain(*args), torch,
                          reps=2, rounds=3)
            share, bms = rows_share(gk, ms, args)
            print(f"  gather_rows_scaled 14e {half:5s} {tag} x "
                  f"{tuple(args[0].shape)} src {tuple(args[1].shape)} "
                  f"max_abs_err={err:.3e} rel={rel:.3e} kernel={ms:.4f} ms"
                  f"{was(f'14e {half} {rows} {tag}')} plain={pms:.4f} ms "
                  f"{share}")
            st = stats["gather_rows_scaled"]
            st["max_abs_err"] = max(st["max_abs_err"], err)
            if dtype == torch.float64 and half == "alpha":
                st.update(ms=ms, plain_ms=pms, bound_ms=bms)
        # both halves of the chunk in one launch
        two_spin_check(torch, gk, grid, x, gm, 0, rows,
                       f"14e [0, {rows}) {tag}", stats, step=28)
        del x
        Y = torch.randn((pb, Na, Nb), generator=gen, dtype=dtype,
                        device=dev)
        srcA, sgnA, tB, srcB, sgnB, tA = blk.tables(Y)
        for name, half, args in (
                ("gather_reduce", "alpha", (Y, srcA, sgnA, tB)),
                ("gather_reduce_cols", "beta", (Y, srcB, sgnB, tA))):
            fn = (getattr(gk, name) if name == "gather_reduce"
                  else lambda *a: cols_kernel(gk, *a))
            plain = getattr(gk, name + "_plain")
            out = fn(*args)
            ref = plain(*args)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            rel = err / max(float(ref.abs().max()), 1e-300)
            del out, ref
            check(rel <= tol[("reduce", dtype)],
                  f"{name} 14e {tag}: relative error {rel:.3e}")
            cols = name == "gather_reduce_cols"
            nbytes = reduce_bytes(*args, cols)
            ms = time_ms(lambda: fn(*args), torch)
            pms = time_ms(lambda: plain(*args), torch, reps=2, rounds=3)
            extra = floor_share(ms, *args[:3]) if cols else ""
            print(f"  {name:18s} 14e {half:5s} {tag} Y {tuple(Y.shape)} "
                  f"max_abs_err={err:.3e} rel={rel:.3e} kernel={ms:.4f} ms "
                  f"plain={pms:.4f} ms {_share(ms, nbytes)}{extra}")
            st = stats[name]
            st["max_abs_err"] = max(st["max_abs_err"], err)
            if dtype == torch.float64:
                st.update(ms=ms, plain_ms=pms, bound_ms=bound_ms(nbytes))
        del Y
    torch.cuda.empty_cache()
    beyond_int32(torch, gk, gm, gen, stats)


def beyond_int32(torch, gk, gm, gen, stats, step=28):
    """Each grid kernel on all n2 = 196 pairs of the (14e,14o) maps in one
    f32 launch, whose Phi or Y holds n2 * D = 2.31e9 elements (beyond
    2^31, 9.2 GB): against the plain version a slab of pairs at a time."""
    Na, Nb, n2 = gm.Na, gm.Nb, gm.n2
    srcA, sgnA, tB, srcB, sgnB, tA = gm.tables(
        torch.zeros((), dtype=torch.float32, device=gm.device))
    x = torch.randn((Na, Nb), generator=gen, dtype=torch.float32,
                    device=gm.device)
    out = gk.gather_rows_scaled(x, srcA, sgnA, tB)
    torch.cuda.synchronize()
    check(out.numel() > 2 ** 31, f"{out.numel()} elements")
    err, rel = _slab_err(out, gk.gather_rows_scaled_plain,
                         (x, srcA, sgnA, tB), step)
    del out
    # both halves over the whole grid: Phi of n2 * D elements
    check(n2 * Na * Nb > 2 ** 31, f"{n2 * Na * Nb} elements")
    two_spin_check(torch, gk, None, x, gm, 0, Na,
                   f"14e all {n2} pairs float32 ({n2 * Na * Nb:,} "
                   f"elements)", stats, step=step, timed=False,
                   composite=False)
    del x
    results = [("gather_rows_scaled", err, rel)]
    Y = torch.empty((n2, Na, Nb), dtype=torch.float32, device=gm.device)
    for k0 in range(0, n2, step):
        Y[k0:k0 + step].normal_(generator=gen)
    for name, tabs in (("gather_reduce", (srcA, sgnA, tB)),
                       ("gather_reduce_cols", (srcB, sgnB, tA))):
        out = (gk.gather_reduce(Y, *tabs) if name == "gather_reduce"
               else cols_kernel(gk, Y, *tabs))
        plain = getattr(gk, name + "_plain")
        ref = sum(plain(Y[k0:k0 + step], *(a[k0:k0 + step] for a in tabs))
                  for k0 in range(0, n2, step))
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        results.append((name, err, err / max(float(ref.abs().max()),
                                             1e-300)))
        del out, ref
    del Y
    torch.cuda.empty_cache()
    for name, err, rel in results:
        print(f"  {name:18s} 14e all {n2} pairs float32 ({n2 * Na * Nb:,} "
              f"elements) max_abs_err={err:.3e} rel={rel:.3e}")
        check(rel <= (1e-6 if name == "gather_rows_scaled" else 1e-5),
              f"{name} beyond 2^31 elements: relative error {rel:.3e}")
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)


def sector14_phase(torch, gk, pqc, oo):
    """2 NR iterations of the (14e,14o) path; returns the grid kernel
    launches counted during them."""
    stamps = []

    class Stamp:
        def log(self, n, energy, **kw):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

    theta0 = pqc.init_zeros()
    oao0 = oo.oao_mo_coeff.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gk.reset_launches()
    with armijo_steps_taken() as steps:
        t_start = time.perf_counter()
        energies, thetas, _, oaos, eigs = oo.full_optimization(
            theta0, max_iterations=ITERATIONS_14E14O, alpha=1e-4, beta=0.5,
            mu=1e-6, rho=1.1, lambda_min=1e-6, monitor=Stamp())
    launches = dict(gk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    iter_s = [b - a for a, b in zip([t_start] + stamps[:-1], stamps)]
    for n, e in enumerate(energies, 1):
        ref = ANCHORS_14E14O.get(n)
        ref = ("no anchor" if ref is None
               else f"JAX {ref:.14f}  diff {e - ref:+.3e}")
        print(f"  iter {n}: E = {e:.14f}  {ref}  wall {iter_s[n - 1]:.3f} s"
              f"  lowest eig {eigs[n - 1]:+.6e}")
    check(len(energies) == ITERATIONS_14E14O,
          f"ran {len(energies)} iterations, not {ITERATIONS_14E14O}")
    for n, ref in ANCHORS_14E14O.items():
        e = energies[n - 1]
        check(abs(e - ref) <= TOL_ENERGY,
              f"(14e,14o) iteration {n}: |{e} - {ref}| > {TOL_ENERGY}")
    check_route_kernels(launches, FUSED_KERNELS, "the (14e,14o) run")
    flop_rates("(14e,14o)", pqc, oo, iter_s, steps)
    psi = pqc.state(thetas[-1])
    torch.cuda.synchronize()
    check(psi.shape == (pqc.state_dim,), f"state shape {tuple(psi.shape)}")
    check(bool(torch.isfinite(psi).all()), "non-finite final state")
    norm = float(psi @ psi)
    check(abs(norm - 1.0) < 1e-12, f"final state norm {norm}")
    del psi
    gamma, _ = pqc.get_rdms(thetas[-1])
    trace = float(torch.trace(gamma))
    check(abs(trace - 14.0) < 1e-10, f"tr(gamma) = {trace}, not 14")
    check(bool(torch.isfinite(oaos[-1]).all()), "non-finite OAO-MO")
    print(f"  launches: {launches}; peak device memory of the iterations "
          f"{peak / 1e9:.3f} GB (max_memory_allocated); |norm - 1| "
          f"{abs(norm - 1.0):.2e}, tr(gamma) - 14 {trace - 14.0:+.2e}")
    return launches, thetas[-1], energies


def hosted14_phase(torch, P, gk, gh, mol, pqc, oo, theta):
    """One grad_hess of (14e,14o) at ``theta`` on the hosted route (forced;
    its row chunk from the free device memory; its default form, the Gram
    form there) against the streamed route
    of ``oo``, timed in turns (streamed, hosted, hosted, streamed): e0 and
    gradient within 1e-10, the Hessian within 1e-8."""
    torch.cuda.empty_cache()
    with forced_hosting(gh):
        oo_h = P.OO_pqc(pqc, mol, pqc.ncas, pqc.nelecas, freeze_active=True,
                        oao_mo_coeff=oo.oao_mo_coeff)
    check(oo_h._core["route"] == "hosted",
          f"(14e,14o) forced route {oo_h._core['route']}, expected hosted")
    check(oo_h._core["hosted_form"] == "gram",
          f"(14e,14o) hosted form {oo_h._core['hosted_form']}, expected gram")
    runs = []
    for name, o in (("streamed", oo), ("hosted", oo_h), ("hosted", oo_h),
                    ("streamed", oo)):
        torch.cuda.synchronize()
        gk.reset_launches()
        t0 = time.perf_counter()
        out = o._grad_hess(theta)
        torch.cuda.synchronize()
        runs.append((name, time.perf_counter() - t0, out, dict(gk.LAUNCHES)))
    (_, _, (e_s, g_s, h_s), _), (_, _, (e_h, g_h, h_h), l_h) = runs[:2]
    de = abs(float(e_h - e_s))
    dg = float((g_h - g_s).abs().max())
    dh = float((h_h - h_s).abs().max())
    print("  grad_hess in turns: " + ", ".join(
        f"{name} {sec:.3f} s" for name, sec, _, _ in runs))
    print(f"  hosted row chunk {oo_h._core['plan'].row_chunk} "
          f"(streamed {oo._core['plan'].row_chunk}, pair block "
          f"{oo._core['plan'].pair_block}); hosted launches {l_h}; "
          f"|de0| {de:.3e}  max|dgrad| {dg:.3e}  max|dhess| {dh:.3e}")
    check(de <= 1e-10, f"(14e,14o) hosted e0 differs by {de}")
    check(dg <= 1e-10, f"(14e,14o) hosted gradient differs by {dg}")
    check(dh <= 1e-8, f"(14e,14o) hosted Hessian differs by {dh}")
    check_route_kernels(l_h, HOSTED_KERNELS, "the (14e,14o) hosted run")
    del oo_h, runs
    torch.cuda.empty_cache()


def unrestricted14_phase(torch, gk, pqc, theta):
    """Phase 33, after phase 8's gradient pipeline with its Newton core
    freed: the spin-resolved RDMs of the (14e,14o) H14 chain at full width
    (D = 11,778,624) at phase 8's theta after iteration 2.  The
    cross-sector pair maps are built on the card first (30.2 GB); one
    get_rdms(restricted=False) must launch gather_rows_scaled exactly
    twice (the two one-spin Phi, 18.5 GB each) and no other kernel; its
    spin sums equal the restricted streamed RDMs of the same state within
    1e-12 relative, and gamma_alpha equals gamma_beta (a singlet) within
    1e-12 relative.  Prints its wall time and peak device memory; frees
    the maps.  Returns its launches."""
    gr, Gr = pqc.get_rdms(theta)               # restricted, streamed
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    umaps, t_maps = _synced(torch, pqc._umaps)
    nbytes = sum(_nbytes(v[1], v[2]) for v in umaps.values())
    sizes = ", ".join(f"{k} {tuple(v[1].shape)}" for k, v in umaps.items())
    print(f"  pair-annihilation maps on the card: {t_maps:.3f} s, {sizes}, "
          f"{nbytes / 1e9:.3f} GB")
    del umaps
    gk.reset_launches()
    (gu, Gu), sec = _synced(torch, lambda: pqc.get_rdms(theta,
                                                        restricted=False))
    launches = dict(gk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    del pqc._sector_umaps
    torch.cuda.empty_cache()
    gs, Gs = _spin_sums(gu, Gu, pqc.ncas)
    d_sum = max(_rel(gs, gr), _rel(Gs, Gr))
    d_spin = _rel(gu[0::2, 0::2], gu[1::2, 1::2])
    print(f"  get_rdms(restricted=False): {sec:.3f} s; peak device memory "
          f"{peak / 1e9:.3f} GB (max_memory_allocated; {resident / 1e9:.3f} "
          f"GB resident before the maps); launches "
          f"{ {k: v for k, v in launches.items() if v} }; spin sums - "
          f"restricted streamed {d_sum:.2e} relative; gamma_alpha - "
          f"gamma_beta {d_spin:.2e} relative")
    check(launches["gather_rows_scaled"] == 2
          and sum(launches.values()) == 2,
          f"(14e,14o) get_rdms(restricted=False) launches {launches}")
    check(d_sum <= 1e-12, f"(14e,14o) spin sums differ by {d_sum:.2e}")
    check(d_spin <= 1e-12, f"(14e,14o) gamma_alpha != gamma_beta: "
          f"{d_spin:.2e}")
    return launches


def sector16_setup(torch, P):
    """The (16e,16o) problem on the default device; returns (mol, pqc,
    oo)."""
    t0 = time.perf_counter()
    mol = P.Moldata(H16_GEOMETRY, "sto-3g")
    t1 = time.perf_counter()
    pqc = P.Parameterized_circuit(16, 16, ansatz="np_fabric", n_layers=1,
                                  sector=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    oo = P.OO_pqc(pqc, mol, 16, 16, freeze_active=True)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    plan = oo._core["plan"]
    print(f"(16e,16o) setup: {t3 - t0:.2f} s (Moldata {t1 - t0:.2f}, "
          f"circuit and grid maps {t2 - t1:.2f}, OO_pqc {t3 - t2:.2f}); "
          f"n_theta={pqc.theta_shape}, n_kappa={oo.n_kappa}, "
          f"D={pqc.state_dim}, gates={len(pqc.grid_program.gates)}, "
          f"route={oo._core['route']}, row chunk {plan and plan.row_chunk} "
          f"of {pqc.sector_maps.Na}, budget "
          f"{plan and plan.budget / 1e9:.1f} GB; device memory after setup "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    check(oo._core["route"] == "hosted",
          f"(16e,16o) route {oo._core['route']}, expected hosted")
    check(pqc._sector_basis is None, "a D-sized host table was built")
    return mol, pqc, oo


def scatter_bytes(Y, src, s, t, r0):
    """Bytes scatter_rows must move: the Y rows of the pairs whose source
    lies in the window once, each acc row that such a pair reaches read
    and written once, the tables once."""
    hit = (s != 0) & (src >= r0) & (src < r0 + Y.shape[-2])
    B = Y.numel() // (Y.shape[-3] * Y.shape[-2] * Y.shape[-1])
    rows = int(hit.any(0).sum())
    return (B * (int(hit.sum()) + 2 * rows) * Y.shape[-1] * Y.element_size()
            + _nbytes(src, s, t))


def scatter_check(torch, gk, gh, gm, Y, acc0, r0, label, step=None):
    """scatter_rows on a copy of acc0 twice (the same bits) against its
    plain version (index_add_, ``step`` pairs at a time), within 1e-14 of
    max |out| in f64 and 1e-6 in f32; returns (err, rel)."""
    srcA, sgnA, tB = gm.tables(Y)[:3]
    dst, dsg = gh._inverse_tables(gm, Y)
    outs = [gk.scatter_rows(acc0.clone(), Y, srcA, sgnA, tB, dst, dsg, r0)
            for _ in range(2)]
    ref = acc0.clone()
    n2 = srcA.shape[0]
    step = step or n2
    for k0 in range(0, n2, step):
        sl = slice(k0, k0 + step)
        gk.scatter_rows_plain(ref, Y[..., sl, :, :], srcA[sl], sgnA[sl],
                              tB[sl], dst[sl], dsg[sl], r0)
    torch.cuda.synchronize()
    check(torch.equal(outs[0], outs[1]),
          f"scatter_rows {label}: two launches differ")
    check(bool(torch.isfinite(outs[0]).all()), f"scatter_rows {label}: "
          "non-finite")
    err = float((outs[0] - ref).abs().max())
    rel = err / max(float(ref.abs().max()), 1e-300)
    tol = 1e-14 if Y.dtype == torch.float64 else 1e-6
    check(rel <= tol, f"scatter_rows {label}: relative error {rel:.3e} > "
          f"{tol:.0e}")
    return err, rel


def hosted_kernel_phase(torch, gk, gh, grid, oo, stats, step=28):
    """The kernels of the hosted route at the (16e,16o) chunk shapes of
    ``oo``'s plan against their plain versions (a slab of ``step`` pairs
    at a time: whole-chunk temporaries would crowd the card), timed beside
    their bounds (f64, into ``stats``): the alpha and beta halves of a Phi
    chunk, the column form on its Y, and the scatter on the same Y in the
    middle chunk's window (f64 and f32, and the ragged last window)
    beside index_add_ of its contributions."""
    gm = oo.pqc.sector_maps
    Na, Nb, n2 = gm.Na, gm.Nb, gm.n2
    chunks = grid._row_chunks(Na, oo._core["plan"].row_chunk)
    r0, r1 = chunks[len(chunks) // 2]
    R = r1 - r0
    dev = gm.device
    gen = torch.Generator(device=dev).manual_seed(16)
    f64 = torch.float64
    like = torch.zeros((), dtype=f64, device=dev)
    _, _, tB, srcB, sgnB, _ = gm.tables(like)
    srcA_k, sgnA_k, tA_k = grid._row_tables(gm, like, r0, r1)
    x = torch.randn((Na, Nb), generator=gen, dtype=f64, device=dev)
    for half, args in (("alpha", (x, srcA_k, sgnA_k, tB)),
                       ("beta", (x[r0:r1].T.contiguous(), srcB, sgnB,
                                 tA_k))):
        out = gk.gather_rows_scaled(*args)
        torch.cuda.synchronize()
        err, rel = _slab_err(out, gk.gather_rows_scaled_plain, args, step)
        del out
        check(rel <= 1e-15, f"gather_rows_scaled 16e {half}: relative "
              f"error {rel:.3e}")
        ms = time_ms(lambda: gk.gather_rows_scaled(*args), torch)
        pms = time_ms(lambda: [gk.gather_rows_scaled_plain(
            args[0], *(a[k0:k0 + step] for a in args[1:]))
            for k0 in range(0, n2, step)], torch, reps=2, rounds=3)
        share, bms = rows_share(gk, ms, args)
        print(f"  gather_rows_scaled 16e {half:5s} x {tuple(args[0].shape)} "
              f"src {tuple(args[1].shape)} rows [{r0}, {r1}) "
              f"max_abs_err={err:.3e} rel={rel:.3e} kernel={ms:.4f} ms"
              f"{was(f'16e {half} {R}@{r0} float64')} plain={pms:.4f} ms "
              f"({step} pairs at a time) {share}")
        st = stats["gather_rows_scaled"]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        if half == "alpha":
            st.update(ms=ms, plain_ms=pms, bound_ms=bms)
    del args
    torch.cuda.empty_cache()
    # both halves of the chunk in one launch, and in f32 on the ragged
    # last window (Nb = 12870 is no multiple of 4: scalar loads)
    res = two_spin_check(torch, gk, grid, x, gm, r0, r1,
                         f"16e [{r0}, {r1}) f64", stats, step=step)
    stats["gather_two_spin"].update(ms=res["ms"], plain_ms=res["plain_ms"],
                                    bound_ms=res["bound_ms"])
    l0, l1 = chunks[-1]
    two_spin_check(torch, gk, grid, x.float(), gm, l0, l1,
                   f"16e [{l0}, {l1}) f32", stats, step=step, timed=False)
    del x
    torch.cuda.empty_cache()
    Y = torch.randn((n2, R, Nb), generator=gen, dtype=f64, device=dev)
    args = (Y, srcB, sgnB, tA_k)
    out = cols_kernel(gk, *args)
    ref = sum(gk.gather_reduce_cols_plain(*(a[k0:k0 + step] for a in args))
              for k0 in range(0, n2, step))
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    rel = err / max(float(ref.abs().max()), 1e-300)
    del ref
    check(rel <= 1e-13, f"gather_reduce_cols 16e: relative error {rel:.3e}")
    # the route's add mode into the window of an accumulator: acc + the
    # kernel's result, bit for bit
    acc = torch.randn((R, Nb), generator=gen, dtype=f64, device=dev)
    added = cols_kernel(gk, *args, out=acc.clone())
    check(torch.equal(added, acc + out), "gather_reduce_cols 16e: add mode "
          "differs from out + the kernel's result")
    del out, added
    nbytes = reduce_bytes(*args, True)
    ms = time_ms(lambda: cols_kernel(gk, *args), torch)
    add_ms = time_ms(lambda: cols_kernel(gk, *args, out=acc), torch)
    del acc
    pms = time_ms(lambda: sum(gk.gather_reduce_cols_plain(
        *(a[k0:k0 + step] for a in args)) for k0 in range(0, n2, step)),
        torch, reps=2, rounds=3)
    print(f"  gather_reduce_cols 16e beta  Y {tuple(Y.shape)} "
          f"max_abs_err={err:.3e} rel={rel:.3e} kernel={ms:.4f} ms (add "
          f"mode {add_ms:.4f} ms, the same bits as out + kernel) "
          f"plain={pms:.4f} ms {_share(ms, nbytes)}"
          f"{floor_share(ms, *args[:3])}")
    st = stats["gather_reduce_cols"]
    st.update(max_abs_err=max(st["max_abs_err"], err), ms=ms, plain_ms=pms,
              bound_ms=bound_ms(nbytes))
    # the scatter: the middle window in f64 and f32, the last (ragged)
    acc = torch.randn((Na, Nb), generator=gen, dtype=f64, device=dev)
    st = stats["scatter_rows"]
    for Yc, accc, w0, tag in ((Y, acc, r0, "f64"),
                              (Y.float(), acc.float(), r0, "f32"),
                              (Y[:, :chunks[-1][1] - chunks[-1][0]]
                               .contiguous(), acc, chunks[-1][0],
                               "f64 last window")):
        err, rel = scatter_check(torch, gk, gh, gm, Yc, accc, w0,
                                 f"16e {tag}", step)
        st["max_abs_err"] = max(st["max_abs_err"], err)
        print(f"  scatter_rows 16e {tag} window [{w0}, "
              f"{w0 + Yc.shape[-2]}) max_abs_err={err:.3e} rel={rel:.3e} "
              f"bit-identical over two launches")
    srcA, sgnA, tB = gm.tables(Y)[:3]
    dst, dsg = gh._inverse_tables(gm, Y)
    sargs = (acc, Y, srcA, sgnA, tB, dst, dsg, r0)
    nbytes = scatter_bytes(Y, srcA, sgnA, tB, r0)
    ms = time_ms(lambda: gk.scatter_rows(*sargs), torch)
    pms = time_ms(lambda: [gk.scatter_rows_plain(
        acc, Y[k0:k0 + step], *(a[k0:k0 + step] for a in sargs[2:7]), r0)
        for k0 in range(0, n2, step)], torch, reps=2, rounds=3)
    contrib = (Y * dsg[:, r0:r1, None] * tB[:, None, :]).reshape(-1, Nb)
    idx = dst[:, r0:r1].reshape(-1)
    lms = time_ms(lambda: acc.index_add_(0, idx, contrib), torch, reps=2,
                  rounds=3)
    del contrib
    print(f"  scatter_rows 16e f64 Y {tuple(Y.shape)} window [{r0}, {r1}) "
          f"kernel={ms:.4f} ms plain={pms:.4f} ms ({step} pairs at a time) "
          f"index_add_ of the contributions={lms:.4f} ms "
          f"{_share(ms, nbytes)} ({nbytes / 1e9:.3f} GB)")
    st.update(ms=ms, plain_ms=pms, bound_ms=bound_ms(nbytes),
              library_ms=lms)
    del Y, acc, sargs
    torch.cuda.empty_cache()


def sector16_phase(torch, gk, mol, pqc, oo):
    """The (16e,16o) H16 chain on the hosted route: E(0) against the RHF
    energy, then one grad_hess at the demo's theta0 = 0.02 * arange(14)
    and one damped-Newton update from it (the NR iteration), with its
    time, peak memory and kernel launches; the new state's norm and
    tr(gamma).  Returns the launches of the iteration, e0 and the
    gradient."""
    from auto_oo_tpu_torch.utils.newton_raphson import newton_step_pure

    t0 = time.perf_counter()
    e_zero = float(oo.energy_from_parameters(pqc.init_zeros()))
    t_e = time.perf_counter() - t0
    mol.run_rhf()
    diff = e_zero - mol.hf.e_tot
    print(f"  E(0) = {e_zero:.12f}  RHF {mol.hf.e_tot:.12f}  diff "
          f"{diff:+.3e}  ({t_e:.2f} s: one state sweep and one hosted RDM "
          f"pass)")
    check(abs(diff) <= TOL_ENERGY, f"(16e,16o) E(0) misses RHF by {diff}")
    theta0 = 0.02 * torch.arange(pqc.theta_shape, dtype=torch.float64,
                                 device=pqc.device)
    core, args = oo._core, oo._mol_args
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gk.reset_launches()
    t0 = time.perf_counter()
    e0, grad, hess = core["grad_hess"](theta0, oo.oao_mo_coeff, *args)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with armijo_steps_taken() as steps:
        new_theta, _, _, e1, _ = core["newton_update"](
            theta0, oo.oao_mo_coeff, *args, e0, grad, hess, *STEP.values())
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(gk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    check(bool(torch.isfinite(grad).all() and torch.isfinite(hess).all()),
          "(16e,16o) non-finite gradient or Hessian")
    check(hess.shape == (pqc.theta_shape,) * 2, f"Hessian {hess.shape}")
    gnorm = float(grad.norm())
    e0, e1 = float(e0), float(e1)
    step = new_theta - theta0
    dp = newton_step_pure(grad, hess, mu=STEP["mu"], rho=STEP["rho"],
                          lambda_min=STEP["lambda_min"])[0]
    t_step = float(step @ dp) / float(dp @ dp)
    asym = float((hess - hess.T).abs().max())
    print(f"  grad_hess at theta0 {t1 - t0:.3f} s: E(theta0) = {e0:.12f}, "
          f"|grad| = {gnorm:.6e} (JAX f64 {GRAD_NORM_16E16O:.3e}, diff "
          f"{gnorm - GRAD_NORM_16E16O:+.2e}), max|H - H^T| {asym:.2e}")
    print(f"  newton_update {t2 - t1:.3f} s; NR iteration {t2 - t0:.3f} s: "
          f"E = {e1:.12f} (below E(theta0) by {e0 - e1:.3e}; JAX mixed "
          f"{E_NR1_16E16O:.10f}, diff {e1 - E_NR1_16E16O:+.3e}), step "
          f"length |dtheta| = {float(step.norm()):.6e}, t = {t_step:.6f}")
    print(f"  launches of the iteration: {launches}; peak device memory "
          f"{peak / 1e9:.3f} GB allocated, {reserved / 1e9:.3f} GB reserved")
    check(abs(gnorm - GRAD_NORM_16E16O) <= 1e-5,
          f"(16e,16o) |grad| {gnorm} misses {GRAD_NORM_16E16O}")
    check(e1 < e0, f"(16e,16o) NR energy {e1} not below E(theta0) {e0}")
    check(abs(e1 - E_NR1_16E16O) <= 5e-5,
          f"(16e,16o) NR energy {e1} misses {E_NR1_16E16O} by more than "
          "5e-5")
    check_route_kernels(launches, HOSTED_KERNELS,
                        "the (16e,16o) iteration")
    flop_rates("(16e,16o)", pqc, oo, [t2 - t0], steps)
    psi = pqc.state(new_theta)
    torch.cuda.synchronize()
    check(psi.shape == (pqc.state_dim,), f"state shape {tuple(psi.shape)}")
    check(bool(torch.isfinite(psi).all()), "non-finite (16e,16o) state")
    norm = float(psi @ psi)
    del psi
    gamma, _ = pqc.get_rdms(new_theta)
    trace = float(torch.trace(gamma))
    print(f"  after the iteration: |norm - 1| {abs(norm - 1.0):.2e}, "
          f"tr(gamma) - 16 {trace - 16.0:+.2e}")
    check(abs(norm - 1.0) < 1e-12, f"(16e,16o) state norm {norm}")
    check(abs(trace - 16.0) < 1e-10, f"(16e,16o) tr(gamma) = {trace}")
    return launches, e0, grad


def mixed10_phase(torch, P, gk):
    """The (10e,10o) slice in precision="mixed" (fused route): at
    init_zeros its grad_hess against the f64 one (e0 and gradient stay
    f64: within 1e-12; the f32 Hessian within 1e-5 relative, Frobenius),
    then 4 NR iterations, each energy within TOL_10E10O_MIXED of the JAX
    package's CPU mixed trajectory; returns the launches of the
    iterations."""
    from auto_oo_tpu_torch.utils.misc import get_formal_geo

    mol = P.Moldata(get_formal_geo(140, 80), "sto-3g")
    pqc = P.Parameterized_circuit(10, 10, ansatz="np_fabric", n_layers=2,
                                  sector=True)
    oo = P.OO_pqc(pqc, mol, 10, 10, freeze_active=True, precision="mixed")
    check(oo._core["route"] == "fused",
          f"(10e,10o) mixed route {oo._core['route']}, expected fused")
    oo64 = P.OO_pqc(pqc, mol, 10, 10, freeze_active=True)
    theta0 = pqc.init_zeros()
    e_m, g_m, h_m = oo._grad_hess(theta0)
    e_d, g_d, h_d = oo64._grad_hess(theta0)
    de = abs(float(e_m - e_d))
    dg = float((g_m - g_d).abs().max())
    rel = float((h_m - h_d).norm() / h_d.norm())
    print(f"  iteration 0, mixed against f64: |de0| {de:.3e}  max|dgrad| "
          f"{dg:.3e}  |dH|/|H| {rel:.3e} (Hessian {h_m.dtype})")
    check(de <= 1e-12, f"(10e,10o) mixed e0 differs from f64 by {de}")
    check(dg <= 1e-12, f"(10e,10o) mixed gradient differs by {dg}")
    check(0.0 < rel <= 1e-5, f"(10e,10o) mixed Hessian relative error {rel}")
    check(h_m.dtype == torch.float64, "the mixed Hessian is not f64")
    stamps = []

    class Stamp:
        def log(self, n, energy, **kw):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gk.reset_launches()
    t_start = time.perf_counter()
    energies, thetas, *_ = oo.full_optimization(
        theta0, max_iterations=4, monitor=Stamp(), **STEP)
    launches = dict(gk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    iter_s = [b - a for a, b in zip([t_start] + stamps[:-1], stamps)]
    for i, (e, ref) in enumerate(zip(energies, ANCHORS_10E10O_MIXED)):
        print(f"  iter {i + 1}: E = {e:.14f}  JAX-CPU mixed {ref:.14f}  "
              f"diff {e - ref:+.3e}  (f64 JAX {ANCHORS_10E10O[i]:.14f}, "
              f"diff {e - ANCHORS_10E10O[i]:+.3e})  wall {iter_s[i]:.3f} s")
    check(len(energies) == 4, f"ran {len(energies)} iterations, not 4")
    for i, (e, ref, tol) in enumerate(zip(energies, ANCHORS_10E10O_MIXED,
                                          TOL_10E10O_MIXED)):
        check(abs(e - ref) <= tol, f"(10e,10o) mixed iteration {i + 1}: "
              f"|{e} - {ref}| > {tol}")
    check_route_kernels(launches, FUSED_KERNELS, "the (10e,10o) mixed run")
    norm = float(pqc.state(thetas[-1]).norm())
    check(abs(norm - 1.0) < 1e-12, f"(10e,10o) mixed final norm {norm}")
    print(f"  launches: {launches}; median wall of iterations 2-4: "
          f"{statistics.median(iter_s[1:]):.4f} s; peak device memory "
          f"{peak / 1e9:.3f} GB")
    return launches


def sector14_mixed_phase(torch, P, gk, mol, pqc, energies64):
    """2 NR iterations of the (14e,14o) path in precision="mixed" (the
    streamed route, its f32 rows on their own plan): iteration 2 within
    1e-7 Ha of the JAX package's mixed value and of the port's f64
    iteration 2 (``energies64``); returns the launches."""
    oo = P.OO_pqc(pqc, mol, pqc.ncas, pqc.nelecas, freeze_active=True,
                  precision="mixed")
    check(oo._core["route"] == "streamed",
          f"(14e,14o) mixed route {oo._core['route']}, expected streamed")
    stamps = []

    class Stamp:
        def log(self, n, energy, **kw):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gk.reset_launches()
    t_start = time.perf_counter()
    energies, thetas, *_ = oo.full_optimization(
        pqc.init_zeros(), max_iterations=ITERATIONS_14E14O, monitor=Stamp(),
        **STEP)
    launches = dict(gk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    iter_s = [b - a for a, b in zip([t_start] + stamps[:-1], stamps)]
    for n, (e, e64) in enumerate(zip(energies, energies64), 1):
        print(f"  iter {n}: E = {e:.14f}  f64 {e64:.14f}  diff "
              f"{e - e64:+.3e}  wall {iter_s[n - 1]:.3f} s")
    check(len(energies) == ITERATIONS_14E14O,
          f"ran {len(energies)} iterations, not {ITERATIONS_14E14O}")
    e2 = energies[1]
    print(f"  iteration 2 against the JAX mixed {E_ITER2_14E14O_MIXED:.10f}"
          f": {e2 - E_ITER2_14E14O_MIXED:+.3e}; plans f64 "
          f"{oo._core['plan']}, f32 {oo._core['plan_lp']}")
    check(abs(e2 - E_ITER2_14E14O_MIXED) <= 1e-7,
          f"(14e,14o) mixed iteration 2 {e2} misses {E_ITER2_14E14O_MIXED}")
    check(abs(e2 - energies64[1]) <= 1e-7,
          f"(14e,14o) mixed iteration 2 {e2} misses the f64 {energies64[1]}")
    check_route_kernels(launches, FUSED_KERNELS, "the (14e,14o) mixed run")
    print(f"  launches: {launches}; peak device memory {peak / 1e9:.3f} GB")
    del oo
    torch.cuda.empty_cache()
    return launches


def gram_stack_check(torch, gk, gm, B, rows, pass_rows):
    """The f32 gather_two_spin launches of the (16e,16o) mixed iteration,
    each against its plain version a slab of pairs at a time, equal as
    values, and timed beside its bound and re-read floor: one over a (B,
    Na, Nb) stack at the Gram route's cross-sweep chunk (``rows`` grid
    rows: a middle and the ragged last window), and one on a single state
    at the hosted pass's chunk (``pass_rows``, the middle window)."""
    gen = torch.Generator(device=gm.device).manual_seed(1616)
    S = torch.randn((B, gm.Na, gm.Nb), generator=gen, dtype=torch.float32,
                    device=gm.device)
    chunks = [(r0, min(gm.Na, r0 + rows)) for r0 in range(0, gm.Na, rows)]
    mid = (gm.Na - pass_rows) // 2
    for x, (r0, r1) in ((S, chunks[len(chunks) // 2]), (S, chunks[-1]),
                        (S[0], (mid, mid + pass_rows))):
        tabs = gm.phi_tables(x)
        compact = gm.two_spin_tables()

        def kernel():
            return gk.gather_two_spin(x, compact, r0, r1)

        out = kernel()
        torch.cuda.synchronize()
        for k0, ref in _two_spin_plain(gk, x, tabs, r0, r1, 16):
            check(torch.equal(out[..., k0:k0 + ref.shape[-3], :, :], ref),
                  f"gather_two_spin over {tuple(x.shape)} f32 [{r0}, {r1}): "
                  "not equal to plain")
            del ref
        del out
        ms = time_ms(kernel, torch, reps=3, rounds=3)
        shares, _ = two_spin_share(gk, ms, x, gm, r0, r1)
        what = (f"stack {tuple(x.shape)}" if x.dim() == 3
                else "hosted pass chunk")
        print(f"  gather_two_spin 16e {what} f32 rows [{r0}, {r1}): equal to "
              f"plain; kernel {ms:.4f} ms {shares}")
    del S
    torch.cuda.empty_cache()


def mixed_pass_kernels(torch, gk, gh, grid, gm, rows, step=28):
    """The f32 column form and scatter of the (16e,16o) mixed hosted pass
    at its row chunk (``rows`` grid rows, the middle window) against their
    plain versions (a slab of ``step`` pairs at a time; 1e-5 relative, and
    scatter_check's 1e-6 of max |out|), timed beside their bounds (the
    column form also beside its 32- and 128-byte floors), with index_add_
    of the scatter's contributions."""
    Na, Nb, n2 = gm.Na, gm.Nb, gm.n2
    r0 = (Na - rows) // 2
    r1 = r0 + rows
    f32 = torch.float32
    gen = torch.Generator(device=gm.device).manual_seed(1617)
    like = torch.zeros((), dtype=f32, device=gm.device)
    srcA, sgnA, tB, srcB, sgnB, _ = gm.tables(like)
    tA_k = grid._row_tables(gm, like, r0, r1)[2]
    Y = torch.randn((n2, rows, Nb), generator=gen, dtype=f32,
                    device=gm.device)
    args = (Y, srcB, sgnB, tA_k)
    out = cols_kernel(gk, *args)
    err = scale = 0.0
    for k0 in range(0, n2, step):
        ref = gk.gather_reduce_cols_plain(*(a[k0:k0 + step] for a in args))
        if k0 == 0:
            total = ref
        else:
            total += ref
        del ref
    err = float((out - total).abs().max())
    scale = float(total.abs().max())
    del out, total
    check(err <= 1e-5 * scale, f"gather_reduce_cols 16e f32 pass: relative "
          f"error {err / scale:.3e}")
    ms = time_ms(lambda: cols_kernel(gk, *args), torch)
    nbytes = reduce_bytes(*args, True)
    print(f"  gather_reduce_cols 16e f32 pass Y {tuple(Y.shape)} "
          f"rel={err / scale:.3e} kernel={ms:.4f} ms {_share(ms, nbytes)}"
          f"{floor_share(ms, *args[:3])}")
    acc = torch.randn((Na, Nb), generator=gen, dtype=f32, device=gm.device)
    err, rel = scatter_check(torch, gk, gh, gm, Y, acc, r0, "16e f32 pass",
                             step)
    dst, dsg = gh._inverse_tables(gm, Y)
    sargs = (acc, Y, srcA, sgnA, tB, dst, dsg, r0)
    nbytes = scatter_bytes(Y, srcA, sgnA, tB, r0)
    ms = time_ms(lambda: gk.scatter_rows(*sargs), torch)
    contrib = (Y * dsg[:, r0:r1, None] * tB[:, None, :]).reshape(-1, Nb)
    idx = dst[:, r0:r1].reshape(-1)
    lms = time_ms(lambda: acc.index_add_(0, idx, contrib), torch, reps=2,
                  rounds=3)
    print(f"  scatter_rows 16e f32 pass Y {tuple(Y.shape)} window [{r0}, "
          f"{r1}) rel={rel:.3e} kernel={ms:.4f} ms index_add_ of the "
          f"contributions={lms:.4f} ms {_share(ms, nbytes)} "
          f"({nbytes / 1e9:.3f} GB)")
    del Y, acc, contrib, sargs, args
    torch.cuda.empty_cache()


def sector16_mixed_phase(torch, gk, gh, grid, P, mol, pqc):
    """The (16e,16o) H16 chain in precision="mixed": the hosted route's
    Gram form (the (15, D) f32 stack fits the 11e9-byte budget, as in the
    JAX package); the f32 gather_two_spin launches of the iteration's
    shapes against plain (gram_stack_check) and the pass's column form
    and scatter (mixed_pass_kernels); then one grad_hess at theta0 and
    one damped-Newton update from it, with |grad| within 1e-4 relative
    of the JAX package's 5.379e-02, E(1) below E(theta0) and within 5e-5
    Ha of its mixed iteration 1; the step length, the iteration's time,
    peak memory and launches.  Returns the launches of the iteration."""
    from auto_oo_tpu_torch.utils.newton_raphson import newton_step_pure

    nt = pqc.theta_shape
    t0 = time.perf_counter()
    oo = P.OO_pqc(pqc, mol, pqc.ncas, pqc.nelecas, freeze_active=True,
                  precision="mixed")
    core = oo._core
    print(f"  mixed OO_pqc {time.perf_counter() - t0:.2f} s: route "
          f"{core['route']}, hosted form {core['hosted_form']}, cross "
          f"sweep row chunk {core['cross_rows']}, pass row chunk "
          f"{core['plan_lp'].row_chunk}")
    check(core["route"] == "hosted" and core["hosted_form"] == "gram",
          f"(16e,16o) mixed: {core['route']} {core['hosted_form']}, "
          "expected the hosted route's Gram form")
    gram_stack_check(torch, gk, pqc.sector_maps, nt + 1, core["cross_rows"],
                     core["plan_lp"].row_chunk)
    mixed_pass_kernels(torch, gk, gh, grid, pqc.sector_maps,
                       core["plan_lp"].row_chunk)
    theta0 = 0.02 * torch.arange(nt, dtype=torch.float64, device=pqc.device)
    args = oo._mol_args
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gk.reset_launches()
    t0 = time.perf_counter()
    e0, grad, hess = core["grad_hess"](theta0, oo.oao_mo_coeff, *args)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with armijo_steps_taken() as steps:
        new_theta, _, _, e1, _ = core["newton_update"](
            theta0, oo.oao_mo_coeff, *args, e0, grad, hess, *STEP.values())
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(gk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    check(bool(torch.isfinite(grad).all() and torch.isfinite(hess).all()),
          "(16e,16o) mixed: non-finite gradient or Hessian")
    check(hess.dtype == torch.float64 and hess.shape == (nt, nt),
          f"(16e,16o) mixed Hessian {hess.dtype} {tuple(hess.shape)}")
    gnorm = float(grad.norm())
    e0, e1 = float(e0), float(e1)
    step = new_theta - theta0
    dp = newton_step_pure(grad, hess, mu=STEP["mu"], rho=STEP["rho"],
                          lambda_min=STEP["lambda_min"])[0]
    t_step = float(step @ dp) / float(dp @ dp)
    print(f"  grad_hess at theta0 {t1 - t0:.3f} s: E(theta0) = {e0:.12f}, "
          f"|grad| = {gnorm:.6e} (JAX f64 {GRAD_NORM_16E16O:.3e}, relative "
          f"diff {gnorm / GRAD_NORM_16E16O - 1:+.2e})")
    print(f"  newton_update {t2 - t1:.3f} s; NR iteration {t2 - t0:.3f} s: "
          f"E = {e1:.12f} (below E(theta0) by {e0 - e1:.3e}; JAX mixed "
          f"{E_NR1_16E16O:.10f}, diff {e1 - E_NR1_16E16O:+.3e}), step "
          f"length |dtheta| = {float(step.norm()):.6e}, t = {t_step:.6f}")
    print(f"  launches of the iteration: {launches}; peak device memory "
          f"{peak / 1e9:.3f} GB allocated, {reserved / 1e9:.3f} GB reserved")
    check(abs(gnorm / GRAD_NORM_16E16O - 1) <= 1e-4,
          f"(16e,16o) mixed |grad| {gnorm} misses {GRAD_NORM_16E16O}")
    check(e1 < e0, f"(16e,16o) mixed NR energy {e1} not below {e0}")
    check(abs(e1 - E_NR1_16E16O) <= 5e-5,
          f"(16e,16o) mixed NR energy {e1} misses {E_NR1_16E16O} by more "
          "than 5e-5")
    check_route_kernels(launches, HOSTED_KERNELS,
                        "the (16e,16o) mixed iteration")
    flop_rates("(16e,16o) mixed", pqc, oo, [t2 - t0], steps, "mixed")
    del oo, core, grad, hess
    torch.cuda.empty_cache()
    return launches


def mixed_2e2o_phase(torch, P):
    """(2e,2o) ucc in the full space, freeze_active=False (the JAX
    package's tests/test_mixed_precision.py:25-44 case), to convergence in
    f64 and in mixed precision: the two energies within 1e-9 Ha, the mixed
    one within 1e-8 Ha of CASSCF."""
    from auto_oo_tpu_torch.utils.misc import get_formal_geo

    mol = P.Moldata(get_formal_geo(140, 80), "sto-3g")
    pqc = P.Parameterized_circuit(2, 2, ansatz="ucc")
    out = {}
    for precision in ("f64", "mixed"):
        oo = P.OO_pqc(pqc, mol, 2, 2, precision=precision)
        check(oo._core["route"] == "flat", f"(2e,2o) {oo._core['route']}")
        energies, *_ = oo.full_optimization(pqc.init_zeros())
        out[precision] = energies
    e64, emx = out["f64"][-1], out["mixed"][-1]
    print(f"  (2e,2o) ucc full space: f64 {e64:.14f} ({len(out['f64'])} "
          f"iterations), mixed {emx:.14f} ({len(out['mixed'])}), diff "
          f"{emx - e64:+.3e}; CASSCF diff {emx - E_CASSCF_2E2O:+.3e}")
    check(abs(emx - e64) <= 1e-9, f"(2e,2o) mixed {emx} != f64 {e64}")
    check(abs(emx - E_CASSCF_2E2O) <= TOL_ENERGY,
          f"(2e,2o) mixed misses CASSCF by {emx - E_CASSCF_2E2O}")


def convergence_phase(torch, P):
    """(2e,2o) to convergence, built on the port's default device."""
    from auto_oo_tpu_torch.utils.misc import get_formal_geo

    mol = P.Moldata(get_formal_geo(140, 80), "sto-3g")
    pqc = P.Parameterized_circuit(2, 2, ansatz="ucc", sector=True)
    oo = P.OO_pqc(pqc, mol, 2, 2)
    check(oo.mo_coeff.device.type == "cuda",
          f"default device is {oo.mo_coeff.device}, not the card")
    t0 = time.perf_counter()
    energies, *_ = oo.full_optimization(pqc.init_zeros())
    torch.cuda.synchronize()
    diff = energies[-1] - E_CASSCF_2E2O
    print(f"(2e,2o) sector ucc: {len(energies)} iterations, "
          f"E = {energies[-1]:.14f}, CASSCF {E_CASSCF_2E2O:.14f}, "
          f"diff {diff:+.3e}, {time.perf_counter() - t0:.2f} s")
    check(abs(diff) <= TOL_ENERGY, f"(2e,2o) misses CASSCF by {diff}")



def check_no_kernels(launches, what):
    """The flat route runs no grid kernel (its gathers are element
    gathers over the full space, plain PyTorch as in the JAX package)."""
    check(not any(launches.values()),
          f"{what} launched grid kernels: {launches}")


def full_space_convergence_phase(torch, P, gk):
    """(2e,2o) in the full space to convergence, every object built with
    no sector= and no device=: np_fabric L=1 with freeze_active (the
    README quick start) and ucc without it (its one double reaches CASSCF
    only with the active-active rotations); returns the launches."""
    from auto_oo_tpu_torch.utils.misc import get_formal_geo

    mol = P.Moldata(get_formal_geo(140, 80), "sto-3g")
    gk.reset_launches()
    for label, kw, frozen in (
            ("np_fabric L=1", dict(ansatz="np_fabric", n_layers=1), True),
            ("ucc", dict(ansatz="ucc"), False)):
        pqc = P.Parameterized_circuit(2, 2, **kw)
        oo = P.OO_pqc(pqc, mol, 2, 2, freeze_active=frozen)
        check(pqc.init_zeros().device.type == "cuda",
              f"default device is {pqc.init_zeros().device}, not the card")
        check(oo._core["route"] == "flat",
              f"(2e,2o) full space route {oo._core['route']}")
        t0 = time.perf_counter()
        energies, *_ = oo.full_optimization(pqc.init_zeros())
        torch.cuda.synchronize()
        diff = energies[-1] - E_CASSCF_2E2O
        print(f"  (2e,2o) full space {label} (freeze_active={frozen}): "
              f"{len(energies)} iterations, E = {energies[-1]:.14f}, "
              f"CASSCF {E_CASSCF_2E2O:.14f}, diff {diff:+.3e}, "
              f"{time.perf_counter() - t0:.2f} s")
        check(abs(diff) <= TOL_ENERGY,
              f"(2e,2o) full space {label} misses CASSCF by {diff}")
    launches = dict(gk.LAUNCHES)
    check_no_kernels(launches, "the (2e,2o) full-space runs")
    return launches


def flat_phase(torch, P, gk, label, ncas, nelecas, kw, anchors, held,
               max_iterations, molkw=None, converge=False, parts=False):
    """Damped Newton on the full-space (flat) route from init_zeros,
    built with no sector= and no device=: energies 1-``held`` within
    1e-8 Ha of the CPU JAX ``anchors`` (the rest printed beside them);
    with ``converge``, the run must converge to a minimum above the
    CASSCF energy.  Prints s/NR-iter, peak memory and the busy/idle
    share of one more iteration under the profiler (with ``parts``, that
    iteration taken apart on the host clock first); returns the grid
    kernel launches of the run."""
    from auto_oo_tpu_torch.models import oo_pqc
    from auto_oo_tpu_torch.ops import hamiltonian as ham
    from auto_oo_tpu_torch.ops import rdms as rd
    from auto_oo_tpu_torch.ops import transforms as tr
    from auto_oo_tpu_torch.scripts.profile_14e14o import (_timed,
                                                          device_profile)
    from auto_oo_tpu_torch.utils.misc import get_formal_geo

    ne = nelecas if isinstance(nelecas, int) else sum(nelecas)
    t0 = time.perf_counter()
    mol = P.Moldata(get_formal_geo(140, 80), "sto-3g", **(molkw or {}))
    pqc = P.Parameterized_circuit(ncas, nelecas, **kw)
    oo = P.OO_pqc(pqc, mol, ncas, nelecas, freeze_active=True)
    torch.cuda.synchronize()
    print(f"{label} setup: {time.perf_counter() - t0:.2f} s "
          f"(n_theta={pqc.theta_shape}, n_kappa={oo.n_kappa}, "
          f"D={pqc.state_dim}, route={oo._core['route']}, "
          f"{len(pqc.program.half)} gates)")
    check(oo._core["route"] == "flat", f"{label} route {oo._core['route']}")
    check(oo.mo_coeff.device.type == "cuda",
          f"default device is {oo.mo_coeff.device}, not the card")

    stamps = []

    class Stamp:
        def log(self, n, energy, **kw):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    gk.reset_launches()
    t_start = time.perf_counter()
    energies, thetas, _, oaos, eigs = oo.full_optimization(
        pqc.init_zeros(), max_iterations=max_iterations, monitor=Stamp(),
        **STEP)
    launches = dict(gk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    iter_s = [b - a for a, b in zip([t_start] + stamps[:-1], stamps)]
    for i, e in enumerate(energies):
        ref = (f"JAX-CPU {anchors[i]:.14f}  diff {e - anchors[i]:+.3e}"
               + ("" if i < held else " (not held)")
               if i < len(anchors) else "JAX-CPU (none)")
        print(f"  iter {i + 1}: E = {e:.14f}  {ref}  wall {iter_s[i]:.3f} s"
              f"  lowest eig {eigs[i]:+.6e}")
    check(len(energies) >= held, f"{label}: ran {len(energies)} iterations")
    for i in range(held):
        check(abs(energies[i] - anchors[i]) <= TOL_ENERGY,
              f"{label} iteration {i + 1}: |{energies[i]} - {anchors[i]}| "
              f"> {TOL_ENERGY}")
    if converge:
        e_cas = E_CASSCF_6E6O
        check(len(energies) < max_iterations
              and abs(energies[-1] - energies[-2]) < 1e-10,
              f"{label} did not converge in {max_iterations} iterations")
        check(eigs[-1] > 0, f"{label} ends at a saddle (lowest eig "
              f"{eigs[-1]})")
        check(energies[-1] >= e_cas - TOL_ENERGY,
              f"{label} ends below CASSCF {e_cas}: {energies[-1]}")
        print(f"  converged in {len(energies)} iterations (JAX-CPU "
              f"{len(anchors)}): E = {energies[-1]:.14f}, JAX-CPU "
              f"{anchors[-1]:.14f} (diff {energies[-1] - anchors[-1]:+.3e}),"
              f" CASSCF {e_cas:.14f} (above by {energies[-1] - e_cas:.3e})")
    check_no_kernels(launches, label)
    psi = pqc.state(thetas[-1])
    torch.cuda.synchronize()
    check(psi.shape == (4 ** ncas,), f"state shape {tuple(psi.shape)}")
    check(bool(torch.isfinite(psi).all()), f"non-finite {label} state")
    norm = float(psi @ psi)
    trace = float(torch.trace(pqc.get_rdms(thetas[-1])[0]))
    check(abs(norm - 1.0) < 1e-12, f"{label} state norm {norm}")
    check(abs(trace - ne) < 1e-10, f"{label} tr(gamma) = {trace}")
    check(bool(torch.isfinite(oaos[-1]).all()), "non-finite OAO-MO")
    warm = iter_s[1:4]
    print(f"  {card_line()}: median s/NR-iter of iterations 2-"
          f"{len(warm) + 1}: {statistics.median(warm):.4f} s; peak device "
          f"memory {peak / 1e9:.4f} GB allocated, {(peak - resident) / 1e9:.4f}"
          f" GB above the {resident / 1e9:.4f} GB resident before the run; "
          f"|norm - 1| "
          f"{abs(norm - 1):.1e}, tr(gamma) - {ne} {trace - ne:+.1e}")

    core, args = oo._core, oo._mol_args
    theta = thetas[-1]

    def iteration():
        e0, grad, hess = core["grad_hess"](theta, oo.oao_mo_coeff, *args)
        return core["newton_update"](theta, oo.oao_mo_coeff, *args, e0,
                                     grad, hess, *STEP.values())

    if parts:
        # the heavy parts of grad_hess at the final point, one by one
        mo = oo.oao_coeff @ oo.oao_mo_coeff
        h1 = tr.int1e_transform(oo.int1e_ao, mo)
        g2 = tr.int2e_transform(oo.int2e_ao, mo)
        _, c1, c2 = tr.molecular_hamiltonian_coefficients(
            oo.nuc, h1, g2, oo._occ, oo._act)
        c1eff, maps = ham.c1_effective(c1, c2), pqc.epq_maps
        out = []
        psi_g, J = _timed("state + J sweep",
                          lambda: pqc._state_and_jacobian_grid(theta), out)
        w = 2.0 * _timed("H psi", lambda: ham.ham_apply(
            c1eff, c2, psi_g, ncas, maps), out)
        # grad_hess's tangent chunks
        chunk = max(1, min(J.shape[0], oo_pqc._CHUNK_ELEMENTS
                           // (ncas ** 2 * J.shape[1])))
        chunks = [J[lo:lo + chunk] for lo in range(0, J.shape[0], chunk)]
        _timed(f"H J ({J.shape[0]} rows, chunks of {chunk})",
               lambda: [ham.ham_apply(c1eff, c2, Jc, ncas, maps)
                        for Jc in chunks], out)
        _timed("circuit-Hessian sweep", lambda: pqc._state_hessian_dot_grid(
            theta, w, psi_g, J), out)
        phi = _timed("Phi of psi", lambda: rd.apply_epq_all(psi_g, ncas,
                                                            maps), out)
        _timed("Phi of J (transition RDMs)",
               lambda: [rd.apply_epq_all(Jc, ncas, maps) for Jc in chunks],
               out)
        _timed("RDM grams", lambda: rd.rdms_from_gram(phi, psi_g, ncas),
               out)
        _timed("one energy (line-search trial)",
               lambda: oo.energy_from_parameters(theta), out)
        for name, sec in out:
            print(f"    {name:32s} {sec * 1e3:9.2f} ms")
        del psi_g, J, phi, chunks
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iteration()
    torch.cuda.synchronize()
    it_s = time.perf_counter() - t0
    print(f"  one more iteration at the final point: {it_s:.4f} s")
    busy = device_profile(iteration, it_s, top=8)
    if busy is not None:
        print(f"  {label}: device busy {100 * busy:.1f}%, idle "
              f"{100 - 100 * busy:.1f}% of the iteration")
    return launches


def prebuilt_program_phase(torch, P, gk):
    """A prebuilt (4e,4o) kupccd GateProgram through sector=True (projected
    onto the sector, factorized onto the string grid) against the
    built-in sector circuit at a seeded theta; returns the launches of
    the prebuilt circuit's grad_hess."""
    from auto_oo_tpu_torch.simulator import ansatze as A
    from auto_oo_tpu_torch.utils.misc import get_formal_geo

    mol = P.Moldata(get_formal_geo(140, 80), "sto-3g")
    built = P.Parameterized_circuit(4, 4, ansatz="kupccd", k=1, sector=True)
    prebuilt = P.Parameterized_circuit(4, 4, ansatz=A.kupccd_program(4, 4),
                                       sector=True)
    check(prebuilt.program.dim == built.state_dim,
          f"projected program dim {prebuilt.program.dim}")
    oo_b = P.OO_pqc(built, mol, 4, 4, freeze_active=True)
    oo_p = P.OO_pqc(prebuilt, mol, 4, 4, freeze_active=True)
    check(oo_p._core["route"] == "fused",
          f"prebuilt route {oo_p._core['route']}")
    theta = 0.3 * np.random.default_rng(31).standard_normal(
        built.theta_shape)
    torch.cuda.synchronize()
    gk.reset_launches()
    e_p, g_p, h_p = oo_p._grad_hess(theta)
    torch.cuda.synchronize()
    launches = dict(gk.LAUNCHES)
    e_b, g_b, h_b = oo_b._grad_hess(theta)
    de = abs(float(e_p - e_b))
    dg = float((g_p - g_b).abs().max())
    dh = float((h_p - h_b).abs().max())
    print(f"  prebuilt (4e,4o) kupccd ({len(prebuilt.program.half)} flat "
          f"gates -> {len(prebuilt.grid_program.gates)} grid gates, "
          f"n_kappa={oo_p.n_kappa}): |de0| {de:.3e}  max|dgrad| {dg:.3e}  "
          f"max|dhess| {dh:.3e}; launches {launches}")
    check(de <= 1e-12, f"prebuilt e0 differs by {de}")
    check(dg <= 1e-11, f"prebuilt gradient differs by {dg}")
    check(dh <= 1e-9, f"prebuilt Hessian differs by {dh}")
    check_route_kernels(launches, FUSED_KERNELS,
                        "the prebuilt program's grad_hess")
    return launches


def gradient_call(torch, gk, oo, theta, label, kernels):
    """One energy_and_gradient of ``oo`` at ``theta`` with the core's part
    timer on (each part between synchronizes, with its peak) and its
    kernel launches counted (``kernels`` launched, gather_rows_scaled
    not); tr(gamma) must be the electron count (to 1e-8, mixed 1e-5).
    Returns (e, gradient, launches)."""
    parts = oo._core["parts"]
    parts.seconds, parts.peaks = {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gk.reset_launches()
    parts.enabled = True
    t0 = time.perf_counter()
    try:
        e, grad, (gamma, _) = oo.energy_and_gradient(theta)
        torch.cuda.synchronize()
    finally:
        parts.enabled = False
    sec = time.perf_counter() - t0
    launches = dict(gk.LAUNCHES)
    # the part timer resets the peak at each part
    peak = max([torch.cuda.max_memory_allocated()]
               + list(parts.peaks.values()))
    nt = oo.pqc.theta_shape
    check(grad.shape == (nt + oo.n_kappa,) and grad.dtype == torch.float64,
          f"{label}: gradient {grad.dtype} {tuple(grad.shape)}")
    check(bool(torch.isfinite(grad).all()), f"{label}: non-finite gradient")
    trace = float(torch.trace(gamma))
    nelec = sum(oo.nelecas) if isinstance(oo.nelecas, tuple) else oo.nelecas
    # mixed: gamma comes from an f32 pass (the JAX package's 1e-5 bound)
    tol = 1e-8 if oo.precision == "f64" else 1e-5
    check(abs(trace - nelec) < tol, f"{label}: tr(gamma) = {trace}")
    print(f"  {label}: energy_and_gradient {sec:.3f} s (part timer on), E ="
          f" {float(e):.12f}, |grad| = {float(grad.norm()):.6e}, tr(gamma) - "
          f"{nelec} {trace - nelec:+.2e}; peak {peak / 1e9:.3f} GB")
    print("    parts: " + "; ".join(
        f"{k} {1e3 * v:.1f} ms (peak {parts.peaks.get(k, 0) / 1e9:.3f} GB)"
        for k, v in parts.seconds.items()))
    print(f"    launches: {launches}")
    if kernels:
        check_route_kernels(launches, kernels, label)
    else:
        check_no_kernels(launches, label)
    return float(e), grad, launches


def adam_run(torch, gk, oo, theta0, steps, label, kernels, lr=0.05,
             every=0):
    """``steps`` steps of gradient_optimization from ``theta0`` (conv_tol
    0), with s/gradient step (host clock over the run, which ends in a
    synchronize: each step is one energy_and_gradient and one Adam
    update, plus the relaxations), peak memory and launches; returns
    (energies, theta, launches)."""
    stamps = []

    class Stamp:
        def log(self, n, energy):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gk.reset_launches()
    t0 = time.perf_counter()
    energies, theta = oo.gradient_optimization(
        theta0, max_iterations=steps, learning_rate=lr, orbital_every=every,
        conv_tol=0, monitor=Stamp())
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = dict(gk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(len(energies) == steps, f"{label}: {len(energies)} steps")
    check(all(np.isfinite(energies)), f"{label}: non-finite energies")
    evals = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    print(f"  {label}: {steps} steps {sec:.3f} s, {sec / steps:.4f} "
          f"s/gradient step; to each step's energy: "
          f"{', '.join(f'{x:.3f}' for x in evals)} s; peak {peak / 1e9:.3f} "
          f"GB; launches {launches} "
          f"({', '.join(f'{k} {v / steps:g}' for k, v in launches.items())}"
          f" per step)")
    if kernels:
        check_route_kernels(launches, kernels, label)
    else:
        check_no_kernels(launches, label)
    return energies, theta, launches


def gradient16_phase(torch, gk, pqc, oo, e0, grad_ref, precision, e_rhf):
    """The (16e,16o) H16 chain's gradient-only pipeline on the hosted
    route: energy_and_gradient at theta0 (f64: E equal to the grad_hess
    e0 ``e0`` and to energy_from_parameters to 1e-9, the gradient equal
    to the per-tangent grad_hess one ``grad_ref`` to 1e-12 relative, the
    same sweep, |grad| = 5.379e-02 to 4 digits; mixed: |grad| within 1e-4
    relative of the JAX package's 5.378922e-02), then Adam from
    init_zeros as in the demo (f64: 2 steps, dE within 1e-5 Ha of the
    JAX package's -2.57e-3; mixed: 3 steps descending to 1e-5, E(0) = RHF
    to 1e-4).  Returns {path: launches}."""
    theta0 = 0.02 * torch.arange(pqc.theta_shape, dtype=torch.float64,
                                 device=pqc.device)
    tag = "" if precision == "f64" else "_mixed"
    e, grad, l_grad = gradient_call(torch, gk, oo, theta0,
                                    f"(16e,16o) {precision}", HOSTED_KERNELS)
    gnorm = float(grad.norm())
    if precision == "f64":
        e_ref = float(oo.energy_from_parameters(theta0))
        rel = float((grad - grad_ref).norm() / grad_ref.norm())
        print(f"    E - grad_hess e0 {e - e0:+.3e}, E - E(theta0) "
              f"{e - e_ref:+.3e}; |grad - grad_hess grad| / |grad| "
              f"{rel:.3e}; |grad| - JAX f64 {gnorm - GRAD_NORM_16E16O:+.2e}")
        check(abs(e - e_ref) <= 1e-9 and abs(e - e0) <= 1e-9,
              f"(16e,16o) energy_and_gradient E {e} misses {e_ref}, {e0}")
        check(rel <= 1e-12, f"(16e,16o) gradient differs from grad_hess's "
              f"by {rel} relative")
        check(round(gnorm, 5) == GRAD_NORM_16E16O,
              f"(16e,16o) |grad| {gnorm} is not {GRAD_NORM_16E16O}")
    else:
        rel = gnorm / GRAD_NORM_16E16O_MIXED - 1
        print(f"    |grad| against the JAX mixed {GRAD_NORM_16E16O_MIXED:.6e}"
              f": {rel:+.2e} relative")
        check(abs(rel) <= 1e-4, f"(16e,16o) mixed |grad| {gnorm} misses "
              f"{GRAD_NORM_16E16O_MIXED}")
    del grad
    torch.cuda.empty_cache()
    steps = 2 if precision == "f64" else 3
    energies, _, l_adam = adam_run(torch, gk, oo, pqc.init_zeros(), steps,
                                   f"(16e,16o) {precision} Adam",
                                   HOSTED_KERNELS)
    de = energies[-1] - energies[0]
    print(f"    energies {', '.join(f'{x:.12f}' for x in energies)}; dE = "
          f"{de:+.4e} Ha")
    if precision == "f64":
        check(abs(de - ADAM_DE_16E16O) <= 1e-5,
              f"(16e,16o) Adam dE {de} misses {ADAM_DE_16E16O}")
    else:
        print(f"    E(0) - RHF {energies[0] - e_rhf:+.3e}")
        check(energies[-1] <= energies[0] + 1e-5,
              f"(16e,16o) mixed Adam does not descend: {energies}")
        check(abs(energies[0] - e_rhf) <= 1e-4,
              f"(16e,16o) mixed E(0) {energies[0]} misses RHF {e_rhf}")
    return {f"16e16o_grad{tag}": l_grad, f"16e16o_adam{tag}": l_adam}


def gradient14_phase(torch, gk, P, mol, pqc, oo):
    """The (14e,14o) H14 chain's gradient-only pipeline on the streamed
    route: energy_and_gradient at theta0 = 0.02 * arange(14), E equal to
    energy_from_parameters to 1e-9, then 3 Adam steps from init_zeros
    with dE within 1e-4 Ha of the JAX package's -5.3 mHa; the same in
    precision="mixed" (E and gradient against the f64 ones within 1e-5
    Ha and 1e-4 (max|g| + 1), 3 steps descending to 1e-5).  Returns
    {path: launches}."""
    theta0 = 0.02 * torch.arange(pqc.theta_shape, dtype=torch.float64,
                                 device=pqc.device)
    paths = {}
    e64 = g64 = None
    for precision, o in (("f64", oo), ("mixed", None)):
        tag = "" if precision == "f64" else "_mixed"
        if o is None:
            o = P.OO_pqc(pqc, mol, pqc.ncas, pqc.nelecas, freeze_active=True,
                         precision=precision)
        check(o._core["route"] == "streamed",
              f"(14e,14o) route {o._core['route']}, expected streamed")
        e, grad, paths[f"14e14o_grad{tag}"] = gradient_call(
            torch, gk, o, theta0, f"(14e,14o) {precision}", FUSED_KERNELS)
        if precision == "f64":
            e_ref = float(o.energy_from_parameters(theta0))
            print(f"    E - E(theta0) {e - e_ref:+.3e}")
            check(abs(e - e_ref) <= 1e-9,
                  f"(14e,14o) energy_and_gradient E {e} misses {e_ref}")
            e64, g64 = e, grad
        else:
            dg = float((grad - g64).abs().max())
            print(f"    mixed - f64: E {e - e64:+.3e}, max|dgrad| {dg:.3e}")
            check(abs(e - e64) <= 1e-5, f"(14e,14o) mixed E {e} vs {e64}")
            check(dg <= 1e-4 * (float(g64.abs().max()) + 1),
                  f"(14e,14o) mixed gradient differs by {dg}")
        energies, _, paths[f"14e14o_adam{tag}"] = adam_run(
            torch, gk, o, pqc.init_zeros(), 3, f"(14e,14o) {precision} Adam",
            FUSED_KERNELS)
        de = energies[-1] - energies[0]
        print(f"    energies {', '.join(f'{x:.12f}' for x in energies)}; "
              f"dE = {de:+.4e} Ha (JAX f64 {ADAM_DE_14E14O:+.1e})")
        if precision == "f64":
            check(abs(de - ADAM_DE_14E14O) <= 1e-4,
                  f"(14e,14o) Adam dE {de} misses {ADAM_DE_14E14O}")
        else:
            check(energies[-1] <= energies[0] + 1e-5,
                  f"(14e,14o) mixed Adam does not descend: {energies}")
        del o
        torch.cuda.empty_cache()
    return paths


def adam10_phase(torch, P, gk, precision):
    """10 steps of gradient_optimization on the (10e,10o) slice from
    init_zeros (learning rate 0.05, an orbital relaxation of its 30
    rotations after steps 4 and 9), each energy printed beside the CPU
    JAX anchor; f64 steps 0-4 held to 1e-8 Ha and mixed step 0 to 1e-5
    Ha, the rest to 1e-3 Ha (see ANCHORS_10E10O_ADAM).  Returns the
    launches."""
    from auto_oo_tpu_torch.utils.misc import get_formal_geo

    mol = P.Moldata(get_formal_geo(140, 80), "sto-3g")
    pqc = P.Parameterized_circuit(10, 10, ansatz="np_fabric", n_layers=2,
                                  sector=True)
    oo = P.OO_pqc(pqc, mol, 10, 10, freeze_active=True, precision=precision)
    anchors = (ANCHORS_10E10O_ADAM if precision == "f64"
               else ANCHORS_10E10O_ADAM_MIXED)
    held, held_tol = HELD_10E10O_ADAM[precision]
    energies, theta, launches = adam_run(
        torch, gk, oo, pqc.init_zeros(), len(anchors),
        f"(10e,10o) {precision} Adam", FUSED_KERNELS, every=5)
    for n, (e, ref) in enumerate(zip(energies, anchors)):
        tol = held_tol if n < held else TOL_10E10O_ADAM_SPREAD
        print(f"  step {n}: E = {e:.14f}  JAX-CPU {ref:.14f}  diff "
              f"{e - ref:+.3e}  (held to {tol:.0e})")
        check(abs(e - ref) <= tol, f"(10e,10o) {precision} Adam step {n}: "
              f"|{e} - {ref}| > {tol}")
    norm = float(pqc.state(theta).norm())
    check(abs(norm - 1.0) < 1e-12, f"(10e,10o) Adam final norm {norm}")
    check(bool(torch.isfinite(oo.oao_mo_coeff).all()), "non-finite OAO-MO")
    return launches


def adam_2e2o_phase(torch, P, gk):
    """(2e,2o) ucc in the full space (freeze_active=False): 60 steps of
    gradient_optimization from init_zeros (learning rate 0.1, a
    relaxation every 5), every energy within 1e-8 Ha of the CPU JAX
    anchor and the last within 2e-4 Ha of CASSCF; returns the launches
    (none: the flat route)."""
    from auto_oo_tpu_torch.utils.misc import get_formal_geo

    mol = P.Moldata(get_formal_geo(140, 80), "sto-3g")
    pqc = P.Parameterized_circuit(2, 2, ansatz="ucc")
    oo = P.OO_pqc(pqc, mol, 2, 2)
    check(oo._core["route"] == "flat", f"(2e,2o) {oo._core['route']}")
    energies, _, launches = adam_run(
        torch, gk, oo, pqc.init_zeros(), len(ANCHORS_2E2O_ADAM),
        "(2e,2o) full space Adam", (), lr=0.1, every=5)
    diff = max(abs(e - r) for e, r in zip(energies, ANCHORS_2E2O_ADAM))
    print(f"  max |E - JAX-CPU| over the 60 steps {diff:.3e}; last E = "
          f"{energies[-1]:.14f}, CASSCF {E_CASSCF_2E2O:.14f}, diff "
          f"{energies[-1] - E_CASSCF_2E2O:+.3e}")
    check(diff <= TOL_ENERGY, f"(2e,2o) Adam trajectory off by {diff}")
    check(abs(energies[-1] - E_CASSCF_2E2O) <= 2e-4,
          f"(2e,2o) Adam ends {energies[-1]}, not within 2e-4 of CASSCF")
    return launches


def _loop_geometries(get_formal_geo, points):
    """The tutorial's loop around the formaldimine conical intersection:
    origin (130, 89.9) deg, radius 10 deg, ``points`` geometries with the
    first and last equal."""
    ts = np.linspace(0, 1, points)
    return [get_formal_geo(130 + 10 * np.cos(2 * np.pi * t + np.pi / 20),
                           89.9 + 10 * np.sin(2 * np.pi * t + np.pi / 20))
            for t in ts]


@contextlib.contextmanager
def _nr_timer(torch, P):
    """Counts the OO_pqc._nr_iteration calls inside the block and their
    seconds on the host clock (each call ended in a synchronize):
    yields a dict {"calls", "seconds"}."""
    stats = {"calls": 0, "seconds": 0.0}
    original = P.OO_pqc._nr_iteration

    def timed(self, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = original(self, *args)
        torch.cuda.synchronize()
        stats["calls"] += 1
        stats["seconds"] += time.perf_counter() - t0
        return out

    P.OO_pqc._nr_iteration = timed
    try:
        yield stats
    finally:
        P.OO_pqc._nr_iteration = original


def _synced_s(torch, fn):
    """(fn(), its seconds on the host clock, ending in a synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def berry_loop_run(torch, P, gk, label, geos, ncas, kw, run_kw,
                   newton_method=None):
    """One BerryPhaseLoop on the port's default device (no device=):
    prints s per point, the NR iterations of the run with their mean
    seconds, s per overlaps() and per transfer_state (median of 5 at
    point 0 -> 1).  Returns (loop, overlaps, launches of the run)."""
    from auto_oo_tpu_torch.models import berry
    from auto_oo_tpu_torch.models.oo_pqc import _route

    pqc = P.Parameterized_circuit(ncas, ncas, **kw)
    check(pqc.init_zeros().device.type == "cuda",
          f"default device is {pqc.init_zeros().device}, not the card")
    loop = P.BerryPhaseLoop(geos, "sto-3g", ncas, ncas, pqc,
                            newton_method=newton_method)
    gk.reset_launches()
    with _nr_timer(torch, P) as nr:
        _, sec = _synced_s(torch, lambda: loop.run(**run_kw))
    launches = dict(gk.LAUNCHES)
    ov, ov_s = _synced_s(torch, loop.overlaps)
    states = loop.states()
    dets = pqc.sector_basis if pqc.sector else None
    mo = (loop.oao_mo_coeff_l[0].T @ loop.oao_mo_coeff_l[1]).cpu().numpy()
    times = [_synced_s(torch, lambda: berry.transfer_state(
        states[0], mo, loop.act_idx, ncas, dets=dets))[1] for _ in range(6)]
    print(f"  {label}: {len(geos)} points in {sec:.2f} s "
          f"({sec / len(geos):.4f} s per point; {nr['calls']} NR "
          f"iterations, {nr['seconds'] / max(1, nr['calls']):.4f} s each; "
          f"route {_route(pqc)}); "
          f"overlaps() {ov_s:.4f} s, transfer_state "
          f"{statistics.median(times[1:]):.5f} s (D = {pqc.state_dim})")
    return loop, ov, launches


def _held(label, got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    check(got.shape == ref.shape, f"{label}: {got.shape} vs {ref.shape}")
    err = float(np.max(np.abs(got - ref)))
    print(f"    {label}: max |port - JAX-CPU| {err:.3e} (limit {tol:g})")
    check(err <= tol, f"{label} off its JAX anchors by {err}")
    return err


def berry_full_phase(torch, P, gk):
    """Phase a: the tutorial loop, (2e,2o) np_fabric L=1 in the full space,
    21 points, run(conv_tol=1e-10, track_steps=12, track_tol=1e-10):
    every energy, lowest Hessian eigenvalue and overlap within 1e-8 of
    the CPU JAX anchors, the Berry phase within 1e-8 of JAX's and of +-pi
    within 0.05; the flat route launches no grid kernel."""
    from auto_oo_tpu_torch.utils.misc import get_formal_geo

    loop, ov, launches = berry_loop_run(
        torch, P, gk, "(2e,2o) full space", _loop_geometries(
            get_formal_geo, 21), 2, dict(ansatz="np_fabric", n_layers=1),
        dict(conv_tol=1e-10, track_steps=12, track_tol=1e-10))
    _held("energies", loop.energy_l, BERRY_2E2O_E, TOL_ENERGY)
    _held("lowest Hessian eigenvalues", loop.hess_eig_l, BERRY_2E2O_EIG,
          TOL_ENERGY)
    _held("overlaps", ov.real, BERRY_2E2O_OVERLAP, TOL_ENERGY)
    check(float(np.max(np.abs(ov.imag))) < 1e-10, "complex overlaps")
    phase = loop.berry_phase()
    print(f"    Berry phase {phase:+.15f} (JAX-CPU {BERRY_PHASE_2E2O:+.15f})")
    check(abs(phase - BERRY_PHASE_2E2O) <= TOL_ENERGY,
          f"Berry phase {phase} off JAX's {BERRY_PHASE_2E2O}")
    check(abs(abs(phase) - np.pi) < 0.05, f"Berry phase {phase} is not +-pi")
    check_no_kernels(launches, "the full-space Berry loop")
    return launches


def berry_sector_phase(torch, P, gk):
    """Phase b: the same loop in sector mode, 11 points: the fused route's
    three kernels launched by the run, every number within 1e-8 of the
    CPU JAX anchors, the Berry phase +-pi."""
    from auto_oo_tpu_torch.utils.misc import get_formal_geo

    loop, ov, launches = berry_loop_run(
        torch, P, gk, "(2e,2o) sector", _loop_geometries(get_formal_geo, 11),
        2, dict(ansatz="np_fabric", n_layers=1, sector=True),
        dict(conv_tol=1e-10, track_steps=12, track_tol=1e-10))
    _held("energies", loop.energy_l, BERRY_2E2O_SECTOR_E, TOL_ENERGY)
    _held("lowest Hessian eigenvalues", loop.hess_eig_l,
          BERRY_2E2O_SECTOR_EIG, TOL_ENERGY)
    _held("overlaps", ov.real, BERRY_2E2O_SECTOR_OVERLAP, TOL_ENERGY)
    phase = loop.berry_phase()
    print(f"    Berry phase {phase:+.15f}; launches {launches}")
    check(abs(phase - BERRY_PHASE_2E2O) <= TOL_ENERGY,
          f"sector Berry phase {phase}")
    check_route_kernels(launches, FUSED_KERNELS, "the sector Berry loop")
    return launches


def berry_6e6o_phase(torch, P, gk):
    """Phase c: the (6e,6o) sector arc (np_fabric L=2, D = 400, three
    geometries 0.25 deg apart), built with no device=: finite energies,
    overlaps real and above 0.97 (the JAX test's contract: JAX's own run
    from theta = 1e-13 leaves its unperturbed one by 1.4e-4 Ha), printed
    beside both JAX runs; the fused route's kernels launched."""
    from auto_oo_tpu_torch.utils.misc import get_formal_geo

    geos = [get_formal_geo(140 + 0.25 * k, 80 + 0.25 * k) for k in range(3)]
    loop, ov, launches = berry_loop_run(
        torch, P, gk, "(6e,6o) sector arc", geos, 6,
        dict(ansatz="np_fabric", n_layers=2, sector=True),
        dict(conv_tol=1e-9, max_iterations=30, track_steps=6,
             track_tol=1e-9))
    for i, e in enumerate(loop.energy_l):
        print(f"    point {i}: E = {e:.14f}  JAX-CPU {BERRY_6E6O_E[i]:.14f} "
              f"(diff {e - BERRY_6E6O_E[i]:+.2e}), from 1e-13 "
              f"{BERRY_6E6O_PERTURBED_E[i]:.14f}; overlap {ov[i].real:.10f}"
              f" (JAX {BERRY_6E6O_OVERLAP[i]:.10f}, from 1e-13 "
              f"{BERRY_6E6O_PERTURBED_OVERLAP[i]:.10f})")
    check(len(loop.energy_l) == 3 and np.all(np.isfinite(loop.energy_l)),
          f"(6e,6o) arc energies {loop.energy_l}")
    check(bool(np.all(ov.real > 0.97)), f"(6e,6o) arc overlaps {ov}")
    check(float(np.max(np.abs(ov.imag))) < 1e-10, "complex overlaps")
    check_route_kernels(launches, FUSED_KERNELS, "the (6e,6o) Berry arc")
    return launches


def _solver_case(torch, n, seed, dev):
    """A seeded symmetric indefinite H (one eigenvalue -0.5 below a
    spectrum 0.1-2) and gradient on the card."""
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    w = np.concatenate([[-0.5], np.linspace(0.1, 2.0, n - 1)])
    return (torch.as_tensor(Q @ np.diag(w) @ Q.T, device=dev),
            torch.as_tensor(rng.standard_normal(n), device=dev), w[0])


def iterative_phase(torch, P, gk, dev):
    """Phase d: newton_method="iterative".  The 6-point (2e,2o) loop
    (track_steps=8) on both solvers: each within 1e-8 of its CPU JAX
    anchors, the two within 1e-8 in energy and 2e-2 relative in lowest
    Hessian eigenvalue; newton_dir_iterative on seeded symmetric
    indefinite H at n = 128 and 362 against the eigh direction (lowest
    within 1e-9, dp within 1e-7 relative), each solver's time (median of
    5 after a warm-up) and the guard's fallbacks printed."""
    from auto_oo_tpu_torch.ops import linalg
    from auto_oo_tpu_torch.utils.misc import get_formal_geo

    geos = _loop_geometries(get_formal_geo, 6)
    runs = {}
    fallbacks0 = linalg.ITERATIVE_FALLBACKS
    for method, e_ref, eig_ref in (
            ("eigh", BERRY_ITER_EIGH_E, BERRY_ITER_EIGH_EIG),
            ("iterative", BERRY_ITER_ITERATIVE_E,
             BERRY_ITER_ITERATIVE_EIG)):
        loop, _, _ = berry_loop_run(
            torch, P, gk, f"(2e,2o) loop, newton_method={method!r}", geos, 2,
            dict(ansatz="np_fabric", n_layers=1),
            dict(conv_tol=1e-10, track_steps=8, track_tol=1e-10), method)
        _held(f"{method} energies", loop.energy_l, e_ref, TOL_ENERGY)
        _held(f"{method} lowest Hessian eigenvalues", loop.hess_eig_l,
              eig_ref, TOL_ENERGY)
        runs[method] = (np.asarray(loop.energy_l), np.asarray(loop.hess_eig_l))
    (en_e, eig_e), (en_i, eig_i) = runs["eigh"], runs["iterative"]
    rel = float(np.max(np.abs(eig_i - eig_e)
                       / np.maximum(np.abs(eig_e), 1e-3)))
    print(f"    iterative vs eigh: energies {np.max(np.abs(en_i - en_e)):.3e},"
          f" lowest eigenvalues {rel:.3e} relative; guard fallbacks in the "
          f"loop: {linalg.ITERATIVE_FALLBACKS - fallbacks0}")
    check(float(np.max(np.abs(en_i - en_e))) <= TOL_ENERGY,
          "iterative and eigh loops part")
    check(rel < 2e-2, f"iterative hess_eig off eigh's by {rel}")
    for n in (128, 362):
        H, g, w0 = _solver_case(torch, n, n, dev)
        before = linalg.ITERATIVE_FALLBACKS
        dp, low = linalg.newton_dir_iterative(g, H)
        dp_e, low_e = linalg.eigh_direction(g, H)
        fell = linalg.ITERATIVE_FALLBACKS - before
        err = float((dp - dp_e).norm() / dp_e.norm())
        t_it = statistics.median(
            _synced_s(torch, lambda: linalg.newton_dir_iterative(g, H))[1]
            for _ in range(5))
        t_eh = statistics.median(
            _synced_s(torch, lambda: linalg.eigh_direction(g, H))[1]
            for _ in range(5))
        print(f"    n = {n}: iterative {t_it * 1e3:.2f} ms, eigh "
              f"{t_eh * 1e3:.2f} ms; lowest {float(low):+.12f} (eigh "
              f"{float(low_e):+.12f}, exact {w0:+.1f}), dp {err:.2e} "
              f"relative; fallbacks {fell}")
        check(abs(float(low) - float(low_e)) < 1e-9,
              f"n = {n}: iterative lowest {float(low)} vs {float(low_e)}")
        check(err < 1e-7, f"n = {n}: iterative dp off eigh's by {err}")
        check(fell == 0, f"n = {n}: the guard fell back on a healthy H")


def s2_14e14o_phase(torch, P, grid, pqc):
    """Phase e, (14e,14o): the demo's s2 stage at theta0 = 0.02 *
    arange(n_theta) (|<S^2>| < 1e-8) and the grid S^- alone on its state,
    then a seeded normalized random
    state: the grid S^- against the flat cross-sector tables
    (simulator/sector.sector_sminus_maps) within 1e-10, with seconds and
    peak memory of each."""
    from auto_oo_tpu_torch.scripts.demo_16e16o import s2_stage
    from auto_oo_tpu_torch.simulator import sector

    theta = 0.02 * torch.arange(pqc.theta_shape, dtype=torch.float64,
                                device=pqc.device)
    s2_stage(pqc, theta)
    sminus_alone(torch, grid, pqc, theta)
    gen = torch.Generator(device=pqc.device).manual_seed(14)
    x = torch.randn(pqc.state_dim, generator=gen, dtype=torch.float64,
                    device=pqc.device)
    x /= x.norm()
    torch.cuda.reset_peak_memory_stats()
    s2_grid, sec_grid = _synced_s(torch, lambda: float(
        grid.s2_expectation_grid(x, pqc.sector_maps, pqc._s2maps(), 14)))
    peak_grid = torch.cuda.max_memory_allocated()
    maps, sec_build = _synced_s(
        torch, lambda: sector.sector_sminus_maps(14, 14, device=pqc.device))
    torch.cuda.reset_peak_memory_stats()
    s2_flat, sec_flat = _synced_s(torch, lambda: float(
        sector.s2_expectation_sector(x, maps, 14)))
    peak_flat = torch.cuda.max_memory_allocated()
    del maps
    print(f"  (14e,14o) random state: <S^2> grid {s2_grid:.14f} "
          f"({sec_grid:.3f} s, peak {peak_grid / 1e9:.3f} GB), flat tables {s2_flat:.14f} "
          f"({sec_flat:.3f} s, peak {peak_flat / 1e9:.3f} GB; tables built "
          f"on the host in {sec_build:.1f} s), diff {s2_grid - s2_flat:+.2e}")
    check(abs(s2_grid - s2_flat) < 1e-10,
          f"(14e,14o) grid <S^2> {s2_grid} vs flat {s2_flat}")


def s2_scale_phase(torch, P, grid, pqc16):
    """Phase e, (10e,10o) and (16e,16o): a seeded normalized random state
    on the (10e,10o) sector, its grid <S^2> against the host's S^2
    (fermion.s2_sparse, scipy) restricted to the sector basis, within
    1e-10; then the (16e,16o) demo's s2 stage at theta0 (|<S^2>| < 1e-8)
    and the grid S^- alone on its state, with seconds and peak memory."""
    from auto_oo_tpu_torch.ops import fermion
    from auto_oo_tpu_torch.scripts.demo_16e16o import s2_stage

    basis = fermion.sector_basis(10, 10)
    S2 = fermion.s2_sparse(10).tocsr()[basis][:, basis]
    v = np.random.default_rng(10).standard_normal(len(basis))
    v /= np.linalg.norm(v)
    host = float(v @ (S2 @ v))
    gm = grid.build_grid_maps(10, 10)
    s2, sec = _synced_s(torch, lambda: float(grid.s2_expectation_grid(
        torch.as_tensor(v, device=gm.device), gm,
        grid.sminus_grid_maps(10, 10), 10)))
    print(f"  (10e,10o) random state: <S^2> grid {s2:.14f} ({sec:.3f} s), "
          f"host scipy {host:.14f}, diff {s2 - host:+.2e}")
    check(abs(s2 - host) < 1e-10, f"(10e,10o) <S^2> {s2} vs host {host}")
    theta = 0.02 * torch.arange(pqc16.theta_shape, dtype=torch.float64,
                                device=pqc16.device)
    s2_stage(pqc16, theta)
    sminus_alone(torch, grid, pqc16, theta)


def sminus_alone(torch, grid, pqc, theta):
    """<S^2> from a state already built (the grid S^- alone): seconds
    (median of 3) and peak device memory above the state."""
    maps = pqc.sector_maps
    psi = pqc._state_impl_grid(theta).reshape(maps.Na, maps.Nb)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    runs = [_synced_s(torch, lambda: float(grid.s2_expectation_grid(
        psi, maps, pqc._s2maps(), pqc.nelecas))) for _ in range(3)]
    peak = torch.cuda.max_memory_allocated() - resident
    print(f"  grid S^- alone ({pqc.ncas}e,{pqc.ncas}o): <S^2> = "
          f"{runs[0][0]:.2e}, {statistics.median(r[1] for r in runs):.4f} s,"
          f" peak {peak / 1e9:.3f} GB above the state "
          f"({psi.numel() * 8 / 1e9:.3f} GB)")


def noisy_phase(torch, P):
    """Phase f: Noisy_OO_pqc on (2e,2o) np_fabric L=1 in the full space:
    variance 0 equals full_optimization within 1e-12; variance 1e-10
    reaches CASSCF within 1e-4; one seed twice gives the same
    trajectory on the card's generator."""
    from auto_oo_tpu_torch.utils.misc import get_formal_geo

    mol = P.Moldata(get_formal_geo(140, 80), "sto-3g")
    pqc = P.Parameterized_circuit(2, 2, ansatz="np_fabric", n_layers=1)

    def noisy(seed=7):
        return P.Noisy_OO_pqc(pqc, mol, 2, 2, freeze_active=True, seed=seed)

    check(noisy().generator.device.type == "cuda", "generator off the card")
    zero = noisy().full_noisy_optimization(pqc.init_zeros(), 0.0)[0]
    exact = P.OO_pqc(pqc, mol, 2, 2, freeze_active=True).full_optimization(
        pqc.init_zeros())[0]
    err = float(np.max(np.abs(np.array(zero) - np.array(exact)))) if len(
        zero) == len(exact) else float("inf")
    print(f"  variance 0: {len(zero)} iterations, max |noisy - exact| "
          f"{err:.2e}")
    check(err <= 1e-12, f"variance-0 noisy run off exact by {err}")
    (small, _, _, _, _), sec = _synced_s(
        torch, lambda: noisy().full_noisy_optimization(
            pqc.init_zeros(), 1e-10, max_iterations=25, conv_tol=1e-9))
    print(f"  variance 1e-10: {len(small)} iterations in {sec:.2f} s, E = "
          f"{small[-1]:.12f}, CASSCF {E_CASSCF_2E2O:.12f}, diff "
          f"{small[-1] - E_CASSCF_2E2O:+.2e}")
    check(abs(small[-1] - E_CASSCF_2E2O) < 1e-4,
          f"variance 1e-10 ends at {small[-1]}")
    runs = [noisy(3).full_noisy_optimization(
        pqc.init_zeros(), 1e-6, max_iterations=6, conv_tol=0.0)[0]
        for _ in range(2)]
    print(f"  variance 1e-6, seed 3 twice: {runs[0][-1]:.14f}, "
          f"{runs[1][-1]:.14f}")
    check(runs[0] == runs[1], "the same seed gave two trajectories")


def rdm_functionals(gamma, Gamma, seed=14):
    """(||gamma||_F, ||Gamma||_F, sum(M * Gamma)), M standard normal from
    numpy's default_rng(seed) in Gamma's shape (full_space_anchors.py's
    functionals)."""
    g, G = gamma.double().cpu().numpy(), Gamma.double().cpu().numpy()
    M = np.random.default_rng(seed).standard_normal(G.shape)
    return [float(np.linalg.norm(g)), float(np.linalg.norm(G)),
            float(np.sum(M * G))]


def _hold_functionals(label, got, ref):
    diffs = [a - b for a, b in zip(got, ref)]
    print(f"  {label}: functionals {got} JAX-CPU {ref} diffs "
          f"{[f'{d:+.2e}' for d in diffs]}")
    check(all(abs(d) <= TOL_RDM_ANCHOR for d in diffs),
          f"{label}: functionals {got} != JAX-CPU {ref}")


def _spin_sums(gu, Gu, n):
    """The restricted (gamma, Gamma) of spin-resolved ones (interleaved
    modes): gamma_pq = sum_s gu[2p+s, 2q+s], Gamma_pqrs = sum_{s,t}
    Gu[(p,s), (r,t), (s,t), (q,s)]."""
    import torch

    g = gu[0::2, 0::2] + gu[1::2, 1::2]
    G = torch.zeros((n,) * 4, dtype=Gu.dtype, device=Gu.device)
    for a in range(2):
        for b in range(2):
            G += Gu[a::2, b::2, b::2, a::2].permute(0, 3, 1, 2)
    return g, G


def _max_diff(pairs):
    return max(float((a - b).abs().max()) for a, b in pairs)


def _synced(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def one_spin_kernel_check(torch, gk, gm, psi_g, label, stats):
    """gather_rows_scaled on both halves of the one-spin Phi of a grid
    state against its plain version on the card (1e-15 relative), timed
    beside its bound (x, tables and Phi once); returns the alpha half's
    (ms, plain ms, bound ms)."""
    srcA, sgnA, tB, srcB, sgnB, tA = gm.tables(psi_g)
    xg = psi_g.reshape(gm.Na, gm.Nb)
    res = None
    for half, args in (("alpha", (xg.contiguous(), srcA, sgnA, tB)),
                       ("beta", (xg.T.contiguous(), srcB, sgnB, tA))):
        out = gk.gather_rows_scaled(*args)
        ref = gk.gather_rows_scaled_plain(*args)
        torch.cuda.synchronize()
        check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
              f"gather_rows_scaled {label} {half}: shape or values")
        err = float((out - ref).abs().max())
        rel = err / max(float(ref.abs().max()), 1e-300)
        check(rel <= 1e-15, f"gather_rows_scaled {label} {half}: relative "
              f"error {rel:.3e}")
        del out, ref
        ms = time_ms(lambda: gk.gather_rows_scaled(*args), torch)
        pms = time_ms(lambda: gk.gather_rows_scaled_plain(*args), torch,
                      reps=3, rounds=3)
        st = stats["gather_rows_scaled"]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        share, bms = rows_share(gk, ms, args)
        print(f"  gather_rows_scaled {label} {half:5s} x "
              f"{tuple(args[0].shape)} src {tuple(args[1].shape)} one-spin "
              f"Phi: max_abs_err={err:.3e} rel={rel:.3e} kernel={ms:.4f} ms"
              f"{was(f'{label} {half} float64')} plain={pms:.4f} ms {share}")
        if half == "alpha":
            res = (ms, pms, bms)
        torch.cuda.empty_cache()
    return res


def unrestricted_sector_phase(torch, P, gk, grid, ncas, n_layers, stats):
    """Spin-resolved RDMs on the sector grid at full width (formaldimine
    (ncas e, ncas o) np_fabric, theta = 0.07 * arange + 0.1; no molecule
    needed): gather_rows_scaled on both halves of the one-spin Phi against
    its plain version; the cross-sector pair maps built on the card; one
    get_rdms(restricted=False) launching gather_rows_scaled twice and no
    other kernel, its spin sums equal to get_rdms' restricted RDMs; a
    complex state (a seeded per-determinant phase) through
    get_rdms_from_state, restricted (gather_two_spin twice, its real and
    imaginary parts) and spin-resolved (gather_rows_scaled four times),
    its spin sums equal to its restricted RDMs; a global phase changes no
    RDM; the JAX anchors' functionals where RDM_ANCHORS has them.  Returns
    the launches of each path."""
    from auto_oo_tpu_torch.ops import fermion

    label = f"({ncas}e,{ncas}o)"
    tag = f"{ncas}e{ncas}o"
    t0 = time.perf_counter()
    pqc = P.Parameterized_circuit(ncas, ncas, ansatz="np_fabric",
                                  n_layers=n_layers, sector=True)
    gm = pqc.sector_maps
    theta = 0.07 * np.arange(pqc.theta_shape) + 0.1
    psi = pqc.state(theta)
    torch.cuda.synchronize()
    print(f"{label} setup and state: {time.perf_counter() - t0:.2f} s "
          f"(Na={gm.Na} Nb={gm.Nb} n2={gm.n2} D={gm.dim})")
    res = one_spin_kernel_check(torch, gk, gm, grid.to_grid(psi, gm), tag,
                                stats)
    umaps, t_maps = _synced(torch, pqc._umaps)
    sizes = ", ".join(f"{k} {tuple(v[1].shape)}" for k, v in umaps.items())
    nbytes = sum(_nbytes(v[1], v[2]) for v in umaps.values())
    print(f"  pair-annihilation maps built on the card (searchsorted): "
          f"{t_maps:.3f} s; {sizes}; {nbytes / 1e9:.3f} GB")
    paths = {}
    gr, Gr = pqc.get_rdms(theta)
    pqc.get_rdms(theta, restricted=False)            # warm
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    gk.reset_launches()
    (gu, Gu), t_u = _synced(torch, lambda: pqc.get_rdms(
        theta, restricted=False))
    paths[f"{tag}_unrestricted"] = launches = dict(gk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - base
    check(launches["gather_rows_scaled"] == 2
          and sum(launches.values()) == 2,
          f"{label} get_rdms(restricted=False) launches {launches}")
    gs, Gs = _spin_sums(gu, Gu, ncas)
    d_sum = _max_diff(((gs, gr), (Gs, Gr)))
    nm, ne = 2 * ncas, ncas
    tr1 = float(torch.trace(gu))
    tr2 = float(torch.einsum("pqqp->", Gu))
    print(f"  get_rdms(restricted=False): {t_u:.4f} s, "
          f"{gm.n2}-pair one-spin Phi x 2, peak {peak / 1e9:.3f} GB above "
          f"the resident; launches {launches}; spin sums - restricted "
          f"{d_sum:.2e}; tr gamma {tr1:.12f}, sum Gamma_pqqp {tr2:.12f}")
    check(d_sum <= TOL_SPIN_SUM, f"{label} spin sums differ by {d_sum}")
    check(abs(tr1 - ne) < 1e-10 and abs(tr2 - ne * (ne - 1)) < 1e-9,
          f"{label} traces {tr1}, {tr2}")
    anchors = RDM_ANCHORS.get(tag, {})
    if anchors:
        _hold_functionals(f"{label} spin-resolved", rdm_functionals(gu, Gu),
                          anchors["unrestricted"])
    # the complex state: the seeded per-determinant phase, canonical order
    phase = np.exp(1j * np.random.default_rng(10).uniform(0, 2 * np.pi,
                                                          gm.dim))
    psi_c = psi * torch.as_tensor(phase, device=psi.device)
    gk.reset_launches()
    (grc, Grc), t_rc = _synced(torch, lambda: pqc.get_rdms_from_state(psi_c))
    paths[f"{tag}_complex"] = lr = dict(gk.LAUNCHES)
    check(lr["gather_two_spin"] == 2 and sum(lr.values()) == 2,
          f"{label} complex restricted RDMs launches {lr}")
    gk.reset_launches()
    (guc, Guc), t_uc = _synced(torch, lambda: pqc.get_rdms_from_state(
        psi_c, restricted=False))
    paths[f"{tag}_unrestricted_complex"] = lu = dict(gk.LAUNCHES)
    check(lu["gather_rows_scaled"] == 4 and sum(lu.values()) == 4,
          f"{label} complex spin-resolved RDMs launches {lu}")
    gsc, Gsc = _spin_sums(guc, Guc, ncas)
    d_sum_c = _max_diff(((gsc, grc), (Gsc, Grc)))
    print(f"  complex state: restricted {t_rc:.4f} s (launches {lr}), "
          f"spin-resolved {t_uc:.4f} s (launches {lu}); spin sums - "
          f"restricted {d_sum_c:.2e}")
    check(d_sum_c <= TOL_SPIN_SUM,
          f"{label} complex spin sums differ by {d_sum_c}")
    if anchors:
        _hold_functionals(f"{label} phased, restricted",
                          rdm_functionals(grc, Grc),
                          anchors["phased_restricted"])
        _hold_functionals(f"{label} phased, spin-resolved",
                          rdm_functionals(guc, Guc),
                          anchors["phased_unrestricted"])
    psi_g = psi * np.exp(0.7j)
    d_phase = _max_diff((
        *zip(pqc.get_rdms_from_state(psi_g), (gr, Gr)),
        *zip(pqc.get_rdms_from_state(psi_g, restricted=False), (gu, Gu))))
    print(f"  psi e^(0.7i) against psi: RDMs differ by {d_phase:.2e}")
    check(d_phase <= TOL_SPIN_SUM,
          f"{label} global phase moves the RDMs by {d_phase}")
    # up-then-down RDMs of a sector state come from the mode permutation
    gp, Gp = fermion.reorder_unrestricted_rdms(gu, Gu, ncas)
    gb, Gb = fermion.reorder_unrestricted_rdms(gp, Gp, ncas,
                                               to_up_then_down=False)
    check(torch.equal(gb, gu) and torch.equal(Gb, Gu),
          f"{label} reorder_unrestricted_rdms round trip")
    check(Gu.shape == (nm,) * 4, f"{label} Gamma shape {tuple(Gu.shape)}")
    del pqc, umaps, gm
    torch.cuda.empty_cache()
    return paths, res


def unrestricted_full_phase(torch, P, gk):
    """Spin-resolved RDMs in the full space: (8e,8o) np_fabric L=2 at
    theta = 0.07 * arange + 0.1 (D = 65,536, nm^2 = 256: a 134 MB W
    gather), held to the JAX anchor's functionals and to the restricted
    RDMs through the spin sums; no grid kernel."""
    pqc = P.Parameterized_circuit(8, 8, ansatz="np_fabric", n_layers=2)
    theta = 0.07 * np.arange(pqc.theta_shape) + 0.1
    gr, Gr = pqc.get_rdms(theta)
    (gu, Gu), t_first = _synced(torch, lambda: pqc.get_rdms(
        theta, restricted=False))
    gk.reset_launches()
    (gu, Gu), t_u = _synced(torch, lambda: pqc.get_rdms(
        theta, restricted=False))
    launches = dict(gk.LAUNCHES)
    check_no_kernels(launches, "(8e,8o) spin-resolved RDMs")
    d_sum = _max_diff(zip(_spin_sums(gu, Gu, 8), (gr, Gr)))
    print(f"  (8e,8o) get_rdms(restricted=False): {t_u:.4f} s ({t_first:.2f}"
          f" s with the tables' build); spin sums - restricted "
          f"{d_sum:.2e}")
    check(d_sum <= TOL_SPIN_SUM, f"(8e,8o) spin sums differ by {d_sum}")
    _hold_functionals("(8e,8o) spin-resolved", rdm_functionals(gu, Gu),
                      RDM_ANCHORS["8e8o"]["unrestricted"])
    return launches


def _nr_run(torch, P, gk, label, pqc, theta0, anchors, mol):
    """3 NR iterations from theta0 with per-iteration host-clock seconds,
    each energy within 1e-8 Ha of ``anchors``; no grid kernel (the flat
    route).  Returns the seconds per iteration."""
    oo = P.OO_pqc(pqc, mol, 6, 6, freeze_active=True)
    check(oo._core["route"] == "flat", f"{label} route {oo._core['route']}")
    stamps = []

    class Stamp:
        def log(self, n, energy, **kw):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

    gk.reset_launches()
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    energies, *_ = oo.full_optimization(theta0, max_iterations=3,
                                        monitor=Stamp(), **STEP)
    check_no_kernels(dict(gk.LAUNCHES), label)
    iter_s = [b - a for a, b in zip([t_start] + stamps[:-1], stamps)]
    for i, (e, ref) in enumerate(zip(energies, anchors)):
        print(f"  {label} iter {i + 1}: E = {e:.14f}  JAX-CPU {ref:.14f}  "
              f"diff {e - ref:+.3e}  wall {iter_s[i]:.3f} s")
        check(abs(e - ref) <= TOL_ENERGY,
              f"{label} iteration {i + 1}: |{e} - {ref}| > {TOL_ENERGY}")
    check(len(energies) == 3, f"{label}: {len(energies)} iterations")
    return iter_s


def user_states_phase(torch, P, gk):
    """The user-defined states in the full space (formaldimine sto-3g,
    freeze_active, built with no device=): the prebuilt (6e,6o) np_fabric
    L=2 GateProgram read up_then_down=True, 3 NR iterations against CPU
    JAX; the JAX test's complex (2e,2o) ansatz (UCCD times an
    occupation-dependent phase) by full_optimization to CASSCF within
    1e-7; the same construction on the (6e,6o) program, 3 NR iterations
    against CPU JAX; a real callable wrapping the built-in (6e,6o)
    program, 3 NR iterations against the built-in trajectory's CPU JAX
    anchor, timed beside the built-in circuit's own sweeps in the same
    call.  J, the circuit-Hessian term and the adjoint rows of a callable
    come from torch.func over it on the card."""
    from auto_oo_tpu_torch.utils.misc import get_formal_geo

    mol = P.Moldata(get_formal_geo(140, 80), "sto-3g")
    base = P.Parameterized_circuit(6, 6, ansatz="np_fabric", n_layers=2)
    prog, nt = base.program, base.theta_shape
    dev = base.device
    utd = P.Parameterized_circuit(6, 6, ansatz=prog, up_then_down=True)
    s_utd = _nr_run(torch, P, gk, "(6e,6o) up_then_down", utd,
                    utd.init_zeros(), ANCHORS_6E6O_UTD, mol)

    def n0(ncas):
        idx = np.arange(1 << (2 * ncas))
        return torch.as_tensor(((idx >> (2 * ncas - 1)) & 1).astype(
            np.float64), device=dev)

    # the complex (2e,2o) ansatz to CASSCF
    p22 = P.Parameterized_circuit(2, 2, ansatz="ucc").program
    n22 = n0(2)

    def complex_2e2o(theta):
        return p22.apply(theta[:1]).to(torch.complex128) * torch.exp(
            1j * theta[1] * n22)

    c22 = P.Parameterized_circuit(2, 2, ansatz=complex_2e2o, theta_shape=2)
    oo22 = P.OO_pqc(c22, mol, 2, 2)
    (energies, *_), t22 = _synced(torch, lambda: oo22.full_optimization(
        c22.init_zeros(), conv_tol=1e-12))
    diff = energies[-1] - E_CASSCF_2E2O
    print(f"  complex (2e,2o) callable: {len(energies)} iterations in "
          f"{t22:.2f} s, E = {energies[-1]:.14f}, CASSCF "
          f"{E_CASSCF_2E2O:.14f}, diff {diff:+.3e}; state dtype "
          f"{c22.state(c22.init_zeros()).dtype}")
    check(abs(diff) <= TOL_COMPLEX_CASSCF,
          f"complex (2e,2o) misses CASSCF by {diff}")
    n66 = n0(6)

    def complex_6e6o(theta):
        psi = prog.apply(base._expand_theta(theta[:nt]))
        return psi.to(torch.complex128) * torch.exp(1j * theta[nt] * n66)

    c66 = P.Parameterized_circuit(6, 6, ansatz=complex_6e6o,
                                  theta_shape=nt + 1)
    theta0 = 0.1 * np.random.default_rng(6).standard_normal(nt + 1)
    s_complex = _nr_run(torch, P, gk, "(6e,6o) complex callable", c66,
                        theta0, ANCHORS_6E6O_COMPLEX, mol)
    real = P.Parameterized_circuit(
        6, 6, ansatz=lambda th: prog.apply(base._expand_theta(th)),
        theta_shape=nt)
    s_real = _nr_run(torch, P, gk, "(6e,6o) real callable", real,
                     real.init_zeros(), ANCHORS_6E6O[:3], mol)
    s_sweep = _nr_run(torch, P, gk, "(6e,6o) built-in (sweeps)", base,
                      base.init_zeros(), ANCHORS_6E6O[:3], mol)
    print(f"  {card_line()}: s/NR-iter (iterations 2-3, mean) up_then_down "
          f"{statistics.mean(s_utd[1:]):.4f}, complex callable "
          f"{statistics.mean(s_complex[1:]):.4f}, real callable "
          f"{statistics.mean(s_real[1:]):.4f} against the built-in "
          f"sweeps' {statistics.mean(s_sweep[1:]):.4f}")


class _SyncCount:
    """Counts the host synchronizations PyTorch reports inside a block
    under torch.cuda.set_sync_debug_mode("warn"), each by the innermost
    line of the port (auto_oo_tpu_torch/...) on the Python stack that
    made it: ``counts`` maps "file:line (function)" to its count."""

    def __init__(self, torch):
        self.torch = torch
        self.counts = collections.Counter()

    def __enter__(self):
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.simplefilter("always")
        warnings.showwarning = self._record
        self.torch.cuda.synchronize()
        self.torch.cuda.set_sync_debug_mode("warn")
        return self

    def _record(self, message, category, filename, lineno, file=None,
                line=None):
        if "synchroniz" not in str(message):
            return
        frame = sys._getframe(1)
        where = "outside the port"
        while frame is not None:
            fn = frame.f_code.co_filename
            if "auto_oo_tpu_torch" in fn:
                where = (f"{fn[fn.rindex('auto_oo_tpu_torch'):]}:"
                         f"{frame.f_lineno} ({frame.f_code.co_name})")
                break
            frame = frame.f_back
        self.counts[where] += 1

    def __exit__(self, *exc):
        self.torch.cuda.set_sync_debug_mode(0)
        self._catch.__exit__(*exc)
        return False

    @property
    def total(self):
        return sum(self.counts.values())

    def show(self, label, per=None, top=8):
        unit = f", {self.total / per:.1f} per iteration" if per else ""
        print(f"    {label}: {self.total} host synchronizations{unit}")
        for where, n in self.counts.most_common(top):
            print(f"      {n:5d}  {where}")


def _spy_kernel_batches(grid, shapes):
    """Wrap the grid module's three fused-route kernels so that each call
    appends (kernel, leading batch dims of its input) to ``shapes``;
    returns a function that restores them."""
    saved = {}
    for name, lead in (("gather_two_spin", 2), ("gather_reduce", 3),
                       ("gather_reduce_cols", 3)):
        fn = getattr(grid, name)
        saved[name] = fn

        def spy(x, *args, _fn=fn, _name=name, _lead=lead, **kw):
            shapes.append((_name, tuple(x.shape[:-_lead])))
            return _fn(x, *args, **kw)

        setattr(grid, name, spy)

    def restore():
        for name, fn in saved.items():
            setattr(grid, name, fn)
    return restore


def _max_abs(a, b):
    return float((a - b).abs().max())


def batch10_phase(torch, P, gk, grid):
    """Phase 23 (a): GeometryBatch.newton_steps at full width, (10e,10o)
    sector np_fabric L=2, freeze_active, B = 8 points of the tutorial's
    loop (the first 8 of 9), from init_zeros: equal to 8 sequential
    _nr_iteration calls (energy, theta and OAO 1e-12, lowest eigenvalue
    1e-9) and to the CPU JAX anchors of points 0 and 4 (1e-10); the
    fused route's three kernels launched with the geometry axis in their
    batch; the batched Newton direction and lowest eigenvalue equal to
    the per-lane solves (1e-12), on the step's Hessians and on a random
    stack of 32 x 32 matrices; s per batched step against 8 sequential
    iterations, the device busy share of a step and its host syncs.
    Returns the launches of one batched step and (the molecules, the
    circuit, theta0, the OAO matrices, the step's thetas, OAO matrices,
    energies and lowest eigenvalues) for phase 32."""
    from auto_oo_tpu_torch.ops import linalg
    from auto_oo_tpu_torch.parallel import GeometryBatch
    from auto_oo_tpu_torch.scripts.profile_14e14o import device_profile
    from auto_oo_tpu_torch.utils.misc import get_formal_geo

    geos = _loop_geometries(get_formal_geo, 9)[:8]
    t0 = time.perf_counter()
    pqc = P.Parameterized_circuit(10, 10, ansatz="np_fabric", n_layers=2,
                                  sector=True)
    mols = [P.Moldata(g, "sto-3g") for g in geos]
    batch = GeometryBatch(mols, 10, 10, pqc)
    B = len(geos)
    theta0 = pqc.init_zeros()
    oaos = torch.stack([oo.oao_mo_coeff for oo in batch.oo_list])
    torch.cuda.synchronize()
    print(f"  setup of {B} geometries: {time.perf_counter() - t0:.2f} s "
          f"(D = {pqc.state_dim}, n_theta = {pqc.theta_shape}, n_kappa = "
          f"{batch.oo0.n_kappa}, route {batch._core['route']})")
    def step():
        return batch.newton_steps(theta0, oaos)

    step()
    shapes = []
    restore = _spy_kernel_batches(grid, shapes)
    gk.reset_launches()
    try:
        (nth, nka, noao, es, lows), step_s = _synced_s(torch, step)
    finally:
        restore()
    launches = dict(gk.LAUNCHES)
    check_route_kernels(launches, FUSED_KERNELS, "the batched step")
    for name in FUSED_KERNELS:
        most = max((s[0] for k, s in shapes if k == name and s), default=1)
        print(f"    {name}: {launches[name]} launches, largest leading "
              f"batch {most}")
        check(most > 1, f"{name} never carried more than one geometry")
    seq_s = []
    oo = batch.oo_list[0]
    oo._nr_iteration(theta0, oo.oao_mo_coeff, *STEP.values())
    errs = dict(energy=0.0, theta=0.0, oao=0.0, eig=0.0)
    for i, oo in enumerate(batch.oo_list):
        ref, sec = _synced_s(torch, lambda oo=oo: oo._nr_iteration(
            theta0, oo.oao_mo_coeff, *STEP.values()))
        seq_s.append(sec)
        errs["energy"] = max(errs["energy"], abs(float(ref[3] - es[i])))
        errs["theta"] = max(errs["theta"], _max_abs(ref[0], nth[i]))
        errs["oao"] = max(errs["oao"], _max_abs(ref[2], noao[i]))
        errs["eig"] = max(errs["eig"], abs(float(ref[4] - lows[i])))
    print(f"    batched vs sequential: {errs}")
    for k in ("energy", "theta", "oao"):
        check(errs[k] <= TOL_BATCH, f"batched {k} off sequential by "
              f"{errs[k]}")
    check(errs["eig"] <= TOL_BATCH_EIG,
          f"batched lowest eigenvalue off sequential by {errs['eig']}")
    for lane, (e_ref, eig_ref, norm_ref) in BATCH_10E10O.items():
        got = (float(es[lane]), float(lows[lane]), float(nth[lane].norm()))
        err = max(abs(a - b) for a, b in zip(got, (e_ref, eig_ref,
                                                   norm_ref)))
        print(f"    lane {lane}: E {got[0]:.14f} (JAX-CPU {e_ref:.14f}), "
              f"lowest eig {got[1]:+.12e}, |theta| {got[2]:.12f}; max "
              f"|port - JAX| {err:.3e}")
        check(err <= TOL_BATCH_ANCHOR, f"lane {lane} off its anchor by "
              f"{err}")
    # the batched solve on the card (a batched Jacobi solver may serve
    # small stacked matrices) against the per-lane solves
    e0, grad, hess = batch._core["grad_hess_batch"](
        nth, noao, batch.int1e, batch.int2e, batch.oao_c, batch.nuc)
    gen = torch.Generator(device="cuda").manual_seed(23)
    Hr = torch.randn((B, 32, 32), generator=gen, dtype=torch.float64,
                     device="cuda")
    gr = torch.randn((B, 32), generator=gen, dtype=torch.float64,
                     device="cuda")
    for label, g_, H_ in (("the step's Hessians", grad, hess),
                          ("random 32 x 32", gr, Hr + Hr.mT)):
        dp, low = linalg.eigh_direction(g_, H_)
        e_dp = max(_max_abs(dp[b], linalg.eigh_direction(g_[b], H_[b])[0])
                   for b in range(B))
        e_low = max(abs(float(low[b] - linalg.eigh_direction(
            g_[b], H_[b])[1])) for b in range(B))
        print(f"    batched eigh_direction ({label}, n = "
              f"{H_.shape[-1]}): dp {e_dp:.3e}, lowest {e_low:.3e} from "
              f"the per-lane solves")
        check(max(e_dp, e_low) <= TOL_BATCH,
              f"batched Newton solve ({label}) off per-lane by "
              f"{max(e_dp, e_low)}")
    with _SyncCount(torch) as syncs:
        step()
    busy = device_profile(step, step_s, top=6)
    med = statistics.median(seq_s)
    shown = "not measured" if busy is None else f"{100 * busy:.1f}%"
    print(f"  one batched step of {B} geometries {step_s:.4f} s; {B} "
          f"sequential iterations {sum(seq_s):.4f} s ({med:.4f} s each, "
          f"median); launches {launches}; busy {shown}")
    syncs.show("one batched step")
    return launches, (mols, pqc, theta0, oaos, (nth, noao, es, lows))


def _time_loop(torch, label, runs):
    """Print the per-point seconds of each (name, fn) in ``runs`` (each
    fn returns (loop, points)) and return their results."""
    out = {}
    for name, fn in runs:
        (loop, points), sec = _synced_s(torch, fn)
        out[name] = (loop, sec)
        print(f"    {label} {name}: {points} points in {sec:.3f} s, "
              f"{sec / points:.4f} s per point")
    return out


def run_batched_phase(torch, P, gk):
    """Phase 24 (b): BerryPhaseLoop.run_batched on the tutorial's loop,
    (2e,2o) np_fabric L=1, track_steps=12: 21 points in the full space,
    energies and lowest eigenvalues within 1e-8 of CPU JAX run_batched
    and the Berry phase +-pi within 0.05 (and JAX's within 1e-8); 11
    points in sector mode, the same checks, the fused route's kernels
    launched at n2 = 4; s per point against run() in the same phase.
    Returns the launches of the sector loop's run_batched."""
    from auto_oo_tpu_torch.utils.misc import get_formal_geo

    launches = {}
    for label, points, kw, e_ref, eig_ref in (
            ("full space", 21, {}, BATCHED_2E2O_E, BATCHED_2E2O_EIG),
            ("sector", 11, dict(sector=True), BATCHED_2E2O_SECTOR_E,
             BATCHED_2E2O_SECTOR_EIG)):
        geos = _loop_geometries(get_formal_geo, points)
        pqc = P.Parameterized_circuit(2, 2, ansatz="np_fabric", n_layers=1,
                                      **kw)

        def batched():
            loop = P.BerryPhaseLoop(geos, "sto-3g", 2, 2, pqc)
            return loop.run_batched(conv_tol=1e-10, track_steps=12), points

        def sequential():
            loop = P.BerryPhaseLoop(geos, "sto-3g", 2, 2, pqc)
            return loop.run(conv_tol=1e-10, track_steps=12,
                            track_tol=1e-10), points

        gk.reset_launches()
        res = _time_loop(torch, f"(2e,2o) {label}",
                         [("run_batched", batched)])
        launches = dict(gk.LAUNCHES)
        res.update(_time_loop(torch, f"(2e,2o) {label}",
                              [("run", sequential)]))
        loop = res["run_batched"][0]
        _held(f"{label} run_batched energies", loop.energy_l, e_ref,
              TOL_ENERGY)
        _held(f"{label} run_batched lowest Hessian eigenvalues",
              loop.hess_eig_l, eig_ref, TOL_ENERGY)
        phase = loop.berry_phase()
        print(f"    Berry phase {phase:+.15f}")
        check(abs(abs(phase) - np.pi) < 0.05, f"Berry phase {phase}")
        check(abs(phase - BERRY_PHASE_2E2O) <= TOL_ENERGY,
              f"{label} Berry phase {phase}")
        if kw:
            check_route_kernels(launches, FUSED_KERNELS,
                                "the sector run_batched")
        else:
            check_no_kernels(launches, "the full-space run_batched")
    return launches


def _loop_pair(torch, P, label, pqc, mol, ncas, run_kw, held=None,
               anchors=None, method=None, precision="f64", tol=None):
    """full_optimization on the host loop and the device loop (fresh
    OO_pqc each), timed, then once more each under the sync counter.
    The device loop must equal the host loop: the same iteration count,
    energies 1e-11, theta, kappa, OAO matrices and lowest eigenvalues
    1e-9 (the first ``held`` iterations only, where given), and the final
    OAO matrix left in oao_mo_coeff; energies within 1e-8 (or ``tol``,
    one bound per iteration) of ``anchors`` where given.  Returns the
    device loop's result."""
    def build():
        return P.OO_pqc(pqc, mol, ncas, ncas, freeze_active=True,
                        newton_method=method, precision=precision)

    def run(oo, device_loop):
        return oo, oo.full_optimization(pqc.init_zeros(),
                                        device_loop=device_loop, **run_kw)

    run(build(), True)
    oo_h, oo_d = build(), build()
    (oo_h, host), host_s = _synced_s(torch, lambda: run(oo_h, False))
    (oo_d, dev), dev_s = _synced_s(torch, lambda: run(oo_d, True))
    n = len(host[0]) if held is None else min(held, len(host[0]))
    check(len(dev[0]) == len(host[0]),
          f"{label}: {len(dev[0])} device-loop iterations, host "
          f"{len(host[0])}")
    e_err = max(abs(a - b) for a, b in zip(dev[0][:n], host[0][:n]))
    eig_err = max(abs(a - b) for a, b in zip(dev[4][:n], host[4][:n]))
    p_err = max(_max_abs(a, b) for k in (1, 2, 3)
                for a, b in zip(dev[k][:n], host[k][:n]))
    print(f"    {label}: {len(dev[0])} iterations; device loop vs host "
          f"loop over {n}: energies {e_err:.3e}, theta/kappa/OAO "
          f"{p_err:.3e}, lowest eigenvalues {eig_err:.3e}; host loop "
          f"{host_s:.3f} s ({host_s / len(host[0]):.4f} s/iter), device "
          f"loop {dev_s:.3f} s ({dev_s / len(dev[0]):.4f} s/iter)")
    check(e_err <= TOL_LOOP_E, f"{label}: energies part by {e_err}")
    check(max(p_err, eig_err) <= TOL_LOOP_PARAMS,
          f"{label}: parameters part by {max(p_err, eig_err)}")
    check(torch.equal(oo_d.oao_mo_coeff, dev[3][-1]),
          f"{label}: oao_mo_coeff is not the last OAO matrix")
    if anchors is not None and tol is None:
        _held(f"{label} device-loop energies", dev[0][:n], anchors[:n],
              TOL_ENERGY)
    elif anchors is not None:
        for i, (e, ref, t) in enumerate(zip(dev[0], anchors, tol)):
            print(f"      iteration {i + 1}: {e:.14f}, CPU JAX {ref:.14f}, "
                  f"diff {e - ref:+.3e} (bound {t:.0e})")
            check(abs(e - ref) <= t, f"{label} iteration {i + 1} off its "
                  f"anchor by {e - ref}")
    oo_h, oo_d = build(), build()
    with _SyncCount(torch) as s_h:
        run(oo_h, False)
    with _SyncCount(torch) as s_d:
        run(oo_d, True)
    s_h.show(f"{label} host loop", per=len(host[0]), top=4)
    s_d.show(f"{label} device loop", per=len(dev[0]))
    check(s_d.total < s_h.total, f"{label}: the device loop synchronized "
          f"{s_d.total} times, the host loop {s_h.total}")
    return dev, dict(host_s=host_s, dev_s=dev_s, host_syncs=s_h.total,
                     dev_syncs=s_d.total, iterations=len(dev[0]))


def device_loop_phase(torch, P, gk):
    """Phase 25 (c): full_optimization(device_loop=True) against the host
    loop on the card (_loop_pair): (2e,2o) np_fabric L=1 in the full
    space, freeze_active, to CASSCF within 1e-8, on eigh and on
    newton_method="iterative"; (6e,6o) np_fabric L=2 in the full space,
    12 iterations, held to the CPU JAX anchors (the trajectory amplifies
    its last bits tenfold per iteration after that); (10e,10o) sector
    np_fabric L=2, 4 iterations at conv_tol=0, held to its anchors, in
    f64 and in precision="mixed" (iteration 1 within 1e-6 of CPU JAX
    mixed, 2-4 within 1e-5).  (The (12e,12o) staged refusal is checked
    in phase 6.)  Returns the (10e,10o) device loop's kernel launches."""
    from auto_oo_tpu_torch.utils.misc import get_formal_geo

    mol = P.Moldata(get_formal_geo(140, 80), "sto-3g")
    pqc2 = P.Parameterized_circuit(2, 2, ansatz="np_fabric", n_layers=1)
    for method in ("eigh", "iterative"):
        dev, _ = _loop_pair(torch, P, f"(2e,2o) {method}", pqc2, mol, 2, {},
                            method=method)
        diff = dev[0][-1] - E_CASSCF_2E2O
        print(f"      to CASSCF: {diff:+.3e}")
        check(abs(diff) <= TOL_ENERGY, f"(2e,2o) {method} device loop "
              f"misses CASSCF by {diff}")
    pqc6 = P.Parameterized_circuit(6, 6, ansatz="np_fabric", n_layers=2)
    _loop_pair(torch, P, "(6e,6o) full space", pqc6, mol, 6,
               dict(max_iterations=HELD_6E6O), anchors=ANCHORS_6E6O)
    pqc10 = P.Parameterized_circuit(10, 10, ansatz="np_fabric", n_layers=2,
                                    sector=True)
    gk.reset_launches()
    oo = P.OO_pqc(pqc10, mol, 10, 10, freeze_active=True)
    oo.full_optimization(pqc10.init_zeros(), max_iterations=4, conv_tol=0.0,
                         device_loop=True)
    launches = dict(gk.LAUNCHES)
    check_route_kernels(launches, FUSED_KERNELS, "the (10e,10o) device loop")
    print(f"    (10e,10o) device loop, 4 iterations: launches {launches} "
          f"({ {k: v / 4 for k, v in launches.items() if v} } per "
          f"iteration)")
    _loop_pair(torch, P, "(10e,10o) sector", pqc10, mol, 10,
               dict(max_iterations=4, conv_tol=0.0), anchors=ANCHORS_10E10O)
    _loop_pair(torch, P, "(10e,10o) sector, mixed", pqc10, mol, 10,
               dict(max_iterations=4, conv_tol=0.0),
               anchors=ANCHORS_10E10O_MIXED, precision="mixed",
               tol=TOL_10E10O_MIXED)
    return launches


def batch_loop_phase(torch, P):
    """Phase 26 (d): GeometryBatch.optimize_device_loop against optimize,
    (2e,2o) np_fabric L=1, geometries (140, 80) and (135, 85): 8 steps at
    conv_tol=0 equal (energies 1e-11, theta, OAO and lowest eigenvalues
    1e-9); with conv_tol=1e-10 it stops before 20 steps, within 1e-8 of
    each geometry's CASSCF; times and host syncs of both drivers."""
    from auto_oo_tpu_torch.parallel import GeometryBatch
    from auto_oo_tpu_torch.utils.misc import get_formal_geo

    mols = [P.Moldata(get_formal_geo(a, p), "sto-3g")
            for a, p in ((140, 80), (135, 85))]
    pqc = P.Parameterized_circuit(2, 2, ansatz="np_fabric", n_layers=1)
    batch = GeometryBatch(mols, 2, 2, pqc)
    theta0 = pqc.init_zeros()
    batch.optimize(theta0, n_steps=1)
    (hist_h, th_h, oao_h, low_h), host_s = _synced_s(
        torch, lambda: batch.optimize(theta0, n_steps=8))
    (hist_d, th_d, oao_d, low_d), dev_s = _synced_s(
        torch, lambda: batch.optimize_device_loop(theta0, max_steps=8,
                                                  conv_tol=0.0))
    check(tuple(hist_d.shape) == (8, 2), f"device loop ran "
          f"{tuple(hist_d.shape)} steps")
    e_err = _max_abs(hist_d, torch.stack(hist_h))
    p_err = max(_max_abs(th_d, th_h), _max_abs(oao_d, oao_h),
                _max_abs(low_d, low_h))
    print(f"    8 steps: optimize_device_loop vs optimize: energies "
          f"{e_err:.3e}, theta/OAO/eigenvalues {p_err:.3e}; optimize "
          f"{host_s:.3f} s, optimize_device_loop {dev_s:.3f} s")
    check(e_err <= TOL_LOOP_E, f"batched device loop energies part by "
          f"{e_err}")
    check(p_err <= TOL_LOOP_PARAMS, f"batched device loop parameters part "
          f"by {p_err}")
    (hist_c, *_), conv_s = _synced_s(
        torch, lambda: batch.optimize_device_loop(theta0, max_steps=50,
                                                  conv_tol=1e-10))
    steps = hist_c.shape[0]
    print(f"    conv_tol=1e-10: stopped after {steps} steps, {conv_s:.3f} s")
    check(3 <= steps < 20, f"batched device loop took {steps} steps")
    for i, mol in enumerate(mols):
        mol.run_casscf(2, 2)
        diff = float(hist_c[-1, i]) - mol.casscf.e_tot
        check(abs(diff) <= TOL_ENERGY, f"geometry {i} misses CASSCF by "
              f"{diff}")
    with _SyncCount(torch) as s_h:
        batch.optimize(theta0, n_steps=8)
    with _SyncCount(torch) as s_d:
        batch.optimize_device_loop(theta0, max_steps=8, conv_tol=0.0)
    s_h.show("optimize, 8 steps", per=8, top=4)
    s_d.show("optimize_device_loop, 8 steps", per=8)


@contextlib.contextmanager
def dist_measure(torch, gk, D, label, paths=None, key=None):
    """Time a block of distributed calls on the card: its wall time (host
    clock, synchronized), peak device memory, the collectives issued
    with the bytes of their inputs (parallel.distributed.COLLECTIVES) and
    the kernel launches, all counted from 0 at its start; the launches
    are added to ``paths[key]``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    D.reset_collectives()
    gk.reset_launches()
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = dict(gk.LAUNCHES)
    coll = ", ".join(f"{k} {n} ({b / 1e9:.4f} GB)"
                     for k, (n, b) in D.COLLECTIVES.items() if n)
    print(f"    {label}: {sec:.3f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB, collectives "
          f"{coll or 'none'}; launches { {k: v for k, v in launches.items() if v} }")
    if paths is not None:
        acc = paths.setdefault(key, dict.fromkeys(launches, 0))
        for k, v in launches.items():
            acc[k] += v


def _rel(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


def sharded16_phase(torch, P, gk, D, mesh, pqc, oo):
    """Phases 27 (a) and 28 (b): the (16e,16o) H16 chain (D = 165,636,900)
    at full width on one NCCL rank, at the demo's theta0 = 0.02 *
    arange(14).  (a) row_sharded_sector_fns: rdms, ham_apply and
    energy_gradient, e0 and the gradient held to the single-card hosted
    energy_and_gradient within 1e-10, the RDMs to its RDMs and H psi to
    grid_hosted.ham_apply_hosted within 1e-12 relative; (b)
    hosted_sharded_fns (its default row chunk): rdms and ham_apply held
    to grid_hosted within 1e-12 relative to max |H psi| (and max |Gamma|).
    Returns {path: launches}."""
    from auto_oo_tpu_torch.ops import grid, grid_hosted
    from auto_oo_tpu_torch.ops import hamiltonian
    from auto_oo_tpu_torch.parallel import (hosted_sharded_fns,
                                            row_sharded_sector_fns)

    gm = pqc.sector_maps
    paths = {}
    theta0 = 0.02 * torch.arange(pqc.theta_shape, dtype=torch.float64,
                                 device=pqc.device)
    c0, c1, c2 = oo.get_active_integrals(oo.mo_coeff)
    c1e = hamiltonian.c1_effective(c1, c2)
    psi_g = pqc._state_impl_grid(theta0)
    e_ref, g_ref, (gamma, Gamma) = oo.energy_and_gradient(theta0)
    h_ref = grid_hosted.ham_apply_hosted(c1e, c2, psi_g, gm)
    key = "row_sharded_16e16o"
    eng = row_sharded_sector_fns(pqc, mesh, axis="row")
    with dist_measure(torch, gk, D, "(a) rdms_grid", paths, key):
        g1, G2 = eng["rdms_grid"](psi_g)
    psi = grid.from_grid(psi_g, gm)
    with dist_measure(torch, gk, D, "(a) ham_apply", paths, key):
        h = eng["ham_apply"](c1e, c2, psi)
    del psi
    h = grid.to_grid(h, gm)
    with dist_measure(torch, gk, D, "(a) energy_gradient", paths, key):
        e0, grad = eng["energy_gradient"](c0, c1e, c2, theta0)
    errs = dict(e0=abs(float(e0 - e_ref)),
                grad=float((grad - g_ref[:pqc.theta_shape]).abs().max()),
                gamma=_rel(g1, gamma), Gamma=_rel(G2, Gamma),
                ham=_rel(h, h_ref))
    del h
    print(f"    (a) against the single-card hosted path: "
          f"{ {k: f'{v:.2e}' for k, v in errs.items()} }")
    check(errs["e0"] <= 1e-10 and errs["grad"] <= 1e-10,
          f"(16e,16o) row-sharded energy_gradient off: {errs}")
    check(max(errs["gamma"], errs["Gamma"], errs["ham"]) <= 1e-12,
          f"(16e,16o) row-sharded RDMs or H psi off: {errs}")
    check_route_kernels(paths[key], HOSTED_KERNELS, "the row-sharded engine")
    torch.cuda.empty_cache()
    key = "hosted_sharded_16e16o"
    hs = hosted_sharded_fns(gm, mesh, axis="row")
    print(f"    (b) hosted x row-sharded row chunk {hs['row_chunk']} of "
          f"{gm.Na} rows; memory table {hs['memory_budget']()}")
    xn = hs["rows"](psi_g)
    with dist_measure(torch, gk, D, "(b) rdms", paths, key):
        gam, cor = hs["rdms"](xn)
    with dist_measure(torch, gk, D, "(b) ham_apply", paths, key):
        hh = hs["ham_apply"](c1e, c2, xn)
    del xn
    hh = hs["gather"](hh)
    g1h, G2h = grid.assemble_rdms(gam, cor, pqc.ncas)
    errs = dict(gamma=_rel(g1h, gamma), Gamma=_rel(G2h, Gamma),
                ham=_rel(hh, h_ref))
    print(f"    (b) against the single-card hosted passes: "
          f"{ {k: f'{v:.2e}' for k, v in errs.items()} }")
    check(max(errs.values()) <= 1e-12,
          f"(16e,16o) hosted x row-sharded engine off: {errs}")
    for name in ("gather_rows_scaled", "gather_reduce_cols",
                 "scatter_rows"):
        check(paths[key][name] > 0, f"{name} not launched by the hosted x "
              f"row-sharded engine")
    segment_rows_scaled(torch, gk, gm, psi_g, hs)
    xn = hs["rows"](psi_g)
    mine, total = kernel_share(torch, lambda: hs["rdms"](xn),
                               "gather_rows_scaled")
    del xn
    print("    (b) rdms under torch.profiler: " + (
        "no device time in the trace (not measured)" if total is None else
        f"gather_rows_scaled {mine / 1e3:.1f} ms of {total / 1e3:.1f} ms "
        f"device time ({100 * mine / total:.1f}%)"))
    return paths


def segment_rows_scaled(torch, gk, gm, psi_g, hs):
    """One segment of the hosted x row-sharded engine at one rank (the
    middle one, hs["row_chunk"] grid rows): its two gather_rows_scaled
    launches on the engine's shapes, the alpha half on the whole grid x
    with the segment's columns of the alpha maps and the beta half on the
    segment's transposed rows, each equal to its plain version as values
    and timed beside its bound, then both in turns as a segment takes
    them, beside their summed bound and per pass (every segment)."""
    seg = hs["row_chunk"]
    n_seg = -(-gm.Na // seg)
    r0 = seg * (n_seg // 2)
    r1 = min(gm.Na, r0 + seg)
    srcA, sgnA, tB, srcB, sgnB, tA = gm.tables(psi_g)
    xg = psi_g.reshape(gm.Na, gm.Nb)
    halves = (("alpha", (xg, srcA[:, r0:r1].contiguous(),
                         sgnA[:, r0:r1].contiguous(), tB)),
              ("beta", (xg[r0:r1].T.contiguous(), srcB, sgnB,
                        tA[:, r0:r1].contiguous())))
    bound = 0.0
    for half, args in halves:
        out = gk.gather_rows_scaled(*args)
        torch.cuda.synchronize()
        err, _ = _slab_err(out, gk.gather_rows_scaled_plain, args)
        check(err == 0.0, f"gather_rows_scaled segment {half}: not equal to "
              f"its plain version ({err:.3e})")
        del out
        ms = time_ms(lambda: gk.gather_rows_scaled(*args), torch)
        share, bms = rows_share(gk, ms, args)
        bound += bms
        print(f"    (b) segment [{r0}, {r1}) {half:5s}: x "
              f"{tuple(args[0].shape)} src {tuple(args[1].shape)} equal to "
              f"plain; kernel={ms:.4f} ms"
              f"{was(f'16e {half} {seg}@{r0} float64')} {share}")
    ms = time_ms(lambda: [gk.gather_rows_scaled(*a) for _, a in halves],
                 torch)
    print(f"    (b) one segment's two launches: {ms:.4f} ms against a bound "
          f"of {bound:.4f} ms ({100 * bound / ms:.1f}%); x {n_seg} segments "
          f"= {ms * n_seg:.1f} ms per rdms or ham_apply pass")


def kernel_share(torch, fn, name):
    """(device us of the kernels whose name holds ``name``, device us of
    all kernels) in one fn() under torch.profiler; (None, None) where the
    trace holds no device time."""
    from auto_oo_tpu_torch.scripts.profile_14e14o import _device_us

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if "cuda" in str(getattr(e, "device_type", "")).lower()
            and _device_us(e) > 0]
    if not rows:
        return None, None
    return (sum(_device_us(e) for e in rows if name in e.key),
            sum(_device_us(e) for e in rows))


def grid2d12_phase(torch, gk, D, mesh, objects):
    """Phase 29 (c): grid2d_nr_fns on a 1 x 1 (tangent, row) NCCL mesh at
    the (12e,12o) 6-31G sector (phase 6's objects): its first nr_step
    from init_zeros equal to phase 6's first iteration within 1e-10 Ha
    and to the CPU JAX anchor within 1e-8.  Returns {path: launches}."""
    from auto_oo_tpu_torch.parallel import grid2d_nr_fns

    _mol, pqc, oo, oao0, energies = objects
    paths = {}
    eng = grid2d_nr_fns(oo, mesh, t_axis="tp", r_axis="row")
    with dist_measure(torch, gk, D, "(c) grid2d nr_step", paths,
                      "grid2d_12e12o"):
        out = eng["nr_step"](pqc.init_zeros(), oao0)
    e = float(out[3])
    print(f"    (c) E = {e:.14f}; phase 6 iteration 1 {energies[0]:.14f} "
          f"(diff {e - energies[0]:+.3e}); CPU JAX {ANCHORS_12E12O[0]:.14f} "
          f"(diff {e - ANCHORS_12E12O[0]:+.3e})")
    check(abs(e - energies[0]) <= 1e-10, "grid2d (12e,12o) step off phase 6")
    check(abs(e - ANCHORS_12E12O[0]) <= TOL_ENERGY,
          "grid2d (12e,12o) step off its anchor")
    check_route_kernels(paths["grid2d_12e12o"], HOSTED_KERNELS,
                        "the grid2d step")
    return paths


def batch12_phase(torch, P, gk, objects):
    """Phase 30: GeometryBatch on the staged route (ROADMAP queue 1 item
    11): the (12e,12o) 6-31G sector at 2 geometries, (140, 80) (phase 6's
    molecule) and (135, 85), one newton_steps from init_zeros: lane 0
    within 1e-8 of the CPU JAX anchor (iteration 1 of phase 6's path;
    the second geometry has no CPU JAX anchor, a full-size run), each
    lane within 1e-10 of its sequential _nr_iteration; its time, peak
    memory and launches.  Returns {path: launches}."""
    from auto_oo_tpu_torch.parallel import GeometryBatch
    from auto_oo_tpu_torch.utils.misc import get_formal_geo

    mol, pqc, _oo, _oao0, _energies = objects
    mols = [mol, P.Moldata(get_formal_geo(135, 85), mol.basis)]
    batch = GeometryBatch(mols, pqc.ncas, pqc.ncas, pqc)
    check(batch._core["route"] == "staged",
          f"(12e,12o) batch route {batch._core['route']}")
    theta0 = pqc.init_zeros()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gk.reset_launches()
    t0 = time.perf_counter()
    out = batch.newton_steps(theta0, None)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = dict(gk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    es = out[3].tolist()
    seq = [float(oo._nr_iteration(theta0, oo.oao_mo_coeff,
                                  *STEP.values())[3])
           for oo in batch.oo_list]
    print(f"    one batched step of 2 (12e,12o) geometries: {sec:.3f} s, "
          f"peak device memory {peak / 1e9:.3f} GB; energies {es}; "
          f"sequential {seq}; lane 0 - CPU JAX {es[0] - ANCHORS_12E12O[0]:+.3e}"
          f"; launches {launches}")
    check(abs(es[0] - ANCHORS_12E12O[0]) <= TOL_ENERGY,
          "(12e,12o) batch lane 0 off its anchor")
    check(max(abs(a - b) for a, b in zip(es, seq)) <= 1e-10,
          "(12e,12o) batch off the sequential iterations")
    check_route_kernels(launches, FUSED_KERNELS, "the (12e,12o) batch")
    return {"batch_12e12o": launches}


def tangent_sharded_phase(torch, P, gk, D, mesh):
    """Phase 31 (d): sharded_nr_step_fn on one NCCL rank: the (10e,10o)
    sector slice (np_fabric L=2, from init_zeros) and the (8e,8o) full
    space (np_fabric L=1, tangents and state on one axis), each equal to
    the single-card _nr_iteration within 1e-10 Ha; (10e,10o) within 1e-8
    of its CPU JAX anchor, (8e,8o) within 1e-9 of the JAX package's
    8-device -92.6688074620 (MULTICHIP_r05.json).  Returns {path:
    launches}."""
    from auto_oo_tpu_torch.parallel import sharded_nr_step_fn
    from auto_oo_tpu_torch.utils.misc import get_formal_geo

    mol = P.Moldata(get_formal_geo(140, 80), "sto-3g")
    paths = {}
    for label, ncas, kw, state_axis, anchor, tol in (
            ("10e10o", 10, dict(n_layers=2, sector=True), None,
             ANCHORS_10E10O[0], TOL_ENERGY),
            ("8e8o", 8, dict(n_layers=1), "tp", E_NR_8E8O, 1e-9)):
        pqc = P.Parameterized_circuit(ncas, ncas, ansatz="np_fabric", **kw)
        oo = P.OO_pqc(pqc, mol, ncas, ncas, freeze_active=True)
        theta0 = pqc.init_zeros()
        ref = oo._nr_iteration(theta0, oo.oao_mo_coeff, *STEP.values())
        step = sharded_nr_step_fn(oo, mesh, axis="tp", state_axis=state_axis)
        key = f"tangent_sharded_{label}"
        with dist_measure(torch, gk, D, f"(d) ({label}) sharded NR step",
                          paths, key):
            out = step(theta0, oo.oao_mo_coeff)
        e = float(out[3])
        print(f"    (d) ({label}): E = {e:.14f}, single card "
              f"{float(ref[3]):.14f} (diff {e - float(ref[3]):+.3e}), "
              f"anchor {anchor:.10f} (diff {e - anchor:+.3e})")
        check(abs(e - float(ref[3])) <= 1e-10,
              f"({label}) sharded NR step off the single card")
        check(abs(e - anchor) <= tol, f"({label}) sharded NR step off "
              f"its anchor by {e - anchor}")
    check_route_kernels(paths["tangent_sharded_10e10o"], FUSED_KERNELS,
                        "the (10e,10o) sharded step")
    del paths["tangent_sharded_8e8o"]
    return paths


def batch_mesh_phase(torch, gk, D, mesh, objects):
    """Phase 32 (e): GeometryBatch(mesh=, axis="dp") over phase 23's 8
    (10e,10o) geometries on one NCCL rank: one newton_steps equal to the
    batch without a mesh (energies 1e-12 Ha, theta and OAO 1e-12, lowest
    eigenvalues 1e-9).  Returns {path: launches}."""
    from auto_oo_tpu_torch.parallel import GeometryBatch

    mols, pqc, theta0, oaos, (nth, noao, es, lows) = objects
    batch = GeometryBatch(mols, 10, 10, pqc, mesh=mesh, axis="dp")
    paths = {}
    with dist_measure(torch, gk, D, "(e) GeometryBatch(mesh=) newton_steps",
                      paths, "batch_mesh_10e10o"):
        out = batch.newton_steps(theta0, oaos)
    errs = dict(energy=_max_abs(out[3], es), theta=_max_abs(out[0], nth),
                oao=_max_abs(out[2], noao), eig=_max_abs(out[4], lows))
    print(f"    (e) against mesh=None: "
          f"{ {k: f'{v:.2e}' for k, v in errs.items()} }")
    for k in ("energy", "theta", "oao"):
        check(errs[k] <= TOL_BATCH, f"batch mesh {k} off by {errs[k]}")
    check(errs["eig"] <= TOL_BATCH_EIG, f"batch mesh eig off {errs['eig']}")
    check_route_kernels(paths["batch_mesh_10e10o"], FUSED_KERNELS,
                        "the meshed batch")
    return paths


def count_phase(torch, P, objects12):
    """The FLOP count of one f64 NR iteration (utils/flops.py) against
    the matmul FLOPs (mm, bmm, addmm, baddbmm) that
    torch.utils.flop_counter.FlopCounterMode sees it run on the card,
    from init_zeros and outside any timed call: (10e,10o) on the fused
    route (built here) and phase 6's (12e,12o) 6-31G on the staged route
    (from its initial OAO matrix).  grad_hess and the update (its Armijo
    trials from the step taken) are counted apart; the total must lie
    within FLOP_BAND of the counter's.  Prints the count's share in the
    D-scaling terms."""
    from torch.utils.flop_counter import FlopCounterMode
    from auto_oo_tpu_torch.utils import flops
    from auto_oo_tpu_torch.utils.misc import get_formal_geo

    _, pqc12, oo12, oao12, _ = objects12
    pqc10 = P.Parameterized_circuit(10, 10, ansatz="np_fabric", n_layers=2,
                                    sector=True)
    oo10 = P.OO_pqc(pqc10, P.Moldata(get_formal_geo(140, 80), "sto-3g"),
                    10, 10, freeze_active=True)
    ratios = {}
    for label, route, pqc, oo, oao in (
            ("(10e,10o)", "fused", pqc10, oo10, oo10.oao_mo_coeff),
            ("(12e,12o)", "staged", pqc12, oo12, oao12)):
        check(oo._core["route"] == route,
              f"{label} route {oo._core['route']}, expected {route}")
        theta, args = pqc.init_zeros(), (oao, *oo._mol_args)
        seen = {}
        with armijo_steps_taken() as steps:
            with FlopCounterMode(display=False) as counter:
                e0, grad, hess = oo._core["grad_hess"](theta, *args)
            seen["grad_hess"] = counter.get_total_flops()
            ops = dict(counter.get_flop_counts()["Global"])
            with FlopCounterMode(display=False) as counter:
                oo._core["newton_update"](theta, *args, e0, grad, hess,
                                          *STEP.values())
            seen["update"] = counter.get_total_flops()
        torch.cuda.synchronize()
        seen["total"] = seen["grad_hess"] + seen["update"]
        (t,) = steps
        count = flops.nr_iteration_flops(pqc, oo, n_trials=armijo_trials(t))
        shapes = flops._shapes(pqc, oo)
        no_d = (flops.grad_hess_flops(shapes[0], 0, *shapes[2:])
                + flops.update_flops(shapes[0], 0, *shapes[2:],
                                     n_trials=armijo_trials(t)))
        ratios[label] = {k: count[k] / seen[k] for k in seen}
        print(f"  {label} {route}, D = {pqc.state_dim}: one NR iteration "
              f"from init_zeros ({armijo_trials(t)} Armijo trials): count "
              f"{count['total'] / 1e9:.3f} GFLOP "
              f"({100 * (1 - no_d / count['total']):.2f}% in the D terms), "
              f"FlopCounterMode "
              f"{seen['total'] / 1e9:.3f} GFLOP; count / counter: "
              + ", ".join(f"{k} {v:.4f}" for k, v in ratios[label].items())
              + "; grad_hess ops: " + ", ".join(
                  f"{op} {n / 1e9:.3f}" for op, n in ops.items()))
        lo, hi = FLOP_BAND
        check(lo <= ratios[label]["total"] <= hi,
              f"{label}: count / FlopCounterMode {ratios[label]['total']} "
              f"outside {FLOP_BAND}")
    del oo10, pqc10
    torch.cuda.empty_cache()
    return ratios


def tutorial_phase(torch, P, gk):
    """The OO-VQE tutorial (python -m auto_oo_tpu_torch.scripts.
    tutorial_oo_vqe, examples/tutorial_oo_vqe.py) at full length on the
    default device: the Newton run to CASSCF within 1e-8 Ha, each of its
    iterations within 1e-8 Ha of the JAX example's, then 300 circuit-only
    Adam steps, the last energy within 1e-8 of the JAX example's and
    printed beside CASCI; the full space launches no grid kernel.
    Returns the launches."""
    from auto_oo_tpu_torch.scripts import tutorial_oo_vqe as tut

    gk.reset_launches()
    t0 = time.perf_counter()
    mol, pqc, oo = tut.build()
    check(oo.device.type == "cuda", f"tutorial on {oo.device}")
    energies, _, _, _, eigs = tut.newton_run(oo, pqc)
    torch.cuda.synchronize()
    t_newton = time.perf_counter() - t0
    check(len(energies) == len(TUTORIAL_NEWTON_E),
          f"tutorial: {len(energies)} Newton iterations, the JAX example "
          f"{len(TUTORIAL_NEWTON_E)}")
    drift = max(abs(e - r) for e, r in zip(energies, TUTORIAL_NEWTON_E))
    mol.run_casscf(tut.NCAS, tut.NELECAS)
    diff = energies[-1] - mol.casscf.e_tot
    print(f"  Newton: {len(energies)} iterations (JAX {len(TUTORIAL_NEWTON_E)}"
          f") in {t_newton:.2f} s, E = {energies[-1]:.12f}, CASSCF "
          f"{mol.casscf.e_tot:.12f}, diff {diff:+.3e}, lowest Hessian "
          f"eigenvalue {eigs[-1]:.3e}; max |E - JAX| over the iterations "
          f"{drift:.2e}")
    for n, (e, ref) in enumerate(zip(energies, TUTORIAL_NEWTON_E), 1):
        print(f"    iter {n}: E = {e:.12f}  JAX-CPU {ref:.12f}  diff "
              f"{e - ref:+.2e}")
    check(abs(diff) <= TOL_ENERGY, f"tutorial misses CASSCF by {diff}")
    check(drift <= TOL_ENERGY,
          f"tutorial Newton trajectory {drift} from the JAX example's")
    t0 = time.perf_counter()
    H = tut.cas_hamiltonian(mol, oo)
    adam_e, theta = tut.adam_run(pqc, H)
    torch.cuda.synchronize()
    t_adam = time.perf_counter() - t0
    mol.run_casci(tut.NCAS, tut.NELECAS, fix_singlet=0)
    e_casci = mol.casci.e_tot
    diff = adam_e[-1] - TUTORIAL_ADAM_E
    print(f"  circuit-only Adam: {len(adam_e)} steps in {t_adam:.2f} s "
          f"({1e3 * t_adam / len(adam_e):.2f} ms a step), E = "
          f"{adam_e[-1]:.12f}, JAX-CPU {TUTORIAL_ADAM_E:.10f} (diff "
          f"{diff:+.2e}), CASCI (any spin) {e_casci:.12f}")
    check(len(adam_e) == 300 and bool(torch.isfinite(theta).all()),
          "tutorial Adam run")
    check(abs(diff) <= TOL_ENERGY,
          f"tutorial Adam energy {adam_e[-1]} misses {TUTORIAL_ADAM_E}")
    launches = dict(gk.LAUNCHES)
    check_no_kernels(launches, "the tutorial")
    return launches


def noise_study_phase(torch, P, gk):
    """The noise study (python -m auto_oo_tpu_torch.scripts.noise_study,
    examples/noise_study.py), cut to NOISE_VARIANCES x NOISE_SEEDS, on
    the default device: its rows (the JAX keys, a basin fraction that is
    a share of the seeds; at 1e-8 every seed in the basin); its
    noiseless limit, a variance-0 row, equal to the plain Newton run of
    the same 30 iterations (best error within 1e-12 Ha, the iterations
    to the basin exactly).  The full space launches no grid kernel.
    Returns the launches."""
    from auto_oo_tpu_torch.scripts import noise_study as ns

    mol = P.Moldata(P.get_formal_geo(140, 80), "sto-3g")
    e_ref = ns.casscf_energy(mol)
    pqc = P.Parameterized_circuit(2, 2, ansatz="np_fabric", n_layers=1)
    gk.reset_launches()
    t0 = time.perf_counter()
    row0 = ns.study_row(pqc, mol, e_ref, 0.0, range(1))
    plain = P.OO_pqc(pqc, mol, 2, 2, freeze_active=True).full_optimization(
        pqc.init_zeros(), max_iterations=ns.MAX_ITER, conv_tol=0.0)[0]
    err = np.abs(np.array(plain) - e_ref)
    first = int(np.nonzero(err < row0["basin_tol_ha"])[0][0]) + 1
    print(f"  noiseless limit ({time.perf_counter() - t0:.2f} s): "
          f"{json.dumps(row0)}; plain Newton best error {err.min():.3e}, "
          f"in the basin from iteration {first}")
    check(len(plain) == ns.MAX_ITER, f"plain run of {len(plain)}")
    check(abs(row0["median_best_error_ha"] - err.min()) <= 1e-12
          and row0["median_iters_to_basin"] == first
          and row0["fraction_in_basin"] == 1.0,
          f"variance-0 row {row0} against the plain run")
    for var in NOISE_VARIANCES:
        t0 = time.perf_counter()
        row = ns.study_row(pqc, mol, e_ref, var, NOISE_SEEDS)
        print(f"  {json.dumps(row)} ({len(NOISE_SEEDS)} seeds, "
              f"{time.perf_counter() - t0:.2f} s)")
        check(set(row) == set(row0), f"row keys {sorted(row)}")
        check(row["fraction_in_basin"] * len(NOISE_SEEDS) in range(
            len(NOISE_SEEDS) + 1), f"basin fraction {row}")
        check(np.isfinite(row["worst_best_error_ha"]), f"row {row}")
        if var == NOISE_VARIANCES[0]:
            check(row["fraction_in_basin"] == 1.0,
                  f"variance {var}: not every seed in the basin")
    launches = dict(gk.LAUNCHES)
    check_no_kernels(launches, "the noise study")
    return launches


def rdms_sector_state_phase(torch, P, gk):
    """simulator.sector.rdms_from_sector_state at (10e,10o) np_fabric L=2
    (theta = 0.07 * arange + 0.1) on the card: over the circuit's GridMaps
    it launches gather_two_spin and no other kernel, and equals its plain
    version (the flat (2, n^2, D) sector tables, element gathers in plain
    PyTorch, no kernel) and the circuit's own get_rdms within 1e-12; the
    same for the state with a seeded per-determinant phase.  Returns the
    launches of the grid call."""
    from auto_oo_tpu_torch.simulator import sector

    pqc = P.Parameterized_circuit(10, 10, ansatz="np_fabric", n_layers=2,
                                  sector=True)
    theta = 0.07 * np.arange(pqc.theta_shape) + 0.1
    psi = pqc.state(theta)
    flat, t_flat = _synced(torch, lambda: sector.sector_epq_maps(10, 10))
    print(f"  flat sector tables: {t_flat:.2f} s, "
          f"{_nbytes(flat.src, flat.sign) / 1e6:.1f} MB")
    phase = np.exp(1j * np.random.default_rng(10).uniform(0, 2 * np.pi,
                                                          psi.numel()))
    launches = None
    for label, state in (("real", psi), ("phased", psi * torch.as_tensor(
            phase, device=psi.device))):
        gk.reset_launches()
        got, t_grid = _synced(torch, lambda: sector.rdms_from_sector_state(
            state, pqc.sector_maps))
        grid_launches = dict(gk.LAUNCHES)
        gk.reset_launches()
        plain, t_plain = _synced(torch, lambda: sector.rdms_from_sector_state(
            state, flat))
        check_no_kernels(gk.LAUNCHES, f"the flat tables ({label})")
        ref = pqc.get_rdms_from_state(state)
        d_plain = _max_diff(zip(got, plain))
        d_ref = _max_diff(zip(got, ref))
        print(f"  {label} state: GridMaps {t_grid:.4f} s (launches "
              f"{grid_launches}), flat tables {t_plain:.4f} s; |grid - "
              f"plain| {d_plain:.2e}, |grid - get_rdms| {d_ref:.2e}")
        check(grid_launches["gather_two_spin"] > 0
              and sum(grid_launches.values())
              == grid_launches["gather_two_spin"],
              f"rdms_from_sector_state launches {grid_launches}")
        check(max(d_plain, d_ref) <= TOL_SPIN_SUM,
              f"rdms_from_sector_state ({label}) off by "
              f"{max(d_plain, d_ref)}")
        launches = launches or grid_launches
    del pqc, flat
    torch.cuda.empty_cache()
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2

    import auto_oo_tpu_torch as P
    from auto_oo_tpu_torch.ops import cuda_build, grid
    from auto_oo_tpu_torch.ops import grid_hosted as gh
    from auto_oo_tpu_torch.ops import gather_mechanisms as gm
    from auto_oo_tpu_torch.ops import grid_kernels as gk
    from auto_oo_tpu_torch.scripts import experiment_gather_mechanisms as exp
    import torch.distributed as dist
    from auto_oo_tpu_torch.parallel import distributed as D, make_mesh

    dev = torch.device("cuda")
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    build_s = cuda_build.load_all([gk.LIBRARY, gm.LIBRARY])
    print(f"kernel build + load (both libraries): {build_s:.2f} s")
    # the distributed engines' phases run on a one-rank NCCL group of this
    # process (the card's machine has one card)
    t0 = time.perf_counter()
    mesh = make_mesh(shape=(1, 1), names=("tp", "row"), device="cuda")
    mesh_dp = make_mesh(shape=(1,), names=("dp",), device="cuda")
    print(f"one-rank process group: backend {dist.get_backend()}, world "
          f"size {dist.get_world_size()}, meshes {mesh.mesh_dim_names} and "
          f"{mesh_dp.mesh_dim_names} ({time.perf_counter() - t0:.2f} s)")
    check(dist.get_backend() == "nccl", "the process group is not NCCL")
    t_all = time.perf_counter()

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        print(f"== {name}")
        out = fn(*args)
        print(f"== {name}: {time.perf_counter() - t0:.2f} s")
        return out

    try:
        stats = phase("grid kernels vs plain", kernel_phase, torch, gk, gh,
                      grid, dev)
        stats.update(phase("gather mechanisms vs plain", mechanism_phase,
                           torch, gm, exp, dev))
        paths = {"probes": phase("gather mechanism entry point",
                                 entry_point_phase, gm, gk, exp)}
        paths["10e10o"] = phase("(10e,10o) slice", slice_phase, torch, P, gk)
        paths["12e12o"], objects12 = phase("(12e,12o) sector",
                                           sector12_phase, torch, P, gk, dev)
        paths.update(phase("(c) grid2d_nr_fns, (12e,12o), one NCCL rank",
                           grid2d12_phase, torch, gk, D, mesh, objects12))
        paths.update(phase("GeometryBatch on the staged route, (12e,12o), 2 "
                           "geometries", batch12_phase, torch, P, gk,
                           objects12))
        flop_ratios = phase("the FLOP count against FlopCounterMode, "
                            "(10e,10o) fused and (12e,12o) staged",
                            count_phase, torch, P, objects12)
        del objects12
        torch.cuda.empty_cache()
        paths["10e10o_mixed"] = phase("(10e,10o) slice, mixed precision",
                                      mixed10_phase, torch, P, gk)
        torch.cuda.empty_cache()
        for precision in ("f64", "mixed"):
            tag = "" if precision == "f64" else "_mixed"
            paths[f"10e10o_adam{tag}"] = phase(
                f"(10e,10o) slice, Adam with orbital relaxations, "
                f"{precision}", adam10_phase, torch, P, gk, precision)
        phase("streamed and hosted (per-tangent and Gram) equal fused at "
              "(10e,10o)", routes_equal_fused_phase, torch, P, gk, gh, grid)
        torch.cuda.empty_cache()
        mol14, pqc14, oo14 = phase("(14e,14o) setup", sector14_setup, torch,
                                   P)
        phase("(14e,14o) grid kernels vs plain", streamed_kernel_phase,
              torch, gk, grid, oo14, stats)
        paths["14e14o"], theta14, energies14 = phase(
            "(14e,14o) sector", sector14_phase, torch, gk, pqc14, oo14)
        phase("(14e,14o) hosted against streamed", hosted14_phase, torch, P,
              gk, gh, mol14, pqc14, oo14, theta14)
        paths.update(phase("(14e,14o) gradient-only pipeline, f64 and mixed",
                           gradient14_phase, torch, gk, P, mol14, pqc14,
                           oo14))
        del oo14
        torch.cuda.empty_cache()
        paths["14e14o_unrestricted"] = phase(
            "(14e,14o) spin-resolved RDMs at full width",
            unrestricted14_phase, torch, gk, pqc14, theta14)
        del theta14
        torch.cuda.empty_cache()
        phase("(14e,14o) S^2: the demo's s2 stage, grid S^- against the "
              "flat tables", s2_14e14o_phase, torch, P, grid, pqc14)
        torch.cuda.empty_cache()
        paths["14e14o_mixed"] = phase(
            "(14e,14o) sector, mixed precision", sector14_mixed_phase,
            torch, P, gk, mol14, pqc14, energies14)
        del mol14, pqc14
        torch.cuda.empty_cache()
        phase("(2e,2o) convergence", convergence_phase, torch, P)
        phase("(2e,2o) full space, mixed precision", mixed_2e2o_phase,
              torch, P)
        paths["full_2e2o"] = phase("(2e,2o) full space convergence",
                                   full_space_convergence_phase, torch, P,
                                   gk)
        paths["full_2e2o_adam"] = phase(
            "(2e,2o) full space, Adam with orbital relaxations",
            adam_2e2o_phase, torch, P, gk)
        paths["tutorial_oo_vqe"] = phase(
            "the OO-VQE tutorial, (4e,3o) full space", tutorial_phase, torch,
            P, gk)
        paths["noise_study"] = phase(
            "the noise study, (2e,2o), 2 variances x 2 seeds",
            noise_study_phase, torch, P, gk)
        paths["berry_2e2o"] = phase(
            "Berry loop, (2e,2o) full space, 21 points", berry_full_phase,
            torch, P, gk)
        paths["berry_2e2o_sector"] = phase(
            "Berry loop, (2e,2o) sector, 11 points", berry_sector_phase,
            torch, P, gk)
        paths["berry_6e6o_sector"] = phase(
            "Berry arc, (6e,6o) sector", berry_6e6o_phase, torch, P, gk)
        phase("newton_method='iterative'", iterative_phase, torch, P, gk,
              dev)
        phase("Noisy_OO_pqc, (2e,2o)", noisy_phase, torch, P)
        paths["full_3e3o"] = phase(
            "(3e,3o) doublet, full space", flat_phase, torch, P, gk,
            "(3e,3o) doublet", 3, (2, 1),
            dict(ansatz="ucc", add_singles=True), ANCHORS_3E3O, 3, 3,
            dict(charge=1, spin=1))
        paths["full_6e6o"] = phase(
            "(6e,6o) full space", flat_phase, torch, P, gk, "(6e,6o)", 6, 6,
            dict(ansatz="np_fabric", n_layers=2), ANCHORS_6E6O, HELD_6E6O,
            100, None, True)
        paths["full_8e8o"] = phase(
            "(8e,8o) full space", flat_phase, torch, P, gk, "(8e,8o)", 8, 8,
            dict(ansatz="np_fabric", n_layers=2), ANCHORS_8E8O, 3, 3, None,
            False, True)
        paths["prebuilt_4e4o"] = phase(
            "prebuilt (4e,4o) GateProgram, sector=True",
            prebuilt_program_phase, torch, P, gk)
        torch.cuda.empty_cache()
        mol16, pqc16, oo16 = phase("(16e,16o) setup", sector16_setup, torch,
                                   P)
        phase("(16e,16o) grid kernels vs plain", hosted_kernel_phase, torch,
              gk, gh, grid, oo16, stats)
        paths["16e16o"], e0_16, grad16 = phase(
            "(16e,16o) sector", sector16_phase, torch, gk, mol16, pqc16,
            oo16)
        paths.update(phase("(16e,16o) gradient-only pipeline, f64",
                           gradient16_phase, torch, gk, pqc16, oo16, e0_16,
                           grad16, "f64", mol16.hf.e_tot))
        torch.cuda.empty_cache()
        paths.update(phase("(a), (b) row-sharded and hosted x row-sharded "
                           "engines, (16e,16o), one NCCL rank",
                           sharded16_phase, torch, P, gk, D, mesh, pqc16,
                           oo16))
        del oo16, grad16
        torch.cuda.empty_cache()
        paths["16e16o_mixed"] = phase(
            "(16e,16o) sector, mixed precision (Gram form)",
            sector16_mixed_phase, torch, gk, gh, grid, P, mol16, pqc16)
        torch.cuda.empty_cache()
        paths.update(phase(
            "(16e,16o) gradient-only pipeline, mixed", gradient16_phase,
            torch, gk, pqc16, P.OO_pqc(pqc16, mol16, 16, 16,
                                       freeze_active=True,
                                       precision="mixed"),
            None, None, "mixed", mol16.hf.e_tot))
        torch.cuda.empty_cache()
        phase("S^2 at scale: (10e,10o) random state against the host, the "
              "(16e,16o) s2 stage", s2_scale_phase, torch, P, grid, pqc16)
        del mol16, pqc16
        torch.cuda.empty_cache()
        for ncas, n_layers in ((10, 2), (12, 1)):
            upaths, res = phase(
                f"({ncas}e,{ncas}o) spin-resolved RDMs on the sector grid",
                unrestricted_sector_phase, torch, P, gk, grid, ncas,
                n_layers, stats)
            paths.update(upaths)
        # gather_rows_scaled's numbers: the (12e,12o) one-spin Phi (alpha)
        stats["gather_rows_scaled"].update(ms=res[0], plain_ms=res[1],
                                           bound_ms=res[2])
        paths["rdms_from_sector_state_10e10o"] = phase(
            "rdms_from_sector_state, (10e,10o) GridMaps against the flat "
            "tables", rdms_sector_state_phase, torch, P, gk)
        paths["8e8o_unrestricted"] = phase(
            "(8e,8o) spin-resolved RDMs, full space",
            unrestricted_full_phase, torch, P, gk)
        phase("user-defined states: up_then_down and callable ansatze",
              user_states_phase, torch, P, gk)
        torch.cuda.empty_cache()
        paths["batch_10e10o"], objects10 = phase(
            "GeometryBatch.newton_steps, (10e,10o) sector, 8 geometries",
            batch10_phase, torch, P, gk, grid)
        paths.update(phase("(e) GeometryBatch(mesh=), (10e,10o), one NCCL "
                           "rank", batch_mesh_phase, torch, gk, D, mesh_dp,
                           objects10))
        del objects10
        paths.update(phase("(d) sharded_nr_step_fn, (10e,10o) sector and "
                           "(8e,8o) full space, one NCCL rank",
                           tangent_sharded_phase, torch, P, gk, D, mesh))
        paths["run_batched_2e2o_sector"] = phase(
            "BerryPhaseLoop.run_batched, (2e,2o), 21 and 11 points",
            run_batched_phase, torch, P, gk)
        paths["device_loop_10e10o"] = phase(
            "full_optimization(device_loop=True) against the host loop",
            device_loop_phase, torch, P, gk)
        phase("GeometryBatch.optimize_device_loop against optimize",
              batch_loop_phase, torch, P)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        dist.destroy_process_group()
    print(f"all phases: {time.perf_counter() - t_all:.2f} s")
    print("flop count / FlopCounterMode: " + json.dumps(flop_ratios))
    # each kernel's main path: the probes' entry point (the probes), the
    # (12e,12o) spin-resolved RDMs (gather_rows_scaled), the hosted
    # (16e,16o) iteration, and (14e,14o) for the row form of
    # gather_reduce, which the hosted route does not run
    main_path = {name: ("12e12o_unrestricted"
                        if name == "gather_rows_scaled"
                        else "probes" if name in paths["probes"]
                        else "14e14o" if name == "gather_reduce"
                        else "16e16o") for name in stats}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE[name],
         "replaces": REPLACES[name],
         "launches": paths[main_path[name]][name],
         "launches_by_path": {path: n[name] for path, n in paths.items()
                              if name in n},
         "max_abs_err": st["max_abs_err"], "ms": st["ms"],
         "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
         "bound_by": "bytes", "library_ms": st.get("library_ms")}
        for name, st in stats.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
