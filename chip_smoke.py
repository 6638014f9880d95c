"""Smoke test of the PyTorch port (``cirkit_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device: requires CUDA, prints the card's name and power limit as
   ``nvidia-smi`` reports them, and turns TF32 off for the plain versions;
2. build: compiles ``cirkit_tpu_torch/csrc`` with ``nvcc`` into ``build/``;
3. kernel against plain: every forward entry of the log-einsum-exp kernels
   against its plain PyTorch version on the card, at the flagship circuits'
   shapes and at edge shapes (O=1, a ragged batch, a row that is all -inf),
   with ``|kernel - plain| <= 1e-4 + 1e-5 |plain|`` in log space; the wide
   kernels (the K1-chunked Tucker forward with logits and with plain
   weights, the blocked dense forward and its row max) at the K=128 entries
   (F=784, B=128, K1=K2=O=128; dense I=16384) and at edge shapes (ragged B,
   O=1, K1 != K2, a K1 that the chunk rows do not divide, a weight row wider
   than a chunk, an odd K2 or I (no 16-byte loads), I not a multiple of the
   chunk, a row that is all -inf, a
   chunk of logits or of inputs that is all -inf); the edges of the two
   forwards on the tensor cores: the blocked one at B=100, O=1 and 129,
   I=8200 (not a multiple of its 32-column chunk), a row of -inf and rows
   whose max sits in the last chunk, the single-pass Tucker one at K1 != K2,
   K2=30 (no 16-byte loads), O=1 and 65, rows of x1 and of x2 that are
   -inf, a unit's logits (weights) -inf (0) over a row i or all but the
   last, and K1 K2 = 8100, just under ``WIDE_WIDTH``; kernel 1 timed beside
   kernel 5 at the K=128 Tucker shapes;
3b. backward against plain: every backward entry against its plain version
   (``*_bwd_ref``) on the same cases (the Tucker backward kernel at the
   K=128 Tucker shape among them, the blocked backward on the dense ones),
   with a random cotangent that is 0 on some rows, each gradient to
   ``|kernel - plain| <= 1e-4 max|plain| + 1e-4 |plain|`` (linear sums of
   up to B or O*K2 terms), no NaN, input gradients that are 0 where the
   plain version's are, and a second call equal to the bit; ragged cases
   (B=100, O=33, K1=13 and K2=21, I=273) that no tile of the float32 lse
   backward's tensor-core path divides;
   the ``DX_ONLY`` cases (the K=64 and K=128 Tucker softmax entries and a
   dense mixing entry) also with the input gradients only (``needs`` with
   the weight False, the expectation queries' route): no weight gradient,
   the same bound against the plain version with the same ``needs``, a
   second call equal to the bit, timed;
3c. routing against plain: the max-product Tucker kernel
   (``tropical_tucker2``) and the routing choice (``route_tucker2``) against
   their plain versions at the flagship's largest Tucker entry (F=784,
   B=128, K1=K2=O=64) with logits and with linear weights, at its other
   nine Tucker entries (``ROUTE_FOLDS``: F=392 down to 2, where the tropical
   kernel splits the composite index and few rows take a team of warps)
   with logits, each timed, and at edge shapes (B=13, O=1, O=70, K1 != K2,
   -inf children, zero weights, -inf logits; the tropical kernel there also
   split in 3 ranges of m): tropical values to ``|kernel - plain| <= 1e-5
   |plain| + 1e-5`` with the same -inf pattern; each argmax by the score of
   its choice, the plain scores at the kernel's index within ``1e-5 |max| +
   1e-5`` of the plain maximum (f32 rounding may flip near-ties; the
   indices that differ are counted); the ``"sample"`` kind's inverse-CDF
   draws at every case the same from the same seed, in range and never of
   zero mass, and over 65,536 identical rows against the exact
   ``softmax(scores)``, every frequency within ``5 sqrt(p(1-p)/N) + 1e-3``;
3d. signed against plain: every entry of the signed log-einsum-exp kernels
   (``slse_*``, forward and backward) against its plain version at the SoS
   TensorDot entry (F=144, B*Kq=4096, I=O=32), the K=64 Tucker entry, dense
   mixing-sum entries and edge shapes (O=1, ragged B, K1 != K2, a row that
   is all -inf, an exact cancellation), with signs drawn from {-1, 0, +1}
   and weights of both signs: the forward in linear space scaled by the
   row's absolute mass A (the lse of the inputs against ``|w|``),
   ``|s_k exp(a_k - A) - s_p exp(a_p - A)| <= 1e-5``, a sign differing only
   below that bound (counted), an exact cancellation giving (-inf, 0); the
   backward with phase 3b's bound and a second call equal to the bit; the
   SoS entry's edges (a ragged B*Kq of 4000, I = 33 with O = 1) and a
   Tucker width past one block of the dx kernel (K1 = K2 = 208, the K1
   split); the backward's launches split one by one (``torch.profiler``) at
   the SoS and K=64 Tucker entries; the narrow forward's route edges
   (``NARROW_EDGES``: I and O of 1, 7, 32 and 33, B of 1, 33 and 4096, a row
   that is all -inf) with plain weights and logits in float32 and float64
   (``F64_*`` bounds), the forward's kernel named by ``torch.profiler`` there
   and at the SoS entry (``slse_fwd_narrow`` exactly where I and O are at
   most 32), and every forward twice, equal to the bit;
3e. complex against plain: ``clse_matmul`` and ``clse_tucker2``, forward
   and backward, against their plain versions at the SoS TensorDot entry,
   the K=64 Tucker entry (with the real weights the flagship gives it, and
   with complex ones), a dense mixing entry and edge shapes (O=1, O=70,
   B=13, K1 != K2, a row whose real parts are all -inf, an exact
   cancellation, real weights), in complex64 and complex128: the forward in
   linear space scaled by the row's absolute mass as phase 3d, on the real
   and the imaginary part (1e-5; 1e-12 in complex128), the backward to
   phase 3b's bound on every plane of every gradient (1e-9 in complex128)
   and a second call equal to the bit; an exact cancellation gives a real
   part of -inf and zero gradients; the SoS entry with real weights, its
   edges (a ragged B*Kq of 4000, I = 33 with O = 1) and K1 = K2 = 128 (past
   one block of the Tucker dx: the K1 split) in complex64 and, with real
   weights, complex128; the backward's launches split one by one at every
   timed shape; the narrow forward's route edges (``NARROW_EDGES``) with
   complex and real weights in both types, the forward's kernel named by
   ``torch.profiler`` there and at the SoS entry (``clse_fwd_narrow``
   exactly where I and O are at most 32), and every forward twice, equal to
   the bit;
3f. float64 against plain: the ``double`` instances of the single-pass lse
   kernels and of the signed kernels, forward and backward, at their
   flagship and SoS entries and at an edge shape (``F64_*`` below), and the
   Tucker backwards at K1 = K2 = O = 128 (past one block of the dx kernel:
   the K1 split), the lse ones timed; then the ``double`` instances of the wide kernels (the K1-chunked Tucker
   forward, the blocked dense forward, its row max and its backward) at the
   K=128 entries with F cut to ``F64_WIDE_F``, and of the routing kernels
   (the tropical Tucker to ``F64_TROP_TOL``; the argmax at the float64
   maximum, the draws reproducible by seed and never a zero weight) at the
   flagship's ten Tucker entries, the largest timed, and at an edge shape
   (the tropical kernel also split in 3 ranges of m);
4. slice: the MNIST QuadGraph flagship forward (K=64, 784 variables, batch
   128) for the Tucker circuit, the CP circuit and the Tucker circuit with
   plain (EM-ready) weights, through ``PipelineContext.compile`` and
   ``cc(x)``: the output's shape and finiteness, the kernel launches of the
   run against the kernel-bearing plan entries, agreement of 8 rows with a
   float64 CPU evaluation of the same store (rtol 1e-5), and the median
   forward time;
5. training: maximum-likelihood steps of the same flagships through
   ``parallel.data_parallel_step``: Tucker at batch 128 with
   ``torch.optim.Adam(lr=1e-2)`` and with ``adam_lowmem(1e-2)``, CP at batch
   256 with Adam. For each flagship store, the gradient of every learnable
   slot on 8 rows against the same store's float64 CPU gradient, to
   ``2e-3 max|slot| + 1e-4`` (``GRAD_REL`` and ``GRAD_ABS`` below say why);
   for each run, 10 steps on a fixed batch with one forward and one
   backward kernel call per kernel-bearing plan entry per step, finite
   losses and the last below the first; the median step time (CUDA events
   around forward, backward and optimizer, 10 steps after 3 warm-ups); and,
   for the ``adam_lowmem`` and CP runs, ``fit`` over 3 batches with
   ``checkpoint_every=2``, interrupted after its checkpoint and resumed to
   the end. The EM-ready Tucker store takes the
   gradient of its log-likelihood (the E-step's expected counts that
   ``fit_em`` reads): the same gradient check, one counted call at batch
   128 and its median time;
5b. EM (``parallel.em``), the EM main path: (a) the EM-ready Tucker
   flagship's ``em_programs`` flow step at batch 128, counted (one forward
   and one backward launch per kernel-bearing entry) and timed as
   ``bench_em`` times it (median of 10 into one accumulator), its mean flows
   a row on 8 rows within the ``GRAD_*`` bound of a float64 CPU flow step of
   the same store, and one M-step at step size 1 (every sum and categorical
   slot nonnegative, its rows summing to 1 within 1e-5); (b) ``fit_em`` over
   ``EM_ROWS`` rows from seed 0 at batch 128 for ``EM_EPOCHS`` epochs, every
   launch counted, the loss non-increasing within ``EM_MONO_REL`` of its
   size, a run checkpointed every epoch, interrupted after epoch 1 and
   resumed, equal to the uninterrupted one to the bit, and 2 epochs with the
   50% mask of ``bench.py:222-224`` missing (``missing=-1``), finite and
   decreasing; (c) the same flagship with Gaussian and with Binomial leaves
   (``EM_LEAVES``, ``em_ready=True``): the compile time, 8 forward rows
   against float64 on the CPU (rtol 1e-5), a counted flow step and its
   median ms, and ``fit_em`` for ``EM_LEAF_EPOCHS`` epochs on synthetic rows
   of the leaf's type, monotone, every leaf slot moved, every stddev
   positive and every success probability inside (0, 1);
6. profile: the forward, backward and optimizer of each training run timed
   apart, and 5 steps traced with ``torch.profiler`` for the device time by
   kernel category and the device's idle share;
7. queries: the Tucker flagship at batch 128 with the 50% random mask of
   ``bench.py:222-224``: ``IntegrateQuery``, ``MAPQuery`` (plain and with
   ``marginalize_vars``), ``SamplingQuery`` of 128 samples and
   ``SamplingQuery.conditional``, each call counted (one tropical and one
   route launch per Tucker entry for MAP, one route launch per Tucker
   entry and one forward launch per kernel-bearing entry for sampling, the
   forward launches for the marginals); 8 rows of the marginals, of both
   MAP log-values and of the conditional log-evidence against a float64
   CPU run of the same store (rtol 1e-5), evidence returned unchanged, the
   assignments that differ from float64 counted; the median ms of each
   query, and the device time of MAP and sampling by kernel category;
7b. expectation and information queries (``bench.py:255-316``'s
   ``bench_queries`` workload) on the same flagship, batch and mask:
   ``ExpectationQuery`` mean, mean and variance, ``marginals`` (float32 and
   bfloat16), ``cdf(t=127)``, ``quantile(q=0.5)`` and ``covariance`` over
   ``COV_VARS``, ``EntropyQuery`` without and with the evidence, and
   ``mutual_information`` over anchors 6-21 (each a batch of 256 anchor
   states): each call counted from zeroed counts (one forward and one
   dx-only backward launch per kernel-bearing entry, every backward launch
   recorded and none asking for the weight's gradient; a covariance row and
   the entropies launch nothing: the rows are plain compositions), 8 rows of
   the means, variances, marginals and CDFs within the ``GRAD_*`` bound of
   float64 on the CPU (they are sums of responsibilities, gradients) and
   the entropies within ``INFO_RTOL``; MI held to its identities (symmetric
   within 1e-4 of its largest entry, the diagonal the marginals' entropies,
   no entry below -1e-6); ``KLDivergenceQuery`` of the store against itself
   (0) and against a seed-1 store (>= 0, and with its posterior form on 8
   rows within ``INFO_RTOL`` of float64); ``MAPQuery(top_k=4)`` at batch 4
   (top-1 equal to ``MAPQuery`` in value and assignment, the scores
   descending, each assignment's log p(x) at least its score - 1e-4
   |score|); ``renyi2_entropy`` of a 12x12 CP circuit at K=32 (its launches,
   float64, at most the ``EntropyQuery`` value + 1e-4); the median ms of 10
   calls of each, the peak memory of ``marginals`` and of top-k, and the
   mean's device time by kernel category;
8. wide: the Tucker flagship at K=128 (3.30 G parameters), where the wide
   kernels run, at batch 128: with ``optimize=True`` the forward, the
   EM-ready store's forward and one EM flow step and M-step (counted and
   timed, the M-step's rows summing to 1, the peak memory of each),
   ``IntegrateQuery`` and the ``ExpectationQuery`` mean (kernel 5's forward,
   the Tucker backward dx-only, in range) with the 50% mask,
   ``MAPQuery``, ``SamplingQuery`` of 128 samples and ``.conditional``, and
   10 Adam steps; with ``optimize=False`` the forward and 10 SGD steps.
   Every call's launches are counted per kernel: one K1-chunked launch per
   wide Tucker entry and one blocked launch per wide sum a forward, no
   single-pass launch on them, one Tucker or blocked backward launch per
   entry a step. 8 rows of each forward, of the marginals and of the MAP
   value against the same store in float64 on the CPU (rtol 1e-5), finite
   and decreasing losses, the median ms of each call and the peak device
   memory of each run.
9. SoS: ``bench.py``'s sum-of-squares circuit (``bench_sos``: CP on a quad
   tree, K=32, unconstrained normal sum weights) under the signed semiring
   at 12x12 and 28x28, batch 128: ``cc``, ``sq = multiply(conjugate(cc),
   cc)`` and ``zc = integrate(sq)`` through ``PipelineContext``; one
   ``slse_matmul`` launch per TensorDot entry a forward of ``sq`` and of
   ``zc``; sq against twice cc's log-magnitude; 8 rows of sq, log Z and the
   ``IntegrateQuery`` marginals (the 50% mask) against float64 on the CPU
   (``SOS_SQ_RTOL`` says why sq gets a wider bound than 1e-5); every
   normalized log-likelihood at most 1e-4; the median ms of the forward, of
   the normalized log-likelihood and of the marginals, and the device time
   of the forward and of a step by kernel category; the gradients of
   cc's learnable slots on 8 rows against float64 (held to the ``GRAD_*``
   bound at 12x12, measured at 28x28: ``SOS_GRAD_SIDE``), and 10 Adam steps
   on the SoS loss with one backward launch per TensorDot entry a step;
9b. the K=64 flagships of phase 4 compiled under the signed semiring with
   phase 4's stores loaded by slot name: forwards equal to the lse-sum ones
   (rtol 1e-5) with every sign +1, one backward's gradients within the
   ``GRAD_*`` bound of the lse-sum ones, the launches of each signed
   kernel, and the forward's median ms beside the lse-sum one's;
10. complex SoS: phase 9's circuit under the complex semiring at 12x12 and
   28x28, batch 128. (a) Phase 9's store loaded by slot name: sq's real
   part within ``SOS_SQ_RTOL`` and log Z within 1e-5 of the signed run's,
   phases 0 or pi. (b) Complex normal sum weights (``dtype="complex"``),
   seed 0: one ``clse_matmul`` launch per TensorDot entry a forward of
   ``sq`` and of ``zc``; 8 rows of sq, log Z and the marginals against
   complex128 on the CPU; Im(log Z) a multiple of 2 pi; every normalized
   log-likelihood at most 1e-4; the gradients of cc's slots on 8 rows
   against complex128 (held at 12x12, measured at 28x28); 10 Adam steps on
   the SoS loss with one backward launch per entry a step; the median ms
   of each, peak memory, device time by kernel category;
10b. the K=64 Tucker flagship of phase 4 under the complex semiring with
   phase 4's store (softmaxed, real weights): the real part equal to the
   lse-sum forward (rtol 1e-5), phases 0, 10 ``clse_tucker2`` and 5
   ``clse_matmul`` launches a forward, one backward's gradients within the
   ``GRAD_*`` bound of the lse-sum ones, the median ms beside lse-sum's and
   signed's. Phases 9 to 10b run after phase 7; phase 4's stores are freed
   before phase 8.
11. float64 circuits: the K=64 Tucker flagship compiled in float64 (the
   default dtype float64) through ``MAPQuery``, ``SamplingQuery`` and
   ``.conditional`` (the double routing kernels), and the K=128 Tucker
   circuit on an 8x8 image (Tucker entries of width 16384: the wide route)
   through the ``optimize=True`` forward and 3 SGD steps (the double
   K1-chunked kernel; the Tucker backward at K1 = K2 = 128, whose dx splits
   K1) and the ``optimize=False`` forward and 3 SGD steps (the double
   blocked kernels), each call's launches counted; 8 rows of each forward,
   MAP value and log-evidence, and the SGD loss's gradients, against the
   same store in float64 on the CPU (``F64_RTOL``, ``F64_BWD_REL``,
   ``F64_GRAD_ABS``).
12. cross-circuit queries and the dense sampler, after phase 7b on phase 4's
   stores: (a) ``kl_monte_carlo`` and ``expected_loglikelihood_mc`` with p
   the K=64 Tucker flagship and q the K=64 CP one, ``MC_SAMPLES`` samples in
   rounds of ``MC_BATCH``, each call counted (a round: one forward launch per
   kernel-bearing entry of p for the draw, one route launch per Tucker entry,
   the forwards of p and q; then the two log Z probes), finite estimates and
   standard errors, KL(p || q) not below 0 by more than 4 standard errors,
   KL(p || p) exactly (0.0, 0.0), log p and log q on 8 drawn rows against
   float64 on the CPU (rtol 1e-5), the median ms of 5 calls of each; (b)
   ``cross_circuit_kl`` and ``expected_loglikelihood`` between two
   weightings of one deterministic logic circuit over ``LOGIC_VARS``
   variables (``_logic_chain``), on the host (float64) and with
   ``device=True`` (float32 on the card): both deterministic, the two paths
   within ``CROSS_REL`` of the value's size, KL(p || p) within ``CROSS_REL``
   times H(p) of 0 on both, the median ms of each path; (c) ``SamplingQuery``
   of ``DENSE_SAMPLES`` samples from the K=64 Tucker flagship compiled under
   ``sum-product`` (the dense bottom-up sampler) with phase 4's store: states
   in range, one mixture draw per sum-style entry, the median ms of 5 and
   the peak memory, and the mean log-likelihood of its samples under the
   lse-sum flagship within 4 combined standard errors of that of as many
   samples of the routing sampler (kernel 8).
13. structure search (``backend/torch/pruning.py``, ``distill.py``), after
   phase 12 on phase 4's K=64 Tucker store: the readback of the unoptimized
   sibling alone (its bytes and seconds); ``prune_circuit(threshold=0)`` and
   ``grow_circuit(noise=0, fraction=0.5)`` (K=64 to 96: kernel 5 with plain
   weights, counted), each recompiled in a fresh context, their
   log-likelihoods at batch 128 within rtol 1e-5 of the flagship's;
   README's ``fraction=0.5`` prune data-free and by the usage flows of
   ``STRUCT_ROWS`` seeded rows at ``STRUCT_BATCH`` (the sibling's dense
   I=4096 sums, forward and dx-only backward, counted), the pruned forward's
   8 rows within rtol 1e-5 of float64 on the CPU, and a ``save_circuit`` /
   ``load_circuit`` round trip of it equal to the bit; ``distill_tree`` over
   all 784 variables, its edges a spanning tree, its log Z within 1e-5 of 0
   and its univariate marginals within ``DISTILL_TOL`` of the flagship's;
   ``grow_prune_loop`` at ``bench.py:440-455``'s mid-size configuration with
   a checkpoint directory, and the same loop stopped after its grow stage and
   resumed, its history and best store equal to the uninterrupted run's to
   the bit. Each step prints its seconds, its launches, the device peak above
   the stores and the host's peak resident memory. Phases 3 and 3b hold and
   time the kernels at its shapes (``STRUCT_SHAPES``): the dense I=4096 sums
   (plain weights and logits, also dx-only) and kernel 5 at K1=K2=O=96.
14. quadrature PCs, ensembles and interop (``backend/torch/pic.py``,
   ``models/ensembles.py``, ``models/interop.py``), after phase 13 on phase
   4's K=64 Tucker store: (a) ``pc2qpc`` at ``bench_qpc``'s configuration
   (``bench.py:566-626``: leggauss, ``net_dim=64``, batch 128): the convert
   seconds and the networks' parameter count, every generated weight >= 0
   with each (fold, unit) row summing to 1 within ``QPC_NORM_TOL``, log Z
   within ``LOGZ_TOL`` of 0, 8 rows of the forward against float64 on the
   CPU (rtol 1e-5), the original flagship's forward unchanged to the bit,
   the materialize ms; ``QPC_STEPS`` Adam(5e-3) steps into the integral
   networks, each counted (10 plain ``lse_tucker2`` and 5 ``lse_matmul``
   launches a forward, as many backward), finite and decreasing losses, the
   networks' gradients on 8 rows within the ``GRAD_*`` bound of float64 on
   the CPU, the median step ms (``qpc_samples_per_sec``), the peak and the
   step's device split by kernel; (b) 2048 + 512 rows drawn by
   ``SamplingQuery`` from the flagship, ``boost_mixture`` of three K=64 CP
   flagships (Adam, 2 epochs, batch 256, the 512 rows as validation) and
   ``bag_mixture`` of two EM-ready K=64 Tucker flagships (EM, 1 epoch,
   batch 128): ``stage_lls`` non-decreasing, the served circuit's
   log-likelihood of 128 validation rows the blend of the components'
   within rtol 1e-5, its log Z within ``LOGZ_TOL`` of 0, bagging's bootstrap
   counts ``default_rng([0, seed]).multinomial``'s; each stage's seconds,
   the accepted stages, the mixture's forward ms; (c) ``save_jpc`` and
   ``load_jpc`` of a binary 64-feature CP circuit (K=16) after ``fit_em`` on
   the card, the reloaded circuit's forward on 128 rows within rtol 1e-5 of
   the original's, and ``load_uai`` of a seeded 24-variable Markov network,
   its 128 rows and log Z within rtol 1e-5 of float64 on the CPU. Each step
   prints its seconds, launches and device peak.

The line before the last is a JSON object with each kernel's launches on
its main paths (the forward ops in phases 4, 5b, 7b, 8, 12, 13 and 14, the backward ops
in phases 5, 5b, 7b, 8, 13 and 14, the routing ops in phases 7, 12 and 14, the signed ops in phases 9 and
9b, the complex ops in phases 10 and 10b, the float64 circuits of phase
11), its worst error (for the signed and complex forwards, the linear one of
phases 3d and 3e), its median time beside the plain version's and its
bound: the larger of its FMA work (4 FMAs per complex multiply-add, 2
against a real weight) over the card's f32 peak, or for the routing kernels
their adds, maxes and compares counted as f32 instructions at half that peak
(the FMA rate: an FMA counts as two FLOPs, and an add-max pair is an FADD
and an FMNMX, with no fused form on sm_90), and the bytes it must move over
its memory rate, at the shape timed (the route kernel's is its max kind's;
phase 3c prints the sample kind's beside it: the same bytes, or one
exponential per column at the MUFU rate), and (``tc_bound_ms``) the same with the
sums of products on the tensor cores in 3xTF32. Before it, the run's total
seconds. The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
FWD_OPS = ("lse_matmul", "lse_matmul_softmax", "lse_tucker2", "lse_tucker2_softmax")
ROUTE_OPS = ("tropical_tucker2", "route_tucker2")
SIGNED_OPS = ("slse_matmul", "slse_matmul_softmax", "slse_tucker2", "slse_tucker2_softmax")
COMPLEX_OPS = ("clse_matmul", "clse_tucker2")
_CSRC, _PALLAS = "cirkit_tpu_torch/csrc/", "cirkit_tpu/ops/lse_einsum.py:"
KERNELS = {  # LAUNCHES key -> (source, the Pallas kernel it replaces)
    **{op: (_CSRC + "lse_einsum.cu", _PALLAS + "335") for op in FWD_OPS},
    **{f"{op}_bwd": (_CSRC + "lse_einsum_bwd.cu", _PALLAS + "350") for op in FWD_OPS},
    "lse_tucker2_chunked": (_CSRC + "lse_wide.cu", _PALLAS + "738"),
    "lse_tucker2_softmax_chunked": (_CSRC + "lse_wide.cu", _PALLAS + "738"),
    "lse_matmul_blocked": (_CSRC + "lse_wide.cu", _PALLAS + "548"),
    "lse_matmul_blocked_bwd": (_CSRC + "lse_wide.cu", _PALLAS + "572"),
    "tropical_tucker2": (_CSRC + "tucker_route.cu", _PALLAS + "1334"),
    "route_tucker2": (_CSRC + "tucker_route.cu", _PALLAS + "1176"),
    **{op: (_CSRC + "lse_einsum.cu", _PALLAS + "938") for op in SIGNED_OPS},
    **{f"{op}_bwd": (_CSRC + "lse_einsum_bwd.cu", _PALLAS + "957") for op in SIGNED_OPS},
    **{op: (_CSRC + "clse_einsum.cu", _PALLAS + "1424") for op in COMPLEX_OPS},
    **{f"{op}_bwd": (_CSRC + "clse_einsum.cu", _PALLAS + "1439") for op in COMPLEX_OPS},
}
# The card's peaks for the bounds (NVIDIA's H100 SXM data sheet, at 700 W):
# f32 outside the tensor cores, and device memory.
F32_PEAK, HBM_RATE = 67e12, 3.35e12
F64_PEAK = 34e12  # the same data sheet's FP64 rate outside the tensor cores
# dense TF32 on the tensor cores (the same data sheet): a float32 sum of
# products there takes three TF32 products (3xTF32) for f32 accuracy
TF32_PEAK = 495e12
DEV = "cuda"  # the device of phases 3, 3b, 3c, 7 and 8
ROUTE_FLAGSHIP = (784, 128, 64, 64, 64)  # F, B, K1, K2, O of the largest Tucker entry
# the folds of the K=64 Tucker flagship's other nine Tucker entries (B, K1,
# K2 and O as the largest): the tropical kernel splits the composite index
# there, and the route kernel gives their rows teams of warps from F=12 down
ROUTE_FOLDS = (392, 196, 98, 42, 22, 12, 8, 4, 2)
# exponentials a second of the card's special-function units (16 an SM a
# clock, the CUDA guide's throughput table for compute capability 9.0) at
# the clock of the f32 peak (1.98 GHz): the sample kind's bound
MUFU_RATE = 132 * 16 * 1.98e9
TROP_ATOL = TROP_RTOL = 1e-5  # tropical bound: TROP_RTOL |plain| + TROP_ATOL
SCORE_REL = SCORE_ABS = 1e-5  # route bound on the chosen score
FREQ_ROWS = 65536  # identical rows of the sample-kind frequency check
FLAGSHIP_K = 64
# phase 13's kernel shapes, timed in phases 3 and 3b beside each kernel's
# first case: the dense sums of the unoptimized K=64 flagship (the usage
# flows' forward and dx-only backward) and the grown flagship's Tucker entry
STRUCT_SHAPES = ("F=784 B=128 I=4096 O=64", "F=784 B=128 K1=K2=O=96")
WIDE_K = 128  # the K=128 Tucker flagship of phase 8 and the wide kernels' entry shapes
WIDE_RUNS = (  # (optimize, em_ready, optimizer of the training steps or None)
    (True, False, "adam"),
    (True, True, None),
    (False, False, "sgd"),
)
# Plain SGD for the unoptimized circuit: Adam's moments (26.4 GB) do not fit
# beside its saved Kronecker outputs and normalized weights on an 80 GB card.
SGD_LR = 10.0
QUERY_ROWS = 8  # rows held against the float64 CPU queries
ATOL, RTOL = 1e-4, 1e-5
BWD_REL = 1e-4  # backward bound: BWD_REL * (max|plain| + |plain|)
BATCH = 128
FLAGSHIPS = (  # (sum_product_layer, em_ready)
    ("tucker", False),
    ("cp", False),
    ("tucker", True),
)
TRAIN_RUNS = (  # (sum_product_layer, batch, optimizer)
    ("tucker", 128, "adam"),
    ("tucker", 128, "adam_lowmem"),
    ("cp", 256, "adam"),
)
STEPS = 10  # counted training steps of each run
# the runs whose `fit` is interrupted and resumed: a torch optimizer's and
# adam_lowmem's checkpointed state (the Tucker Adam run would repeat the CP one)
RESUMED = (("tucker", "adam_lowmem"), ("cp", "adam"))
# Gradient check on GRAD_ROWS rows: |f32 - f64| <= GRAD_REL max|slot| +
# GRAD_ABS per slot. In f32, log-values near the flagship's log-likelihood
# of -4.4e3 carry an ulp of 4.9e-4, which every layer's exp(x - shift)
# turns into relative error of the gradients below it (GRAD_REL: 4 ulps).
# Near the root the true gradients are exponentially small (the posteriors
# are peaked), and the softmax VJP cancels terms of the size of the unit
# flows, at most 1 for a mean NLL, leaving an absolute floor (GRAD_ABS).
# The plain f32 composition on the CPU stays within a sixth of this bound.
GRAD_ROWS, GRAD_REL, GRAD_ABS = 8, 2e-3, 1e-4
# Phase 3d's bound on the signed kernels, in linear space scaled by the row's
# absolute mass A (the lse of the inputs against |w|): a signed sum that
# nearly cancels has a log-magnitude no f32 kernel gets to any bound.
SIGNED_TOL = 1e-5
# (F, B, I, O): the edges of the narrow forwards' route (phases 3d and 3e). I
# and O of 1, 7 and 32 and B of 1, 33 and 4096 take slse_fwd_narrow /
# clse_fwd_narrow; I = 33 or O = 33 the tiled kernels (the route is checked by
# the launched kernel's name)
NARROW_EDGES = ((3, 1, 1, 1), (3, 33, 7, 32), (2, 4096, 32, 7), (3, 33, 32, 1),
                (2, 4096, 1, 32), (2, 33, 33, 32), (2, 4096, 32, 33), (2, 1, 33, 33))
SOS_SIDES = (12, 28)  # bench.py's SoS image side (bench_sos) and the MNIST one
SOS_K = 32  # bench_sos's K
SOS_LR = 5e-2  # the Adam rate of tests/backend/test_signed.py's SoS training
# The squared circuit in f32: sq = sum_ij w_i w_j h_i h_j squares each sum's
# cancellation ratio (a TensorDot entry cancels up to 1e8 of its absolute
# mass), and log-values near -500 carry f32 rounding of 3e-5 that the
# cancellation then amplifies. With bench_sos's normal weights, sq on the
# card is off float64 by up to 3.0e-4 (12x12) and 2.3e-4 (28x28) relative
# on log|c|^2 over this phase's 128 rows, and the plain f32 composition on
# the CPU by up to 1.4e-4 on the same store, medians 1e-7 on both
# (scripts/sos_f32_accuracy.py --device cuda). So sq's log-values are held
# to SOS_SQ_RTOL and its signs are counted; log Z and the marginals, which
# cancel far less, are held to 1e-5.
SOS_SQ_RTOL = 1e-3
# The SoS loss's gradients inherit that cancellation through g / y at the
# rows where it is worst. On the checked 8 rows at 12x12 they hold the
# GRAD_* bound; over 16 groups of 8 rows 9 groups do not, at 28x28 15 do not
# (worst 510 times the bound), on the card and for the plain f32
# composition on the CPU alike (the same script). So at 28x28 the error is
# measured and printed, not held to a bound.
SOS_GRAD_SIDE = 12
# Phase 3e's bounds on the complex kernels by value type: the forward in linear
# space scaled by the row's absolute mass, on the real and the imaginary part
# (as SIGNED_TOL), and the backward on each plane of each gradient (as BWD_REL).
COMPLEX_TOL = {"complex64": (SIGNED_TOL, BWD_REL), "complex128": (1e-12, 1e-9)}
# Phase 3f's bounds on the float64 instances of the lse and signed kernels:
# |kernel - plain| <= F64_TOL (1 + |plain|) in log space (the signed ones:
# F64_SIGNED_TOL of the row's absolute mass, in linear space), and F64_BWD_REL
# (max|plain| + |plain|) on each gradient.
F64_TOL, F64_SIGNED_TOL, F64_BWD_REL = 1e-10, 1e-12, 1e-9
# the float64 max-plus Tucker: a max of sums of three terms, and the softmax
# normalizer, to F64_TROP_TOL (1 + |plain|)
F64_TROP_TOL = 1e-12
# Phase 3f's K=128 entries in float64 keep B, K1, K2 and O and take 98 of the
# 784 folds, so each plain version's (F, B, 16384) operands stay at 1.6 GB.
F64_WIDE_F = 98
# Phase 11, circuits compiled in float64: the K=64 Tucker flagship (MAP and
# sampling), and the K=128 Tucker circuit on a F64_SIDE x F64_SIDE image, its
# Tucker entries of width 16384 as at 28x28 (the wide route), with a
# twelfth of the 28x28 circuit's parameters. 8 rows are held to float64 on the CPU within
# F64_RTOL, the card's float64 against the CPU's, and the gradients of the SGD
# step within F64_BWD_REL (max|slot| + |slot|) + F64_GRAD_ABS: a slot whose
# gradient on those rows is 0 gets float64 rounding of the flows' sums there.
F64_SIDE, F64_RTOL, F64_GRAD_ABS = 8, 1e-9, 1e-12
# Phase 10: Im(log Z) is a multiple of 2 pi (Z is real and positive), and the
# phase of |c(x)|^2 is 0, or pi where f32 cancellation leaves it negative. A
# phase off by d radians is the same linear error as a log-magnitude off by d,
# and a sum that cancels amplifies both alike (the f32 pi of a negative weight
# is 8.7e-8 off, times a cancellation ratio of up to 1e8): so each phase is
# held to the absolute error its log-magnitude is allowed, rtol |Re value|.


def _median_ms(fn, *, warmup: int = 3, iters: int = 20) -> float:
    """Median of per-call CUDA-event times of ``fn`` in milliseconds."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device() -> str:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    ).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(
        f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}"
    )
    return smi


def phase_build() -> None:
    from cirkit_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    print(
        f"[build] {path.relative_to(REPO)} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.BUILD_SECONDS if _build.BUILD_SECONDS is not None else 'reused'})"
    )


def _bound(key: str, ins) -> tuple[float, str, float]:
    """The least ms the card could take for the function of kernel ``key`` on
    ``ins`` (its inputs, weight last): the larger of its FMA work over the f32
    peak and its bytes over the memory rate, each input read once and each
    output written once, and which of the two binds; then the same with the
    FMA work on the tensor cores in 3xTF32 (``_tc_bound``)."""
    *xs, w = ins
    f, b = xs[0].shape[:2]
    o, i = w.shape[1:]
    nbytes = sum(t.numel() * t.element_size() for t in ins)
    out = 4 * f * b * o
    flops = 2 * f * b * i * o
    moved = nbytes + out
    if key.endswith("_bwd"):  # two contractions; out and g read, a gradient per input
        flops, moved = 2 * flops, 2 * nbytes + 2 * out
    if key.startswith("lse_matmul_blocked"):
        moved += 4 * f * b  # the row max, written or read
    return (*_bound_of(flops, moved), _tc_bound(flops, moved))


def _bound_of(ops: float, moved: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / F32_PEAK * 1e3, moved / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _tc_bound(flops: float, moved: float) -> float:
    """The bound in ms of a float32 sum of products on the tensor cores: its
    FLOPs three times (3xTF32) over the TF32 peak, or its bytes if larger."""
    return max(3 * flops / TF32_PEAK, moved / HBM_RATE) * 1e3


def _cases(gen):
    """(key, op, kernel wrapper, plain version, make inputs, label) at the
    flagship shapes first, then the K=128 entries and the edge shapes; key
    names the LAUNCHES entry of the forward kernel under test, and each
    case's inputs are made when it runs, so one case at a time holds the
    card's memory."""
    import torch

    from cirkit_tpu_torch.ops import lse_einsum as L

    dev = DEV
    inf = float("-inf")

    def logx(*shape):
        return torch.randn(shape, generator=gen, device=dev) * 3.0 - 2.0

    def weights(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 0.99 + 0.01

    def logits(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def single(op):  # the single-pass kernel, through its public op
        return (op, op, getattr(L, op), getattr(L, f"{op}_ref"))

    def chunked(op):  # the K1-chunked kernel at any width
        key = f"{op}_chunked"
        return (key, op, lambda *ins: L._launch_fwd(key, ins), getattr(L, f"{op}_ref"))

    def tucker(op, f, b, k1, k2, o, *edits):
        def make():
            ins = (logx(f, b, k1), logx(f, b, k2),
                   (logits if "softmax" in op else weights)(f, o, k1 * k2))
            for t, idx, v in edits:
                ins[t][idx] = v
            return ins
        return make

    blocked = ("lse_matmul_blocked", "lse_matmul", L._launch_blocked_fwd, L.lse_matmul_blocked_ref)

    def dense(f, b, i, o, *edits, softmax=False):
        def make():
            ins = (logx(f, b, i), (logits if softmax else weights)(f, o, i))
            for t, idx, v in edits:
                ins[t][idx] = v
            return ins
        return make

    b, k = BATCH, WIDE_K
    cases = [
        (*single("lse_matmul_softmax"), dense(1568, b, 64, 64, softmax=True),
         "F=1568 B=128 I=64 O=64"),
        (*single("lse_matmul"), dense(196, b, 128, 64),
         "F=196 B=128 I=128 O=64"),
        (*single("lse_tucker2_softmax"), tucker("lse_tucker2_softmax", 784, b, 64, 64, 64),
         "F=784 B=128 K1=K2=64 O=64"),
        (*single("lse_tucker2"), tucker("lse_tucker2", 784, b, 64, 64, 64),
         "F=784 B=128 K1=K2=64 O=64"),
        # the K=128 entries, through the public ops where their width routes them
        ("lse_tucker2_softmax_chunked", *single("lse_tucker2_softmax")[1:],
         tucker("lse_tucker2_softmax", 784, b, k, k, k), f"F=784 B=128 K1=K2=O={k}"),
        ("lse_tucker2_chunked", *single("lse_tucker2")[1:],
         tucker("lse_tucker2", 784, b, k, k, k), f"F=784 B=128 K1=K2=O={k}"),
        (*blocked, dense(784, b, k * k, k), f"F=784 B=128 I={k * k} O={k}"),
        # phase 13's shapes: the dense sums over Kronecker composites of the
        # unoptimized K=64 flagship, with plain weights as the readback's
        # sibling compile runs them (the usage flows: its weights are
        # pointers into the optimized store, so it takes them materialized)
        # and with logits as a fresh unoptimized compile does; and the grown
        # K=64 flagship's Tucker entries (K=96, plain weights: kernel 5)
        (*single("lse_matmul"), dense(784, b, 4096, 64), STRUCT_SHAPES[0]),
        (*single("lse_matmul_softmax"), dense(784, b, 4096, 64, softmax=True), STRUCT_SHAPES[0]),
        ("lse_tucker2_chunked", *single("lse_tucker2")[1:],
         tucker("lse_tucker2", 784, b, 96, 96, 96), STRUCT_SHAPES[1]),
        (*single("lse_matmul_softmax"), dense(2, b, 64, 1, softmax=True), "O=1"),
        (*single("lse_matmul"), dense(1, b, 2, 1), "O=1 I=2"),
        (*single("lse_tucker2_softmax"), tucker("lse_tucker2_softmax", 2, b, 64, 64, 1), "O=1"),
        (*single("lse_tucker2"), tucker("lse_tucker2", 2, b, 64, 64, 1), "O=1"),
        (*single("lse_matmul"), dense(5, 13, 64, 64), "ragged B=13"),
        (*single("lse_matmul_softmax"), dense(5, 13, 128, 64, softmax=True),
         "ragged B=13"),
        (*single("lse_tucker2"), tucker("lse_tucker2", 5, 13, 8, 16, 16),
         "ragged B=13 K1=8 K2=16"),
        (*single("lse_tucker2_softmax"), tucker("lse_tucker2_softmax", 5, 13, 64, 64, 64),
         "ragged B=13"),
        # O, B, I, K1 and K2 that no tile of the backward's tensor-core path divides
        (*single("lse_tucker2_softmax"), tucker("lse_tucker2_softmax", 3, 100, 13, 21, 33),
         "ragged B=100 O=33 K1=13 K2=21"),
        (*single("lse_tucker2"), tucker("lse_tucker2", 2, 100, 21, 13, 33),
         "ragged B=100 O=33 K1=21 K2=13"),
        (*single("lse_matmul_softmax"), dense(3, 100, 273, 33, softmax=True),
         "ragged B=100 O=33 I=273"),
        (*single("lse_matmul"), dense(2, 100, 130, 33), "ragged B=100 O=33 I=130"),
    ]
    # the wide kernels' edges: chunks of 512 columns (KC = 512 // K2 rows of
    # K1, at least one), the dense online max in chunks of 256 columns
    for op in ("lse_tucker2_softmax", "lse_tucker2"):
        zero = inf if "softmax" in op else 0.0
        cases += [
            (*chunked(op), tucker(op, 5, 13, 40, 24, 1), "B=13 O=1 K1=40 K2=24 (21+19 rows)"),
            (*chunked(op), tucker(op, 3, 16, 99, 128, 70), "O=70 K1=99 K2=128 (24x4+3 rows)"),
            (*chunked(op), tucker(op, 2, 130, 3, 600, 9), "B=130 K1=3 K2=600 (a row a chunk)"),
            (*chunked(op), tucker(op, 1, 37, 7, 129, 33), "B=37 O=33 K1=7 K2=129 (K2 odd)"),
            (*chunked(op), tucker(op, 3, 16, 64, 16, 64, (0, (1, 5), inf),
                                  (2, (0, 3, slice(0, 512)), zero)),
             "a row -inf, a chunk of logits -inf" if "softmax" in op else "a row -inf, a chunk 0"),
        ]
    cases += [
        (*blocked, dense(5, 13, 10000, 1), "B=13 O=1 I=10000 (39x256+16)"),
        (*blocked, dense(2, 130, 777, 70), "B=130 O=70 I=777"),
        (*blocked, dense(3, 16, 1000, 64, (0, (1, 5), inf), (0, (2, 3, slice(256, 512)), inf)),
         "a row -inf, a chunk of x -inf"),
    ]
    # the tensor-core blocked forward's edges (tiles of 128 rows and 128 units,
    # chunks of 32 columns): a row of -inf, rows whose max sits in the last
    # chunk, so the online rescale runs on their accumulators
    for o in (1, 129):
        cases.append((*blocked, dense(2, 100, 8200, o, (0, (0, 5), inf), (0, (1, 7, -3), 40.0),
                                      (0, (0, 99, -8), 40.0)),
                      f"B=100 O={o} I=8200 (256x32+8), a row -inf, maxes in the last chunk"))
    # the tensor-core single-pass Tucker forward's edges (tiles of 128 rows and
    # 64 units, chunks of 32 columns j): K1 != K2, K2 % 4 != 0, O = 1 and 65,
    # rows of x1 and x2 that are -inf, a unit's logits (weights) -inf (0) over
    # a row i, a unit whose logits are all -inf but the last (whose weights
    # are all 0), and K1 K2 = 8100, just under WIDE_WIDTH
    for op in ("lse_tucker2_softmax", "lse_tucker2"):
        zero = inf if "softmax" in op else 0.0
        last = slice(0, -1) if "softmax" in op else slice(None)
        cases += [
            (*single(op), tucker(op, 3, 37, 21, 30, 1, (0, (1, 2), inf), (1, (2, 4), inf)),
             "B=37 O=1 K1=21 K2=30, x1 and x2 rows -inf"),
            (*single(op), tucker(op, 2, 100, 90, 90, 65, (1, (1, 3), inf),
                                 (2, (0, 5, slice(0, 90)), zero), (2, (1, 64, last), zero)),
             "B=100 O=65 K1=K2=90 (8100), edges"),
        ]
    # rows that are all -inf must give -inf, never NaN
    for op in FWD_OPS:
        row = (0, (1, 5), inf)
        make = (tucker(op, 3, 16, 64, 64, 64, row) if "tucker" in op
                else dense(3, 16, 64, 64, row, softmax="softmax" in op))
        cases.append((*single(op), make, "row all -inf"))
    return cases


def _max_err(key: str, label: str, got, ref) -> float:
    """``|kernel - plain| <= ATOL + RTOL |plain|`` in log space with the same
    -inf pattern and no NaN; returns the worst error."""
    import torch

    if got.shape != ref.shape or torch.isnan(got).any():
        raise AssertionError(f"{key} [{label}]: shape {tuple(got.shape)} or NaN")
    same_inf = torch.equal(torch.isneginf(got), torch.isneginf(ref))
    finite = torch.isfinite(ref)
    err = (got[finite] - ref[finite]).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if not same_inf or not bool((err <= ATOL + RTOL * ref[finite].abs()).all()):
        raise AssertionError(f"{key} [{label}]: max |kernel - plain| = {max_err:.3e} "
                             f"(bound {ATOL} + {RTOL}|ref|), -inf pattern equal: {same_inf}")
    return max_err


def phase_kernels() -> dict[str, dict]:
    """Each forward kernel against its plain version; returns per-kernel
    results (times and bound of the first case of each kernel)."""
    import torch

    from cirkit_tpu_torch.ops import lse_einsum as L

    gen = torch.Generator(device=DEV).manual_seed(0)
    results: dict[str, dict] = {}
    with torch.inference_mode():
        for key, op, kernel, plain, make, label in _cases(gen):
            ins = make()
            got = kernel(*ins)
            ref = plain(*ins)
            torch.cuda.synchronize()
            if isinstance(got, tuple):  # the blocked forward's row max: exact
                if not torch.equal(got[1], ref[1]):
                    raise AssertionError(f"{key} [{label}]: row max differs from the plain one")
                got, ref = got[0], ref[0]
            max_err = _max_err(key, label, got, ref)
            entry = results.setdefault(key, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], max_err)
            line = f"[kernel] {key:27s} {label:36s} max|err|={max_err:.3e}"
            if "ms" not in entry:
                entry["ms"] = _median_ms(lambda: kernel(*ins))
                entry["plain_ms"] = _median_ms(lambda: plain(*ins))
                entry["bound_ms"], entry["bound_by"], entry["tc_bound_ms"] = _bound(key, ins)
                entry["shape"] = label
                line += (f"  kernel {entry['ms']:.3f} ms, plain {entry['plain_ms']:.3f} ms, "
                         f"bound {entry['bound_ms']:.3f} ms ({entry['bound_by']}), tensor-core "
                         f"bound {entry['tc_bound_ms']:.3f} ms")
            elif label in STRUCT_SHAPES:
                ms, plain_ms = _median_ms(lambda: kernel(*ins)), _median_ms(lambda: plain(*ins))
                bound, by, tc = _bound(key, ins)
                entry.setdefault("structure", {})[label] = {"ms": ms, "plain_ms": plain_ms,
                                                            "bound_ms": bound}
                line += (f"  kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound:.3f} ms "
                         f"({by}), tensor-core bound {tc:.3f} ms")
            if key.endswith("_chunked") and f"K1=K2=O={WIDE_K}" in label:
                # the single-pass kernel on the same inputs, checked and timed
                def single_pass():
                    return L._launch_fwd(op, ins)

                _max_err(op, label, single_pass(), ref)
                entry["single_pass_ms"] = _median_ms(single_pass)
                line += f"; single-pass kernel {entry['single_pass_ms']:.3f} ms"
            print(line)
            del ins, got, ref
    return results


def _route_cases(gen):
    """(label, x1, x2, th, log_weights, sel) at the flagship's largest Tucker
    entry first, then at its other Tucker entries (``ROUTE_FOLDS``), then
    the edge shapes; sel has some -1 rows (clamped)."""
    import torch

    def logx(*shape):
        return torch.randn(shape, generator=gen, device=DEV) * 3.0 - 2.0

    def case(label, f, b, k1, k2, o, log_weights):
        th = (torch.randn((f, o, k1 * k2), generator=gen, device=DEV) if log_weights
              else torch.rand((f, o, k1 * k2), generator=gen, device=DEV) * 0.99 + 0.01)
        sel = torch.randint(-1, o, (f, b), generator=gen, device=DEV)
        return [label, logx(f, b, k1), logx(f, b, k2), th, log_weights, sel]

    f, b, k1, k2, o = ROUTE_FLAGSHIP
    shape = f"F={f} B={b} K1={k1} K2={k2} O={o}"
    cases = [
        case(f"{shape} logits", f, b, k1, k2, o, True),
        case(f"{shape} linear", f, b, k1, k2, o, False),
        *(case(f"F={ff} B={b} K1={k1} K2={k2} O={o} logits", ff, b, k1, k2, o, True)
          for ff in ROUTE_FOLDS),
        case("B=13 O=1 K1=8 K2=16 logits", 5, 13, 8, 16, 1, True),
        case("B=13 O=70 K1=16 K2=8 linear", 3, 13, 16, 8, 70, False),
        case("B=130 O=3 K1=3 K2=5 logits", 2, 130, 3, 5, 3, True),
    ]
    inf = float("-inf")
    edge = case("-inf children, zero weights", 3, 16, 8, 8, 16, False)
    edge[1][0, 2] = inf  # a row of x1 all -inf
    edge[1][1, 3, :4] = inf
    edge[2][2, 5, 1:] = inf
    edge[3][:, :, 9] = 0.0  # zero linear weights: log 0 = -inf never wins
    edge[3][1, :, : 32] = 0.0
    cases.append(edge)
    edge = case("-inf children, -inf logits", 3, 16, 8, 8, 16, True)
    edge[1][0, 2] = inf
    edge[3][0, :, 7] = inf
    edge[3][2, 4, 20:] = inf
    cases.append(edge)
    return cases


def _check_choice(label, got, scores) -> int:
    """The plain scores at the kernel's index within SCORE_REL |max| +
    SCORE_ABS of the plain maximum; returns how many indices differ from
    the plain argmax."""
    import torch

    best = scores.amax(dim=-1)
    at = torch.gather(scores, -1, got[..., None])[..., 0]
    ok = (at >= best - (SCORE_REL * best.abs() + SCORE_ABS)) | (best == float("-inf"))
    if got.shape != best.shape or not bool(ok.all()):
        raise AssertionError(f"route_tucker2 [{label}]: a choice scores below the bound: "
                             f"{int((~ok).sum())} rows")
    return int((got != scores.argmax(dim=-1)).sum())


def _sample_frequencies(R, log_weights: bool) -> float:
    """The sample kind's draws over FREQ_ROWS identical rows against the exact
    softmax(scores); returns the worst deviation as a share of its bound."""
    import torch

    gen = torch.Generator(device=DEV).manual_seed(5)
    f, k1, k2, o = 2, 4, 4, 8
    x1 = torch.randn((f, 1, k1), generator=gen, device=DEV)
    x2 = torch.randn((f, 1, k2), generator=gen, device=DEV)
    th = (torch.randn((f, o, k1 * k2), generator=gen, device=DEV) if log_weights
          else torch.rand((f, o, k1 * k2), generator=gen, device=DEV) + 0.05)
    sel = torch.tensor([[3], [6]], device=DEV)
    p = torch.softmax(R.route_scores(x1.double(), x2.double(), th.double(), sel,
                                     log_weights=log_weights)[:, 0], dim=-1)
    rows = [t.expand(-1, FREQ_ROWS, -1).contiguous() for t in (x1, x2)]
    sel_rows = sel.expand(-1, FREQ_ROWS).contiguous()
    draw = lambda seed: R.route_tucker2(rows[0], rows[1], th, sel_rows, kind="sample",  # noqa: E731
                                        log_weights=log_weights, seed=seed)
    idx = draw(2**40 + 17)
    if not torch.equal(idx, draw(2**40 + 17)) or torch.equal(idx, draw(2**40 + 18)):
        raise AssertionError("route_tucker2 sample: draws not reproducible by seed")
    worst = 0.0
    for ff in range(f):
        freq = torch.bincount(idx[ff], minlength=k1 * k2).double() / FREQ_ROWS
        bound = 5 * torch.sqrt(p[ff] * (1 - p[ff]) / FREQ_ROWS) + 1e-3
        share = float(((freq - p[ff]).abs() / bound).max())
        if not share <= 1.0:
            raise AssertionError(f"route_tucker2 sample: frequencies {freq.tolist()} against "
                                 f"{p[ff].tolist()}")
        worst = max(worst, share)
    return worst


def _trop_check(label, got, ref) -> float:
    """``|kernel - plain| <= TROP_RTOL |plain| + TROP_ATOL`` with the same
    -inf pattern and no NaN; returns the worst error."""
    import torch

    torch.cuda.synchronize()
    if got.shape != ref.shape or torch.isnan(got).any():
        raise AssertionError(f"tropical_tucker2 [{label}]: shape or NaN")
    same_inf = torch.equal(torch.isneginf(got), torch.isneginf(ref))
    finite = torch.isfinite(ref)
    err = (got[finite] - ref[finite]).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if not same_inf or not bool((err <= TROP_ATOL + TROP_RTOL * ref[finite].abs()).all()):
        raise AssertionError(f"tropical_tucker2 [{label}]: max |kernel - plain| = "
                             f"{max_err:.3e}, -inf pattern equal: {same_inf}")
    return max_err


def _check_draws(R, label, x1, x2, th, sel, lw, scores) -> None:
    """The sample kind's draws: the same from one seed, in range, and never
    a column of zero mass (a -inf score where the row has a finite one)."""
    import torch

    draw = R.route_tucker2(x1, x2, th, sel, kind="sample", log_weights=lw, seed=7)
    again = R.route_tucker2(x1, x2, th, sel, kind="sample", log_weights=lw, seed=7)
    at = torch.gather(scores, -1, draw[..., None].clamp(0, scores.shape[-1] - 1))[..., 0]
    massless = torch.isneginf(at) & ~torch.isneginf(scores.amax(dim=-1))
    if (not torch.equal(draw, again) or not bool(((draw >= 0) & (draw < scores.shape[-1])).all())
            or bool(massless.any())):
        raise AssertionError(f"route_tucker2 sample [{label}]: draws not reproducible, out of "
                             f"range or of zero mass")


def phase_routing() -> dict[str, dict]:
    """Both routing kernels against their plain versions; returns per-op
    results (times of the flagship-shaped case with logits)."""
    import torch

    from cirkit_tpu_torch.ops import routing as R

    gen = torch.Generator(device=DEV).manual_seed(2)
    results = {op: {"max_abs_err": 0.0} for op in R.ROUTING_OPS}
    with torch.inference_mode():
        for label, x1, x2, th, lw, sel in _route_cases(gen):
            ref = R.tropical_tucker2_ref(x1, x2, th, log_weights=lw)
            max_err = _trop_check(label, R.tropical_tucker2(x1, x2, th, log_weights=lw), ref)
            if not label.startswith("F="):  # the edges also split in 3 ranges of m
                max_err = max(max_err, _trop_check(
                    label + ", 3 ranges", R.tropical_tucker2(x1, x2, th, log_weights=lw,
                                                             splits=3), ref))
            entry = results["tropical_tucker2"]
            entry["max_abs_err"] = max(entry["max_abs_err"], max_err)
            line = f"[routing] tropical_tucker2 {label:36s} max|err|={max_err:.3e}"
            if "ms" not in entry:
                entry["ms"] = _median_ms(lambda: R.tropical_tucker2(x1, x2, th, log_weights=lw))
                entry["plain_ms"] = _median_ms(
                    lambda: R.tropical_tucker2_ref(x1, x2, th, log_weights=lw), iters=5)
                entry["shape"] = label
                # an add and a max per (row, unit, composite index): two f32
                # instructions, each at the FMA rate (F32_PEAK / 2)
                f, b, k1 = x1.shape
                o, mm = th.shape[1:]
                entry["bound_ms"], entry["bound_by"] = _bound_of(
                    2 * (2 * f * b * o * mm),
                    4 * (x1.numel() + x2.numel() + th.numel() + f * b * o))
                line += f"  kernel {entry['ms']:.3f} ms, plain {entry['plain_ms']:.3f} ms"
            elif label.startswith("F="):  # the flagship's other Tucker entries: the kernel's time
                ms = _median_ms(lambda: R.tropical_tucker2(x1, x2, th, log_weights=lw))
                line += f"  kernel {ms:.3f} ms"
            print(line)

            idx = R.route_tucker2(x1, x2, th, sel, kind="max", log_weights=lw)
            scores = R.route_scores(x1, x2, th, sel, log_weights=lw)
            differ = _check_choice(label, idx, scores)
            ref_idx = R.route_tucker2_ref(x1, x2, th, sel, kind="max", log_weights=lw)
            at = torch.gather(scores, -1, idx[..., None])[..., 0]
            ref_at = torch.gather(scores, -1, ref_idx[..., None])[..., 0]
            fin = torch.isfinite(ref_at)
            gap = float((ref_at - at)[fin].max()) if bool(fin.any()) else 0.0
            entry = results["route_tucker2"]
            entry["max_abs_err"] = max(entry["max_abs_err"], gap)
            entry["differ"] = entry.get("differ", 0) + differ
            line = (f"[routing] route_tucker2    {label:36s} score gap {gap:.3e}, "
                    f"{differ} of {idx.numel()} indices differ from plain")
            if "ms" not in entry:
                entry["ms"] = _median_ms(
                    lambda: R.route_tucker2(x1, x2, th, sel, kind="max", log_weights=lw))
                entry["plain_ms"] = _median_ms(
                    lambda: R.route_tucker2_ref(x1, x2, th, sel, kind="max", log_weights=lw))
                seed = 12345
                entry["sample_ms"] = _median_ms(lambda: R.route_tucker2(
                    x1, x2, th, sel, kind="sample", log_weights=lw, seed=seed))
                plain_gen = torch.Generator(device=DEV).manual_seed(seed)
                entry["sample_plain_ms"] = _median_ms(lambda: R.route_tucker2_ref(
                    x1, x2, th, sel, kind="sample", log_weights=lw, generator=plain_gen))
                entry["shape"] = label
                # two adds and a compare per (row, composite index), three f32
                # instructions at the FMA rate (F32_PEAK / 2), over the weight
                # rows this run selects, each read once
                f, b, k1 = x1.shape
                o, mm = th.shape[1:]
                rows = torch.unique(torch.arange(f, device=DEV)[:, None] * o
                                    + sel.clamp(0, o - 1)).numel()
                moved = 4 * (x1.numel() + x2.numel() + rows * mm) + 16 * f * b
                entry["bound_ms"], entry["bound_by"] = _bound_of(2 * (3 * f * b * mm), moved)
                # the sample kind's inverse-CDF draw: the same bytes, or one
                # exponential per (row, composite index) at the MUFU rate
                entry["sample_bound_ms"] = max(moved / HBM_RATE, f * b * mm / MUFU_RATE) * 1e3
                line += (f"  max: kernel {entry['ms']:.3f} ms, plain {entry['plain_ms']:.3f} "
                         f"ms, bound {entry['bound_ms']:.3f} ms; sample: kernel "
                         f"{entry['sample_ms']:.3f} ms, plain {entry['sample_plain_ms']:.3f} "
                         f"ms, bound {entry['sample_bound_ms']:.3f} ms")
            elif label.startswith("F="):
                ms = [_median_ms(lambda kind=kind: R.route_tucker2(
                    x1, x2, th, sel, kind=kind, log_weights=lw, seed=12345))
                    for kind in R.KINDS]
                line += f"  max: kernel {ms[0]:.3f} ms; sample: kernel {ms[1]:.3f} ms"
            print(line)
            _check_draws(R, label, x1, x2, th, sel, lw, scores)
        for lw in (True, False):
            share = _sample_frequencies(R, lw)
            print(f"[routing] route_tucker2 sample, log_weights={lw}: frequencies over "
                  f"{FREQ_ROWS} rows within {share:.3f} of the bound; seed-reproducible")
    return results


def _zero_launches() -> None:
    from cirkit_tpu_torch.ops import lse_einsum as L

    for op in L.LAUNCHES:
        L.LAUNCHES[op] = 0


# The cases of phase 3b whose backward also runs dx-only (``needs`` with the
# weight False), the route of the expectation queries and of phase 13's usage
# flows, whose store is not differentiated: the K=64 Tucker softmax entry, the
# K=128 one (kernel 5's backward), a dense mixing entry and the unoptimized
# K=64 flagship's dense entry (plain weights and logits), each (forward key,
# case label).
DX_ONLY = (("lse_tucker2_softmax", "F=784 B=128 K1=K2=64 O=64"),
           ("lse_tucker2_softmax_chunked", f"F=784 B=128 K1=K2=O={WIDE_K}"),
           ("lse_matmul_softmax", "F=1568 B=128 I=64 O=64"),
           ("lse_matmul", STRUCT_SHAPES[0]),
           ("lse_matmul_softmax", STRUCT_SHAPES[0]))


def _dx_only_case(op: str, bkey: str, label: str, ins, out, g, entry: dict) -> str:
    """The backward of ``op`` with the input gradients only, against its
    plain version with the same ``needs``: the weight's gradient None, a
    second call equal to the bit, phase 3b's bound; timed beside the full
    backward. Returns the line to print."""
    import torch

    from cirkit_tpu_torch.ops import lse_einsum as L

    needs = (True,) * (len(ins) - 1) + (False,)

    def kernel():
        return L.backward(op, ins, out, g, needs)

    def plain():
        return getattr(L, f"{op}_bwd_ref")(*ins, out, g, needs)

    got, again = kernel(), kernel()
    if got[-1] is not None or not all(torch.equal(a, b) for a, b in zip(got[:-1], again[:-1])):
        raise AssertionError(f"{bkey} dx-only [{label}]: a weight gradient, or two calls differ")
    del again
    names = ("dx1", "dx2") if len(ins) == 3 else ("dx",)
    err = _check_backward(f"{bkey} dx-only", label, names, got[:-1], plain()[:-1], BWD_REL)
    del got
    ms, plain_ms = _median_ms(kernel), _median_ms(plain)
    entry.setdefault("dx_only", {})[label] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err}
    return (f"[backward] {bkey + ' dx-only':27s} {label:36s} max|err|={err:.3e}  kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms")


def phase_backward() -> dict[str, dict]:
    """Each backward kernel against its plain version on the cases of phase
    3 (the Tucker backward on the K1-chunked cases, the blocked backward on
    the blocked ones), and the ``DX_ONLY`` cases' input gradients alone;
    returns per-kernel results (times and bound of the first case of each,
    and of the Tucker backward at the K=128 shape)."""
    import torch

    from cirkit_tpu_torch.ops import lse_einsum as L

    gen = torch.Generator(device=DEV).manual_seed(1)
    results: dict[str, dict] = {}
    with torch.inference_mode():
        for key, op, _, plain, make, label in _cases(gen):
            ins = make()
            if key == "lse_matmul_blocked":
                out, m = plain(*ins)
                bkey = "lse_matmul_blocked_bwd"

                def kernel(ins=ins, out=out, m=m):
                    return L._launch_blocked_bwd(*ins, out, m, g, (True, True))

                def plain_bwd(ins=ins, out=out, m=m):
                    return L.lse_matmul_blocked_bwd_ref(*ins, out, m, g)
            else:
                out = plain(*ins)
                bkey = f"{op}_bwd"
                needs = (True,) * len(ins)  # the float32 Tucker dx takes any K1 and K2

                def kernel(ins=ins, out=out, op=op, needs=needs):
                    return L.backward(op, ins, out, g, needs)

                def plain_bwd(ins=ins, out=out, op=op, needs=needs):
                    return getattr(L, f"{op}_bwd_ref")(*ins, out, g, needs)
            g = torch.randn(out.shape, generator=gen, device=DEV)
            g[0, : min(3, g.shape[1])] = 0.0  # rows whose upstream gradient is 0
            got = kernel()
            again = kernel()  # every sum in a fixed order: equal to the bit
            if not all(a is None or torch.equal(a, b_) for a, b_ in zip(got, again)):
                raise AssertionError(f"{bkey} [{label}]: two calls differ")
            del again
            ref = plain_bwd()
            torch.cuda.synchronize()
            max_err = 0.0
            names = ("dx1", "dx2", "dw") if len(ins) == 3 else ("dx", "dw")
            for name, k, p in zip(names, got, ref):
                if k is None and p is None:
                    continue
                if k.shape != p.shape or torch.isnan(k).any():
                    raise AssertionError(f"{bkey} [{label}] {name}: shape {tuple(k.shape)} or NaN")
                # the input gradients' zeros are structural (rows of -inf, rows
                # whose cotangent is 0); a weight gradient can be 0 by a tie
                if name != "dw" and not bool((k[p == 0] == 0).all()):
                    raise AssertionError(f"{bkey} [{label}] {name}: not 0 where the plain is 0")
                err = (k - p).abs()
                bound = BWD_REL * (p.abs().max() + p.abs())
                if not bool((err <= bound).all()):
                    raise AssertionError(
                        f"{bkey} [{label}] {name}: max |kernel - plain| = "
                        f"{float(err.max()):.3e} (bound {BWD_REL} (max|plain| + |plain|), "
                        f"max|plain| {float(p.abs().max()):.3e})"
                    )
                max_err = max(max_err, float(err.max()))
            del got, ref
            entry = results.setdefault(bkey, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], max_err)
            line = f"[backward] {bkey:27s} {label:36s} max|err|={max_err:.3e}"
            wide_tucker = key.endswith("_chunked") and f"K1=K2=O={WIDE_K}" in label
            if label in STRUCT_SHAPES:
                ms, plain_ms = _median_ms(kernel), _median_ms(plain_bwd)
                bound, by, tc = _bound(bkey, ins)
                entry.setdefault("structure", {})[label] = {"ms": ms, "plain_ms": plain_ms,
                                                            "bound_ms": bound}
                line += (f"  kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound:.3f} ms "
                         f"({by}), tensor-core bound {tc:.3f} ms")
            elif "ms" not in entry or wide_tucker:
                ms, plain_ms = _median_ms(kernel), _median_ms(plain_bwd)
                line += f"  kernel {ms:.3f} ms, plain {plain_ms:.3f} ms"
                if "ms" not in entry:
                    entry.update(ms=ms, plain_ms=plain_ms, shape=label)
                    entry["bound_ms"], entry["bound_by"], entry["tc_bound_ms"] = _bound(bkey, ins)
                    line += (f", bound {entry['bound_ms']:.3f} ms ({entry['bound_by']}), "
                             f"tensor-core bound {entry['tc_bound_ms']:.3f} ms")
                else:  # the Tucker backward at the K=128 shape
                    entry.update(k128_ms=ms, k128_plain_ms=plain_ms)
                    entry["k128_bound_ms"], _, tc = _bound(bkey, ins)
                    line += f", bound {entry['k128_bound_ms']:.3f} ms, tensor-core bound {tc:.3f} ms"
            print(line)
            if (key, label) in DX_ONLY:
                print(_dx_only_case(op, bkey, label, ins, out, g, entry))
            del ins, out, g
    return results


def _kernel_layers():
    from cirkit_tpu_torch.backend.torch.layers import TorchSumLayer
    from cirkit_tpu_torch.backend.torch.optimized import TorchCPTLayer, TorchTuckerLayer

    return (TorchSumLayer, TorchCPTLayer, TorchTuckerLayer)


def _flagship_circuit(spl: str, em_ready: bool, k: int, side: int = 28,
                      input_layer: str = "categorical"):
    from cirkit_tpu_torch.models import image_data

    return image_data((1, side, side), "quad-graph", input_layer=input_layer, num_input_units=k,
                      sum_product_layer=spl, num_sum_units=k, em_ready=em_ready)


def _build_flagship(spl: str, em_ready: bool, device: str, *, k: int | None = None,
                    optimize: bool = True, side: int = 28, input_layer: str = "categorical"):
    from cirkit_tpu_torch.pipeline import PipelineContext

    sc = _flagship_circuit(spl, em_ready, FLAGSHIP_K if k is None else k, side, input_layer)
    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=optimize, device=device, seed=0)
    return sc, ctx, ctx.compile(sc)


def _f64_reference(spl: str, em_ready: bool, store, *, k: int | None = None,
                   optimize: bool = True, side: int = 28, input_layer: str = "categorical"):
    """The flagship compiled on the CPU with no store of its own, and
    ``store`` copied there in float64 one slot at a time: the reference the
    checks against float64 evaluate, with no CPU initialization."""
    import torch

    from cirkit_tpu_torch.backend.torch.compiler import TorchCompiler

    sc = _flagship_circuit(spl, em_ready, FLAGSHIP_K if k is None else k, side, input_layer)
    cc = TorchCompiler(semiring="lse-sum", fold=True, optimize=optimize, device="cpu").compile(sc)
    return cc, {s: v.detach().cpu().double() for s, v in store.items()}


def phase_slice(smi: str) -> tuple[list, dict[str, int]]:
    """The flagship forwards through the kernels; returns the compiled
    flagships and the launches of each forward op over the main-path run."""
    import numpy as np
    import torch

    from cirkit_tpu_torch.ops import lse_einsum as L

    x_np = np.random.default_rng(0).integers(0, 256, (BATCH, 784))
    x = torch.as_tensor(x_np, device="cuda")
    built = []
    for spl, em in FLAGSHIPS:
        t0 = time.perf_counter()
        sc, ctx, cc = _build_flagship(spl, em, "cuda")
        torch.cuda.synchronize()
        n_kernel = sum(isinstance(l, _kernel_layers()) for l in cc.layers)
        print(
            f"[slice] {spl} em_ready={em}: compiled in {time.perf_counter() - t0:.1f} s, "
            f"{len(cc.layers)} plan entries, {n_kernel} kernel-bearing, "
            f"{cc.num_parameters()} parameters"
        )
        built.append((spl, em, sc, ctx, cc, n_kernel))

    # The main-path run: one forward of each flagship, counted.
    _zero_launches()
    outs = []
    with torch.inference_mode():
        for spl, em, sc, ctx, cc, n_kernel in built:
            before = sum(L.LAUNCHES.values())
            outs.append(cc(x))
            launched = sum(L.LAUNCHES.values()) - before
            if launched != n_kernel:
                raise AssertionError(
                    f"{spl} em_ready={em}: {launched} kernel launches, {n_kernel} expected"
                )
        torch.cuda.synchronize()
    launches = {op: L.LAUNCHES[op] for op in L.OPS}
    print(f"[slice] launches on the main path: {launches}")
    missing = [op for op, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    for (spl, em, sc, ctx, cc, n_kernel), out in zip(built, outs):
        if out.shape != (BATCH, 1, 1) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{spl} em_ready={em}: output {tuple(out.shape)}, not finite")
        # the same store in float64 on the CPU, through the plain versions
        cc64, st64 = _f64_reference(spl, em, ctx.parameters)
        with torch.inference_mode():
            ref = cc64(st64, torch.as_tensor(x_np[:8])).numpy()
        got = out[:8].double().cpu().numpy()
        rel = float(np.max(np.abs(got - ref) / np.abs(ref)))
        if not np.allclose(got, ref, rtol=1e-5, atol=0.0):
            raise AssertionError(f"{spl} em_ready={em}: max relative error {rel:.3e} > 1e-5")
        del cc64, st64
        with torch.inference_mode():
            ms = _median_ms(lambda: cc(x))
        print(
            f"[slice] {spl} em_ready={em}: out {tuple(out.shape)} finite, "
            f"mean log-likelihood {float(out.mean()):.3f}, max rel err vs CPU float64 "
            f"{rel:.2e}; forward {ms:.3f} ms median of 20 = {BATCH / ms * 1e3:.1f} samples/s "
            f"({smi})"
        )
    return built, launches


def _check_grads(label: str, got, want, *, strict: bool = True) -> float:
    """Each slot's gradient within GRAD_REL max|want| + GRAD_ABS of ``want``
    (``strict``; else only finite); returns the worst error as a share of
    that bound."""
    import torch

    worst = 0.0
    for k, r in want.items():
        wide = torch.complex128 if r.is_complex() else torch.float64
        g = got[k].to(wide).cpu()
        r = r.to(wide).cpu()
        err = float((g - r).abs().max())
        share = err / (GRAD_REL * float(r.abs().max()) + GRAD_ABS)
        if not bool(g.isfinite().all()) or (strict and not share <= 1.0):
            raise AssertionError(f"{label}: gradient of {k} off by {err:.3e}, max|slot| "
                                 f"{float(r.abs().max()):.3e} (bound {GRAD_REL} max + "
                                 f"{GRAD_ABS})")
        worst = max(worst, share)
    return worst


def _check_gradients(label: str, spl: str, em: bool, ctx, cc, x_np) -> None:
    """The mean NLL's gradient of every learnable slot on GRAD_ROWS rows:
    the kernel path in f32 on the card against the same store in float64
    on the CPU, through the plain versions."""
    import torch

    from cirkit_tpu_torch.parallel import split_trainable

    tr, fr = split_trainable(cc, ctx.parameters)
    x = torch.as_tensor(x_np[:GRAD_ROWS], device="cuda")
    got = torch.autograd.grad(-cc.evaluate({**tr, **fr}, x).mean(), list(tr.values()))
    cc64, st64 = _f64_reference(spl, em, ctx.parameters)
    tr_c, fr_c = split_trainable(cc64, st64)
    tr_c = {k: v.requires_grad_() for k, v in tr_c.items()}
    loss_c = -cc64.evaluate({**tr_c, **fr_c}, torch.as_tensor(x_np[:GRAD_ROWS])).mean()
    refs = torch.autograd.grad(loss_c, [tr_c[k] for k in tr])
    worst = _check_grads(label, dict(zip(tr, got)), dict(zip(tr, refs)))
    print(f"[train] {label}: gradients of {len(tr)} learnable slots on {GRAD_ROWS} rows "
          f"agree with the CPU float64 gradients, worst error {worst:.3f} of its bound")


def _counted(label: str, fn, n_kernel: int) -> None:
    """Run ``fn`` once and require one forward and one backward kernel call
    per kernel-bearing plan entry."""
    from cirkit_tpu_torch.ops import lse_einsum as L

    before = dict(L.LAUNCHES)
    fn()
    fwd = sum(L.LAUNCHES[op] - before[op] for op in L.OPS)
    bwd = sum(L.LAUNCHES[f"{op}_bwd"] - before[f"{op}_bwd"] for op in L.OPS)
    if fwd != n_kernel or bwd != n_kernel:
        raise AssertionError(f"{label}: {fwd} forward and {bwd} backward kernel calls, "
                             f"{n_kernel} of each expected")


def _train_setup(spl: str, batch: int, opt_name: str, ctx, cc, x_np):
    """A training step of ``data_parallel_step`` on copies of the flagship's
    trainable slots, with its optimizer factory and its fixed batch; returns
    the factory, the step and the step's parts ``(store, optimizer, x)``."""
    import torch

    from cirkit_tpu_torch.parallel import adam_lowmem, data_parallel_step, split_trainable

    make = adam_lowmem(1e-2) if opt_name == "adam_lowmem" else (
        lambda ps: torch.optim.Adam(ps, lr=1e-2))
    trainable, frozen = split_trainable(cc, ctx.parameters)
    trainable = {k: v.detach().clone().requires_grad_() for k, v in sorted(trainable.items())}
    frozen = {k: v.detach() for k, v in frozen.items()}
    opt = make(list(trainable.values()))
    step = data_parallel_step(cc, opt)
    x = torch.as_tensor(x_np[:batch], device="cuda")
    return make, lambda: step(trainable, frozen, x), ({**trainable, **frozen}, opt, x)


def _train_run(spl: str, batch: int, opt_name: str, ctx, cc, n_kernel: int, x_np, smi: str,
               launches: dict[str, int]) -> None:
    import numpy as np

    from cirkit_tpu_torch.ops import lse_einsum as L
    from cirkit_tpu_torch.parallel import fit

    label = f"{spl} {opt_name} batch {batch}"
    make, step, _ = _train_setup(spl, batch, opt_name, ctx, cc, x_np)

    # The main-path run: STEPS steps on a fixed batch, counted.
    _zero_launches()
    losses = []
    for _ in range(STEPS):
        _counted(label, lambda: losses.append(float(step())), n_kernel)
    for op, n in L.LAUNCHES.items():
        launches[op] += n
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: losses {losses} not finite and decreasing")
    ms = _median_ms(step, warmup=3, iters=10)
    print(f"[train] {label}: {STEPS} steps, NLL {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"step {ms:.3f} ms median of 10 = {batch / ms * 1e3:.1f} samples/s ({smi})")
    del step
    if (spl, opt_name) not in RESUMED:
        return

    # fit over 3 batches, interrupted after its checkpoint at step 2, resumed
    ck = REPO / "build" / "chip_smoke" / f"{spl}_{opt_name}"
    ck.parent.mkdir(parents=True, exist_ok=True)
    data = np.random.default_rng(1).integers(0, 256, (3 * batch, 784))
    kw = dict(store=ctx.parameters, batch_size=batch, optimizer=make, checkpoint_every=2,
              checkpoint_path=str(ck))

    class Interrupt(Exception):
        pass

    def interrupt(epoch, step_idx, loss):
        if step_idx == 2:
            raise Interrupt

    t0 = time.perf_counter()
    try:
        fit(cc, data, callback=interrupt, **kw)
        raise AssertionError(f"{label}: fit was not interrupted")
    except Interrupt:
        pass
    _, fit_losses = fit(cc, data, resume=True, **kw)
    if len(fit_losses) != 3 or not all(np.isfinite(fit_losses)):
        raise AssertionError(f"{label}: resumed fit losses {fit_losses}")
    shutil.rmtree(ck.parent)
    print(f"[train] {label}: fit of 3 batches interrupted at step 2 and resumed, losses "
          f"{[round(v, 3) for v in fit_losses]}, {time.perf_counter() - t0:.1f} s")


def phase_train(smi: str, built: list) -> dict[str, int]:
    """Maximum-likelihood training of the flagships through the kernels;
    returns the launches of each op over the counted (main-path) runs."""
    import numpy as np
    import torch

    from cirkit_tpu_torch.ops import lse_einsum as L

    x_np = np.random.default_rng(0).integers(0, 256, (max(b for _, b, _ in TRAIN_RUNS), 784))
    launches = {op: 0 for op in L.LAUNCHES}
    flagships = {(spl, em): (ctx, cc, n_kernel) for spl, em, _, ctx, cc, n_kernel in built}
    for spl, em in FLAGSHIPS:
        ctx, cc, n_kernel = flagships[spl, em]
        _check_gradients(f"{spl} em_ready={em}", spl, em, ctx, cc, x_np)
    for spl, batch, opt_name in TRAIN_RUNS:
        ctx, cc, n_kernel = flagships[spl, False]
        _train_run(spl, batch, opt_name, ctx, cc, n_kernel, x_np, smi, launches)

    # The EM-ready Tucker store: the gradient of the log-likelihood at
    # batch 128, one counted call.
    ctx, cc, n_kernel = flagships["tucker", True]
    params = dict(ctx.parameters)
    x = torch.as_tensor(x_np[:BATCH], device="cuda")

    def flows():
        return torch.autograd.grad(cc.evaluate(params, x).sum(), list(params.values()))

    _zero_launches()
    _counted("tucker em_ready E-step gradient", flows, n_kernel)
    for op, n in L.LAUNCHES.items():
        launches[op] += n
    if not all(bool(torch.isfinite(g).all()) for g in flows()):
        raise AssertionError("tucker em_ready: gradient not finite")
    ms = _median_ms(flows, warmup=3, iters=10)
    print(f"[train] tucker em_ready E-step gradient at batch {BATCH}: {ms:.3f} ms median of "
          f"10 ({smi})")

    bwd = {f"{op}_bwd": launches[f"{op}_bwd"] for op in L.OPS}
    print(f"[train] backward launches on the main path: {bwd}")
    missing = [op for op, n in bwd.items() if n == 0]
    if missing:
        raise AssertionError(f"backward kernels not launched on the main path: {missing}")
    return bwd


# Phase 5b, EM. fit_em trains on EM_ROWS fixed rows in batches of BATCH (4
# batches an epoch) for EM_EPOCHS epochs; the Gaussian and Binomial
# flagships (EM_LEAVES) train EM_LEAF_EPOCHS epochs on synthetic rows of their
# type. Full-batch EM is monotone, but a float32 loss near the flagship's
# 4.4e3 carries an ulp of 5e-4: each epoch's loss may exceed the one before
# by EM_MONO_REL of its size.
EM_ROWS, EM_EPOCHS, EM_LEAF_EPOCHS = 512, 3, 3
EM_LEAVES = ("gaussian", "binomial")
EM_MONO_REL = 1e-5


def _em_rows(kind: str):
    """EM_ROWS rows of the 28x28 image from seed 0: pixel states 0..255 (the
    categorical flagship; the binomial one's counts), or pixel values scaled
    to [0, 1] plus noise (the Gaussian one); with the categorical rows, the
    50% missing mask of ``bench.py:222-224`` drawn after them."""
    import numpy as np

    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, size=(EM_ROWS, 784))
    if kind == "gaussian":
        return (x / 255.0 + rng.normal(0.0, 0.05, size=x.shape)).astype(np.float32), None
    return x, rng.random((EM_ROWS, 784)) < 0.5


def _em_monotone(label: str, losses: list[float]) -> None:
    import numpy as np

    if not all(np.isfinite(losses)) or any(b > a + EM_MONO_REL * abs(a)
                                           for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"{label}: losses {losses} not finite and non-increasing "
                             f"(within {EM_MONO_REL} |loss|)")


def _em_step(cc, store, x, rows: int | None = None):
    """``em_programs``' flow step on ``store`` and its update: a function
    running one flow step on the first ``rows`` rows of ``x`` (all, if None)
    with unit weights into fresh accumulators, and the programs' parts."""
    import torch

    from cirkit_tpu_torch.parallel import em_programs

    flow_step, em_update, state = em_programs(cc, store)
    ref = next(iter(state["store"].values()))
    x = x if rows is None else x[:rows]
    w = torch.ones(x.shape[0], device=ref.device)

    def step(acc=None):
        acc = state["zero_acc"]() if acc is None else acc
        zero = torch.zeros((), dtype=ref.dtype, device=ref.device)
        return flow_step(state["em_params"], state["gauss_params"], acc, zero, x, w)

    return step, em_update, state


def phase_em(smi: str, built: list) -> dict[str, int]:
    """Phase 5b: EM through the kernels. (a) The EM-ready K=64 Tucker
    flagship's flow step at batch 128, counted and timed, its flows on
    GRAD_ROWS rows against float64 on the CPU, one M-step at step size 1;
    (b) ``fit_em`` on EM_ROWS rows, monotone, resumed from a checkpoint to
    the bit, and with missing entries; (c) the Gaussian and Binomial K=64
    flagships: compiled, 8 forward rows against float64, a counted and timed
    flow step, ``fit_em`` monotone with the leaves moved. Returns each
    kernel's launches over the counted (main-path) runs."""
    import numpy as np
    import torch

    from cirkit_tpu_torch.parallel import fit_em
    from cirkit_tpu_torch.parallel.em import binomial_em_layers, em_slots, gaussian_em_layers

    launches: dict[str, int] = {}
    ctx, cc = next((ctx, cc) for spl, em, _, ctx, cc, _ in built if spl == "tucker" and em)
    fwd, bwd = _expected_launches(cc)
    per_step = {op: fwd.get(op, 0) + bwd.get(op, 0) for op in {*fwd, *bwd}}

    def times(n):
        return {op: k * n for op, k in per_step.items()}

    data, mask = _em_rows("categorical")
    x = torch.as_tensor(data[:BATCH], device=DEV)
    label = f"[em] tucker K={FLAGSHIP_K}"

    # (a) the flow step, counted; its flows against float64; one M-step
    step, em_update, state = _em_step(cc, ctx.parameters, x)
    acc, ll = _counted_launches(f"{label} flow step", step, times(1), launches)
    if not bool(torch.isfinite(ll)):
        raise AssertionError(f"{label}: flow step log-likelihood {float(ll)}")
    new_em, _ = em_update(state["em_params"], state["gauss_params"], acc, 1.0)
    kinds = em_slots(cc)
    worst_sum = 0.0
    for slot, w in new_em.items():
        worst_sum = max(worst_sum, float((w.sum(dim=-1).double() - 1.0).abs().max()))
        if not bool((w >= 0).all()) or worst_sum > 1e-5:
            raise AssertionError(f"{label}: M-step {kinds[slot]} slot {slot} negative, or rows "
                                 f"off 1 by {worst_sum:.3e} (1e-5)")
    del new_em
    # timed as bench_em times it: the steps add into one accumulator
    ms = _median_ms(lambda: step(acc), warmup=3, iters=10)
    del acc
    step8, _, _ = _em_step(cc, ctx.parameters, x, GRAD_ROWS)
    cc64, st64 = _f64_reference("tucker", True, ctx.parameters)
    step64, _, _ = _em_step(cc64, st64, torch.as_tensor(data[:GRAD_ROWS]))
    (flows, _, _), _ = step8()
    (want, _, _), _ = step64()
    # mean flows a row, the scale of phase 5's mean-NLL gradients
    worst = _check_grads(f"{label} flows", {k: v / GRAD_ROWS for k, v in flows.items()},
                         {k: v / GRAD_ROWS for k, v in want.items()})
    del cc64, st64, step64, flows, want
    gc.collect()
    print(f"{label}: flow step at batch {BATCH} {ms:.3f} ms median of 10, one forward and one "
          f"backward launch per kernel-bearing entry {per_step}; flows of {len(kinds)} slots "
          f"on {GRAD_ROWS} rows within {worst:.3f} of the GRAD bound of float64; M-step at "
          f"step size 1: every slot nonnegative, rows within {worst_sum:.1e} of 1 ({smi})")

    # (b) fit_em: monotone; resumed from a checkpoint to the bit; missing entries
    nb = -(-EM_ROWS // BATCH)
    kw = dict(store=ctx.parameters, batch_size=BATCH)
    t0 = time.perf_counter()
    store_a, losses_a = _counted_launches(
        f"{label} fit_em", lambda: fit_em(cc, data, num_epochs=EM_EPOCHS, **kw),
        times(nb * EM_EPOCHS), launches)
    fit_s = time.perf_counter() - t0
    _em_monotone(f"{label} fit_em", losses_a)
    ck = REPO / "build" / "chip_smoke" / "em"
    ck.parent.mkdir(parents=True, exist_ok=True)
    ckw = dict(checkpoint_every=1, checkpoint_path=str(ck), **kw)
    fit_em(cc, data, num_epochs=1, **ckw)  # interrupted after epoch 1
    store_b, losses_b = fit_em(cc, data, num_epochs=EM_EPOCHS, resume=True, **ckw)
    shutil.rmtree(ck.parent)
    if losses_b != losses_a or not all(torch.equal(store_a[k], store_b[k]) for k in store_a):
        raise AssertionError(f"{label}: resumed fit_em differs from the uninterrupted run "
                             f"(losses {losses_b} against {losses_a})")
    del store_a, store_b
    data_m = np.where(mask, -1, data)
    _, losses_m = _counted_launches(
        f"{label} fit_em missing", lambda: fit_em(cc, data_m, num_epochs=2, missing=-1, **kw),
        times(2 * nb), launches)
    if not all(np.isfinite(losses_m)) or not losses_m[1] < losses_m[0]:
        raise AssertionError(f"{label}: missing-data losses {losses_m} not finite and "
                             "decreasing")
    print(f"{label}: fit_em over {EM_ROWS} rows at batch {BATCH}, {EM_EPOCHS} epochs in "
          f"{fit_s:.1f} s, NLL {[round(v, 3) for v in losses_a]}; interrupted after epoch 1 "
          f"and resumed: equal to the bit; 2 epochs with the 50% mask missing: "
          f"{[round(v, 3) for v in losses_m]} ({smi})")

    # (c) the Gaussian and Binomial flagships
    for kind in EM_LEAVES:
        label = f"[em] {kind} tucker K={FLAGSHIP_K}"
        gc.collect()
        t0 = time.perf_counter()
        _, lctx, lcc = _build_flagship("tucker", True, DEV, input_layer=kind)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        lfwd, lbwd = _expected_launches(lcc)
        lstep = {op: lfwd.get(op, 0) + lbwd.get(op, 0) for op in {*lfwd, *lbwd}}
        rows, _ = _em_rows(kind)
        lx = torch.as_tensor(rows[:BATCH], device=DEV)
        with torch.inference_mode():
            out = lcc(lx)
        if out.shape != (BATCH, 1, 1) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{label}: output {tuple(out.shape)}, not finite")
        cc64, st64 = _f64_reference("tucker", True, lctx.parameters, input_layer=kind)
        with torch.inference_mode():
            ref = cc64(st64, torch.as_tensor(rows[:QUERY_ROWS]))
        got = out[:QUERY_ROWS].double().cpu()
        rel = float(((got - ref).abs() / ref.abs()).max())
        if not torch.allclose(got, ref, rtol=1e-5, atol=0.0):
            raise AssertionError(f"{label}: forward off float64 by {rel:.3e} (1e-5)")
        del cc64, st64
        lstep_fn, _, _ = _em_step(lcc, lctx.parameters, lx)
        lacc, _ = _counted_launches(f"{label} flow step", lstep_fn, lstep, launches)
        lms = _median_ms(lambda: lstep_fn(lacc), warmup=3, iters=10)
        new, losses = _counted_launches(
            f"{label} fit_em",
            lambda: fit_em(lcc, rows, store=lctx.parameters, num_epochs=EM_LEAF_EPOCHS,
                           batch_size=BATCH),
            {op: n * nb * EM_LEAF_EPOCHS for op, n in lstep.items()}, launches)
        _em_monotone(f"{label} fit_em", losses)
        if kind == "gaussian":
            leaves = [(ms_, ss) for _, _, ms_, ss in gaussian_em_layers(lcc)]
            moved = all(not torch.equal(new[s_], lctx.parameters[s_]) for p in leaves for s_ in p)
            ok = moved and all(bool((new[ss] > 0).all()) for _, ss in leaves)
        else:
            leaves = [s_ for _, _, s_, _ in binomial_em_layers(lcc)]
            moved = all(not torch.equal(new[s_], lctx.parameters[s_]) for s_ in leaves)
            ok = moved and all(bool(((new[s_] > 0) & (new[s_] < 1)).all()) for s_ in leaves)
        if not leaves or not ok:
            raise AssertionError(f"{label}: leaf slots {leaves} did not move, or left their "
                                 "domain")
        print(f"{label}: compiled in {compile_s:.1f} s, {lcc.num_parameters()} parameters; "
              f"forward of {QUERY_ROWS} rows within {rel:.2e} of float64; flow step at batch "
              f"{BATCH} {lms:.3f} ms median of 10; fit_em {EM_LEAF_EPOCHS} epochs over "
              f"{EM_ROWS} rows, NLL {[round(v, 3) for v in losses]}, {len(leaves)} leaf "
              f"layers moved ({smi})")
        del lctx, lcc, new, lstep_fn, lacc, out
    gc.collect()
    torch.cuda.empty_cache()
    missing = [op for op in per_step if not launches.get(op)]
    if missing:
        raise AssertionError(f"kernels of the EM path not launched: {missing}")
    print(f"[em] launches on the EM main path: {launches}")
    return launches


PROFILE_STEPS = 5
# (category, substrings of kernel names), first match wins: the float32 wide
# kernels on the tensor cores (ct_fwd_tc, blocked_fwd_tc, blocked_gy_tc,
# blocked_bwd_tc) are wide kernels, not kernel 2's tc_ ones, and the float32
# single-pass Tucker forward (tucker_fwd_tc) is a forward kernel
_KERNEL_CATEGORIES = (
    ("tropical kernel", ("tropical_tucker", "tropical_lse", "tropical_finish")),
    ("route kernel", ("route_tucker",)),
    ("wide forward kernel", ("ct_fwd", "blocked_fwd")),
    ("wide backward kernel", ("blocked_gy", "blocked_bwd")),
    ("torch softmax", ("softmaxforward", "softmaxbackward")),
    ("forward kernel", ("lse_fwd", "tucker_fwd")),
    ("backward kernel", ("bwd_prep", "softmax_weights", "lse_bwd_dx", "lse_bwd_dw",
                         "softmax_vjp", "tc_softmax_stats", "tc_dx", "tc_dw", "tucker_dx_finish",
                         "bwd_narrow", "sum_partials", "split_finish")),
    ("foreach optimizer", ("multi_tensor_apply",)),
    ("copies and gathers", ("copy", "cat", "index", "gather", "scatter")),
)


def _kernel_category(name: str) -> str:
    return next((cat for cat, keys in _KERNEL_CATEGORIES
                 if any(k in name.lower() for k in keys)), "other")


def _parts_ms(store, opt, cc, x) -> dict[str, float]:
    """Median CUDA-event ms of the step's parts, each timed alone (10 after
    3 warm-ups): the forward and loss, ``loss.backward()``, and the
    optimizer step on those gradients."""
    import torch

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    times: dict[str, list[float]] = {"forward": [], "backward": [], "optimizer": []}
    for i in range(13):
        opt.zero_grad(set_to_none=True)
        loss, t_fwd = timed(lambda: -cc.evaluate(store, x).mean())
        _, t_bwd = timed(loss.backward)
        _, t_opt = timed(opt.step)
        if i >= 3:
            for part, t in zip(times, (t_fwd, t_bwd, t_opt)):
                times[part].append(t)
    return {part: statistics.median(t) for part, t in times.items()}


def phase_profile(smi: str, built: list) -> None:
    """Each training run's step split into forward, backward
    and optimizer (CUDA events, each part timed alone), and
    ``torch.profiler`` over PROFILE_STEPS steps (after 3 warm-ups): device
    time per step by kernel category and the device's idle share of the
    profiled window. The 25 entries with the most device time go to
    ``build/profile/``."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x_np = np.random.default_rng(0).integers(0, 256, (256, 784))
    flagships = {(spl, em): (ctx, cc) for spl, em, _, ctx, cc, _ in built}
    out_dir = REPO / "build" / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    for spl, batch, opt_name in TRAIN_RUNS:
        ctx, cc = flagships[spl, False]
        _, step, (store, opt, x) = _train_setup(spl, batch, opt_name, ctx, cc, x_np)
        for _ in range(3):
            step()
        parts = _parts_ms(store, opt, cc, x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILE_STEPS):
                step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
        events = prof.key_averages()
        cats: dict[str, float] = {}
        for e in events:
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False) \
                    and "#" not in e.key:  # "#" marks the optimizer's own annotations
                cat = _kernel_category(e.key)
                cats[cat] = cats.get(cat, 0.0) + e.self_device_time_total / 1e3 / PROFILE_STEPS
        device = sum(cats.values())
        print(f"[profile] {spl} {opt_name} batch {batch}: parts timed alone "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
              + f"; under the profiler {wall:.3f} ms a step, device busy {device:.3f} ms "
              f"(idle {1 - device / wall:.1%}): "
              + ", ".join(f"{k} {v:.3f} ms ({v / device:.1%})"
                          for k, v in sorted(cats.items(), key=lambda i: -i[1]))
              + f" ({smi})")
        (out_dir / f"profile_{spl}_{opt_name}.txt").write_text(
            events.table(sort_by="self_device_time_total", row_limit=25)
        )
        del step, store, opt


def _profile(fn, calls: int) -> tuple[float, dict[str, float]]:
    """``torch.profiler`` over ``calls`` calls of ``fn`` (after a warm-up):
    the wall ms a call and the device ms a call of each kernel, by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    kernels: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            kernels[e.key] = kernels.get(e.key, 0.0) + e.self_device_time_total / 1e3 / calls
    return wall, kernels


def _device_breakdown(fn, calls: int) -> str:
    """Device ms a call of ``fn`` by kernel category, and the device's idle
    share (``_profile``)."""
    wall, kernels = _profile(fn, calls)
    cats: dict[str, float] = {}
    for key, ms in kernels.items():
        cat = _kernel_category(key)
        cats[cat] = cats.get(cat, 0.0) + ms
    device = sum(cats.values())
    return (f"{wall:.3f} ms a call under the profiler, device busy {device:.3f} ms "
            f"(idle {1 - device / wall:.1%}): "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(cats.items(), key=lambda i: -i[1])))


def _kernel_split(fn, calls: int = 10) -> str:
    """Device ms a call of ``fn`` by kernel (its name without namespace and
    parameters): the per-launch split of a backward."""
    parts: dict[str, float] = {}
    for key, ms in _profile(fn, calls)[1].items():
        name = key.removeprefix("void ").replace("(anonymous namespace)::", "").split("(")[0]
        parts[name] = parts.get(name, 0.0) + ms
    return f"device {sum(parts.values()):.4f} ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in sorted(parts.items(), key=lambda i: -i[1]))


def _query_counted(label: str, fn, want: dict[str, int], launches: dict[str, int]):
    """Run ``fn`` once and require the launches of each op group in ``want``:
    ``forward`` (the lse forward ops), ``tropical_tucker2``,
    ``route_tucker2``; the launches add into ``launches``."""
    import torch

    from cirkit_tpu_torch.ops import lse_einsum as L

    before = dict(L.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    diff = {op: L.LAUNCHES[op] - before[op] for op in L.LAUNCHES}
    got = {"forward": sum(diff[op] for op in L.OPS),
           "tropical_tucker2": diff["tropical_tucker2"], "route_tucker2": diff["route_tucker2"]}
    if got != want or any(diff[f"{op}_bwd"] for op in L.OPS):
        raise AssertionError(f"{label}: launches {got}, expected {want}")
    for op, n in diff.items():
        launches[op] = launches.get(op, 0) + n
    return out


def phase_queries(smi: str, built: list) -> dict[str, int]:
    """The queries on the Tucker flagship at batch 128; returns the launches
    of each op over the counted (main-path) calls."""
    import numpy as np
    import torch

    from cirkit_tpu_torch.backend.torch import IntegrateQuery, MAPQuery, SamplingQuery
    from cirkit_tpu_torch.backend.torch.optimized import TorchTuckerLayer

    ctx, cc, n_kernel = next((ctx, cc, n) for spl, em, _, ctx, cc, n in built
                             if spl == "tucker" and not em)
    n_tucker = sum(isinstance(l, TorchTuckerLayer) and l.arity == 2 for l in cc.layers)
    rng = np.random.default_rng(0)  # the batch and 50% mask of bench.py:222-224
    x_np = rng.integers(0, 256, size=(BATCH, 784), dtype=np.int32).astype(np.int64)
    mask_np = rng.random((BATCH, 784)) < 0.5
    marg_np = ~mask_np & (rng.random((BATCH, 784)) < 0.5)
    x = torch.as_tensor(x_np, device=DEV)
    mask = torch.as_tensor(mask_np, device=DEV)
    marg = torch.as_tensor(marg_np, device=DEV)
    iq, mq, sq = IntegrateQuery(cc), MAPQuery(cc), SamplingQuery(cc)
    gen = torch.Generator().manual_seed(0)
    # the store of the compile (phase 5's fit bound its trained store as
    # cc.default_store), the one the float64 reference below loads
    st = ctx.parameters
    calls = {
        "integrate": (lambda: iq(x, integrate_vars=mask, store=st), {"forward": n_kernel}),
        "map": (lambda: mq(x, evidence_mask=mask, store=st), {}),
        "map marginal": (lambda: mq(x, evidence_mask=mask, marginalize_vars=marg, store=st),
                         {}),
        "sample": (lambda: sq(BATCH, generator=gen, store=st), {"forward": n_kernel}),
        "conditional": (lambda: sq.conditional(x, evidence_mask=mask, generator=gen, store=st),
                        {"forward": n_kernel}),
    }
    for name, (_, want) in calls.items():
        want.setdefault("forward", 0)
        want["tropical_tucker2"] = n_tucker if name.startswith("map") else 0
        want["route_tucker2"] = 0 if name == "integrate" else n_tucker

    # The main-path run: each query once, counted.
    _zero_launches()
    launches: dict[str, int] = {}
    outs = {name: _query_counted(name, fn, want, launches)
            for name, (fn, want) in calls.items()}
    from cirkit_tpu_torch.ops import lse_einsum as L

    routed = {op: launches[op] for op in ROUTE_OPS}
    print(f"[queries] Tucker flagship, batch {BATCH}, {n_tucker} Tucker entries of {n_kernel} "
          f"kernel-bearing: launches on the main path {routed}, forward "
          f"{sum(launches[op] for op in L.OPS)}")
    for op in ("tropical_tucker2", "route_tucker2"):
        if launches[op] == 0:
            raise AssertionError(f"{op} was not launched on the query path")

    marginals = outs["integrate"]
    (asg, vals), (asg_m, vals_m) = outs["map"], outs["map marginal"]
    samples, mixtures = outs["sample"]
    csamples, log_ev = outs["conditional"]
    checks = [
        ("marginals", marginals.shape == (BATCH, 1, 1) and bool(marginals.isfinite().all())),
        ("map", asg.shape == (BATCH, 784) and bool(vals.isfinite().all())
         and torch.equal(asg[mask], x[mask].to(asg.dtype))),
        ("map marginal", bool(vals_m.isfinite().all()) and bool((asg_m[marg] == 0).all())
         and torch.equal(asg_m[mask], x[mask].to(asg.dtype))),
        ("sample", samples.shape == (BATCH, 784) and len(mixtures) > 0),
        ("conditional", torch.equal(csamples[mask], x[mask].to(csamples.dtype))
         and bool(log_ev.isfinite().all())),
    ]
    for s_ in (asg, asg_m, samples, csamples):
        checks.append(("states", bool(((s_ >= 0) & (s_ <= 255) & (s_ == s_.round())).all())))
    bad = [name for name, ok in checks if not ok]
    if bad:
        raise AssertionError(f"queries: outputs wrong in {bad}")

    # QUERY_ROWS rows against the same store in float64 on the CPU
    t0 = time.perf_counter()
    cc64, st64 = _f64_reference("tucker", False, ctx.parameters)
    r = QUERY_ROWS
    xr, mr, gr = (torch.as_tensor(a[:r]) for a in (x_np, mask_np, marg_np))
    want_marg = IntegrateQuery(cc64)(xr, integrate_vars=mr, store=st64)
    want_map = MAPQuery(cc64)(xr, evidence_mask=mr, store=st64)
    want_map_m = MAPQuery(cc64)(xr, evidence_mask=mr, marginalize_vars=gr, store=st64)
    _, want_ev = SamplingQuery(cc64).conditional(xr, evidence_mask=mr, store=st64,
                                                   generator=torch.Generator().manual_seed(0))
    del cc64, st64
    rels = {}
    for name, got, want in (("marginals", marginals[:r, 0, 0], want_marg[:, 0, 0]),
                            ("map", vals[:r], want_map[1]), ("map marginal", vals_m[:r],
                                                               want_map_m[1]),
                            ("log-evidence", log_ev[:r], want_ev)):
        got = got.double().cpu()
        rels[name] = float(((got - want).abs() / want.abs()).max())
        if not torch.allclose(got, want, rtol=1e-5, atol=0.0):
            raise AssertionError(f"queries: {name} off the float64 CPU run by {rels[name]:.3e}")
    differ = [int((a[:r].double().cpu() != w[0]).sum()) for a, w in ((asg, want_map),
                                                                      (asg_m, want_map_m))]
    print(f"[queries] {r} rows against float64 on the CPU ({time.perf_counter() - t0:.1f} s): "
          + ", ".join(f"{k} max rel err {v:.2e}" for k, v in rels.items())
          + f"; assignments differing from float64: MAP {differ[0]}, marginal MAP {differ[1]} "
          f"of {r * 784} entries; evidence returned unchanged")

    with torch.inference_mode():
        for name, (fn, _) in calls.items():
            ms = _median_ms(fn, warmup=2, iters=10)
            print(f"[queries] {name}: {ms:.3f} ms median of 10 = {BATCH / ms * 1e3:.1f} rows/s "
                  f"({smi})")
        for name in ("map", "sample"):
            print(f"[queries] {name} profile: {_device_breakdown(calls[name][0], 3)} ({smi})")
    return launches


# The expectation and information queries of phase 7b on the K=64 Tucker
# flagship at batch 128: the 16 anchors of bench.py's mi_per_anchor_ms
# (6-21), the variables of the covariance, the top-k batch and slots, and
# the Renyi-2 circuit (image_data at RENYI_SIDE x RENYI_SIDE, CP, K=RENYI_K).
MI_ANCHORS = tuple(range(6, 22))
COV_VARS = (100, 300, 500, 700)
TOPK_BATCH, TOPK = 4, 4
RENYI_SIDE, RENYI_K = 12, 32
# The entropies, KL divergences and Renyi-2 entropies of phase 7b against
# float64: a forward-like pass whose log-measures cancel against each other
# (H_o = sum pi H - sum pi log pi), held to INFO_RTOL of their size.
INFO_RTOL = 1e-4


def _dx_only(fn):
    """Run ``fn`` with every backward kernel launch recorded; each must ask
    for the input gradients only (the weight's ``needs`` False)."""
    from cirkit_tpu_torch.ops import lse_einsum as L

    seen = []
    launch = L._launch_bwd

    def recorded(op, ins, out, g, needs):
        seen.append((op, tuple(needs)))
        return launch(op, ins, out, g, needs)

    L._launch_bwd = recorded
    try:
        out = fn()
    finally:
        L._launch_bwd = launch
    weight = [s for s in seen if s[1][-1]]
    if not seen or weight:
        raise AssertionError(f"backward launches {seen}: expected input gradients only")
    return out


def _held(label: str, got, want, bound) -> float:
    """|got - want| <= bound elementwise (a tensor or a number), both finite;
    returns the worst error."""
    import torch

    got = got.double().cpu()
    want = want.double()
    err = (got - want).abs()
    if not bool(torch.isfinite(got).all()) or not bool((err <= bound).all()):
        raise AssertionError(f"[expect] {label}: max |card - float64| = {float(err.max()):.3e}")
    return float(err.max())


def _grad_bound(want):
    """The GRAD_* bound on a statistic computed from responsibilities:
    GRAD_REL of the table's largest entry plus GRAD_ABS."""
    return GRAD_REL * float(want.abs().max()) + GRAD_ABS


def phase_expectation(smi: str, built: list) -> dict[str, int]:
    """Phase 7b: the expectation and information queries on the K=64 Tucker
    flagship; returns each kernel's launches over the counted calls."""
    import numpy as np
    import torch

    from cirkit_tpu_torch.backend.torch import (
        EntropyQuery,
        ExpectationQuery,
        KLDivergenceQuery,
        MAPQuery,
        mutual_information,
    )
    from cirkit_tpu_torch.pipeline import PipelineContext

    ctx, cc = next((ctx, cc) for spl, em, _, ctx, cc, _ in built if spl == "tucker" and not em)
    st = ctx.parameters  # the compile's store (phase 5's fit bound another as default)
    fwd, bwd = _expected_launches(cc)
    step = {**fwd, **bwd}
    rng = np.random.default_rng(0)  # the batch and 50% mask of bench.py:222-224
    x_np = rng.integers(0, 256, size=(BATCH, 784), dtype=np.int32).astype(np.int64)
    mask_np = rng.random((BATCH, 784)) < 0.5
    x, mask = torch.as_tensor(x_np, device=DEV), torch.as_tensor(mask_np, device=DEV)
    q, hq = ExpectationQuery(cc), EntropyQuery(cc)
    kw = dict(evidence_mask=mask, store=st)
    n_mi = len(MI_ANCHORS) + 1  # the base row's marginals, then one pass per anchor
    calls = {
        "mean": (lambda: q(x, **kw), step),
        "mean+variance": (lambda: q(x, return_variance=True, **kw), step),
        "marginals": (lambda: q.marginals(x, **kw), step),
        "marginals bf16": (lambda: q.marginals(x, dtype=torch.bfloat16, **kw), step),
        "cdf t=127": (lambda: q.cdf(x, t=127.0, **kw), step),
        "quantile q=0.5": (lambda: q.quantile(x, q=0.5, **kw), step),
        "covariance": (lambda: q.covariance(x, variables=COV_VARS, **kw), step),
        "covariance row (plain)": (lambda: q._dispatch("cov_row", x, mask, st, 0, 0,
                                                       extra=(COV_VARS[0],)), {}),
        "entropy": (lambda: hq(store=st), {}),
        "posterior entropy": (lambda: hq(x, **kw), {}),
        "mutual information": (lambda: mutual_information(cc, store=st, variables=MI_ANCHORS),
                          {k: n * n_mi for k, n in step.items()}),
    }

    # The main-path run: each call once from zeroed counts; a backward
    # launch that asks for the weight's gradient fails the run.
    launches: dict[str, int] = {}
    outs = {}
    for name, (fn, want) in calls.items():
        run = fn if name in ("covariance row (plain)", "entropy", "posterior entropy") else (
            lambda fn=fn: _dx_only(fn))
        outs[name] = _counted_launches(f"[expect] {name}", run, want, launches)
    print(f"[expect] Tucker flagship, batch {BATCH}: a forward and a dx-only backward launch "
          f"per kernel-bearing entry a call ({step}); covariance rows and entropies plain "
          f"(0 launches); launches on the main path {launches}")

    mean, (mean2, var) = outs["mean"], outs["mean+variance"]
    marg, marg16 = outs["marginals"], outs["marginals bf16"]
    cdf, quant, cov = outs["cdf t=127"], outs["quantile q=0.5"], outs["covariance"]
    h, hp, mi = outs["entropy"], outs["posterior entropy"], outs["mutual information"]
    xf = x.to(mean.dtype)
    free = ~mask
    checks = {
        "mean": torch.equal(mean, mean2) and torch.equal(mean[mask], xf[mask])
        and bool(((mean >= 0) & (mean <= 255)).all()),
        "variance": bool((var[mask] == 0).all()) and bool((var >= 0).all()),
        # the rows of responsibilities sum to 1 within the GRAD_* bound of a
        # probability
        "marginals": marg.shape == (BATCH, 784, 256)
        and bool(((marg.sum(dim=2) - 1).abs() <= GRAD_REL + GRAD_ABS).all()),
        "marginals bf16": marg16.dtype == torch.bfloat16
        and bool(((marg16.float() - marg).abs() <= 2.0**-8).all()),
        "cdf": bool(((cdf >= -1e-6) & (cdf <= 1 + 1e-5)).all())
        and torch.equal(cdf[mask], (xf[mask] <= 127.0).to(cdf.dtype)),
        "quantile": torch.equal(quant[mask], xf[mask])
        and bool(((quant[free] >= -1e-3) & (quant[free] <= 255 + 1e-3)).all()),
        "covariance": cov.shape == (BATCH, 4, 4) and bool(cov.isfinite().all())
        and bool(((cov - cov.transpose(1, 2)).abs() <= 1e-3 * cov.abs().amax() + 1e-6).all()),
        "entropies": bool(h.isfinite().all()) and bool((hp >= -1e-3).all()),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"[expect] outputs wrong: {bad}")

    # mutual information, which has no CPU reference at this size: its
    # identities (symmetric; the diagonal the marginals' entropies; >= 0)
    scale = float(mi.abs().max())
    base = q.marginals(np.zeros((1, 784), np.int64), evidence_mask=np.zeros((1, 784), bool),
                       store=st)[0]  # (D, S)
    p = base[list(MI_ANCHORS)]
    h_marg = -torch.where(p > 0, p * torch.log(p), 0.0).sum(dim=1)
    asym = float((mi - mi.t()).abs().max())
    diag = float((torch.diagonal(mi) - h_marg).abs().max())
    if not (asym <= 1e-4 * scale and diag <= 1e-4 * scale and float(mi.min()) >= -1e-6):
        raise AssertionError(f"[expect] MI: asymmetry {asym:.3e}, diagonal off the marginal "
                             f"entropies by {diag:.3e}, least entry {float(mi.min()):.3e}")
    print(f"[expect] MI over anchors {MI_ANCHORS[0]}-{MI_ANCHORS[-1]}: symmetric within "
          f"{asym:.2e}, diagonal within {diag:.2e} of the marginals' entropies, least entry "
          f"{float(mi.min()):.2e}, largest {scale:.3f} nats")

    # KL: the store against itself, and against a seed-1 store
    ctx1 = PipelineContext(semiring="lse-sum", fold=True, optimize=True, device=DEV, seed=1)
    cc1 = ctx1.compile(_flagship_circuit("tucker", False, FLAGSHIP_K))
    st1 = cc1.restrict_store(ctx1.parameters)
    kq = KLDivergenceQuery(cc)
    kl_self = kq(st, st)
    kl, kl_post = kq(st, st1), kq(st, st1, x, evidence_mask=mask)
    if not (float(kl_self.abs().max()) <= 1e-3 and bool((kl >= 0).all())
            and bool((kl_post >= -1e-3).all())):
        raise AssertionError(f"[expect] KL(p||p) {float(kl_self.max()):.3e}, KL(p||q) "
                             f"{float(kl.min()):.3e}, posterior {float(kl_post.min()):.3e}")

    # QUERY_ROWS rows against the same stores in float64 on the CPU
    t0 = time.perf_counter()
    r = QUERY_ROWS
    cc64, st64 = _f64_reference("tucker", False, st)
    st1_64 = {k: v.detach().cpu().double() for k, v in st1.items()}
    xr, mr = torch.as_tensor(x_np[:r]), torch.as_tensor(mask_np[:r])
    q64, h64 = ExpectationQuery(cc64), EntropyQuery(cc64)
    kw64 = dict(evidence_mask=mr, store=st64)
    m64, v64 = q64(xr, return_variance=True, **kw64)
    want = {"mean": m64, "variance": v64, "marginals": q64.marginals(xr, **kw64),
            "cdf": q64.cdf(xr, t=127.0, **kw64)}
    got = {"mean": mean[:r], "variance": var[:r], "marginals": marg[:r], "cdf": cdf[:r]}
    errs = {k: _held(k, got[k], want[k], _grad_bound(want[k])) for k in want}
    info = {"entropy": (h, h64(store=st64)), "posterior entropy": (hp[:r], h64(xr, **kw64)),
            "KL": (kl, KLDivergenceQuery(cc64)(st64, st1_64)),
            "posterior KL": (kl_post[:r], KLDivergenceQuery(cc64)(st64, st1_64, xr,
                                                                  evidence_mask=mr))}
    for k, (g, w) in info.items():
        errs[k] = _held(k, g, w, INFO_RTOL * w.abs())
    del cc64, st64, st1_64, cc1, ctx1, st1
    gc.collect()
    print(f"[expect] {r} rows against float64 on the CPU ({time.perf_counter() - t0:.1f} s): "
          + ", ".join(f"{k} max |err| {v:.2e}" for k, v in errs.items())
          + f" (responsibility statistics within {GRAD_REL} max + {GRAD_ABS}, the rest within "
          f"{INFO_RTOL} relative); entropy {float(h[0, 0]):.3f} nats, KL(p||q) "
          f"{float(kl[0, 0]):.3f} nats")

    # top-k MPE at TOPK_BATCH rows: top-1 is MAP, the scores descend, and
    # each assignment is at least as likely as its parse's score
    xt, mt = x[:TOPK_BATCH], mask[:TOPK_BATCH]
    mq = MAPQuery(cc)

    def topk():
        return mq(xt, evidence_mask=mt, top_k=TOPK, store=st)

    base_alloc = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    asg, scores = _counted_launches("[expect] top-k", topk, {}, launches)
    topk_gb = (torch.cuda.max_memory_allocated() - base_alloc) / 1e9
    masg, mval = mq(xt, evidence_mask=mt, store=st)
    with torch.inference_mode():
        ll = cc(st, asg.reshape(-1, 784).round().long()).reshape(TOPK_BATCH, TOPK)
    top1_rel = float(((scores[:, 0] - mval).abs() / mval.abs()).max())
    top1_differ = int((asg[:, 0] != masg).sum())
    if not (bool(scores.isfinite().all()) and top1_rel <= RTOL and top1_differ == 0
            and bool((scores[:, 1:] <= scores[:, :-1]).all())
            and bool((ll >= scores - 1e-4 * scores.abs()).all())):
        raise AssertionError(f"[expect] top-k: top-1 off MAP by {top1_rel:.3e} with "
                             f"{top1_differ} states differing; scores {scores.tolist()}; "
                             f"log p(x) {ll.tolist()}")
    print(f"[expect] top-{TOPK} MPE at batch {TOPK_BATCH}: top-1 equal to MAP (value within "
          f"{top1_rel:.1e}, assignment equal), scores descending, log p(x) >= score; peak "
          f"memory {topk_gb:.2f} GB above what was allocated")

    # Renyi-2 on a 12x12 CP circuit with softmax weights: its product circuit's
    # integral runs kernel 1
    r2 = _phase_renyi(smi, launches)

    with torch.inference_mode():
        base_alloc = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        calls["marginals"][0]()
        marg_gb = (torch.cuda.max_memory_allocated() - base_alloc) / 1e9
    times = {name: _median_ms(fn, warmup=2, iters=10) for name, (fn, _) in calls.items()}
    times["top-k"] = _median_ms(topk, warmup=1, iters=10)
    times["renyi2"] = _median_ms(r2, warmup=1, iters=10)
    print(f"[expect] median ms of 10 calls at batch {BATCH} (top-k at {TOPK_BATCH}): "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
          + f"; MI {times['mutual information'] / len(MI_ANCHORS):.3f} ms an anchor; marginals peak "
          f"memory {marg_gb:.2f} GB above the stores ({smi})")
    print(f"[expect] mean profile: {_device_breakdown(calls['mean'][0], 3)} ({smi})")
    return launches


def _phase_renyi(smi: str, launches: dict[str, int]):
    """``renyi2_entropy`` of image_data((1, RENYI_SIDE, RENYI_SIDE), CP,
    K=RENYI_K, softmax weights): its launches (the forwards of the squared
    and of the plain circuit's integrals), against float64 on the CPU, and
    at most the EntropyQuery bound; returns the call, for timing."""
    import numpy as np
    import torch

    from cirkit_tpu_torch.backend.torch import EntropyQuery, renyi2_entropy
    from cirkit_tpu_torch.backend.torch.optimized import TorchTensorDotLayer
    from cirkit_tpu_torch.models import image_data
    from cirkit_tpu_torch.pipeline import PipelineContext

    def circuit():
        return image_data((1, RENYI_SIDE, RENYI_SIDE), "quad-tree-2", input_layer="categorical",
                          num_input_units=RENYI_K, sum_product_layer="cp", num_sum_units=RENYI_K)

    flags = dict(semiring="lse-sum", fold=True, optimize=True)
    ctx = PipelineContext(**flags, device=DEV, seed=0)
    cc = ctx.compile(circuit())
    renyi2_entropy(cc, ctx=ctx)  # builds the product circuit
    sq = cc.__dict__["_squared_cc"]
    want = dict(_expected_launches(cc)[0])
    for k, n in _expected_launches(sq)[0].items():
        want[k] = want.get(k, 0) + n
    n_td = sum(isinstance(l, TorchTensorDotLayer) for l in sq.layers)
    if n_td:
        want["lse_matmul"] = want.get("lse_matmul", 0) + n_td

    def call():
        return renyi2_entropy(cc, ctx=ctx)

    h2 = _counted_launches("[expect] renyi2", call, want, launches)
    h = EntropyQuery(cc)()
    ctx64 = PipelineContext(**flags, device="cpu", seed=0)
    cc64 = ctx64.compile(circuit())
    renyi2_entropy(cc64, ctx=ctx64)
    ctx64.load_parameters({k: v.detach().cpu().double().numpy()
                           for k, v in ctx.parameters.items()})
    h2_64 = renyi2_entropy(cc64, ctx=ctx64)
    err = _held("renyi2", h2, h2_64, INFO_RTOL * h2_64.abs())
    if not bool((h2 <= h + 1e-4).all()):
        raise AssertionError(f"[expect] renyi2 {float(h2[0, 0]):.4f} above the entropy bound "
                             f"{float(h[0, 0]):.4f}")
    print(f"[expect] renyi2 at {RENYI_SIDE}x{RENYI_SIDE} CP K={RENYI_K}: launches {want} a call, "
          f"H2 {float(h2[0, 0]):.4f} <= H bound {float(h[0, 0]):.4f} nats, |card - float64| "
          f"{err:.2e}")
    return call


# --------------------------------------------------------------------------- #
# Phase 12: cross-circuit queries and the dense sampler
# --------------------------------------------------------------------------- #

# 12a: kl_monte_carlo's and expected_loglikelihood_mc's defaults (JAX's)
MC_SAMPLES, MC_BATCH = 4096, 1024
# 12b: the chained logic circuit's variables, and the bound of the card's
# float32 carriers against the float64 host walk, of the value's size
LOGIC_VARS, CROSS_REL = 128, 1e-4
# 12c: samples of the dense sampler (kept if the peak stays under 60 GB)
DENSE_SAMPLES = 128


def _logic_chain(n: int, seed: int):
    """A deterministic, structured-decomposable logic circuit over ``n``
    variables, lowered with literal weights drawn from ``seed``: the
    multiplexer ``(x_k and A) or (not x_k and B)`` of
    ``tests/backend/test_cross.py:258-270`` chained down the variables, A
    and B each level's two functions of the rest (the parity of x_k..x_n-1
    and its negation), so every conjunction splits {k} from {k+1..n-1}.
    Its weighted-model-count distribution is a PSDD's."""
    import numpy as np

    import cirkit_tpu_torch.models.logic as L
    import cirkit_tpu_torch.symbolic as S

    lit = {}

    def literal(v, negated=False):
        if (v, negated) not in lit:
            lit[v, negated] = L.NegatedLiteralNode(v) if negated else L.LiteralNode(v)
        return lit[v, negated]

    ins = {}
    a, b = literal(n - 1), literal(n - 1, True)
    for k in range(n - 2, -1, -1):
        level = []
        for yes, no in ((a, b), (b, a)):
            c1, c2, d = L.ConjunctionNode(), L.ConjunctionNode(), L.DisjunctionNode()
            ins[c1], ins[c2], ins[d] = [literal(k), yes], [literal(k, True), no], [c1, c2]
            level.append(d)
        a, b = level
    nodes = list(set(ins) | {c for cs in ins.values() for c in cs})
    weights = np.random.default_rng(seed).uniform(0.1, 1.0, (n, 2))

    def factory(negated):
        def make(scope, num_units):
            (var,) = tuple(scope)
            w = weights[var, 1 - int(negated)]
            with np.errstate(divide="ignore"):
                logits = np.log(np.array([w, 0.0]) if negated else np.array([0.0, w]))
            return S.CategoricalLayer(scope, num_units, num_categories=2, logits=(
                S.Parameter.from_input(S.TensorParameter(
                    1, 2, initializer=S.ConstantTensorInitializer(logits), learnable=False))))

        return make

    return L.LogicalCircuit(nodes, ins, [a]).build_circuit(
        literal_input_factory=factory(False), negated_literal_input_factory=factory(True))


def _wall_ms(fn, iters: int = 3) -> float:
    """Median host-clock ms of ``fn``, whose result is read back to the host."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_cross(smi: str, built: list) -> dict[str, int]:
    """Phase 12: (a) Monte Carlo KL and E_p[log q] between the K=64 Tucker
    (p) and CP (q) flagships of phase 4; (b) the exact cross-circuit KL of
    two weightings of one logic circuit over ``LOGIC_VARS`` variables, on
    the host and on the card; (c) the dense bottom-up sampler on the K=64
    Tucker flagship under sum-product. Returns each kernel's launches over
    12a's counted calls."""
    import numpy as np
    import torch

    from cirkit_tpu_torch.backend.torch import (
        SamplingQuery,
        cross_circuit_kl,
        expected_loglikelihood,
        expected_loglikelihood_mc,
        is_deterministic,
        kl_monte_carlo,
    )
    from cirkit_tpu_torch.backend.torch.compiler import TorchCompiler
    from cirkit_tpu_torch.backend.torch.optimized import TorchTuckerLayer
    from cirkit_tpu_torch.ops import lse_einsum as L
    from cirkit_tpu_torch.pipeline import PipelineContext

    (ctx_p, cc_p, n_p), (ctx_q, cc_q, n_q) = (
        next((ctx, cc, n) for spl_, em, _, ctx, cc, n in built if spl_ == spl and not em)
        for spl in ("tucker", "cp"))
    st_p, st_q = ctx_p.parameters, ctx_q.parameters
    n_tucker = sum(isinstance(l, TorchTuckerLayer) and l.arity == 2 for l in cc_p.layers)

    # ---- 12a: Monte Carlo KL and E_p[log q], counted --------------------
    rounds = -(-MC_SAMPLES // MC_BATCH)
    mc = {
        "kl_monte_carlo": kl_monte_carlo,
        "expected_loglikelihood_mc": expected_loglikelihood_mc,
    }

    def call(fn, q=cc_q, sq=st_q, seed=0):
        return fn(cc_p, q, num_samples=MC_SAMPLES, batch_size=MC_BATCH, store_p=st_p,
                  store_q=sq, generator=torch.Generator().manual_seed(seed))

    # a round: the draw (a forward and the routing), log p and log q; then
    # the two log Z probes
    want = {"forward": rounds * (2 * n_p + n_q) + n_p + n_q, "tropical_tucker2": 0,
            "route_tucker2": rounds * n_tucker}
    _zero_launches()
    launches: dict[str, int] = {}
    est = {name: _query_counted(f"[cross] {name}", lambda fn=fn: call(fn), want, launches)
           for name, fn in mc.items()}
    print(f"[cross] 12a: p = Tucker K={FLAGSHIP_K}, q = CP K={FLAGSHIP_K}, {MC_SAMPLES} samples "
          f"in {rounds} rounds of {MC_BATCH}: launches a call {want}; over both calls kernel 1 "
          f"{sum(launches[op] for op in L.OPS)}, kernel 8 (sample kind) "
          f"{launches['route_tucker2']}")
    for name, (value, se) in est.items():
        if not (np.isfinite(value) and np.isfinite(se) and se > 0):
            raise AssertionError(f"[cross] {name}: ({value}, {se}) not finite")
    kl, se = est["kl_monte_carlo"]
    if kl + 4 * se < 0:
        raise AssertionError(f"[cross] KL(p || q) = {kl} +- {se} below 0")
    self_kl = call(kl_monte_carlo, cc_p, st_p)
    if self_kl != (0.0, 0.0):
        raise AssertionError(f"[cross] KL(p || p) = {self_kl}, not exactly (0.0, 0.0)")
    gen = torch.Generator().manual_seed(1)
    with torch.inference_mode():
        x8, _ = SamplingQuery(cc_p)(QUERY_ROWS, generator=gen, store=st_p)
        got = [cc(st, x8)[:, 0, 0].double().cpu() for cc, st in ((cc_p, st_p), (cc_q, st_q))]
    rels = []
    for (spl, st), g in zip((("tucker", st_p), ("cp", st_q)), got):
        cc64, st64 = _f64_reference(spl, False, st)
        with torch.inference_mode():
            ref = cc64(st64, x8.cpu())[:, 0, 0]
        rels.append(float(((g - ref).abs() / ref.abs()).max()))
        if not torch.allclose(g, ref, rtol=1e-5, atol=0.0):
            raise AssertionError(f"[cross] log {spl} on drawn rows off float64 by {rels[-1]:.3e}")
        del cc64, st64
    times = {name: _median_ms(lambda fn=fn: call(fn), warmup=1, iters=5) for name, fn in mc.items()}
    print(f"[cross] 12a: KL(p || q) = {kl:.3f} +- {se:.3f} nats, E_p[log q] = "
          f"{est['expected_loglikelihood_mc'][0]:.3f} +- {est['expected_loglikelihood_mc'][1]:.3f}; "
          f"KL(p || p) = {self_kl}; {QUERY_ROWS} drawn rows against float64 on the CPU: log p "
          f"max rel err {rels[0]:.2e}, log q {rels[1]:.2e}; median ms of 5: "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items()) + f" ({smi})")

    # ---- 12b: the exact cross-circuit KL of two logic weightings --------
    ctx = PipelineContext(semiring="lse-sum", fold=True, device=DEV, seed=0)
    sc_p, sc_q = _logic_chain(LOGIC_VARS, 0), _logic_chain(LOGIC_VARS, 1)
    ctx.compile(sc_p)
    ctx.compile(sc_q)
    if not (is_deterministic(sc_p, ctx=ctx) and is_deterministic(sc_q, ctx=ctx)):
        raise AssertionError("[cross] the logic circuits are not deterministic")
    queries = (("KL", cross_circuit_kl, sc_q), ("E_p[log q]", expected_loglikelihood, sc_q),
               ("KL(p || p)", cross_circuit_kl, sc_p))
    vals, ms = {}, {}
    for device in (False, True):
        for name, fn, q in queries:
            vals[name, device] = float(fn(sc_p, q, ctx=ctx, device=device)[0, 0])
        ms[device] = _wall_ms(lambda d=device: cross_circuit_kl(sc_p, sc_q, ctx=ctx, device=d))
    entropy = -vals["E_p[log q]", False] - vals["KL", False]  # H(p)
    for name in ("KL", "E_p[log q]"):
        host, dev = vals[name, False], vals[name, True]
        if not abs(dev - host) <= CROSS_REL * max(1.0, abs(host)):
            raise AssertionError(f"[cross] {name}: card {dev} against host {host}")
    for device in (False, True):
        if not abs(vals["KL(p || p)", device]) <= CROSS_REL * max(1.0, abs(entropy)):
            raise AssertionError(f"[cross] KL(p || p) = {vals['KL(p || p)', device]}, "
                                 f"device={device}")
    print(f"[cross] 12b: logic chain over {LOGIC_VARS} variables ({len(list(sc_p.layers))} "
          f"layers), two weightings: KL {vals['KL', False]:.6f} host, {vals['KL', True]:.6f} "
          f"card; E_p[log q] {vals['E_p[log q]', False]:.6f}, {vals['E_p[log q]', True]:.6f}; "
          f"KL(p || p) {vals['KL(p || p)', False]:.2e}, {vals['KL(p || p)', True]:.2e} "
          f"(H(p) {entropy:.3f}); cross_circuit_kl median ms of 3: host {ms[False]:.1f}, "
          f"device=True {ms[True]:.1f} ({smi})")

    # ---- 12c: the dense sampler under sum-product ------------------------
    sc = _flagship_circuit("tucker", False, FLAGSHIP_K)
    cc_sp = TorchCompiler(semiring="sum-product", fold=True, optimize=True, device=DEV).compile(sc)
    if not set(cc_sp.used_slots) <= set(st_p):
        raise AssertionError("[cross] the sum-product flagship's slots are not phase 4's")
    dense = SamplingQuery(cc_sp)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    xd, mixtures = dense(DENSE_SAMPLES, generator=torch.Generator().manual_seed(2), store=st_p)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    n_sum = sum(type(l).__name__ in ("TorchSumLayer", "TorchTuckerLayer", "TorchCPTLayer")
                for l in cc_sp.layers)
    if (xd.shape != (DENSE_SAMPLES, 784) or len(mixtures) != n_sum
            or not bool(((xd >= 0) & (xd <= 255) & (xd == xd.round())).all())):
        raise AssertionError(f"[cross] dense samples {tuple(xd.shape)}, {len(mixtures)} "
                             f"mixtures of {n_sum} sum-style entries")
    dense_ms = _median_ms(lambda: dense(DENSE_SAMPLES, generator=gen, store=st_p), warmup=1,
                          iters=5)
    with torch.inference_mode():
        xr, _ = SamplingQuery(cc_p)(DENSE_SAMPLES, generator=torch.Generator().manual_seed(3),
                                    store=st_p)
        lls = [cc_p(st_p, x)[:, 0, 0].double().cpu() for x in (xd, xr)]
    means = [float(v.mean()) for v in lls]
    se = float(np.sqrt(sum(float(v.var()) / len(v) for v in lls)))
    if not abs(means[0] - means[1]) <= 4 * se:
        raise AssertionError(f"[cross] mean log-likelihood of dense samples {means[0]:.3f} and "
                             f"of routed ones {means[1]:.3f} differ by more than 4 x {se:.3f}")
    print(f"[cross] 12c: dense sampler, Tucker K={FLAGSHIP_K} under sum-product, "
          f"{DENSE_SAMPLES} samples: {dense_ms:.3f} ms median of 5, peak {peak:.2f} GB above "
          f"the stores; mean log-likelihood under lse-sum {means[0]:.3f} against the routing "
          f"sampler's {means[1]:.3f} (combined SE {se:.3f}) ({smi})")
    return launches


# --------------------------------------------------------------------------- #
# Structure search (phase 13): pruning, growing, distillation, the loop
# --------------------------------------------------------------------------- #

STRUCT_ROWS = 512  # the seeded rows of the data-aware prune
STRUCT_BATCH = 128  # its flow batches (the default 1024 would not fit beside the stores)
LOOP_SIDE, LOOP_K = 8, 16  # bench.py:440-455's mid-size grow/prune loop
LOOP_ROWS, LOOP_BATCH = 512, 256
DISTILL_TOL = 1e-4  # the tree's univariate marginals against the flagship's


def _host_peak_gb() -> float:
    """This process's peak resident host memory so far, in GB (Linux gives
    ``ru_maxrss`` in KiB)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def _structure_step(label: str, fn, launches: dict[str, int], tag: str = "structure"):
    """Run ``fn`` once from zeroed counts, adding its launches into
    ``launches``; returns (result, seconds, device peak GB above the memory
    in use before, the launches of this step). ``tag`` heads the line."""
    import torch

    from cirkit_tpu_torch.ops import lse_einsum as L

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    step = {op: n for op, n in L.LAUNCHES.items() if n}
    for op, n in step.items():
        launches[op] = launches.get(op, 0) + n
    print(f"[{tag}] {label}: {sec:.2f} s, device peak {peak:.2f} GB above the stores, "
          f"host peak RSS so far {_host_peak_gb():.1f} GB, launches {step}")
    return out, sec, peak, step


def _fresh_forward(sc, x, *, optimize: bool = True):
    """``sc`` compiled in a new context on the card (its constants become
    the store) and evaluated on ``x``: (ctx, cc, out)."""
    import torch

    from cirkit_tpu_torch.pipeline import PipelineContext

    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=optimize, device=DEV)
    cc = ctx.compile(sc)
    with torch.inference_mode():
        out = cc(x)
    return ctx, cc, out


def _held_rtol(label: str, got, want, rtol: float, tag: str = "structure") -> float:
    """``got`` finite, of ``want``'s shape and within ``rtol`` of it
    elementwise; returns the worst relative error."""
    import torch

    got, want = got.double().cpu(), want.double().cpu()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"[{tag}] {label}: {tuple(got.shape)} or not finite")
    rel = float(((got - want).abs() / want.abs()).max())
    if not rel <= rtol:
        raise AssertionError(f"[{tag}] {label}: max relative error {rel:.3e} > {rtol}")
    return rel


def _spanning_tree(edges, variables) -> bool:
    parent = {v: v for v in variables}

    def find(v):
        while parent[v] != v:
            parent[v] = parent[parent[v]]
            v = parent[v]
        return v

    for u, v in edges:
        ru, rv = find(u), find(v)
        if ru == rv:
            return False
        parent[ru] = rv
    return len(edges) == len(variables) - 1


def phase_structure(smi: str, built: list) -> dict[str, int]:
    """Phase 13: structure search on phase 4's K=64 Tucker flagship (softmax
    weights, lse-sum, folded, optimized): (1) the lossless rebuilds
    (``prune_circuit(threshold=0)``, ``grow_circuit(noise=0,
    fraction=0.5)``) recompiled in fresh contexts against the original's
    log-likelihood at batch 128; (2) README's ``fraction=0.5`` prune
    data-free and by the usage flows of ``STRUCT_ROWS`` seeded rows, the
    pruned forward against float64 on the CPU; (3) ``distill_tree`` over all
    784 variables, its log Z, univariate marginals and edges; (4)
    ``grow_prune_loop`` at ``bench.py:440-455``'s mid-size configuration
    with a checkpoint directory, resumed from its stage-2 checkpoint to the
    uninterrupted history, and a ``save_circuit``/``load_circuit`` round
    trip of the pruned flagship. Returns each kernel's launches."""
    import numpy as np
    import torch

    from cirkit_tpu_torch.backend.torch import (
        ExpectationQuery,
        distill_tree,
        grow_circuit,
        grow_prune_loop,
        prune_circuit,
    )
    from cirkit_tpu_torch.backend.torch.compiler import TorchCompiler
    from cirkit_tpu_torch.backend.torch.pruning import (
        _flow_importance,
        _materialize,
        _sibling_compile,
    )
    from cirkit_tpu_torch.pipeline import PipelineContext
    from cirkit_tpu_torch.utils.checkpoint import load_circuit, save_circuit

    _, _, sc, ctx, cc, n_kernel = next(b for b in built if b[:2] == ("tucker", False))
    store = ctx.parameters
    x_np = np.random.default_rng(0).integers(0, 256, (BATCH, 784))
    x = torch.as_tensor(x_np, device=DEV)
    with torch.inference_mode():
        base = cc(store, x)
    launches: dict[str, int] = {}
    work = REPO / "build" / "chip_smoke" / "structure"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)

    # ---- the readback alone: bytes and seconds ---------------------------
    values, rb_s, rb_peak, _ = _structure_step(
        "readback (_materialize, the unoptimized sibling)",
        lambda: _materialize(sc, ctx, dict(store)), launches)
    arrays = {}
    for v in values.values():
        for a in (v if isinstance(v, tuple) else (v,)):
            root = a if a.base is None else a.base
            arrays[id(root)] = root
    rb_bytes = sum(a.nbytes for a in arrays.values())
    del values, arrays
    print(f"[structure] readback: {rb_bytes / 1e9:.3f} GB in {rb_s:.2f} s "
          f"({rb_bytes / 1e9 / rb_s:.2f} GB/s) ({smi})")

    # ---- (1) lossless rebuilds -------------------------------------------
    (lossless, rep), t_p0, _, _ = _structure_step(
        "prune_circuit(threshold=0.0)", lambda: prune_circuit(sc, ctx=ctx, threshold=0.0),
        launches)
    if rep["units_after"] != rep["units_before"]:
        raise AssertionError(f"[structure] threshold 0 kept {rep['units_after']} of "
                             f"{rep['units_before']} units")
    (_, cc0, out0), _, _, step = _structure_step(
        "threshold-0 prune compiled fresh, forward", lambda: _fresh_forward(lossless, x),
        launches)
    rel0 = _held_rtol("threshold-0 prune", out0, base, RTOL)
    del lossless, cc0, out0
    (grown, grep), t_g, _, _ = _structure_step(
        "grow_circuit(noise=0.0, fraction=0.5)",
        lambda: grow_circuit(sc, ctx=ctx, noise=0.0, fraction=0.5), launches)
    (_, ccg, outg), _, g_peak, step = _structure_step(
        "grown circuit compiled fresh, forward", lambda: _fresh_forward(grown, x), launches)
    relg = _held_rtol("noise-0 grow", outg, base, RTOL)
    if not step.get("lse_tucker2_chunked"):
        raise AssertionError(f"[structure] the grown forward launched no kernel 5: {step}")
    widths = sorted({l.num_input_units for l in grown.layers
                     if type(l).__name__ == "KroneckerLayer"})
    with torch.inference_mode():
        g_ms = _median_ms(lambda: ccg(x), warmup=2, iters=10)
    del grown, ccg, outg
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[structure] (1) lossless: threshold-0 prune {t_p0:.2f} s, forward max rel err "
          f"{rel0:.2e}; noise-0 grow {t_g:.2f} s, {grep['units_before']} -> "
          f"{grep['units_after']} units, Kronecker digit widths {widths}, forward max rel err "
          f"{relg:.2e}, {g_ms:.3f} ms median of 10 ({smi})")

    # ---- (2) README's fraction=0.5 prune, both ways ---------------------
    (pruned, prep), t_pf, _, _ = _structure_step(
        "prune_circuit(fraction=0.5), data-free",
        lambda: prune_circuit(sc, ctx=ctx, fraction=0.5), launches)
    rows = np.random.default_rng(1).integers(0, 256, (STRUCT_ROWS, 784))
    (pruned_d, drep), t_pd, d_peak, step = _structure_step(
        f"prune_circuit(fraction=0.5, data={STRUCT_ROWS} rows, batch_size={STRUCT_BATCH})",
        lambda: prune_circuit(sc, ctx=ctx, fraction=0.5, data=rows, batch_size=STRUCT_BATCH),
        launches)
    if not (step.get("lse_matmul") and step.get("lse_matmul_bwd")):
        raise AssertionError(f"[structure] the flows launched no dense kernel 1 and 2: {step}")
    sib = _sibling_compile(sc, ctx)
    _, t_fl, fl_peak, _ = _structure_step(
        "the usage flows alone (_flow_importance, sibling compiled)",
        lambda: _flow_importance(sc, ctx, dict(store), rows, STRUCT_BATCH, sib=sib), launches)
    del sib
    n_batches = -(-STRUCT_ROWS // STRUCT_BATCH)
    print(f"[structure] usage flows: {n_batches} batches of {STRUCT_BATCH} in {t_fl:.3f} s = "
          f"{t_fl / n_batches * 1e3:.1f} ms a batch (a forward and a dx-only backward of the "
          f"unoptimized flagship), device peak {fl_peak:.2f} GB ({smi})")
    for label, r in (("data-free", prep), ("data", drep)):
        if not r["units_after"] < r["units_before"]:
            raise AssertionError(f"[structure] the {label} prune kept every unit")
    ctxp, ccp, outp = _fresh_forward(pruned, x)
    cc64 = TorchCompiler(semiring="lse-sum", fold=True, optimize=True,
                         device="cpu").compile(pruned)
    st64 = {s: v.detach().cpu().double() for s, v in ctxp.parameters.items()}
    with torch.inference_mode():
        ref = cc64(st64, torch.as_tensor(x_np[:QUERY_ROWS]))
    relp = _held_rtol("pruned forward against float64", outp[:QUERY_ROWS], ref, RTOL)
    with torch.inference_mode():
        p_ms = _median_ms(lambda: ccp(x))
    del cc64, st64
    print(f"[structure] (2) fraction 0.5: data-free {prep['units_before']} -> "
          f"{prep['units_after']} units in {t_pf:.2f} s; by the flows of {STRUCT_ROWS} rows "
          f"{drep['units_before']} -> {drep['units_after']} units in {t_pd:.2f} s (peak "
          f"{d_peak:.2f} GB); pruned forward {p_ms:.3f} ms median of 20 (the flagship's in "
          f"phase 4), 8 rows against float64 max rel err {relp:.2e}, mean log-likelihood "
          f"{float(outp.mean()):.3f} against {float(base.mean()):.3f} ({smi})")
    # the pruned flagship through save_circuit / load_circuit
    save_circuit(work / "pruned.ckpt", pruned)
    _, _, outl = _fresh_forward(load_circuit(work / "pruned.ckpt"), x)
    if not torch.equal(outl, outp):
        raise AssertionError("[structure] the reloaded pruned circuit's forward differs")
    size = (work / "pruned.ckpt").stat().st_size / 1e6
    print(f"[structure] save_circuit/load_circuit of the pruned flagship: {size:.1f} MB, "
          f"forward equal to the bit")
    del pruned, pruned_d, ctxp, ccp, outp, outl
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (3) distill_tree over all 784 variables ---------------------------
    (tree, trep), t_d, t_peak, step = _structure_step(
        "distill_tree (784 variables, 256 states)", lambda: distill_tree(cc, store=store),
        launches)
    if not _spanning_tree(trep["edges"], range(784)):
        raise AssertionError("[structure] the distilled edges are not a spanning tree")
    ctxt = PipelineContext(semiring="lse-sum", fold=True, optimize=True, device=DEV)
    cct = ctxt.compile(tree)
    ccz = ctxt.integrate(cct)
    with torch.inference_mode():
        logz = float(ccz(batch_size=1)[0, 0, 0])
    if not abs(logz) <= RTOL:
        raise AssertionError(f"[structure] the tree's log Z = {logz:.3e}, not within {RTOL} of 0")
    zero = np.zeros((1, 784), dtype=np.int64)
    mask = np.zeros((1, 784), dtype=bool)
    m_tree = ExpectationQuery(cct).marginals(zero, evidence_mask=mask)[0]
    m_src = ExpectationQuery(cc).marginals(zero, evidence_mask=mask, store=store)[0]
    m_err = float((m_tree - m_src).abs().max())
    if not m_err <= DISTILL_TOL:
        raise AssertionError(f"[structure] tree marginals off the flagship's by {m_err:.3e}")
    depth = {0: 0}
    kids: dict[int, list[int]] = {}
    for p, c in trep["edges"]:
        kids.setdefault(p, []).append(c)
    stack = [trep["root"]]
    while stack:
        v = stack.pop()
        for c in kids.get(v, []):
            depth[c] = depth[v] + 1
            stack.append(c)
    print(f"[structure] (3) distill_tree: {t_d:.2f} s (peak {t_peak:.2f} GB), 783 edges "
          f"spanning 784 variables, depth {max(depth.values())}, {len(kids)} parents, "
          f"mi_objective {trep['mi_objective']:.4f} nats, tree {trep['units']} units; log Z "
          f"{logz:.2e}; univariate marginals max |tree - flagship| {m_err:.2e} ({smi})")
    del tree, ctxt, cct, ccz, m_tree, m_src
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (4) the grow/prune loop at bench.py's mid-size configuration -----
    lsc = _flagship_circuit("tucker", True, LOOP_K, side=LOOP_SIDE)
    data = np.random.default_rng(0).integers(0, 256, size=(LOOP_ROWS, LOOP_SIDE ** 2))
    kw = dict(rounds=1, grow_fraction=0.25, prune_fraction=0.25, em_epochs=2,
              batch_size=LOOP_BATCH)

    def loop(checkpoint_dir, **extra):
        lctx = PipelineContext(semiring="lse-sum", fold=True, device=DEV)
        lctx.compile(lsc)
        return grow_prune_loop(lsc, data, ctx=lctx, checkpoint_dir=str(checkpoint_dir),
                               **{**kw, **extra})

    (_, best_store, history), t_loop, l_peak, _ = _structure_step(
        "grow_prune_loop (1,8,8) K=16, one round", lambda: loop(work / "loop"), launches)
    if [h[0] for h in history] != ["init", "grow@0", "prune@0"]:
        raise AssertionError(f"[structure] loop history {history}")
    if not all(np.isfinite(h[2]) for h in history):
        raise AssertionError(f"[structure] loop log-likelihoods not finite: {history}")
    # stopped after its grow stage: the skipped prune stage writes no checkpoint
    loop(work / "resume", prune_fraction=0.0)
    if (work / "resume" / "LATEST").read_text() != "2":
        raise AssertionError("[structure] the interrupted loop did not stop at stage 2")
    (_, res_store, resumed), t_res, _, _ = _structure_step(
        "grow_prune_loop resumed from its stage-2 checkpoint",
        lambda: loop(work / "resume", resume=True), launches)
    same = resumed == history and set(res_store) == set(best_store) and all(
        torch.equal(res_store[s], best_store[s]) for s in best_store)
    if not same:
        raise AssertionError(f"[structure] resumed history {resumed} against {history}")
    print(f"[structure] (4) grow_prune_loop: {t_loop:.2f} s (peak {l_peak:.2f} GB), history "
          + ", ".join(f"{s} {u} units LL {ll:.4f}" for s, u, ll in history)
          + f"; resumed from stage 2 in {t_res:.2f} s, history and best store equal to the bit "
          f"({smi})")
    shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[structure] launches of phase 13: {launches}")
    return launches


# --------------------------------------------------------------------------- #
# Quadrature PCs, ensembles and the interop formats (phase 14)
# --------------------------------------------------------------------------- #

QPC_NET_DIM = 64  # bench_qpc's integral networks (bench.py:581-626), leggauss
QPC_LR = 5e-3  # optax.adam(5e-3) of tests/backend/test_pic.py
QPC_STEPS = 10
# Each generated weight row's sum against 1: the quadrature normalizer is an
# f32 sum over the row's 4096 (Tucker) or 64 (sum) mesh points.
QPC_NORM_TOL = 1e-5
# log Z against 0, of the QPC and of the ensembles' mixtures: every unit of
# these circuits is normalized, so log Z is 0 up to the f32 rounding of the
# leaves' softmax and of each of the 15 sum entries' sums of exponentials
# (4096 terms at a Tucker entry), some 1e-6 an entry.
LOGZ_TOL = 1e-4
ENS_TRAIN, ENS_VALID, ENS_DRAW = 2048, 512, 512  # rows of phase 4's sampler, drawn 512 a call
ENS_SEED = 0
ENS_ROWS = 128  # the validation rows of the served-blend check and the forward's time
JPC_FEATURES, JPC_K = 64, 16  # the binary tabular circuit of the .jpc round trip
UAI_VARS = 24  # the seeded Markov network of load_uai


def _uai_network(seed: int, n: int, max_card: int = 3):
    """A seeded Markov network as ``tests/models/test_interop.py``'s
    ``_uai_case`` draws it (n factors over 1-3 variables, tables uniform on
    [0.05, 2]), and its UAI text."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cards = list(rng.integers(2, max_card + 1, size=n))
    scopes = [tuple(rng.choice(n, size=int(rng.integers(1, 4)), replace=False))
              for _ in range(n)]
    tables = [rng.uniform(0.05, 2.0, size=[cards[v] for v in sc]) for sc in scopes]
    parts = ["MARKOV", str(n), " ".join(map(str, cards)), str(len(scopes))]
    parts += [f"{len(s)} " + " ".join(map(str, s)) for s in scopes]
    for t in tables:
        parts += [str(t.size), " ".join(repr(float(v)) for v in t.reshape(-1))]
    return cards, "\n".join(parts) + "\n"


def _ensemble_checks(label: str, res, valid, smi: str, stage_s: list[float]) -> None:
    """``stage_lls`` non-decreasing; the served circuit's log-likelihood of
    ENS_ROWS validation rows the blend (the logaddexp of the components'
    normalized log-likelihoods with the returned weights) within RTOL, and
    its log Z within LOGZ_TOL of 0; prints the stages and the forward's ms."""
    import numpy as np
    import torch

    from cirkit_tpu_torch.models import ensembles as E

    lls = res.stage_lls
    if not all(np.isfinite(lls)) or any(b < a for a, b in zip(lls, lls[1:])):
        raise AssertionError(f"[ensembles] {label}: stage_lls {lls}")
    rows = valid[:ENS_ROWS]
    per = np.stack([E._per_sample_ll(c, res.store, rows, ENS_ROWS) for c in res.components])
    want = np.logaddexp.reduce(per + np.log(res.weights)[:, None], axis=0)
    xv = torch.as_tensor(rows, device=DEV)
    logz = E._component_log_z(res.circuit, res.store, rows)
    with torch.inference_mode():
        got = res.circuit(res.store, xv)[:, 0, 0].double().cpu().numpy()
        ms = _median_ms(lambda: res.circuit(res.store, xv), warmup=2, iters=10)
    rel = float(np.max(np.abs(got - logz - want) / np.abs(want)))
    if not rel <= RTOL or not abs(logz) <= LOGZ_TOL:
        raise AssertionError(f"[ensembles] {label}: served circuit off the blend by {rel:.3e} "
                             f"(bound {RTOL}), log Z {logz:.3e} (bound {LOGZ_TOL})")
    print(f"[ensembles] {label}: {len(stage_s)} stages in "
          + ", ".join(f"{s:.2f}" for s in stage_s) + f" s, {len(res.components)} accepted, "
          f"weights {np.round(res.weights, 4).tolist()}, stage LLs "
          f"{[round(v, 3) for v in lls]}; served circuit on {ENS_ROWS} validation rows within "
          f"{rel:.2e} of the blend, log Z {logz:.2e}; forward {ms:.3f} ms median of 10 at "
          f"batch {ENS_ROWS} ({smi})")


def phase_qpc(smi: str, built: list) -> dict[str, int]:
    """Phase 14, on phase 4's K=64 Tucker flagship (softmax weights,
    lse-sum, folded, optimized): (1) ``pc2qpc`` at ``bench_qpc``'s
    configuration, its generated weights normalized, log Z, 8 rows against
    float64 on the CPU, the original's forward unchanged, QPC_STEPS counted
    Adam steps into the integral networks (their gradients on 8 rows against
    float64), the step's time, peak and device split; (2) ``boost_mixture``
    of three K=64 CP flagships (Adam) and ``bag_mixture`` of two EM-ready
    K=64 Tucker flagships (EM) on rows drawn from the flagship, each serving
    its exact blend; (3) a ``.jpc`` round trip of a binary tabular circuit
    after ``fit_em`` and ``load_uai`` of a seeded Markov network, against the
    original and float64 on the CPU. Returns each kernel's launches."""
    import numpy as np
    import torch

    from cirkit_tpu_torch.backend.torch import IntegrateQuery, SamplingQuery
    from cirkit_tpu_torch.backend.torch.pic import load_net_params, pc2qpc
    from cirkit_tpu_torch.models import (
        bag_mixture,
        boost_mixture,
        load_jpc,
        load_uai,
        save_jpc,
        tabular_data,
    )
    from cirkit_tpu_torch.models import ensembles as E
    from cirkit_tpu_torch.parallel import fit_em
    from cirkit_tpu_torch.pipeline import PipelineContext
    from cirkit_tpu_torch.utils import Scope

    _, _, sc, ctx, cc, _ = next(b for b in built if b[:2] == ("tucker", False))
    st = ctx.parameters
    x_np = np.random.default_rng(0).integers(0, 256, (BATCH, 784))  # bench_qpc's rows
    x = torch.as_tensor(x_np, device=DEV)
    r = QUERY_ROWS
    launches: dict[str, int] = {}
    work = REPO / "build" / "chip_smoke" / "interop"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)

    # ---- (1) the quadrature PC at bench_qpc's configuration -----------------
    with torch.inference_mode():
        base = cc(st, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qpc, qp = pc2qpc(cc, st, integration_method="leggauss", seed=0, net_dim=QPC_NET_DIM)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    with torch.inference_mode():
        if not torch.equal(cc(st, x), base):
            raise AssertionError("[qpc] pc2qpc changed the original flagship's forward")
        store = qp.materialize()
        mat_ms = _median_ms(qp.materialize, warmup=1, iters=5)
    n_net = sum(p.numel() for p in qp.parameters())
    norm_err = 0.0
    for s in qp.nets:
        if s.endswith("_qpc"):
            w = store[s]
            if not bool((w >= 0).all()):
                raise AssertionError(f"[qpc] generated weight {s} has negative entries")
            norm_err = max(norm_err, float((w.double().sum(dim=-1) - 1).abs().max()))
    if not norm_err <= QPC_NORM_TOL:
        raise AssertionError(f"[qpc] generated rows sum to 1 within {norm_err:.3e}, "
                             f"not {QPC_NORM_TOL}")
    logz = float(IntegrateQuery(qpc)(x_np[:1], integrate_vars=Scope(qpc.scope),
                                     store=store).reshape(-1)[0])
    if not abs(logz) <= LOGZ_TOL:
        raise AssertionError(f"[qpc] log Z {logz:.3e}, not within {LOGZ_TOL} of 0")
    with torch.inference_mode():
        out = qpc(store, x)
    if out.shape != (BATCH, 1, 1) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"[qpc] forward {tuple(out.shape)} or not finite")
    # float64 on the CPU: the flagship compiled there, converted there, and
    # the card's materialized store and networks copied over
    t0 = time.perf_counter()
    cc64, st64 = _f64_reference("tucker", False, store)
    del store
    qpc64, qp64 = pc2qpc(cc64, st64, integration_method="leggauss", net_dim=QPC_NET_DIM)
    load_net_params(qp64, {s: {n: p.detach().cpu().numpy() for n, p in net.named_parameters()}
                           for s, net in qp.nets.items()})
    with torch.inference_mode():
        ref = qpc64(st64, torch.as_tensor(x_np[:r]))
    rel = _held_rtol("QPC forward against float64", out[:r], ref, RTOL, tag="qpc")
    named = dict(qp.named_parameters())
    got = torch.autograd.grad(-qpc.evaluate(qp.materialize(), x[:r])[:, 0, 0].mean(),
                              list(named.values()))
    named64 = dict(qp64.named_parameters())
    refs = torch.autograd.grad(
        -qpc64.evaluate(qp64.materialize(), torch.as_tensor(x_np[:r]))[:, 0, 0].mean(),
        [named64[k] for k in named])
    worst = _check_grads("[qpc] the networks' gradients", dict(zip(named, got)),
                         dict(zip(named, refs)))
    f64_s = time.perf_counter() - t0
    del cc64, st64, qpc64, qp64, ref, got, refs, named64
    gc.collect()
    print(f"[qpc] pc2qpc(leggauss, net_dim={QPC_NET_DIM}) in {convert_s:.2f} s: {n_net} network "
          f"parameters for the flagship's {cc.num_parameters()}, {len(qp.nets)} networks; "
          f"materialize {mat_ms:.3f} ms median of 5; generated rows sum to 1 within "
          f"{norm_err:.2e}, log Z {logz:.2e}; {r} rows against float64 max rel err {rel:.2e}, "
          f"the networks' gradients within {worst:.3f} of the GRAD_* bound ({f64_s:.1f} s of "
          f"float64 on the CPU); the original flagship's forward unchanged to the bit ({smi})")

    fwd, bwd = _expected_launches(qpc)
    opt = torch.optim.Adam(qp.parameters(), lr=QPC_LR)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = -qpc.evaluate(qp.materialize(), x)[:, 0, 0].mean()
        loss.backward()
        opt.step()
        return loss.detach()

    losses = [float(_counted_launches(f"[qpc] Adam step {i}", step, {**fwd, **bwd}, launches))
              for i in range(QPC_STEPS)]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[qpc] losses {losses} not finite and decreasing")
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_ms = _median_ms(step, warmup=3, iters=10)
    peak = (torch.cuda.max_memory_allocated() - mem0) / 1e9
    split = _kernel_split(step, calls=3)
    print(f"[qpc] {QPC_STEPS} Adam(lr={QPC_LR}) steps at batch {BATCH}, launches a step "
          f"{fwd} forward and {bwd} backward; NLL {losses[0]:.3f} -> {losses[-1]:.3f}; step "
          f"{step_ms:.3f} ms median of 10 = qpc_samples_per_sec {BATCH / step_ms * 1e3:.1f}, "
          f"device peak {peak:.2f} GB above the stores; a step's {split} ({smi})")
    del qpc, qp, opt, step, out, base
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (2) boosted and bagged ensembles of K=64 flagships ----------------
    sq = SamplingQuery(cc)
    gen = torch.Generator(device=DEV).manual_seed(ENS_SEED)

    def draw():
        parts = [sq(ENS_DRAW, generator=gen, store=st)[0]
                 for _ in range((ENS_TRAIN + ENS_VALID) // ENS_DRAW)]
        return torch.cat(parts).long().cpu().numpy()

    rows, t_draw, _, _ = _structure_step(
        f"{ENS_TRAIN + ENS_VALID} rows drawn by SamplingQuery from the Tucker flagship", draw,
        launches, tag="ensembles")
    if rows.min() < 0 or rows.max() > 255:
        raise AssertionError("[ensembles] drawn states out of range")
    train, valid = rows[:ENS_TRAIN], rows[ENS_TRAIN:]

    def staged(spl: str, em: bool, marks: list):
        def make(t):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            return _flagship_circuit(spl, em, FLAGSHIP_K)
        return make

    def seconds(marks: list) -> list[float]:
        torch.cuda.synchronize()
        ends = marks[1:] + [time.perf_counter()]
        return [b - a for a, b in zip(marks, ends)]

    def boost(marks):
        bctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True, device=DEV, seed=0)
        res = boost_mixture(staged("cp", False, marks), train, ctx=bctx, num_stages=3,
                            method="adam", num_epochs=2, batch_size=256, valid_data=valid,
                            seed=ENS_SEED)
        return res, seconds(marks)

    (res, stage_s), _, b_peak, _ = _structure_step(
        "boost_mixture of 3 K=64 CP flagships (adam, 2 epochs, batch 256)",
        lambda: boost([]), launches, tag="ensembles")
    _ensemble_checks("boosting", res, valid, smi, stage_s)
    del res
    gc.collect()
    torch.cuda.empty_cache()

    counts: list[np.ndarray] = []
    train_component = E._train_component

    def spy(cc_, ctx_, data, sample_weight, *args, **kw):
        counts.append(np.asarray(sample_weight))
        return train_component(cc_, ctx_, data, sample_weight, *args, **kw)

    def bag(marks):
        gctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True, device=DEV, seed=0)
        E._train_component = spy
        try:
            res = bag_mixture(staged("tucker", True, marks), train, ctx=gctx, num_components=2,
                              method="em", num_epochs=1, batch_size=128, seed=ENS_SEED)
        finally:
            E._train_component = train_component
        return res, seconds(marks)

    (res, stage_s), _, g_peak, _ = _structure_step(
        "bag_mixture of 2 EM-ready K=64 Tucker flagships (em, 1 epoch, batch 128)",
        lambda: bag([]), launches, tag="ensembles")
    rng = np.random.default_rng([0, ENS_SEED])
    want = [rng.multinomial(ENS_TRAIN, np.full(ENS_TRAIN, 1.0 / ENS_TRAIN)) for _ in counts]
    if len(counts) != 2 or not all(np.array_equal(c, w) for c, w in zip(counts, want)):
        raise AssertionError("[ensembles] bagging's bootstrap counts are not "
                             "default_rng([0, seed]).multinomial's")
    _ensemble_checks("bagging", res, valid, smi, stage_s)
    print(f"[ensembles] bootstrap counts equal default_rng([0, {ENS_SEED}]).multinomial's; "
          f"device peaks above the stores: boosting {b_peak:.2f} GB, bagging {g_peak:.2f} GB")
    del res
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (3) interop: a .jpc round trip and load_uai -------------------------
    bsc = tabular_data("random-binary-tree", num_features=JPC_FEATURES,
                       input_layers={"name": "categorical", "args": {"num_categories": 2}},
                       num_input_units=JPC_K, sum_product_layer="cp", num_sum_units=JPC_K,
                       em_ready=True)
    bctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True, device=DEV, seed=0)
    bcc = bctx.compile(bsc)
    bin_rows = (train[:, :JPC_FEATURES] > 127).astype(np.int64)  # the drawn rows, binarized
    (trained, em_losses), t_em, _, _ = _structure_step(
        f"fit_em of the binary {JPC_FEATURES}-feature CP circuit (K={JPC_K}, 2 epochs)",
        lambda: fit_em(bcc, bin_rows, store=bctx.parameters, num_epochs=2, batch_size=256),
        launches, tag="interop")
    path = work / "binary.jpc"
    t0 = time.perf_counter()
    save_jpc(str(path), bsc, bctx, store=trained)
    back = load_jpc(str(path))
    t_io = time.perf_counter() - t0
    xb = torch.as_tensor(bin_rows[:ENS_ROWS], device=DEV)
    (_, _, got), _, _, _ = _structure_step(
        "the reloaded .jpc circuit compiled on the card, forward",
        lambda: _fresh_forward(back, xb), launches, tag="interop")
    with torch.inference_mode():
        want = bcc(trained, xb)
    rel_j = _held_rtol(".jpc round trip", got, want, RTOL, tag="interop")
    print(f"[interop] save_jpc + load_jpc of the fit_em-trained circuit ({em_losses[-1]:.4f} "
          f"NLL): {path.stat().st_size / 1e3:.1f} kB, {len(back.layers)} scalar layers, "
          f"{t_io:.2f} s; the reloaded forward on {ENS_ROWS} rows within {rel_j:.2e} of the "
          f"original ({smi})")
    del bcc, bctx, trained, back, got, want

    cards, text = _uai_network(UAI_VARS, UAI_VARS)
    upath = work / "markov.uai"
    upath.write_text(text)
    xu = np.stack([np.random.default_rng(3).integers(0, c, ENS_ROWS) for c in cards], axis=1)

    def uai_run(device: str):
        uctx = PipelineContext(semiring="lse-sum", fold=True, device=device)
        ucc = uctx.compile(load_uai(str(upath)))
        with torch.inference_mode():
            vals = ucc(torch.as_tensor(xu, device=device))[:, 0, 0]
        z = IntegrateQuery(ucc)(xu[:1], integrate_vars=Scope(ucc.scope)).reshape(-1)
        return ucc, vals, z

    (ucc, vals, z), t_u, _, _ = _structure_step(
        f"load_uai of a seeded {UAI_VARS}-variable Markov network, compiled on the card, "
        f"{ENS_ROWS} rows and log Z", lambda: uai_run(DEV), launches, tag="interop")
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        _, vals64, z64 = uai_run("cpu")
    finally:
        torch.set_default_dtype(old)
    rel_u = max(_held_rtol("load_uai rows against float64", vals, vals64, RTOL, tag="interop"),
                _held_rtol("load_uai log Z against float64", z, z64, RTOL, tag="interop"))
    print(f"[interop] load_uai: {len(ucc.layers)} plan entries, log Z {float(z[0]):.4f}; rows and "
          f"log Z within {rel_u:.2e} of float64 on the CPU ({smi})")
    shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[qpc] launches of phase 14: {launches}")
    return launches


# --------------------------------------------------------------------------- #
# The signed kernels (phase 3d), squared circuits (phase 9) and the
# flagships under the signed semiring (phase 9b)
# --------------------------------------------------------------------------- #


def _signed_cases(gen):
    """(op, make inputs, label) of phase 3d: the SoS TensorDot entry, the
    K=64 Tucker entry, dense mixing-sum entries, then the edge shapes. Signs
    are drawn from {-1, 0, +1}, weights from a normal (both signs), logits
    likewise; inputs are made when their case runs."""
    import torch

    dev = DEV
    inf = float("-inf")

    def make(op, f, b, widths, o, *edits, dtype=torch.float32):
        def build():
            ins = []
            for k in widths:
                ins += [torch.randn((f, b, k), generator=gen, device=dev) * 3.0 - 2.0,
                        torch.randint(-1, 2, (f, b, k), generator=gen, device=dev).float()]
            width = widths[0] * widths[-1] if "tucker" in op else widths[0]
            ins.append(torch.randn((f, o, width), generator=gen, device=dev))
            ins = [t.to(dtype) for t in ins]
            for t, idx, v in edits:
                ins[t][idx] = v
            return ins
        return build

    def cancel(op):
        """Equal magnitudes with alternating signs against equal weights: y
        is exactly 0, so log|y| = -inf and sign 0."""
        def build():
            alt = torch.tensor([1.0, -1.0], device=dev).repeat(8)
            if "tucker" in op:
                ins = [torch.zeros(1, 8, 4, device=dev), alt[:4].expand(1, 8, 4).contiguous(),
                       torch.zeros(1, 8, 4, device=dev), torch.ones(1, 8, 4, device=dev)]
            else:
                ins = [torch.zeros(1, 8, 16, device=dev), alt.expand(1, 8, 16).contiguous()]
            ins.append((torch.zeros if "softmax" in op else torch.ones)(1, 8, 16, device=dev))
            return ins
        return build

    b, row = BATCH, (0, (1, 5), inf)
    cases = [(op, make(op, 144, 32 * b, (32,), 32), "SoS entry F=144 B*Kq=4096 I=O=32")
             for op in ("slse_matmul", "slse_matmul_softmax")]
    cases += [(op, make(op, 784, b, (64, 64), 64), "F=784 B=128 K1=K2=O=64")
              for op in ("slse_tucker2", "slse_tucker2_softmax")]
    cases += [("slse_matmul_softmax", make("slse_matmul_softmax", 1568, b, (64,), 64),
               "mixing F=1568 B=128 I=O=64"),
              ("slse_matmul", make("slse_matmul", 196, b, (128,), 64),
               "mixing F=196 B=128 I=128 O=64")]
    # the SoS entry's edges for the dense dx tile and the batch-split dw (a
    # ragged batch, O = 1, I = 33), and a Tucker width past one block of the
    # dx kernel (the K1 split, from 202 in float32)
    cases += [("slse_matmul", make("slse_matmul", 144, 4000, (32,), 32, row),
               "SoS ragged B*Kq=4000, a row -inf"),
              ("slse_matmul_softmax", make("slse_matmul_softmax", 16, 32 * b, (33,), 1),
               "B*Kq=4096 I=33 O=1"),
              ("slse_tucker2", make("slse_tucker2", 2, 70, (208, 208), 5, row),
               "K1=K2=208 (the split dx), a row -inf")]
    # the narrow forward's route edges in both types, a row of fold 0 -inf
    for op in ("slse_matmul", "slse_matmul_softmax"):
        for dtype, tag in ((torch.float32, ""), (torch.float64, ", float64")):
            cases += [(op, make(op, f, bb, (i,), o, (0, (0, min(2, bb - 1)), inf), dtype=dtype),
                       f"narrow edge B={bb} I={i} O={o}{tag}") for f, bb, i, o in NARROW_EDGES]
    for op in SIGNED_OPS:
        tucker = "tucker" in op
        ws = (64, 64) if tucker else (64,)
        cases += [
            (op, make(op, 2, b, ws, 1), "O=1"),
            (op, make(op, 5, 13, (8, 16) if tucker else (64,), 16),
             "ragged B=13" + (" K1=8 K2=16" if tucker else "")),
            (op, make(op, 3, 16, ws, 64, row), "a row -inf"),
            (op, cancel(op), "exact cancellation"),
        ]
    return cases


def _signed_check(op: str, label: str, got, ref, ins,
                  tol: float = SIGNED_TOL) -> tuple[float, int]:
    """Phase 3d's forward bound: ``|s_k exp(a_k - A) - s_p exp(a_p - A)| <=
    tol`` with A the row's absolute mass, no NaN, -inf with sign 0
    where the mass is 0, and a sign that differs from the plain one only
    where ``|y| / Y_abs`` is under the bound. Returns the worst error and the
    number of signs that differ."""
    import torch

    from cirkit_tpu_torch.ops import lse_einsum as L

    (ga, gs), (pa, ps) = got, ref
    *xs, w = ins
    wabs = torch.softmax(w, dim=-1) if "softmax" in op else w.abs()
    mass = (L.lse_tucker2_ref(xs[0], xs[2], wabs) if "tucker" in op
            else L.lse_matmul_ref(xs[0], wabs))
    if ga.shape != pa.shape or gs.shape != ps.shape or torch.isnan(ga).any() \
            or torch.isnan(gs).any():
        raise AssertionError(f"{op} [{label}]: shape {tuple(ga.shape)} or NaN")
    empty = torch.isneginf(mass)
    if not (bool(torch.isneginf(ga[empty]).all()) and bool((gs[empty] == 0).all())):
        raise AssertionError(f"{op} [{label}]: a row of zero mass is not (-inf, 0)")
    lin_k = torch.where(empty, 0.0, gs * torch.exp(ga - mass))
    lin_p = torch.where(empty, 0.0, ps * torch.exp(pa - mass))
    max_err = float((lin_k - lin_p).abs().max())
    flips = gs != ps
    if not max_err <= tol or bool((flips & (lin_p.abs() > tol)).any()):
        raise AssertionError(f"{op} [{label}]: linear error {max_err:.3e} (bound {tol} "
                             f"of the row's absolute mass) or a sign differs above it")
    return max_err, int(flips.sum())


def _check_route(op: str, label: str, fn, i: int, o: int) -> str:
    """The forward kernel that ``fn`` launches (``torch.profiler``): the
    narrow one (``*_fwd_narrow``) exactly where I and O are at most 32.
    Returns its name. The trace spans 5 calls: a one-call trace of a
    microsecond kernel has come back empty on the card."""
    names = [key.removeprefix("void ").replace("(anonymous namespace)::", "").split("(")[0]
             for key in _profile(fn, 5)[1]]
    narrow = i <= 32 and o <= 32
    if len(names) != 1 or ("fwd_narrow" in names[0]) != narrow:
        raise AssertionError(f"{op} [{label}]: launched {names}, expected the "
                             f"{'narrow' if narrow else 'tiled'} kernel")
    return f"kernel {names[0]}"


def _signed_bound(key: str, ins) -> tuple[float, str, float]:
    """``_bound`` for the signed ops: the forward reads the (log-magnitude,
    sign) inputs and the weight and writes two outputs; the backward reads
    those, both outputs and g, and writes a gradient per log-magnitude input
    and the weight's, at twice the forward's FMA work."""
    *xs, w = ins
    f, b = xs[0].shape[:2]
    o, i = w.shape[1:]
    nbytes = sum(t.numel() * t.element_size() for t in ins)
    out = 4 * f * b * o
    flops = 2 * f * b * i * o
    if key.endswith("_bwd"):
        grads = sum(t.numel() * t.element_size() for t in (*xs[::2], w))
        ops, moved = 2 * flops, nbytes + 3 * out + grads
    else:
        ops, moved = flops, nbytes + 2 * out
    return (*_bound_of(ops, moved), _tc_bound(ops, moved))


def phase_signed() -> dict[str, dict]:
    """Phase 3d: every entry of the signed kernels, forward and backward,
    against its plain version; returns per-kernel results (times and bound
    of the first case of each)."""
    import torch

    from cirkit_tpu_torch.ops import slse_einsum as S

    gen = torch.Generator(device=DEV).manual_seed(3)
    results: dict[str, dict] = {}
    with torch.inference_mode():
        for op, make, label in _signed_cases(gen):
            ins = make()
            double = ins[0].dtype == torch.float64
            _, _, plain, plain_bwd = S._ENTRIES[op]
            got = getattr(S, op)(*ins)
            ref = plain(*ins)
            torch.cuda.synchronize()
            max_err, flips = _signed_check(op, label, got, ref, ins,
                                           F64_SIGNED_TOL if double else SIGNED_TOL)
            if label == "exact cancellation" and not all(
                    bool(torch.isneginf(a).all()) and bool((s_ == 0).all()) for a, s_ in (got, ref)):
                raise AssertionError(f"{op} [{label}]: not (-inf, sign 0)")
            again = getattr(S, op)(*ins)
            if not all(torch.equal(k, a) for k, a in zip(got, again)):
                raise AssertionError(f"{op} [{label}]: two calls differ")
            entry = results.setdefault(op, {"max_abs_err": 0.0, "sign_flips": 0})
            if not double:
                entry["max_abs_err"] = max(entry["max_abs_err"], max_err)
                entry["sign_flips"] += flips
            line = f"[signed] {op:22s} {label:36s} linear err {max_err:.3e}, {flips} signs differ"
            if label.startswith(("SoS entry", "narrow edge")):
                line += "; " + _check_route(op, label, lambda: getattr(S, op)(*ins),
                                            ins[0].shape[2], ins[-1].shape[1])
            if "ms" not in entry:
                entry["ms"] = _median_ms(lambda: getattr(S, op)(*ins))
                entry["plain_ms"] = _median_ms(lambda: plain(*ins))
                entry["bound_ms"], entry["bound_by"], entry["tc_bound_ms"] = _signed_bound(op, ins)
                line += (f"  kernel {entry['ms']:.3f} ms, plain {entry['plain_ms']:.3f} ms, "
                         f"bound {entry['bound_ms']:.3f} ms ({entry['bound_by']}), "
                         f"tensor-core bound {entry['tc_bound_ms']:.3f} ms")
            print(line)

            # the backward on the plain forward's outputs, with a cotangent
            # that is 0 on some rows
            oa, os_ = ref
            g = torch.randn(oa.shape, generator=gen, device=DEV, dtype=oa.dtype)
            g[0, : min(3, g.shape[1])] = 0.0
            bkey = f"{op}_bwd"
            rel = F64_BWD_REL if double else BWD_REL

            def kernel(ins=ins, oa=oa, os_=os_, g=g, op=op):
                return S.backward(op, tuple(ins), oa, os_, g)

            def plain_b(ins=ins, oa=oa, os_=os_, g=g, plain_bwd=plain_bwd):
                return plain_bwd(*ins, oa, os_, g, (True,) * len(ins))

            got_b, ref_b = kernel(), plain_b()
            torch.cuda.synchronize()
            names = ("da1", "ds1", "da2", "ds2", "dw") if len(ins) == 5 else ("da", "ds", "dw")
            max_err = 0.0
            for name, k, p in zip(names, got_b, ref_b):
                if k is None and p is None:  # the sign inputs get no gradient
                    continue
                if k.shape != p.shape or torch.isnan(k).any():
                    raise AssertionError(f"{bkey} [{label}] {name}: shape or NaN")
                if name != "dw" and not bool((k[p == 0] == 0).all()):
                    raise AssertionError(f"{bkey} [{label}] {name}: not 0 where the plain is 0")
                err = (k - p).abs()
                if not bool((err <= rel * (p.abs().max() + p.abs())).all()):
                    raise AssertionError(
                        f"{bkey} [{label}] {name}: max |kernel - plain| = {float(err.max()):.3e} "
                        f"(bound {rel} (max|plain| + |plain|), max|plain| "
                        f"{float(p.abs().max()):.3e})")
                max_err = max(max_err, float(err.max()))
            again = kernel()
            torch.cuda.synchronize()
            if not all(k is None or torch.equal(k, a) for k, a in zip(got_b, again)):
                raise AssertionError(f"{bkey} [{label}]: two calls differ")
            entry = results.setdefault(bkey, {"max_abs_err": 0.0})
            if not double:
                entry["max_abs_err"] = max(entry["max_abs_err"], max_err)
            line = f"[signed] {bkey:22s} {label:36s} max|err|={max_err:.3e}"
            if "ms" not in entry:
                entry.update(ms=_median_ms(kernel), plain_ms=_median_ms(plain_b))
                entry["bound_ms"], entry["bound_by"], entry["tc_bound_ms"] = _signed_bound(bkey, ins)
                line += (f"  kernel {entry['ms']:.3f} ms, plain {entry['plain_ms']:.3f} ms, "
                         f"bound {entry['bound_ms']:.3f} ms ({entry['bound_by']}), "
                         f"tensor-core bound {entry['tc_bound_ms']:.3f} ms")
            print(line)
            if label.startswith(("SoS entry", "F=784")):  # kernel 7's launches, one by one
                print(f"[signed] {bkey} split [{label}]: {_kernel_split(kernel)}")
            del again
            del ins, got, ref, got_b, ref_b, g
    return results


def _sos_circuit(side: int):
    """``bench.py:126-165``'s circuit (``bench_sos``) at ``side`` x ``side``."""
    from cirkit_tpu_torch.models import image_data
    from cirkit_tpu_torch.models.utils import Parameterization

    return image_data((1, side, side), "quad-tree-2", input_layer="categorical",
                      num_input_units=SOS_K, sum_product_layer="cp", num_sum_units=SOS_K,
                      sum_weight_param=Parameterization(activation="none", initialization="normal"))


def _counted_launches(label: str, fn, want: dict[str, int], launches: dict[str, int]):
    """Run ``fn`` once from zeroed counts; its launches must be ``want``, and
    they add into ``launches``."""
    import torch

    from cirkit_tpu_torch.ops import lse_einsum as L

    _zero_launches()
    out = fn()
    torch.cuda.synchronize()
    got = {op: n for op, n in L.LAUNCHES.items() if n}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")
    for op, n in got.items():
        launches[op] = launches.get(op, 0) + n
    return out


def phase_sos(smi: str) -> tuple[dict[str, int], dict]:
    """Phase 9: bench_sos's squared circuit under the signed semiring at each
    of SOS_SIDES, K=32, batch 128: the forwards of ``cc``, ``sq`` and
    ``zc``, the normalized log-likelihood, ``IntegrateQuery`` marginals and
    Adam steps on the SoS loss; returns each kernel's launches over the
    counted (main-path) calls, and per side the store, sq's log-magnitudes and
    log Z (phase 10 evaluates the same store under the complex semiring)."""
    import numpy as np
    import torch

    from cirkit_tpu_torch.backend.torch import IntegrateQuery
    from cirkit_tpu_torch.backend.torch.compiler import TorchCompiler
    from cirkit_tpu_torch.backend.torch.optimized import TorchTensorDotLayer
    from cirkit_tpu_torch.parallel import split_trainable
    from cirkit_tpu_torch.pipeline import PipelineContext

    launches: dict[str, int] = {}
    runs: dict[int, tuple] = {}
    for side in SOS_SIDES:
        label = f"[sos] {side}x{side} K={SOS_K}"
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()  # phase 4's stores, still held

        def peak_gb():
            return (torch.cuda.max_memory_allocated() - base) / 1e9

        t0 = time.perf_counter()
        ctx = PipelineContext(semiring="signed-lse-sum", fold=True, optimize=True, device=DEV,
                              seed=0)
        cc = ctx.compile(_sos_circuit(side))
        sq = ctx.multiply(ctx.conjugate(cc), cc)
        zc = ctx.integrate(sq)
        torch.cuda.synchronize()
        n_cc = sum(isinstance(l, _kernel_layers()) for l in cc.layers)
        n_sq, n_zc = (sum(isinstance(l, TorchTensorDotLayer) for l in c.layers) for c in (sq, zc))
        print(f"{label}: compiled cc, sq, zc in {time.perf_counter() - t0:.1f} s; "
              f"{cc.num_parameters()} parameters; plan entries {len(cc.layers)}, "
              f"{len(sq.layers)} ({n_sq} TensorDot), {len(zc.layers)} ({n_zc} TensorDot)")
        rng = np.random.default_rng(0)  # the batch and 50% mask of bench.py:222-224
        d = side * side
        x_np = rng.integers(0, 256, size=(BATCH, d), dtype=np.int32).astype(np.int64)
        mask_np = rng.random((BATCH, d)) < 0.5
        x, mask = torch.as_tensor(x_np, device=DEV), torch.as_tensor(mask_np, device=DEV)
        st = ctx.parameters
        iq = IntegrateQuery(sq)

        # The main-path run: each call once, counted.
        with torch.inference_mode():
            c_out = _counted_launches(f"{label} cc", lambda: cc(x), {"slse_matmul": n_cc},
                                      launches)
            s_out = _counted_launches(f"{label} sq", lambda: sq(x), {"slse_matmul": n_sq},
                                      launches)
            z_out = _counted_launches(f"{label} zc", lambda: zc(x[:1]), {"slse_matmul": n_zc},
                                      launches)
            m_out = _counted_launches(f"{label} marginals",
                                      lambda: iq(x, integrate_vars=mask, store=st),
                                      {"slse_matmul": n_sq}, launches)
        (ca, cs), (sa, ss), (za, zs), (ma, ms_) = c_out, s_out, z_out, m_out
        runs[side] = ({k: v.detach().clone() for k, v in st.items()}, sa, za)
        nll = sa[:, 0, 0] - za[0, 0, 0]
        id_rel = float(((sa - 2 * ca).abs() / sa.abs()).max())
        flips = int((ss != 1).sum())  # |c|^2 computed below 0 (see SOS_SQ_RTOL)
        checks = {
            "sq finite, (B, 1, 1)": sa.shape == (BATCH, 1, 1) and bool(sa.isfinite().all()),
            # |c|^2: twice the log-magnitude of c
            f"sq = 2 log|cc| (rel {SOS_SQ_RTOL})": id_rel <= SOS_SQ_RTOL,
            "sq signs nonzero": bool((ss != 0).all()),
            "log Z sign +1": bool((zs == 1).all()),
            "marginals finite, signs +1": bool(ma.isfinite().all()) and bool((ms_ == 1).all()),
            "normalized log-likelihood <= 1e-4": bool((nll <= 1e-4).all()),
        }
        bad = [name for name, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"{label}: failed {bad}")

        # QUERY_ROWS rows against the same store in float64 on the CPU,
        # compiled there with no store of its own (the same slot names)
        t0 = time.perf_counter()
        comp = TorchCompiler(semiring="signed-lse-sum", fold=True, optimize=True, device="cpu")
        cc64, sq64, zc64 = (comp.compile(ctx.get_symbolic_circuit(c)) for c in (cc, sq, zc))
        st64 = {s: v.detach().cpu().double() for s, v in st.items()}
        r = QUERY_ROWS
        xr, mr = torch.as_tensor(x_np[:r]), torch.as_tensor(mask_np[:r])
        with torch.inference_mode():
            want = {"sq": sq64(st64, xr), "log Z": zc64(st64, xr[:1]),
                    "marginals": IntegrateQuery(sq64)(xr, integrate_vars=mr, store=st64)}
        got = {"sq": (sa[:r], ss[:r]), "log Z": (za, zs), "marginals": (ma[:r], ms_[:r])}
        rels, f64_flips = {}, 0
        for name, (wa, ws) in want.items():
            ga, gs = (t.double().cpu() for t in got[name])
            rels[name] = float(((ga - wa).abs() / wa.abs()).max())
            rtol = SOS_SQ_RTOL if name == "sq" else 1e-5
            same_signs = name == "sq" or torch.equal(gs, ws)
            if not torch.allclose(ga, wa, rtol=rtol, atol=0.0) or not same_signs:
                raise AssertionError(f"{label}: {name} off float64 by {rels[name]:.3e} (rtol "
                                     f"{rtol}) or signs differ")
            if name == "sq":
                f64_flips = int((gs != ws).sum())
        print(f"{label}: sq = 2 log|cc| to {id_rel:.2e} relative, {flips} of {BATCH} signs not "
              f"+1; normalized log-likelihood {float(nll.mean()):.3f} mean (max "
              f"{float(nll.max()):.3e}), log Z {float(za[0, 0, 0]):.3f}; {r} rows against "
              f"float64 on the CPU ({time.perf_counter() - t0:.1f} s): "
              + ", ".join(f"{k} max rel err {v:.2e}" for k, v in rels.items())
              + f", sq signs differing {f64_flips}")

        with torch.inference_mode():
            times = {"sq forward": _median_ms(lambda: sq(x)),
                     "normalized log-likelihood": _median_ms(
                         lambda: sq(x)[0] - zc(x[:1])[0][0, 0, 0]),
                     "marginals": _median_ms(lambda: iq(x, integrate_vars=mask, store=st),
                                             iters=10)}
            profile = _device_breakdown(lambda: sq(x), 3)
        print(f"{label}: batch {BATCH}, " + ", ".join(
            f"{k} {v:.3f} ms ({BATCH / v * 1e3:.1f} rows/s)" for k, v in times.items())
            + f" (median of 20, 10 for the marginals); peak memory "
              f"{peak_gb():.2f} GB above phase 4's stores; sq forward profile: {profile} "
              f"({smi})")

        # The SoS loss -mean(log|c(x)|^2) + log Z, a user-level loop: the
        # gradients of cc's learnable slots against float64, then Adam steps
        def loss_fn(sq, zc, store, xb):
            return -sq.evaluate(store, xb)[0].mean() + zc.evaluate(store, xb[:1])[0][0, 0, 0]

        tr, _ = split_trainable(cc, st)
        fr = {k: v.detach() for k, v in st.items() if k not in tr}
        xg = x[:GRAD_ROWS]
        got = dict(zip(tr, torch.autograd.grad(loss_fn(sq, zc, {**tr, **fr}, xg),
                                               list(tr.values()))))
        tr64 = {k: st64[k].clone().requires_grad_() for k in tr}
        fr64 = {k: v for k, v in st64.items() if k not in tr}
        want = dict(zip(tr64, torch.autograd.grad(
            loss_fn(sq64, zc64, {**tr64, **fr64}, xr[:GRAD_ROWS]), list(tr64.values()))))
        worst = _check_grads(f"{label} gradients", got, want, strict=side == SOS_GRAD_SIDE)
        del cc64, sq64, zc64, st64, tr64, fr64, want, got

        torch.cuda.reset_peak_memory_stats()
        tr = {k: v.detach().clone().requires_grad_() for k, v in sorted(tr.items())}
        opt = torch.optim.Adam(list(tr.values()), lr=SOS_LR)

        def step():
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(sq, zc, {**tr, **fr}, x)
            loss.backward()
            opt.step()
            return loss.detach()

        want_step = {"slse_matmul": n_sq + n_zc, "slse_matmul_bwd": n_sq + n_zc}
        losses = [float(_counted_launches(f"{label} step", step, want_step, launches))
                  for _ in range(STEPS)]
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"{label}: losses {losses} not finite and decreasing")
        ms = _median_ms(step, warmup=3, iters=10)
        profile = _device_breakdown(step, 2)
        held = "held to" if side == SOS_GRAD_SIDE else "measured against"
        print(f"{label}: gradients of {len(tr)} learnable slots of cc on {GRAD_ROWS} rows "
              f"{held} float64, worst error {worst:.3f} of the bound {GRAD_REL} max|slot| + "
              f"{GRAD_ABS}; {STEPS} Adam({SOS_LR}) steps, "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; step {ms:.3f} ms median of 10 = "
              f"{BATCH / ms * 1e3:.1f} samples/s; peak memory "
              f"{peak_gb():.2f} GB; step profile: {profile} ({smi})")
        del ctx, cc, sq, zc, st, tr, fr, opt, iq
    return launches, runs


def phase_signed_flagships(smi: str, built: list) -> tuple[dict[str, int], dict]:
    """Phase 9b: phase 4's K=64 flagships (Tucker, CP and the EM-ready
    Tucker store) compiled under the signed semiring from the same symbolic
    circuits, with phase 4's lse-sum stores loaded by slot name: the forward
    against the lse-sum one, every sign +1, and one backward's gradients;
    returns each kernel's launches over the counted calls and each signed
    forward's median ms. The Tucker
    circuits run the Tucker configurations of the signed kernels, the CP
    circuit the softmax dense one."""
    import numpy as np
    import torch

    from cirkit_tpu_torch.pipeline import PipelineContext

    x = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (BATCH, 784)), device=DEV)
    launches: dict[str, int] = {}
    times: dict[tuple, float] = {}
    for spl, em, sc, ctx, cc, _ in built:
        label = f"[signed flagship] {spl} em_ready={em}"
        sctx = PipelineContext(semiring="signed-lse-sum", fold=True, optimize=True, device=DEV,
                               seed=0)
        scc = sctx.compile(sc)
        sctx.update_parameters(ctx.parameters)  # by slot name, sharing the tensors
        fwd, bwd = _expected_launches(scc, values="signed")
        st, sst = ctx.parameters, sctx.parameters
        with torch.inference_mode():
            ref = cc.evaluate(st, x)
            a, s = _counted_launches(f"{label} forward", lambda: scc.evaluate(sst, x), fwd,
                                     launches)
        rel = float(((a - ref).abs() / ref.abs()).max())
        if not (bool((s == 1).all()) and torch.allclose(a, ref, rtol=1e-5, atol=0.0)):
            raise AssertionError(f"{label}: forward off the lse-sum one by {rel:.3e}, or a "
                                 "sign not +1")
        want = dict(zip(st.keys(), torch.autograd.grad(-cc.evaluate(st, x).mean(),
                                                       list(st.values()))))

        def backward():
            loss = -scc.evaluate(sst, x)[0].mean()
            return dict(zip(sst.keys(), torch.autograd.grad(loss, list(sst.values()))))

        got = _counted_launches(f"{label} backward", backward, {**fwd, **bwd}, launches)
        worst = _check_grads(f"{label} gradients", got, want)
        with torch.inference_mode():
            ms = _median_ms(lambda: scc.evaluate(sst, x))
            ms_lse = _median_ms(lambda: cc.evaluate(st, x))
        times[spl, em] = ms
        print(f"{label}: launches a forward {fwd}, a backward {bwd}; forward equals lse-sum "
              f"(max rel err {rel:.2e}), signs +1; gradients of {len(want)} slots within "
              f"{worst:.3f} of the bound; forward {ms:.3f} ms signed, {ms_lse:.3f} ms lse-sum "
              f"(median of 20, batch {BATCH}) ({smi})")
        del sctx, scc, got, want, sst
    return launches, times


# --------------------------------------------------------------------------- #
# The complex kernels (phase 3e), the float64 instances (phase 3f), squared
# circuits under the complex semiring (phase 10) and the Tucker flagship
# under it (phase 10b)
# --------------------------------------------------------------------------- #


def _complex_cases(gen):
    """(op, make inputs, label, timed) of phase 3e: the SoS TensorDot entry,
    the K=64 Tucker entry with the real weights the flagship gives it and with
    complex ones, a dense mixing entry, the two largest in complex128, then
    the edge shapes in both types. Real parts are drawn as the lse cases',
    phases uniform in (-pi, pi], weights normal (complex, or real); inputs are
    made when their case runs."""
    import math

    import torch

    dev = DEV
    c64, c128 = torch.complex64, torch.complex128

    def make(op, f, b, widths, o, ctype, *edits, real_w=False):
        def build():
            real = torch.float64 if ctype == c128 else torch.float32

            def randn(*shape):
                return torch.randn(shape, generator=gen, device=dev, dtype=real)

            def value(*shape):
                phase = (torch.rand(shape, generator=gen, device=dev, dtype=real) * 2 - 1) * math.pi
                return torch.complex(randn(*shape) * 3.0 - 2.0, phase)

            ins = [value(f, b, k) for k in widths]
            shape = (f, o, widths[0] * widths[-1] if "tucker" in op else widths[0])
            ins.append(randn(*shape) if real_w else torch.complex(randn(*shape), randn(*shape)))
            for t, idx, v in edits:
                ins[t][idx] = v
            return ins
        return build

    def cancel(op, ctype):
        """Equal magnitudes of phase 0 against weights +1 and -1: y is exactly
        0, so the real part is -inf."""
        def build():
            n = 2 if "tucker" in op else 1
            ins = [torch.zeros(1, 8, 4 if n == 2 else 16, device=dev, dtype=ctype)
                   for _ in range(n)]
            alt = torch.tensor([1.0, -1.0], device=dev).repeat(8).to(ctype)
            return [*ins, alt.expand(1, 8, 16).contiguous()]
        return build

    b, row = BATCH, (0, (1, 5), complex(float("-inf"), 0.5))
    cases = [
        ("clse_matmul", make("clse_matmul", 144, 32 * b, (32,), 32, c64),
         "SoS entry F=144 B*Kq=4096 I=O=32", True),
        ("clse_tucker2", make("clse_tucker2", 784, b, (64, 64), 64, c64, real_w=True),
         "F=784 B=128 K1=K2=O=64, real w", True),
        ("clse_tucker2", make("clse_tucker2", 784, b, (64, 64), 64, c64),
         "F=784 B=128 K1=K2=O=64, complex w", True),
        ("clse_matmul", make("clse_matmul", 196, b, (128,), 64, c64, real_w=True),
         "mixing F=196 B=128 I=128 O=64, real w", True),
        ("clse_matmul", make("clse_matmul", 144, 32 * b, (32,), 32, c128),
         "SoS entry, complex128", True),
        ("clse_tucker2", make("clse_tucker2", 784, b, (64, 64), 64, c128, real_w=True),
         "F=784 B=128 K1=K2=O=64, real w, complex128", True),
        ("clse_matmul", make("clse_matmul", 144, 32 * b, (32,), 32, c64, real_w=True),
         "SoS entry, real w", True),
        # the SoS entry's edges for the dense dx tile and the batch-split dw,
        # and K1 = K2 = 128, past one block of the Tucker dx (the K1 split)
        ("clse_matmul", make("clse_matmul", 144, 4000, (32,), 32, c64, row),
         "SoS ragged B*Kq=4000, a row -inf", False),
        ("clse_matmul", make("clse_matmul", 16, 32 * b, (33,), 1, c64), "B*Kq=4096 I=33 O=1",
         False),
        ("clse_tucker2", make("clse_tucker2", 4, b, (128, 128), 32, c64, row),
         "K1=K2=128 (the split dx), a row -inf", False),
        ("clse_tucker2", make("clse_tucker2", 4, b, (128, 128), 32, c128, real_w=True),
         "K1=K2=128 (the split dx), real w, complex128", False),
    ]
    # the narrow forward's route edges, a row of fold 0 -inf
    for ctype, tag in ((c64, ""), (c128, ", complex128")):
        for real_w in (False, True):
            cases += [("clse_matmul",
                       make("clse_matmul", f, bb, (i,), o, ctype,
                            (0, (0, min(2, bb - 1)), complex(float("-inf"), 0.5)), real_w=real_w),
                       f"narrow edge B={bb} I={i} O={o}" + (", real w" if real_w else "") + tag,
                       False) for f, bb, i, o in NARROW_EDGES]
    for ctype, tag in ((c64, ""), (c128, ", complex128")):
        for op in COMPLEX_OPS:
            tucker = "tucker" in op
            ws = (64, 64) if tucker else (64,)
            small = (8, 16) if tucker else (64,)
            cases += [
                (op, make(op, 2, b, ws, 1, ctype), "O=1" + tag, False),
                (op, make(op, 5, 13, small, 70, ctype),
                 "B=13 O=70" + (" K1=8 K2=16" if tucker else "") + tag, False),
                (op, make(op, 3, 16, ws, 64, ctype, row), "a row -inf" + tag, False),
                (op, make(op, 3, 16, small, 16, ctype, real_w=True), "real w" + tag, False),
                (op, cancel(op, ctype), "exact cancellation" + tag, False),
            ]
    return cases


def _complex_mass(ins):
    """The log of each output row's absolute mass: the lse of the inputs' real
    parts against ``|w|``, the scale of the linear-space comparison."""
    from cirkit_tpu_torch.ops import lse_einsum as L

    *xs, w = ins
    res = [x.real.contiguous() for x in xs]
    return (L.lse_tucker2_ref if len(xs) == 2 else L.lse_matmul_ref)(*res, w.abs())


def _complex_check(op: str, label: str, got, ref, ins, tol: float) -> float:
    """Phase 3e's forward bound: ``|exp(out_k - A) - exp(out_p - A)| <= tol``
    on the real and on the imaginary part, with A the row's absolute mass; no
    NaN, and a real part of -inf where the mass is 0. Returns the worst error."""
    import torch

    mass = _complex_mass(ins)
    if got.shape != ref.shape or got.dtype != ref.dtype or torch.isnan(got.real).any() \
            or torch.isnan(got.imag).any():
        raise AssertionError(f"{op} [{label}]: shape {tuple(got.shape)}, {got.dtype} or NaN")
    empty = torch.isneginf(mass)
    if not bool(torch.isneginf(got.real[empty]).all()):
        raise AssertionError(f"{op} [{label}]: a row of zero mass is not -inf")
    diff = torch.where(empty, 0.0, torch.exp(got - mass) - torch.exp(ref - mass))
    max_err = float(torch.maximum(diff.real.abs(), diff.imag.abs()).max())
    if not max_err <= tol:
        raise AssertionError(f"{op} [{label}]: linear error {max_err:.3e} (bound {tol} of the "
                             "row's absolute mass)")
    return max_err


def _complex_bound(key: str, ins, peak: float = F32_PEAK) -> tuple[float, str, float | None]:
    """``_bound`` for the complex ops: a complex multiply-add is 4 real FMAs,
    2 against a real weight; the forward reads the inputs and writes the
    complex output, the backward also reads the output and g, writes a
    gradient per input and does two contractions. The tensor-core bound is
    None in complex128."""
    *xs, w = ins
    f, b = xs[0].shape[:2]
    o, i = w.shape[1:]
    nbytes = sum(t.numel() * t.element_size() for t in ins)
    out = xs[0].element_size() * f * b * o
    flops = (8 if w.is_complex() else 4) * f * b * i * o
    if key.endswith("_bwd"):
        flops, moved = 2 * flops, 2 * nbytes + 2 * out
    else:
        moved = nbytes + out
    t_ops, t_bytes = flops / peak * 1e3, moved / HBM_RATE * 1e3
    tc = _tc_bound(flops, moved) if peak == F32_PEAK else None
    return ((t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")) + (tc,)


def _planes(t):
    """The real tensors a gradient is made of: itself, or its two planes."""
    return ((t.real, "re"), (t.imag, "im")) if t.is_complex() else ((t, ""),)


def _check_backward(bkey: str, label: str, names, got, ref, rel: float) -> float:
    """Each gradient (each plane of a complex one) within ``rel (max|plain| +
    |plain|)`` of the plain version's, no NaN, and the input gradients 0
    where the plain ones are; returns the worst absolute error."""
    import torch

    worst = 0.0
    for name, k, p in zip(names, got, ref):
        if k.shape != p.shape or k.dtype != p.dtype:
            raise AssertionError(f"{bkey} [{label}] {name}: {tuple(k.shape)} {k.dtype}")
        scale = p.abs().max()
        for (kp, tag), (pp, _) in zip(_planes(k), _planes(p)):
            if torch.isnan(kp).any():
                raise AssertionError(f"{bkey} [{label}] {name}{tag}: NaN")
            if name != "dw" and not bool((kp[pp == 0] == 0).all()):
                raise AssertionError(f"{bkey} [{label}] {name}{tag}: not 0 where the plain is 0")
            err = (kp - pp).abs()
            if not bool((err <= rel * (scale + pp.abs())).all()):
                raise AssertionError(
                    f"{bkey} [{label}] {name}{tag}: max |kernel - plain| = {float(err.max()):.3e} "
                    f"(bound {rel} (max|plain| + |plain|), max|plain| {float(scale):.3e})")
            worst = max(worst, float(err.max()))
    return worst


def phase_complex() -> dict[str, dict]:
    """Phase 3e: the complex kernels, forward and backward, against their
    plain versions; returns per-kernel results (times and bound of the first
    case of each: the SoS entry for ``clse_matmul``, the K=64 Tucker entry
    with real weights, as the flagship gives it, for ``clse_tucker2``)."""
    import torch

    from cirkit_tpu_torch.ops import clse_einsum as C

    gen = torch.Generator(device=DEV).manual_seed(4)
    results: dict[str, dict] = {}
    with torch.inference_mode():
        for op, make, label, timed in _complex_cases(gen):
            ins = make()
            ctype = str(ins[0].dtype).removeprefix("torch.")
            tol, rel = COMPLEX_TOL[ctype]
            peak = F64_PEAK if ctype == "complex128" else F32_PEAK
            plain, plain_bwd = C._ENTRIES[op]
            got = getattr(C, op)(*ins)
            ref = plain(*ins)
            torch.cuda.synchronize()
            max_err = _complex_check(op, label, got, ref, ins, tol)
            if label.startswith("exact cancellation") and not bool(
                    torch.isneginf(got.real).all() & torch.isneginf(ref.real).all()):
                raise AssertionError(f"{op} [{label}]: real part not -inf")
            if not torch.equal(got, getattr(C, op)(*ins)):
                raise AssertionError(f"{op} [{label}]: two calls differ")
            entry = results.setdefault(op, {"max_abs_err": 0.0})
            if ctype == "complex64":
                entry["max_abs_err"] = max(entry["max_abs_err"], max_err)
            line = f"[complex] {op:16s} {label:44s} linear err {max_err:.3e}"
            if op == "clse_matmul" and label.startswith(("SoS entry", "narrow edge")):
                line += "; " + _check_route(op, label, lambda: getattr(C, op)(*ins),
                                            ins[0].shape[2], ins[-1].shape[1])
            if timed:
                ms = _median_ms(lambda: getattr(C, op)(*ins))
                plain_ms = _median_ms(lambda: plain(*ins))
                bound_ms, bound_by, tc_ms = _complex_bound(op, ins, peak)
                if "ms" not in entry:
                    entry.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                 tc_bound_ms=tc_ms)
                line += (f"  kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} "
                         f"ms ({bound_by})"
                         + ("" if tc_ms is None else f", tensor-core bound {tc_ms:.3f} ms"))
            print(line)

            # the backward on the plain forward's output, with a cotangent that
            # is 0 on some rows
            real = ref.real.dtype
            g = torch.complex(*(torch.randn(ref.shape, generator=gen, device=DEV, dtype=real)
                                for _ in range(2)))
            g[0, : min(3, g.shape[1])] = 0.0
            bkey = f"{op}_bwd"

            def kernel(ins=ins, ref=ref, g=g, op=op):
                return C.backward(op, tuple(ins), ref, g)

            def plain_b(ins=ins, ref=ref, g=g, plain_bwd=plain_bwd):
                return plain_bwd(*ins, ref, g)

            got_b, ref_b = kernel(), plain_b()
            torch.cuda.synchronize()
            names = ("dx1", "dx2", "dw") if len(ins) == 3 else ("dx", "dw")
            max_err = _check_backward(bkey, label, names, got_b, ref_b, rel)
            again = kernel()
            torch.cuda.synchronize()
            if not all(torch.equal(k, a) for k, a in zip(got_b, again)):
                raise AssertionError(f"{bkey} [{label}]: two calls differ")
            del again
            if label.startswith("exact cancellation") and not all(
                    bool((k == 0).all()) for k in got_b):
                raise AssertionError(f"{bkey} [{label}]: gradients not 0")
            entry = results.setdefault(bkey, {"max_abs_err": 0.0})
            if ctype == "complex64":
                entry["max_abs_err"] = max(entry["max_abs_err"], max_err)
            line = f"[complex] {bkey:16s} {label:44s} max|err|={max_err:.3e}"
            if timed:
                ms, plain_ms = _median_ms(kernel), _median_ms(plain_b)
                bound_ms, bound_by, tc_ms = _complex_bound(bkey, ins, peak)
                if "ms" not in entry:
                    entry.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                 tc_bound_ms=tc_ms)
                line += (f"  kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} "
                         f"ms ({bound_by})"
                         + ("" if tc_ms is None else f", tensor-core bound {tc_ms:.3f} ms"))
            print(line)
            if timed:  # kernel 11's launches, one by one
                print(f"[complex] {bkey} split [{label}]: {_kernel_split(kernel)}")
            del ins, got, ref, got_b, ref_b, g
    return results


def _float64_cases(gen):
    """(module, op, make inputs, label, timed) of phase 3f: each lse op at its
    flagship entry and each signed op at the SoS entry (dense) or the K=64
    Tucker entry, then a ragged edge shape with O=1 and a row that is all -inf
    for every op, all in float64."""
    import torch

    from cirkit_tpu_torch.ops import lse_einsum as L
    from cirkit_tpu_torch.ops import slse_einsum as S

    def make(op, f, b, widths, o, *edits):
        def build():
            def randn(*shape):
                return torch.randn(shape, generator=gen, device=DEV, dtype=torch.float64)

            ins = []
            for k in widths:
                ins.append(randn(f, b, k) * 3.0 - 2.0)
                if op.startswith("slse"):
                    ins.append(torch.randint(-1, 2, (f, b, k), generator=gen, device=DEV).double())
            width = widths[0] * widths[-1] if "tucker" in op else widths[0]
            if op.startswith("slse") or "softmax" in op:
                ins.append(randn(f, o, width))
            else:
                ins.append(torch.rand((f, o, width), generator=gen, device=DEV,
                                      dtype=torch.float64) * 0.99 + 0.01)
            for t, idx, v in edits:
                ins[t][idx] = v
            return ins
        return build

    b, row = BATCH, (0, (1, 5), float("-inf"))
    cases = []
    for mod, ops in ((L, FWD_OPS), (S, SIGNED_OPS)):
        for op in ops:
            if "tucker" in op:
                shape, label = (784, b, (64, 64), 64), "F=784 B=128 K1=K2=O=64"
            elif mod is S:
                shape, label = (144, 32 * b, (32,), 32), "SoS entry F=144 B*Kq=4096 I=O=32"
            elif "softmax" in op:
                shape, label = (1568, b, (64,), 64), "F=1568 B=128 I=64 O=64"
            else:
                shape, label = (196, b, (128,), 64), "F=196 B=128 I=128 O=64"
            cases.append((mod, op, make(op, *shape), label, True))
    for mod, ops in ((L, FWD_OPS), (S, SIGNED_OPS)):
        for op in ops:
            widths = (8, 16) if "tucker" in op else (64,)
            cases.append((mod, op, make(op, 5, 13, widths, 1, row), "B=13 O=1, a row -inf", False))
    # Tucker backwards past one block of the dx kernel (from 88 in double):
    # the K1 split, at K1 = K2 = O = 128 (the K=128 circuit's entry widths)
    for mod, op in ((L, "lse_tucker2"), (L, "lse_tucker2_softmax"), (S, "slse_tucker2")):
        cases.append((mod, op, make(op, 4, b, (128, 128), 128, row),
                      "F=4 B=128 K1=K2=O=128 (the split dx), a row -inf", mod is L))
    return cases


def _f64_close(label: str, got, ref, tol: float = F64_TOL) -> float:
    """A float64 output within ``tol (1 + |plain|)`` of the plain one in log
    space, with its -inf pattern and no NaN; returns the worst error."""
    import torch

    if got.dtype != torch.float64 or got.shape != ref.shape or torch.isnan(got).any():
        raise AssertionError(f"{label}: {got.dtype} {tuple(got.shape)} or NaN")
    finite = torch.isfinite(ref)
    err = (got[finite] - ref[finite]).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if not torch.equal(torch.isneginf(got), torch.isneginf(ref)) or not bool(
            (err <= tol * (1 + ref[finite].abs())).all()):
        raise AssertionError(f"{label}: max |kernel - plain| = {max_err:.3e} "
                             f"(bound {tol} (1 + |plain|)) or -inf pattern")
    return max_err


def phase_float64() -> None:
    """Phase 3f: the float64 instances of the single-pass lse kernels and of
    the signed kernels, forward and backward, against their plain versions on
    the card, each timed at its first shape."""
    import torch

    gen = torch.Generator(device=DEV).manual_seed(5)
    with torch.inference_mode():
        for mod, op, make, label, timed in _float64_cases(gen):
            ins = make()
            signed = op.startswith("slse")
            plain, plain_bwd = mod._ENTRIES[op][2:4]
            got = getattr(mod, op)(*ins)
            ref = plain(*ins)
            torch.cuda.synchronize()
            if signed:
                if got[0].dtype != torch.float64 or got[1].dtype != torch.float64:
                    raise AssertionError(f"{op} [{label}]: outputs not float64")
                max_err, _ = _signed_check(op, label, got, ref, ins, F64_SIGNED_TOL)
                outs = ref
            else:
                max_err = _f64_close(f"{op} [{label}]", got, ref)
                outs = (ref,)
            line = f"[float64] {op:22s} {label:34s} err {max_err:.3e}"
            if timed:
                line += (f"  kernel {_median_ms(lambda: getattr(mod, op)(*ins), iters=10):.3f} ms, "
                         f"plain {_median_ms(lambda: plain(*ins), iters=10):.3f} ms")
            g = torch.randn(outs[0].shape, generator=gen, device=DEV, dtype=torch.float64)
            g[0, : min(3, g.shape[1])] = 0.0

            def kernel(ins=ins, outs=outs, g=g, op=op, mod=mod):
                return mod.backward(op, tuple(ins), *outs, g)

            def plain_b(ins=ins, outs=outs, g=g, plain_bwd=plain_bwd):
                return plain_bwd(*ins, *outs, g, (True,) * len(ins))

            got_b, ref_b = kernel(), plain_b()
            torch.cuda.synchronize()
            pairs = [(k, p) for k, p in zip(got_b, ref_b) if p is not None]
            names = [f"d{n}" for n in range(len(pairs) - 1)] + ["dw"]
            max_err = _check_backward(f"{op}_bwd", label, names, *zip(*pairs), F64_BWD_REL)
            line += f"; backward max|err|={max_err:.3e}"
            if timed:
                line += (f"  kernel {_median_ms(kernel, iters=10):.3f} ms, plain "
                         f"{_median_ms(plain_b, iters=10):.3f} ms")
            print(line)
            del ins, got, ref, got_b, ref_b, g, outs, pairs


def phase_float64_wide() -> None:
    """Phase 3f, continued: the double instances of the wide kernels (rows 3,
    4, 5) at the K=128 entries with F cut to F64_WIDE_F, and of the routing
    kernels (rows 8, 9) at the flagship's largest Tucker entry, against their
    plain float64 versions, each timed; then an edge shape of each (ragged
    B, O=1, a row that is all -inf, K1 != K2)."""
    import torch

    from cirkit_tpu_torch.ops import lse_einsum as L
    from cirkit_tpu_torch.ops import routing as R

    gen = torch.Generator(device=DEV).manual_seed(6)
    inf = float("-inf")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEV, dtype=torch.float64)

    def weights(*shape):
        return torch.rand(shape, generator=gen, device=DEV, dtype=torch.float64) * 0.99 + 0.01

    def timed(kernel, plain):
        return (f"  kernel {_median_ms(kernel, iters=10):.3f} ms, plain "
                f"{_median_ms(plain, iters=10):.3f} ms")

    f, k = F64_WIDE_F, WIDE_K
    with torch.inference_mode():
        for (fw, b, k1, k2, o), label in (((f, BATCH, k, k, k), f"F={f} B=128 K1=K2=O={k}"),
                                          ((5, 13, 40, 24, 1), "B=13 O=1 K1=40 K2=24, a row -inf")):
            for op in ("lse_tucker2_softmax", "lse_tucker2"):
                key = f"{op}_chunked"
                ins = [randn(fw, b, k1) * 3.0 - 2.0, randn(fw, b, k2) * 3.0 - 2.0,
                       (randn if "softmax" in op else weights)(fw, o, k1 * k2)]
                ins[0][0, 2] = inf
                plain = L._ENTRIES[op][2]
                err = _f64_close(f"{key} [{label}]", L._launch_fwd(key, ins), plain(*ins))
                line = f"[float64] {key:28s} {label:34s} err {err:.3e}"
                if fw == f:
                    line += timed(lambda: L._launch_fwd(key, ins), lambda: plain(*ins))
                print(line)
                del ins
        for (fw, b, i, o), label in (((f, BATCH, k * k, k), f"F={f} B=128 I={k * k} O={k}"),
                                     ((5, 13, 1000, 1), "B=13 O=1 I=1000, a row -inf")):
            x, w = randn(fw, b, i) * 3.0 - 2.0, weights(fw, o, i)
            x[0, 2] = inf
            out, m = L._launch_blocked_fwd(x, w)
            ref, ref_m = L.lse_matmul_blocked_ref(x, w)
            if not torch.equal(m, ref_m):
                raise AssertionError(f"lse_matmul_blocked [{label}]: float64 row max differs")
            err = _f64_close(f"lse_matmul_blocked [{label}]", out, ref)
            g = randn(*out.shape)
            g[0, :3] = 0.0
            got = L._launch_blocked_bwd(x, w, ref, ref_m, g, (True, True))
            want = L.lse_matmul_blocked_bwd_ref(x, w, ref, ref_m, g)
            torch.cuda.synchronize()
            berr = _check_backward("lse_matmul_blocked_bwd", label, ("dx", "dw"), got, want,
                                   F64_BWD_REL)
            line = f"[float64] {'lse_matmul_blocked':28s} {label:34s} err {err:.3e}"
            if fw == f:
                line += timed(lambda: L._launch_blocked_fwd(x, w),
                              lambda: L.lse_matmul_blocked_ref(x, w))
            line += f"; backward max|err|={berr:.3e}"
            if fw == f:
                line += timed(lambda: L._launch_blocked_bwd(x, w, ref, ref_m, g, (True, True)),
                              lambda: L.lse_matmul_blocked_bwd_ref(x, w, ref, ref_m, g))
            print(line)
            del x, w, out, m, ref, ref_m, g, got, want

        fr, br, k1r, k2r, orr = ROUTE_FLAGSHIP
        for (fw, b, k1, k2, o), lw in (((fr, br, k1r, k2r, orr), True),
                                       ((fr, br, k1r, k2r, orr), False),
                                       *(((ff, br, k1r, k2r, orr), True) for ff in ROUTE_FOLDS),
                                       ((3, 13, 16, 8, 70), False)):
            label = f"F={fw} B={b} K1={k1} K2={k2} O={o} " + ("logits" if lw else "linear")
            x1, x2 = randn(fw, b, k1) * 3.0 - 2.0, randn(fw, b, k2) * 3.0 - 2.0
            th = randn(fw, o, k1 * k2) if lw else weights(fw, o, k1 * k2)
            x1[0, 2] = inf
            if not lw:
                th[:, :, 3] = 0.0  # a zero weight never wins
            sel = torch.randint(-1, o, (fw, b), generator=gen, device=DEV)
            ref = R.tropical_tucker2_ref(x1, x2, th, log_weights=lw)
            err = _f64_close(f"tropical_tucker2 [{label}]",
                             R.tropical_tucker2(x1, x2, th, log_weights=lw), ref, F64_TROP_TOL)
            if b == 13:  # the edge also split in 3 ranges of m, the last ragged
                err = max(err, _f64_close(f"tropical_tucker2 [{label}, 3 ranges]",
                                          R.tropical_tucker2(x1, x2, th, log_weights=lw,
                                                             splits=3), ref, F64_TROP_TOL))
            del ref
            idx = R.route_tucker2(x1, x2, th, sel, kind="max", log_weights=lw)
            scores = R.route_scores(x1, x2, th, sel, log_weights=lw)
            best = scores.amax(dim=-1)
            at = torch.gather(scores, -1, idx[..., None])[..., 0]
            if not bool(((at >= best - F64_TOL * (1 + best.abs())) | torch.isneginf(best)).all()):
                raise AssertionError(f"route_tucker2 [{label}]: a float64 choice below the max")
            draw = R.route_tucker2(x1, x2, th, sel, kind="sample", log_weights=lw, seed=7)
            again = R.route_tucker2(x1, x2, th, sel, kind="sample", log_weights=lw, seed=7)
            if (not torch.equal(draw, again) or not bool(((draw >= 0) & (draw < k1 * k2)).all())
                    or (not lw and bool((draw == 3).any() | (idx == 3).any()))):
                raise AssertionError(f"route_tucker2 [{label}]: float64 draws wrong")
            line = (f"[float64] tropical_tucker2 {label:40s} err {err:.3e}; route_tucker2 "
                    f"{int((idx != scores.argmax(dim=-1)).sum())} of {idx.numel()} choices "
                    "differ from plain, each at the max")
            if fw == fr and lw:
                plain_gen = torch.Generator(device=DEV).manual_seed(7)
                line += ("; tropical" + timed(
                    lambda: R.tropical_tucker2(x1, x2, th, log_weights=lw),
                    lambda: R.tropical_tucker2_ref(x1, x2, th, log_weights=lw))
                    + "; route max" + timed(
                    lambda: R.route_tucker2(x1, x2, th, sel, kind="max", log_weights=lw),
                    lambda: R.route_tucker2_ref(x1, x2, th, sel, kind="max", log_weights=lw))
                    + "; route sample" + timed(
                    lambda: R.route_tucker2(x1, x2, th, sel, kind="sample", log_weights=lw,
                                            seed=7),
                    lambda: R.route_tucker2_ref(x1, x2, th, sel, kind="sample",
                                                log_weights=lw, generator=plain_gen)))
            print(line)
            del x1, x2, th, sel, idx, scores, draw, again


def _complex_sos_circuit(side: int):
    """``_sos_circuit`` with complex normal sum weights (``dtype="complex"``)."""
    from cirkit_tpu_torch.models import image_data
    from cirkit_tpu_torch.models.utils import Parameterization

    return image_data((1, side, side), "quad-tree-2", input_layer="categorical",
                      num_input_units=SOS_K, sum_product_layer="cp", num_sum_units=SOS_K,
                      sum_weight_param=Parameterization(activation="none",
                                                        initialization="normal", dtype="complex"))


def _phase_off(t, rtol: float, period: float) -> tuple[float, float]:
    """The largest distance of the phases of the complex log-values ``t``
    from a multiple of ``period``, and the largest share it takes of its
    bound ``rtol |Re t|`` (at most 1 where the phases hold)."""
    import torch

    off = (t.imag - period * torch.round(t.imag / period)).abs()
    return float(off.max()), float((off / (rtol * t.real.abs())).max())


def phase_complex_sos(smi: str, signed_runs: dict) -> dict[str, int]:
    """Phase 10: bench_sos's squared circuit under the complex semiring at
    each of SOS_SIDES, K=32, batch 128. (a) With phase 9's real store loaded
    by slot name: sq's real part and log Z against the signed run's, phases 0
    or pi. (b) With complex sum weights from seed 0: the forwards of ``cc``,
    ``sq`` and ``zc``, the normalized log-likelihood, ``IntegrateQuery``
    marginals, the gradients of cc's slots against complex128 on the CPU and
    Adam steps on the SoS loss. Returns each kernel's launches over the
    counted (main-path) calls."""
    import math

    import numpy as np
    import torch

    from cirkit_tpu_torch.backend.torch import IntegrateQuery
    from cirkit_tpu_torch.backend.torch.compiler import TorchCompiler
    from cirkit_tpu_torch.backend.torch.optimized import TorchTensorDotLayer
    from cirkit_tpu_torch.parallel import split_trainable
    from cirkit_tpu_torch.pipeline import PipelineContext

    launches: dict[str, int] = {}

    def build(sc):
        ctx = PipelineContext(semiring="complex-lse-sum", fold=True, optimize=True, device=DEV,
                              seed=0)
        cc = ctx.compile(sc)
        sq = ctx.multiply(ctx.conjugate(cc), cc)
        return ctx, cc, sq, ctx.integrate(sq)

    for side in SOS_SIDES:
        label = f"[complex sos] {side}x{side} K={SOS_K}"
        gc.collect()
        torch.cuda.empty_cache()
        rng = np.random.default_rng(0)  # the batch and 50% mask of bench.py:222-224
        d = side * side
        x_np = rng.integers(0, 256, size=(BATCH, d), dtype=np.int32).astype(np.int64)
        mask_np = rng.random((BATCH, d)) < 0.5
        x, mask = torch.as_tensor(x_np, device=DEV), torch.as_tensor(mask_np, device=DEV)

        # (a) the signed run's store under the complex semiring
        store, sq_signed, logz_signed = signed_runs[side]
        ctx, cc, sq, zc = build(_sos_circuit(side))
        ctx.update_parameters(store)  # by slot name
        n_sq, n_zc = (sum(isinstance(l, TorchTensorDotLayer) for l in c.layers) for c in (sq, zc))
        with torch.inference_mode():
            s_out = _counted_launches(f"{label} (a) sq", lambda: sq(x), {"clse_matmul": n_sq},
                                      launches)
            z_out = _counted_launches(f"{label} (a) zc", lambda: zc(x[:1]),
                                      {"clse_matmul": n_zc}, launches)
        rel_sq = float(((s_out.real - sq_signed).abs() / sq_signed.abs()).max())
        rel_z = float(((z_out.real - logz_signed).abs() / logz_signed.abs()).max())
        (off_s, share_s), (off_z, share_z) = (_phase_off(s_out, SOS_SQ_RTOL, math.pi),
                                              _phase_off(z_out, 1e-5, math.pi))
        if not (rel_sq <= SOS_SQ_RTOL and rel_z <= 1e-5 and share_s <= 1 and share_z <= 1):
            raise AssertionError(f"{label} (a): sq off the signed run by {rel_sq:.3e} (rtol "
                                 f"{SOS_SQ_RTOL}), log Z by {rel_z:.3e} (1e-5), phases of sq "
                                 f"{off_s:.3e} and of log Z {off_z:.3e} from a multiple of pi "
                                 f"({share_s:.3f} and {share_z:.3f} of their bounds)")
        print(f"{label} (a): the signed run's store under complex-lse-sum: sq's real part within "
              f"{rel_sq:.2e} relative of the signed log|c|^2, log Z within {rel_z:.2e}; phases "
              f"of sq within {off_s:.2e} of 0 or pi ({share_s:.3f} of {SOS_SQ_RTOL} |Re sq|), of "
              f"log Z within {off_z:.2e} ({share_z:.3f} of 1e-5 |Re log Z|)")
        del ctx, cc, sq, zc, s_out, z_out

        # (b) complex sum weights
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()

        def peak_gb():
            return (torch.cuda.max_memory_allocated() - base) / 1e9

        t0 = time.perf_counter()
        ctx, cc, sq, zc = build(_complex_sos_circuit(side))
        torch.cuda.synchronize()
        st = ctx.parameters
        n_cc = sum(isinstance(l, _kernel_layers()) for l in cc.layers)
        n_complex = sum(v.is_complex() for v in st.values())
        print(f"{label} (b): compiled cc, sq, zc in {time.perf_counter() - t0:.1f} s; "
              f"{cc.num_parameters()} parameters, {n_complex} of {len(st)} slots complex; plan "
              f"entries {len(cc.layers)}, {len(sq.layers)} ({n_sq} TensorDot), {len(zc.layers)} "
              f"({n_zc} TensorDot)")
        iq = IntegrateQuery(sq)
        with torch.inference_mode():
            c_out = _counted_launches(f"{label} cc", lambda: cc(x), {"clse_matmul": n_cc},
                                      launches)
            s_out = _counted_launches(f"{label} sq", lambda: sq(x), {"clse_matmul": n_sq},
                                      launches)
            z_out = _counted_launches(f"{label} zc", lambda: zc(x[:1]), {"clse_matmul": n_zc},
                                      launches)
            m_out = _counted_launches(f"{label} marginals",
                                      lambda: iq(x, integrate_vars=mask, store=st),
                                      {"clse_matmul": n_sq}, launches)
        nll = s_out.real[:, 0, 0] - z_out.real[0, 0, 0]
        id_rel = float(((s_out.real - 2 * c_out.real).abs() / s_out.real.abs()).max())
        z_phase = float(z_out.imag[0, 0, 0])
        z_off, z_share = _phase_off(z_out, 1e-5, 2 * math.pi)
        checks = {
            "sq complex64, finite, (B, 1, 1)": s_out.dtype == torch.complex64
            and s_out.shape == (BATCH, 1, 1) and bool(s_out.real.isfinite().all()),
            f"Re sq = 2 Re cc (rel {SOS_SQ_RTOL})": id_rel <= SOS_SQ_RTOL,
            "Im log Z a multiple of 2 pi (1e-5 |Re log Z|)": z_share <= 1,
            "marginals finite": bool(m_out.real.isfinite().all()),
            "normalized log-likelihood <= 1e-4": bool((nll <= 1e-4).all()),
        }
        bad = [name for name, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"{label}: failed {bad} (Im log Z {z_phase:.3e}, {z_off:.3e} from a "
                                 "multiple of 2 pi)")

        # QUERY_ROWS rows against the same store in complex128 on the CPU
        t0 = time.perf_counter()
        comp = TorchCompiler(semiring="complex-lse-sum", fold=True, optimize=True, device="cpu")
        cc128, sq128, zc128 = (comp.compile(ctx.get_symbolic_circuit(c)) for c in (cc, sq, zc))
        st128 = {s: v.detach().cpu().to(torch.complex128 if v.is_complex() else torch.float64)
                 for s, v in st.items()}
        r = QUERY_ROWS
        xr, mr = torch.as_tensor(x_np[:r]), torch.as_tensor(mask_np[:r])
        with torch.inference_mode():
            want = {"sq": sq128(st128, xr), "log Z": zc128(st128, xr[:1]),
                    "marginals": IntegrateQuery(sq128)(xr, integrate_vars=mr, store=st128)}
        got = {"sq": s_out[:r], "log Z": z_out, "marginals": m_out[:r]}
        rels = {}
        for name, w_ in want.items():
            g_ = got[name].real.double().cpu()
            rels[name] = float(((g_ - w_.real).abs() / w_.real.abs()).max())
            rtol = SOS_SQ_RTOL if name == "sq" else 1e-5
            if not rels[name] <= rtol:
                raise AssertionError(f"{label}: {name} off complex128 by {rels[name]:.3e} (rtol "
                                     f"{rtol})")
        print(f"{label}: Re sq = 2 Re cc to {id_rel:.2e} relative; normalized log-likelihood "
              f"{float(nll.mean()):.3f} mean (max {float(nll.max()):.3e}), log Z "
              f"{float(z_out.real[0, 0, 0]):.3f} + {z_phase:.2e}i; {r} rows against complex128 "
              f"on the CPU ({time.perf_counter() - t0:.1f} s): "
              + ", ".join(f"{k} max rel err {v:.2e}" for k, v in rels.items()))

        with torch.inference_mode():
            times = {"sq forward": _median_ms(lambda: sq(x)),
                     "normalized log-likelihood": _median_ms(
                         lambda: sq(x).real - zc(x[:1]).real[0, 0, 0]),
                     "marginals": _median_ms(lambda: iq(x, integrate_vars=mask, store=st),
                                             iters=10)}
            profile = _device_breakdown(lambda: sq(x), 3)
        print(f"{label}: batch {BATCH}, " + ", ".join(
            f"{k} {v:.3f} ms ({BATCH / v * 1e3:.1f} rows/s)" for k, v in times.items())
            + f" (median of 20, 10 for the marginals); peak memory {peak_gb():.2f} GB; sq "
              f"forward profile: {profile} ({smi})")

        # The SoS loss -mean(Re log|c(x)|^2) + Re log Z: the gradients of cc's
        # learnable slots against complex128, then Adam steps
        def loss_fn(sq, zc, store, xb):
            return -sq.evaluate(store, xb).real.mean() + zc.evaluate(store, xb[:1]).real[0, 0, 0]

        tr, _ = split_trainable(cc, st)
        fr = {k: v.detach() for k, v in st.items() if k not in tr}
        got = dict(zip(tr, torch.autograd.grad(loss_fn(sq, zc, {**tr, **fr}, x[:GRAD_ROWS]),
                                               list(tr.values()))))
        tr128 = {k: st128[k].clone().requires_grad_() for k in tr}
        fr128 = {k: v for k, v in st128.items() if k not in tr}
        want = dict(zip(tr128, torch.autograd.grad(
            loss_fn(sq128, zc128, {**tr128, **fr128}, xr[:GRAD_ROWS]), list(tr128.values()))))
        worst = _check_grads(f"{label} gradients", got, want, strict=side == SOS_GRAD_SIDE)
        del cc128, sq128, zc128, st128, tr128, fr128, want, got

        torch.cuda.reset_peak_memory_stats()
        tr = {k: v.detach().clone().requires_grad_() for k, v in sorted(tr.items())}
        opt = torch.optim.Adam(list(tr.values()), lr=SOS_LR)

        def step():
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(sq, zc, {**tr, **fr}, x)
            loss.backward()
            opt.step()
            return loss.detach()

        want_step = {"clse_matmul": n_sq + n_zc, "clse_matmul_bwd": n_sq + n_zc}
        losses = [float(_counted_launches(f"{label} step", step, want_step, launches))
                  for _ in range(STEPS)]
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"{label}: losses {losses} not finite and decreasing")
        ms = _median_ms(step, warmup=3, iters=10)
        profile = _device_breakdown(step, 2)
        held = "held to" if side == SOS_GRAD_SIDE else "measured against"
        print(f"{label}: gradients of {len(tr)} learnable slots of cc on {GRAD_ROWS} rows "
              f"{held} complex128, worst error {worst:.3f} of the bound {GRAD_REL} max|slot| + "
              f"{GRAD_ABS}; {STEPS} Adam({SOS_LR}) steps, loss {losses[0]:.3f} -> "
              f"{losses[-1]:.3f}; step {ms:.3f} ms median of 10 = {BATCH / ms * 1e3:.1f} "
              f"samples/s; peak memory {peak_gb():.2f} GB; step profile: {profile} ({smi})")
        del ctx, cc, sq, zc, st, tr, fr, opt, iq
    return launches


def phase_complex_flagship(smi: str, built: list, signed_ms: dict) -> dict[str, int]:
    """Phase 10b: phase 4's K=64 Tucker flagship compiled under the complex
    semiring with phase 4's store loaded by slot name (its softmaxed weights
    stay real): the forward's real part against the lse-sum forward, phases
    0, one backward's gradients against the lse-sum ones, and the launches of
    the Tucker and dense routes of the complex kernels."""
    import numpy as np
    import torch

    from cirkit_tpu_torch.pipeline import PipelineContext

    x = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (BATCH, 784)), device=DEV)
    spl, em, sc, ctx, cc, _ = built[0]
    label = f"[complex flagship] {spl} em_ready={em}"
    cctx = PipelineContext(semiring="complex-lse-sum", fold=True, optimize=True, device=DEV,
                           seed=0)
    ccc = cctx.compile(sc)
    cctx.update_parameters(ctx.parameters)  # by slot name, sharing the tensors
    fwd, bwd = _expected_launches(ccc, values="complex")
    st, cst = ctx.parameters, cctx.parameters
    launches: dict[str, int] = {}
    with torch.inference_mode():
        ref = cc.evaluate(st, x)
        out = _counted_launches(f"{label} forward", lambda: ccc.evaluate(cst, x), fwd, launches)
    rel = float(((out.real - ref).abs() / ref.abs()).max())
    if not (bool((out.imag == 0).all()) and torch.allclose(out.real, ref, rtol=1e-5, atol=0.0)):
        raise AssertionError(f"{label}: forward off the lse-sum one by {rel:.3e}, or a phase "
                             "not 0")
    want = dict(zip(st.keys(), torch.autograd.grad(-cc.evaluate(st, x).mean(),
                                                   list(st.values()))))

    def backward():
        loss = -ccc.evaluate(cst, x).real.mean()
        return dict(zip(cst.keys(), torch.autograd.grad(loss, list(cst.values()))))

    got = _counted_launches(f"{label} backward", backward, {**fwd, **bwd}, launches)
    worst = _check_grads(f"{label} gradients", got, want)
    with torch.inference_mode():
        ms = _median_ms(lambda: ccc.evaluate(cst, x))
        ms_lse = _median_ms(lambda: cc.evaluate(st, x))
    print(f"{label}: launches a forward {fwd}, a backward {bwd}; the real part equals lse-sum "
          f"(max rel err {rel:.2e}), phases 0; gradients of {len(want)} slots within "
          f"{worst:.3f} of the bound; forward {ms:.3f} ms complex, {ms_lse:.3f} ms lse-sum, "
          f"{signed_ms[(spl, em)]:.3f} ms signed (median of 20, batch {BATCH}) ({smi})")
    return launches


def _expected_launches(cc, *, values: str = "real") -> tuple[dict[str, int], dict[str, int]]:
    """The kernel launches of one forward and of one backward of ``cc``, per
    LAUNCHES key: an entry of width WIDE_WIDTH or more takes the K1-chunked
    (Tucker) or blocked (dense) kernels, a narrower one the single-pass
    kernels; a wide Tucker entry's backward is the Tucker backward kernel.
    With ``values="signed"`` (a circuit under the signed semiring) every
    entry takes the signed op of its configuration, which has no wide variant;
    with ``values="complex"`` the complex op of its route, dense or Tucker
    (the complex semiring normalizes logits before it contracts)."""
    from cirkit_tpu_torch.backend.torch.layers import TorchSumLayer
    from cirkit_tpu_torch.backend.torch.optimized import TorchCPTLayer, TorchTuckerLayer
    from cirkit_tpu_torch.ops import lse_einsum as L

    fwd: dict[str, int] = {}
    bwd: dict[str, int] = {}
    for layer in cc.layers:
        if isinstance(layer, TorchTuckerLayer) and layer.arity == 2:
            op = "lse_tucker2" + ("_softmax" if layer._logits_slot is not None else "")
            wide = layer.num_input_units**2 >= L.WIDE_WIDTH
            keys = (f"{op}_chunked" if wide else op, f"{op}_bwd")
        elif isinstance(layer, (TorchSumLayer, TorchCPTLayer)):
            width = layer.num_input_units * (layer.arity if isinstance(layer, TorchSumLayer) else 1)
            op = "lse_matmul" + ("_softmax" if layer._logits_slot is not None else "")
            keys = (("lse_matmul_blocked", "lse_matmul_blocked_bwd") if width >= L.WIDE_WIDTH
                    else (op, f"{op}_bwd"))
        else:
            continue
        if values == "signed":
            keys = (f"s{op}", f"s{op}_bwd")
        elif values == "complex":
            op = "c" + op.removesuffix("_softmax")
            keys = (op, f"{op}_bwd")
        fwd[keys[0]] = fwd.get(keys[0], 0) + 1
        bwd[keys[1]] = bwd.get(keys[1], 0) + 1
    return fwd, bwd


def phase_wide(smi: str) -> dict[str, int]:
    """The K=128 Tucker flagship through the wide kernels, one WIDE_RUNS entry
    at a time (each store is 13.2 GB); returns each kernel's launches over the
    counted (main-path) calls."""
    import numpy as np
    import torch

    from cirkit_tpu_torch.backend.torch import (
        ExpectationQuery,
        IntegrateQuery,
        MAPQuery,
        SamplingQuery,
    )
    from cirkit_tpu_torch.backend.torch.optimized import TorchTuckerLayer
    from cirkit_tpu_torch.ops import lse_einsum as L
    from cirkit_tpu_torch.parallel import data_parallel_step, split_trainable

    rng = np.random.default_rng(0)  # the batch and 50% mask of bench.py:222-224
    x_np = rng.integers(0, 256, size=(BATCH, 784), dtype=np.int32).astype(np.int64)
    mask_np = rng.random((BATCH, 784)) < 0.5
    x = torch.as_tensor(x_np, device=DEV)
    mask = torch.as_tensor(mask_np, device=DEV)
    r = QUERY_ROWS
    xr, mr = torch.as_tensor(x_np[:r]), torch.as_tensor(mask_np[:r])
    launches = dict.fromkeys(L.LAUNCHES, 0)

    def counted(label, fn, want):
        return _counted_launches(f"[wide] {label}", fn, want, launches)

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9

    for optimize, em, opt_name in WIDE_RUNS:
        label = f"K={WIDE_K} tucker optimize={optimize} em_ready={em}"
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, ctx, cc = _build_flagship("tucker", em, DEV, k=WIDE_K, optimize=optimize)
        torch.cuda.synchronize()
        fwd, bwd = _expected_launches(cc)
        print(f"[wide] {label}: compiled in {time.perf_counter() - t0:.1f} s, "
              f"{cc.num_parameters()} parameters, {len(cc.layers)} plan entries; launches a "
              f"forward {fwd}, a backward {bwd}")
        st = ctx.parameters
        with torch.inference_mode():
            out = counted(f"{label} forward", lambda: cc(x), fwd)
            if out.shape != (BATCH, 1, 1) or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"[wide] {label}: output {tuple(out.shape)}, not finite")
            ms = _median_ms(lambda: cc(x), warmup=2, iters=10)
            profile = _device_breakdown(lambda: cc(x), 3)
        print(f"[wide] {label}: forward {ms:.3f} ms median of 10 = {BATCH / ms * 1e3:.1f} "
              f"samples/s, mean log-likelihood {float(out.mean()):.3f}; peak memory "
              f"{peak_gb():.2f} GB; profile: {profile} ({smi})")
        got = {"forward": out[:r, 0, 0]}

        if optimize and not em:  # the queries, counted and timed
            n_tucker = sum(isinstance(l, TorchTuckerLayer) and l.arity == 2 for l in cc.layers)
            route = {"route_tucker2": n_tucker}
            iq, mq, sq = IntegrateQuery(cc), MAPQuery(cc), SamplingQuery(cc)
            eq = ExpectationQuery(cc)
            gen = torch.Generator().manual_seed(0)
            calls = {
                "integrate": (lambda: iq(x, integrate_vars=mask, store=st), fwd),
                # kernel 5's forward and the Tucker backward kernel, dx-only
                "expectation": (lambda: _dx_only(lambda: eq(x, evidence_mask=mask, store=st)),
                                {**fwd, **bwd}),
                "map": (lambda: mq(x, evidence_mask=mask, store=st),
                        {"tropical_tucker2": n_tucker, **route}),
                "sample": (lambda: sq(BATCH, generator=gen, store=st), {**fwd, **route}),
                "conditional": (lambda: sq.conditional(x, evidence_mask=mask, generator=gen,
                                                       store=st), {**fwd, **route}),
            }
            outs = {name: counted(f"{label} {name}", fn, want)
                    for name, (fn, want) in calls.items()}
            asg, vals = outs["map"]
            samples, _ = outs["sample"]
            csamples, log_ev = outs["conditional"]
            mean = outs["expectation"]
            ok = (bool(outs["integrate"].isfinite().all()) and bool(vals.isfinite().all())
                  and torch.equal(mean[mask], x[mask].to(mean.dtype))
                  and bool(((mean >= 0) & (mean <= 255)).all())
                  and torch.equal(asg[mask], x[mask].to(asg.dtype))
                  and torch.equal(csamples[mask], x[mask].to(csamples.dtype))
                  and bool(log_ev.isfinite().all())
                  and all(bool(((s_ >= 0) & (s_ <= 255)).all()) for s_ in (asg, samples,
                                                                            csamples)))
            if not ok:
                raise AssertionError(f"[wide] {label}: query outputs wrong")
            got.update(marginals=outs["integrate"][:r, 0, 0], map=vals[:r])
            with torch.inference_mode():
                times = {name: _median_ms(fn, warmup=1, iters=5) for name, (fn, _) in
                         calls.items()}
            print(f"[wide] {label}: queries at batch {BATCH}, " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in times.items()) + f" (median of 5); peak memory "
                f"{peak_gb():.2f} GB ({smi})")
            del calls, outs, asg, vals, samples, csamples, log_ev, iq, mq, sq, eq, mean

        # QUERY_ROWS rows against the same store in float64 on the CPU
        t0 = time.perf_counter()
        cc64, st64 = _f64_reference("tucker", em, st, k=WIDE_K, optimize=optimize)
        with torch.inference_mode():
            want = {"forward": cc64(st64, xr)[:, 0, 0]}
            if "map" in got:
                want["marginals"] = IntegrateQuery(cc64)(xr, integrate_vars=mr, store=st64)[:, 0, 0]
                want["map"] = MAPQuery(cc64)(xr, evidence_mask=mr, store=st64)[1]
        del cc64, st64
        gc.collect()
        rels = {}
        for name, g in got.items():
            g = g.double().cpu()
            rels[name] = float(((g - want[name]).abs() / want[name].abs()).max())
            if not torch.allclose(g, want[name], rtol=1e-5, atol=0.0):
                raise AssertionError(f"[wide] {label}: {name} off float64 by {rels[name]:.3e}")
        print(f"[wide] {label}: {r} rows against float64 on the CPU "
              f"({time.perf_counter() - t0:.1f} s): "
              + ", ".join(f"{k} max rel err {v:.2e}" for k, v in rels.items()))
        del got, want, out

        if em:  # EM's flow step and M-step on the store itself
            torch.cuda.reset_peak_memory_stats()
            em_step, em_update, em_state = _em_step(cc, st, x)
            acc, ll = counted(f"{label} EM flow step", em_step, {**fwd, **bwd})
            flow_gb = peak_gb()
            new_em, _ = em_update(em_state["em_params"], em_state["gauss_params"], acc, 1.0)
            off = max(float((w.sum(dim=-1).double() - 1.0).abs().max()) for w in new_em.values())
            if not (bool(torch.isfinite(ll)) and off <= 1e-5
                    and all(bool((w >= 0).all()) for w in new_em.values())):
                raise AssertionError(f"[wide] {label}: EM log-likelihood {float(ll)}, or an "
                                     f"M-step row negative or off 1 by {off:.3e}")
            del new_em
            flow_ms = _median_ms(lambda: em_step(acc), warmup=1, iters=5)
            upd_ms = _median_ms(lambda: em_update(em_state["em_params"],
                                                  em_state["gauss_params"], acc, 1.0),
                                warmup=1, iters=3)
            print(f"[wide] {label}: EM flow step {flow_ms:.3f} ms median of 5 (peak memory "
                  f"{flow_gb:.2f} GB: store, gradients, flow accumulator), M-step {upd_ms:.3f} ms "
                  f"median of 3 (rows within {off:.1e} of 1; peak memory {peak_gb():.2f} GB) "
                  f"({smi})")
            del acc, ll, em_step, em_update, em_state

        if opt_name is not None:  # training steps on the store itself
            torch.cuda.reset_peak_memory_stats()
            tr, fr = split_trainable(cc, st)
            opt = (torch.optim.Adam(list(tr.values()), lr=1e-2) if opt_name == "adam"
                   else torch.optim.SGD(list(tr.values()), lr=SGD_LR))
            step = data_parallel_step(cc, opt)
            losses = [float(counted(f"{label} step", lambda: step(tr, fr, x), {**fwd, **bwd}))
                      for _ in range(STEPS)]
            if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
                raise AssertionError(f"[wide] {label}: losses {losses} not finite and decreasing")
            ms = _median_ms(lambda: step(tr, fr, x), warmup=1, iters=5)
            print(f"[wide] {label}: {STEPS} {opt_name} steps, NLL {losses[0]:.3f} -> "
                  f"{losses[-1]:.3f}; step {ms:.3f} ms median of 5 = {BATCH / ms * 1e3:.1f} "
                  f"samples/s; peak memory {peak_gb():.2f} GB; profile: "
                  f"{_device_breakdown(lambda: step(tr, fr, x), 2)} ({smi})")
            del tr, fr, opt, step
        del ctx, cc, st
    gc.collect()
    torch.cuda.empty_cache()
    used = {op: n for op, n in launches.items() if n}
    print(f"[wide] launches on the K={WIDE_K} main path: {used}")
    return launches


def _f64_rows(label: str, got, want) -> float:
    """QUERY_ROWS values of a float64 run on the card within F64_RTOL of the
    float64 CPU run's; returns the worst relative error."""
    import torch

    got = got.cpu()
    if got.dtype != torch.float64:
        raise AssertionError(f"[float64] {label}: {got.dtype}, not float64")
    rel = float(((got - want).abs() / want.abs()).max())
    if not torch.allclose(got, want, rtol=F64_RTOL, atol=0.0):
        raise AssertionError(f"[float64] {label}: off the float64 CPU run by {rel:.3e}")
    return rel


def phase_float64_circuits(smi: str) -> dict[str, int]:
    """Phase 11: circuits compiled in float64 (the default dtype float64) on
    the card. The K=64 Tucker flagship: ``MAPQuery`` with phase 7's 50% mask,
    ``SamplingQuery`` of 128 samples and ``.conditional``, each counted (the
    double routing kernels, rows 8 and 9); the MAP values and the
    log-evidence of QUERY_ROWS rows against float64 on the CPU. The K=128
    Tucker circuit on an F64_SIDE image: with ``optimize=True`` the forward
    and 3 SGD steps (the double K1-chunked kernel, row 5, and the Tucker
    backward at K1 = K2 = 128, row 2's K1 split), with ``optimize=False``
    the forward and 3 SGD steps (the double blocked kernels, rows 3 and 4),
    each counted; QUERY_ROWS rows of each forward, and of the SGD loss's
    gradients, against float64 on the CPU. Returns the launches of the
    counted calls."""
    import numpy as np
    import torch

    from cirkit_tpu_torch.backend.torch import MAPQuery, SamplingQuery
    from cirkit_tpu_torch.backend.torch.optimized import TorchTuckerLayer
    from cirkit_tpu_torch.parallel import data_parallel_step, split_trainable

    launches: dict[str, int] = {}
    r = QUERY_ROWS
    rng = np.random.default_rng(0)  # the batch and 50% mask of bench.py:222-224
    x_np = rng.integers(0, 256, size=(BATCH, 784), dtype=np.int32).astype(np.int64)
    mask_np = rng.random((BATCH, 784)) < 0.5
    xs_np = np.random.default_rng(1).integers(0, 256, (BATCH, F64_SIDE**2))
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        x, mask = torch.as_tensor(x_np, device=DEV), torch.as_tensor(mask_np, device=DEV)
        t0 = time.perf_counter()
        _, ctx, cc = _build_flagship("tucker", False, DEV)
        st = ctx.parameters
        if any(v.dtype != torch.float64 for v in st.values()):
            raise AssertionError("[float64] the K=64 flagship's store is not float64")
        fwd, _ = _expected_launches(cc)
        n_tucker = sum(isinstance(l, TorchTuckerLayer) and l.arity == 2 for l in cc.layers)
        route = {"route_tucker2": n_tucker}
        mq, sq = MAPQuery(cc), SamplingQuery(cc)
        gen = torch.Generator().manual_seed(0)
        calls = {
            "map": (lambda: mq(x, evidence_mask=mask, store=st),
                    {"tropical_tucker2": n_tucker, **route}),
            "sample": (lambda: sq(BATCH, generator=gen, store=st), {**fwd, **route}),
            "conditional": (lambda: sq.conditional(x, evidence_mask=mask, generator=gen,
                                                   store=st), {**fwd, **route}),
        }
        outs = {name: _counted_launches(f"[float64] K=64 tucker {name}", fn, want, launches)
                for name, (fn, want) in calls.items()}
        (asg, vals), (samples, _), (csamples, log_ev) = (outs[n] for n in calls)
        ok = (vals.dtype == log_ev.dtype == torch.float64 and bool(vals.isfinite().all())
              and bool(log_ev.isfinite().all())
              and torch.equal(asg[mask], x[mask].to(asg.dtype))
              and torch.equal(csamples[mask], x[mask].to(csamples.dtype))
              and all(bool(((s_ >= 0) & (s_ <= 255)).all()) for s_ in (asg, samples, csamples)))
        if not ok:
            raise AssertionError("[float64] K=64 tucker: query outputs wrong")
        cc64, st64 = _f64_reference("tucker", False, st)
        xr, mr = torch.as_tensor(x_np[:r]), torch.as_tensor(mask_np[:r])
        want_map = MAPQuery(cc64)(xr, evidence_mask=mr, store=st64)
        _, want_ev = SamplingQuery(cc64).conditional(xr, evidence_mask=mr, store=st64,
                                                       generator=torch.Generator().manual_seed(0))
        rels = {"map": _f64_rows("K=64 map", vals[:r], want_map[1]),
                "log-evidence": _f64_rows("K=64 log-evidence", log_ev[:r], want_ev)}
        differ = int((asg[:r].cpu() != want_map[0]).sum())
        with torch.inference_mode():
            times = {name: _median_ms(fn, warmup=1, iters=5) for name, (fn, _) in calls.items()}
        print(f"[float64] K=64 tucker in float64 ({time.perf_counter() - t0:.1f} s): {r} rows "
              "against float64 on the CPU, " + ", ".join(f"{k} max rel err {v:.2e}" for k, v
                                                          in rels.items())
              + f", MAP assignments differing {differ} of {r * 784}; queries at batch {BATCH} "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items()) + f" (median of 5) ({smi})")
        del ctx, cc, st, mq, sq, calls, outs, asg, vals, samples, csamples, log_ev, cc64, st64

        xs = torch.as_tensor(xs_np, device=DEV)
        xsr = torch.as_tensor(xs_np[:r])
        for optimize in (True, False):
            label = f"K={WIDE_K} tucker {F64_SIDE}x{F64_SIDE} optimize={optimize}"
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            _, ctx, cc = _build_flagship("tucker", False, DEV, k=WIDE_K, optimize=optimize,
                                         side=F64_SIDE)
            st = ctx.parameters
            fwd, bwd = _expected_launches(cc)
            wide = "lse_tucker2_softmax_chunked" if optimize else "lse_matmul_blocked"
            if wide not in fwd:
                raise AssertionError(f"[float64] {label}: no wide entry in {fwd}")
            with torch.inference_mode():
                out = _counted_launches(f"[float64] {label} forward", lambda: cc(xs), fwd,
                                        launches)
                ms = _median_ms(lambda: cc(xs), warmup=1, iters=5)
            cc64, st64 = _f64_reference("tucker", False, st, k=WIDE_K, optimize=optimize,
                                        side=F64_SIDE)
            with torch.inference_mode():
                rel = _f64_rows(f"{label} forward", out[:r, 0, 0], cc64(st64, xsr)[:, 0, 0])
            line = (f"[float64] {label}: {cc.num_parameters()} parameters, forward max rel err "
                    f"{rel:.2e} against the CPU, {ms:.3f} ms median of 5 at batch {BATCH}")
            # the SGD loss's gradients, then counted SGD steps (optimize=True: the
            # float64 Tucker backward at K1 = K2 = 128, past one block of its dx)
            tr, fr = split_trainable(cc, st)
            got = torch.autograd.grad(-cc.evaluate({**tr, **fr}, xs[:r]).mean(),
                                      list(tr.values()))
            tr_c, fr_c = split_trainable(cc64, st64)
            tr_c = {k: v.requires_grad_() for k, v in tr_c.items()}
            refs = torch.autograd.grad(-cc64.evaluate({**tr_c, **fr_c}, xsr).mean(),
                                       [tr_c[k] for k in tr])
            worst = 0.0
            for name, g, ref in zip(tr, got, refs):
                err = (g.cpu() - ref).abs()
                bound = F64_BWD_REL * (ref.abs().max() + ref.abs()) + F64_GRAD_ABS
                if not bool(g.isfinite().all()) or not bool((err <= bound).all()):
                    raise AssertionError(f"[float64] {label}: gradient of {name} off by "
                                         f"{float(err.max()):.3e}")
                worst = max(worst, float((err / bound).max()))
            opt = torch.optim.SGD(list(tr.values()), lr=SGD_LR)
            step = data_parallel_step(cc, opt)
            losses = [float(_counted_launches(f"[float64] {label} step",
                                              lambda: step(tr, fr, xs), {**fwd, **bwd},
                                              launches)) for _ in range(3)]
            if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
                raise AssertionError(f"[float64] {label}: losses {losses}")
            step_ms = _median_ms(lambda: step(tr, fr, xs), warmup=1, iters=3)
            line += (f"; gradients of {len(tr)} slots on {r} rows within {worst:.3f} of "
                     f"{F64_BWD_REL} (max|slot| + |slot|) + {F64_GRAD_ABS}; 3 SGD steps, NLL "
                     f"{losses[0]:.3f} "
                     f"-> {losses[-1]:.3f}, step {step_ms:.3f} ms median of 3")
            del tr, fr, got, tr_c, fr_c, refs, opt, step
            print(f"{line} ({time.perf_counter() - t0:.1f} s) ({smi})")
            del ctx, cc, st, out, cc64, st64
    finally:
        torch.set_default_dtype(old)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[float64] launches on the float64 paths: {launches}")
    return launches


def main() -> int:
    import torch

    if not (REPO / "cirkit_tpu_torch").is_dir():
        raise RuntimeError(f"no cirkit_tpu_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(REPO))
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    results = phase_kernels()
    results.update(phase_backward())
    results.update(phase_routing())
    results.update(phase_signed())
    results.update(phase_complex())
    phase_float64()
    phase_float64_wide()
    print(f"[time] kernels against plain done at {time.perf_counter() - t_start:.0f} s")
    # each kernel's launches, summed over the main-path runs of phases 4-14
    launches = dict.fromkeys(KERNELS, 0)
    built, fwd = phase_slice(smi)
    train = phase_train(smi, built)
    em = phase_em(smi, built)
    phase_profile(smi, built)
    queries = phase_queries(smi, built)
    expect = phase_expectation(smi, built)
    cross = phase_cross(smi, built)
    print(f"[time] phases 4-7b and 12 done at {time.perf_counter() - t_start:.0f} s")
    struct = phase_structure(smi, built)
    print(f"[time] phase 13 done at {time.perf_counter() - t_start:.0f} s")
    qpc = phase_qpc(smi, built)
    print(f"[time] phase 14 done at {time.perf_counter() - t_start:.0f} s")
    sos, signed_runs = phase_sos(smi)
    signed, signed_ms = phase_signed_flagships(smi, built)  # reads phase 4's stores
    csos = phase_complex_sos(smi, signed_runs)
    cflag = phase_complex_flagship(smi, built, signed_ms)
    del built, signed_runs
    print(f"[time] phases 9-10b done at {time.perf_counter() - t_start:.0f} s")
    wide = phase_wide(smi)
    f64 = phase_float64_circuits(smi)
    for counts in (fwd, train, em, {op: queries[op] for op in ROUTE_OPS}, expect, cross, struct,
                   qpc, wide, sos, signed, csos, cflag, f64):
        for op, n in counts.items():
            launches[op] += n
    missing = [op for op, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on their main paths: {missing}")

    kernels = [
        {
            "name": op,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[op],
            "max_abs_err": results[op]["max_abs_err"],
            "ms": results[op]["ms"],
            "plain_ms": results[op]["plain_ms"],
            "bound_ms": results[op]["bound_ms"],
            "bound_by": results[op]["bound_by"],
            # the same work's bound with its sums of products on the tensor
            # cores in 3xTF32 (None for the routing kernels, which have none)
            "tc_bound_ms": results[op].get("tc_bound_ms"),
            # no single PyTorch call computes a log-einsum-exp with linear
            # weights, its signed variant, a max-plus Tucker or a routing choice;
            # torch.bmm on complex tensors contracts, but computes neither the
            # shifted exponentials nor the logarithm of the complex ops
            "library_ms": None,
        }
        for op, (source, replaces) in KERNELS.items()
    ]
    print(f"[time] chip_smoke took {time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": kernels}))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
