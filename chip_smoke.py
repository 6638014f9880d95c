"""Smoke test of the PyTorch port (``cirkit_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device: requires CUDA, prints the card's name and power limit as
   ``nvidia-smi`` reports them, and turns TF32 off for the plain versions;
2. build: compiles ``cirkit_tpu_torch/csrc`` with ``nvcc`` into ``build/``;
3. kernel against plain: every forward entry of the log-einsum-exp kernel
   against its plain PyTorch version on the card, at the flagship circuits'
   shapes and at edge shapes (O=1, a ragged batch, a row that is all -inf),
   with ``|kernel - plain| <= 1e-4 + 1e-5 |plain|`` in log space;
3b. backward against plain: every backward entry against its plain version
   (``*_bwd_ref``) on the same cases, with a random cotangent that is 0 on
   some rows, each gradient to ``|kernel - plain| <= 1e-4 max|plain| +
   1e-4 |plain|`` (linear sums of up to B or O*K2 terms), no NaN, and input
   gradients that are 0 where the plain version's are;
3c. routing against plain: the max-product Tucker kernel
   (``tropical_tucker2``) and the routing choice (``route_tucker2``) against
   their plain versions at the flagship's largest Tucker entry (F=784,
   B=128, K1=K2=O=64) with logits and with linear weights, and at edge
   shapes (B=13, O=1, O=70, K1 != K2, -inf children, zero weights, -inf
   logits): tropical values to ``|kernel - plain| <= 1e-5 |plain| + 1e-5``
   with the same -inf pattern; each argmax by the score of its choice, the
   plain scores at the kernel's index within ``1e-5 |max| + 1e-5`` of the
   plain maximum (f32 rounding may flip near-ties; the indices that differ
   are counted); the Gumbel draws of the ``"sample"`` kind over 65,536
   identical rows against the exact ``softmax(scores)``, every frequency
   within ``5 sqrt(p(1-p)/N) + 1e-3``, and the same draws from the same
   seed;
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
   around forward, backward and optimizer, 10 steps after 3 warm-ups); and
   ``fit`` over 3 batches with ``checkpoint_every=2``, interrupted after its
   checkpoint and resumed to the end. The EM-ready Tucker store takes the
   gradient of its log-likelihood (the E-step's expected counts that
   ``fit_em`` reads): the same gradient check, one counted call at batch
   128 and its median time;
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
   query, and the device time of MAP and sampling by kernel category.

The line before the last is a JSON object with each kernel's launches on
its main path (the forward ops in phase 4, the backward ops in phase 5,
the routing ops in phase 7), its worst error and its median time beside
the plain version's; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SOURCE = "cirkit_tpu_torch/csrc/lse_einsum.cu"
REPLACES = "cirkit_tpu/ops/lse_einsum.py:335"
BWD_SOURCE = "cirkit_tpu_torch/csrc/lse_einsum_bwd.cu"
BWD_REPLACES = "cirkit_tpu/ops/lse_einsum.py:350"
ROUTE_SOURCE = "cirkit_tpu_torch/csrc/tucker_route.cu"
ROUTE_REPLACES = {  # the Pallas kernel each routing op replaces
    "tropical_tucker2": "cirkit_tpu/ops/lse_einsum.py:1334",
    "route_tucker2": "cirkit_tpu/ops/lse_einsum.py:1176",
}
DEV = "cuda"  # the device of phases 3c and 7
ROUTE_FLAGSHIP = (784, 128, 64, 64, 64)  # F, B, K1, K2, O of the largest Tucker entry
TROP_ATOL = TROP_RTOL = 1e-5  # tropical bound: TROP_RTOL |plain| + TROP_ATOL
SCORE_REL = SCORE_ABS = 1e-5  # route bound on the chosen score
FREQ_ROWS = 65536  # identical rows of the sample-kind frequency check
FLAGSHIP_K = 64
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
# Gradient check on GRAD_ROWS rows: |f32 - f64| <= GRAD_REL max|slot| +
# GRAD_ABS per slot. In f32, log-values near the flagship's log-likelihood
# of -4.4e3 carry an ulp of 4.9e-4, which every layer's exp(x - shift)
# turns into relative error of the gradients below it (GRAD_REL: 4 ulps).
# Near the root the true gradients are exponentially small (the posteriors
# are peaked), and the softmax VJP cancels terms of the size of the unit
# flows, at most 1 for a mean NLL, leaving an absolute floor (GRAD_ABS).
# The plain f32 composition on the CPU stays within a sixth of this bound.
GRAD_ROWS, GRAD_REL, GRAD_ABS = 8, 2e-3, 1e-4


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


def _cases(gen):
    """(op, kernel wrapper, plain version, inputs, label) at the flagship
    shapes first, then the edge shapes."""
    import torch

    from cirkit_tpu_torch.ops import lse_einsum as L

    dev = "cuda"

    def logx(*shape):
        return torch.randn(shape, generator=gen, device=dev) * 3.0 - 2.0

    def weights(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 0.99 + 0.01

    def logits(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    dense = (L.lse_matmul, L.lse_matmul_ref)
    dense_sm = (L.lse_matmul_softmax, L.lse_matmul_softmax_ref)
    tucker = (L.lse_tucker2, L.lse_tucker2_ref)
    tucker_sm = (L.lse_tucker2_softmax, L.lse_tucker2_softmax_ref)
    b = BATCH
    cases = [
        ("lse_matmul_softmax", *dense_sm, (logx(1568, b, 64), logits(1568, 64, 64)),
         "F=1568 B=128 I=64 O=64"),
        ("lse_matmul", *dense, (logx(196, b, 128), weights(196, 64, 128)),
         "F=196 B=128 I=128 O=64"),
        ("lse_tucker2_softmax", *tucker_sm,
         (logx(784, b, 64), logx(784, b, 64), logits(784, 64, 4096)),
         "F=784 B=128 K1=K2=64 O=64"),
        ("lse_tucker2", *tucker,
         (logx(784, b, 64), logx(784, b, 64), weights(784, 64, 4096)),
         "F=784 B=128 K1=K2=64 O=64"),
        ("lse_matmul_softmax", *dense_sm, (logx(2, b, 64), logits(2, 1, 64)), "O=1"),
        ("lse_matmul", *dense, (logx(1, b, 2), weights(1, 1, 2)), "O=1 I=2"),
        ("lse_tucker2_softmax", *tucker_sm,
         (logx(2, b, 64), logx(2, b, 64), logits(2, 1, 4096)), "O=1"),
        ("lse_tucker2", *tucker, (logx(2, b, 64), logx(2, b, 64), weights(2, 1, 4096)), "O=1"),
        ("lse_matmul", *dense, (logx(5, 13, 64), weights(5, 64, 64)), "ragged B=13"),
        ("lse_matmul_softmax", *dense_sm, (logx(5, 13, 128), logits(5, 64, 128)),
         "ragged B=13"),
        ("lse_tucker2", *tucker, (logx(5, 13, 8), logx(5, 13, 16), weights(5, 16, 128)),
         "ragged B=13 K1=8 K2=16"),
        ("lse_tucker2_softmax", *tucker_sm,
         (logx(5, 13, 64), logx(5, 13, 64), logits(5, 64, 4096)), "ragged B=13"),
    ]
    # rows that are all -inf must give -inf, never NaN
    for op, kernel, plain, ins in (
        ("lse_matmul", *dense, (logx(3, 16, 64), weights(3, 64, 64))),
        ("lse_matmul_softmax", *dense_sm, (logx(3, 16, 64), logits(3, 64, 64))),
        ("lse_tucker2", *tucker, (logx(3, 16, 64), logx(3, 16, 64), weights(3, 64, 4096))),
        ("lse_tucker2_softmax", *tucker_sm,
         (logx(3, 16, 64), logx(3, 16, 64), logits(3, 64, 4096))),
    ):
        ins[0][1, 5] = float("-inf")
        cases.append((op, kernel, plain, ins, "row all -inf"))
    return cases


def phase_kernels() -> dict[str, dict]:
    """Each kernel entry against its plain version; returns per-op results
    (the times are those of the first, flagship-shaped case)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    results: dict[str, dict] = {}
    with torch.inference_mode():
        for op, kernel, plain, ins, label in _cases(gen):
            got = kernel(*ins)
            ref = plain(*ins)
            torch.cuda.synchronize()
            if got.shape != ref.shape or torch.isnan(got).any():
                raise AssertionError(f"{op} [{label}]: shape {tuple(got.shape)} or NaN")
            same_inf = torch.equal(torch.isneginf(got), torch.isneginf(ref))
            finite = torch.isfinite(ref)
            err = (got[finite] - ref[finite]).abs()
            bound = ATOL + RTOL * ref[finite].abs()
            max_err = float(err.max()) if err.numel() else 0.0
            if not same_inf or not bool((err <= bound).all()):
                raise AssertionError(
                    f"{op} [{label}]: max |kernel - plain| = {max_err:.3e} "
                    f"(bound {ATOL} + {RTOL}|ref|), -inf pattern equal: {same_inf}"
                )
            entry = results.setdefault(op, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], max_err)
            line = f"[kernel] {op:20s} {label:28s} max|err|={max_err:.3e}"
            if "ms" not in entry:
                entry["ms"] = _median_ms(lambda: kernel(*ins))
                entry["plain_ms"] = _median_ms(lambda: plain(*ins))
                entry["shape"] = label
                line += f"  kernel {entry['ms']:.3f} ms, plain {entry['plain_ms']:.3f} ms"
            print(line)
    return results


def _route_cases(gen):
    """(label, x1, x2, th, log_weights, sel) at the flagship's largest Tucker
    entry first, then the edge shapes; sel has some -1 rows (clamped)."""
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


def phase_routing() -> dict[str, dict]:
    """Both routing kernels against their plain versions; returns per-op
    results (times of the flagship-shaped case with logits)."""
    import torch

    from cirkit_tpu_torch.ops import routing as R

    gen = torch.Generator(device=DEV).manual_seed(2)
    results = {op: {"max_abs_err": 0.0} for op in R.ROUTING_OPS}
    with torch.inference_mode():
        for label, x1, x2, th, lw, sel in _route_cases(gen):
            got = R.tropical_tucker2(x1, x2, th, log_weights=lw)
            ref = R.tropical_tucker2_ref(x1, x2, th, log_weights=lw)
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
            entry = results["tropical_tucker2"]
            entry["max_abs_err"] = max(entry["max_abs_err"], max_err)
            line = f"[routing] tropical_tucker2 {label:36s} max|err|={max_err:.3e}"
            if "ms" not in entry:
                entry["ms"] = _median_ms(lambda: R.tropical_tucker2(x1, x2, th, log_weights=lw))
                entry["plain_ms"] = _median_ms(
                    lambda: R.tropical_tucker2_ref(x1, x2, th, log_weights=lw), iters=5)
                entry["shape"] = label
                line += f"  kernel {entry['ms']:.3f} ms, plain {entry['plain_ms']:.3f} ms"
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
                line += (f"  max: kernel {entry['ms']:.3f} ms, plain {entry['plain_ms']:.3f} "
                         f"ms; sample: kernel {entry['sample_ms']:.3f} ms, plain "
                         f"{entry['sample_plain_ms']:.3f} ms")
            print(line)
        for lw in (True, False):
            share = _sample_frequencies(R, lw)
            print(f"[routing] route_tucker2 sample, log_weights={lw}: frequencies over "
                  f"{FREQ_ROWS} rows within {share:.3f} of the bound; seed-reproducible")
    return results


def _zero_launches() -> None:
    from cirkit_tpu_torch.ops import lse_einsum as L

    for op in L.LAUNCHES:
        L.LAUNCHES[op] = 0


def phase_backward() -> dict[str, dict]:
    """Each backward entry against its plain version on the cases of phase
    3; returns per-op results (times of the flagship-shaped case)."""
    import torch

    from cirkit_tpu_torch.ops import lse_einsum as L

    gen = torch.Generator(device="cuda").manual_seed(1)
    results: dict[str, dict] = {}
    with torch.inference_mode():
        for op, _, plain, ins, label in _cases(gen):
            out = plain(*ins)
            g = torch.randn(out.shape, generator=gen, device="cuda")
            g[0, : min(3, g.shape[1])] = 0.0  # rows whose upstream gradient is 0
            got = L.backward(op, ins, out, g)
            ref = getattr(L, f"{op}_bwd_ref")(*ins, out, g)
            torch.cuda.synchronize()
            max_err = 0.0
            names = ("dx1", "dx2", "dw") if len(ins) == 3 else ("dx", "dw")
            for name, k, p in zip(names, got, ref):
                if k.shape != p.shape or torch.isnan(k).any():
                    raise AssertionError(f"{op} [{label}] {name}: shape {tuple(k.shape)} or NaN")
                # the input gradients' zeros are structural (rows of -inf, rows
                # whose cotangent is 0); a weight gradient can be 0 by a tie
                if name != "dw" and not bool((k[p == 0] == 0).all()):
                    raise AssertionError(f"{op} [{label}] {name}: not 0 where the plain is 0")
                err = (k - p).abs()
                bound = BWD_REL * (p.abs().max() + p.abs())
                if not bool((err <= bound).all()):
                    raise AssertionError(
                        f"{op} [{label}] {name}: max |kernel - plain| = {float(err.max()):.3e} "
                        f"(bound {BWD_REL} (max|plain| + |plain|), max|plain| "
                        f"{float(p.abs().max()):.3e})"
                    )
                max_err = max(max_err, float(err.max()))
            entry = results.setdefault(f"{op}_bwd", {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], max_err)
            line = f"[backward] {op:20s} {label:28s} max|err|={max_err:.3e}"
            if "ms" not in entry:
                entry["ms"] = _median_ms(lambda: L.backward(op, ins, out, g))
                entry["plain_ms"] = _median_ms(
                    lambda: getattr(L, f"{op}_bwd_ref")(*ins, out, g)
                )
                entry["shape"] = label
                line += f"  kernel {entry['ms']:.3f} ms, plain {entry['plain_ms']:.3f} ms"
            print(line)
    return results


def _kernel_layers():
    from cirkit_tpu_torch.backend.torch.layers import TorchSumLayer
    from cirkit_tpu_torch.backend.torch.optimized import TorchCPTLayer, TorchTuckerLayer

    return (TorchSumLayer, TorchCPTLayer, TorchTuckerLayer)


def _build_flagship(spl: str, em_ready: bool, device: str):
    from cirkit_tpu_torch.models import image_data
    from cirkit_tpu_torch.pipeline import PipelineContext

    sc = image_data(
        (1, 28, 28),
        "quad-graph",
        input_layer="categorical",
        num_input_units=FLAGSHIP_K,
        sum_product_layer=spl,
        num_sum_units=FLAGSHIP_K,
        em_ready=em_ready,
    )
    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True, device=device, seed=0)
    return sc, ctx, ctx.compile(sc)


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
        _, ctx_cpu, cc_cpu = _build_flagship(spl, em, "cpu")
        ctx_cpu.load_parameters(
            {k: v.detach().cpu().numpy() for k, v in ctx.parameters.items()},
            dtype=torch.float64,
        )
        with torch.inference_mode():
            ref = cc_cpu(torch.as_tensor(x_np[:8])).numpy()
        got = out[:8].double().cpu().numpy()
        rel = float(np.max(np.abs(got - ref) / np.abs(ref)))
        if not np.allclose(got, ref, rtol=1e-5, atol=0.0):
            raise AssertionError(f"{spl} em_ready={em}: max relative error {rel:.3e} > 1e-5")
        del ctx_cpu, cc_cpu
        with torch.inference_mode():
            ms = _median_ms(lambda: cc(x))
        print(
            f"[slice] {spl} em_ready={em}: out {tuple(out.shape)} finite, "
            f"mean log-likelihood {float(out.mean()):.3f}, max rel err vs CPU float64 "
            f"{rel:.2e}; forward {ms:.3f} ms median of 20 = {BATCH / ms * 1e3:.1f} samples/s "
            f"({smi})"
        )
    return built, launches


def _check_gradients(label: str, spl: str, em: bool, ctx, cc, x_np) -> None:
    """The mean NLL's gradient of every learnable slot on GRAD_ROWS rows:
    the kernel path in f32 on the card against the same store in float64
    on the CPU, through the plain versions."""
    import numpy as np
    import torch

    from cirkit_tpu_torch.parallel import split_trainable

    tr, fr = split_trainable(cc, ctx.parameters)
    x = torch.as_tensor(x_np[:GRAD_ROWS], device="cuda")
    got = torch.autograd.grad(-cc.evaluate({**tr, **fr}, x).mean(), list(tr.values()))
    _, ctx_cpu, cc_cpu = _build_flagship(spl, em, "cpu")
    ctx_cpu.load_parameters(
        {k: v.detach().cpu().numpy() for k, v in ctx.parameters.items()}, dtype=torch.float64
    )
    tr_c, fr_c = split_trainable(cc_cpu, ctx_cpu.parameters)
    loss_c = -cc_cpu.evaluate({**tr_c, **fr_c}, torch.as_tensor(x_np[:GRAD_ROWS])).mean()
    refs = torch.autograd.grad(loss_c, [tr_c[k] for k in tr])
    worst = 0.0  # the largest error as a share of its bound
    for k, g, r in zip(tr, got, refs):
        g = g.double().cpu().numpy()
        r = r.numpy()
        err = float(np.abs(g - r).max())
        share = err / (GRAD_REL * float(np.abs(r).max()) + GRAD_ABS)
        if not np.isfinite(g).all() or not share <= 1.0:
            raise AssertionError(f"{label}: gradient of {k} off by {err:.3e}, max|slot| "
                                 f"{float(np.abs(r).max()):.3e} (bound {GRAD_REL} max + "
                                 f"{GRAD_ABS})")
        worst = max(worst, share)
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

    bwd = {op: launches[op] for op in L.LAUNCHES if op.endswith("_bwd")}
    print(f"[train] backward launches on the main path: {bwd}")
    missing = [op for op, n in bwd.items() if n == 0]
    if missing:
        raise AssertionError(f"backward kernels not launched on the main path: {missing}")
    return bwd


PROFILE_STEPS = 5
_KERNEL_CATEGORIES = (  # (category, substrings of kernel names), first match wins
    ("tropical kernel", ("tropical_tucker",)),
    ("route kernel", ("route_tucker",)),
    ("forward kernel", ("lse_fwd",)),
    ("backward kernel", ("bwd_prep", "softmax_weights", "lse_bwd_dx", "lse_bwd_dw",
                         "softmax_vjp")),
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


def _device_breakdown(fn, calls: int) -> str:
    """``torch.profiler`` over ``calls`` calls of ``fn`` (after a warm-up):
    device ms a call by kernel category, and the device's idle share."""
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
    cats: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            cat = _kernel_category(e.key)
            cats[cat] = cats.get(cat, 0.0) + e.self_device_time_total / 1e3 / calls
    device = sum(cats.values())
    return (f"{wall:.3f} ms a call under the profiler, device busy {device:.3f} ms "
            f"(idle {1 - device / wall:.1%}): "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(cats.items(), key=lambda i: -i[1])))


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

    routed = {op: launches[op] for op in ROUTE_REPLACES}
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
    _, ctx_cpu, cc_cpu = _build_flagship("tucker", False, "cpu")
    ctx_cpu.load_parameters(
        {k: v.detach().cpu().numpy() for k, v in ctx.parameters.items()}, dtype=torch.float64
    )
    r = QUERY_ROWS
    xr, mr, gr = (torch.as_tensor(a[:r]) for a in (x_np, mask_np, marg_np))
    want_marg = IntegrateQuery(cc_cpu)(xr, integrate_vars=mr)
    want_map = MAPQuery(cc_cpu)(xr, evidence_mask=mr)
    want_map_m = MAPQuery(cc_cpu)(xr, evidence_mask=mr, marginalize_vars=gr)
    _, want_ev = SamplingQuery(cc_cpu).conditional(xr, evidence_mask=mr,
                                                   generator=torch.Generator().manual_seed(0))
    del ctx_cpu, cc_cpu
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


def main() -> int:
    import torch

    if not (REPO / "cirkit_tpu_torch").is_dir():
        raise RuntimeError(f"no cirkit_tpu_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(REPO))
    smi = phase_device()
    phase_build()
    results = phase_kernels()
    results.update(phase_backward())
    results.update(phase_routing())
    built, launches = phase_slice(smi)
    launches.update(phase_train(smi, built))
    phase_profile(smi, built)
    query_launches = phase_queries(smi, built)
    launches.update({op: query_launches[op] for op in ROUTE_REPLACES})

    def source(op: str) -> tuple[str, str]:
        if op in ROUTE_REPLACES:
            return ROUTE_SOURCE, ROUTE_REPLACES[op]
        return (BWD_SOURCE, BWD_REPLACES) if op.endswith("_bwd") else (SOURCE, REPLACES)

    kernels = [
        {
            "name": op,
            "route": "cuda",
            "source": source(op)[0],
            "replaces": source(op)[1],
            "launches": launches[op],
            "max_abs_err": results[op]["max_abs_err"],
            "ms": results[op]["ms"],
            "plain_ms": results[op]["plain_ms"],
        }
        for op in launches
    ]
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
