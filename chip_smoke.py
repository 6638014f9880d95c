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
   kernel category and the device's idle share.

The line before the last is a JSON object with each kernel's launches on
its main path (the forward ops in phase 4, the backward ops in phase 5),
its worst error and its median time beside the plain version's; the last
line is ``{"ok": true, "device": {...}}``.
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
        num_input_units=64,
        sum_product_layer=spl,
        num_sum_units=64,
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


def main() -> int:
    import torch

    if not (REPO / "cirkit_tpu_torch").is_dir():
        raise RuntimeError(f"no cirkit_tpu_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(REPO))
    smi = phase_device()
    phase_build()
    results = phase_kernels()
    results.update(phase_backward())
    built, launches = phase_slice(smi)
    launches.update(phase_train(smi, built))
    phase_profile(smi, built)
    kernels = [
        {
            "name": op,
            "route": "cuda",
            "source": BWD_SOURCE if op.endswith("_bwd") else SOURCE,
            "replaces": BWD_REPLACES if op.endswith("_bwd") else REPLACES,
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
