"""Smoke test of the PyTorch port (``cirkit_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device: requires CUDA, prints the card's name and power limit as
   ``nvidia-smi`` reports them, and turns TF32 off for the plain versions;
2. build: compiles ``cirkit_tpu_torch/csrc`` with ``nvcc`` into ``build/``;
3. kernel against plain: every entry of the log-einsum-exp kernel against
   its plain PyTorch version on the card, at the flagship circuits' shapes
   and at edge shapes (O=1, a ragged batch, a row that is all -inf), with
   ``|kernel - plain| <= 1e-4 + 1e-5 |plain|`` in log space;
4. slice: the MNIST QuadGraph flagship forward (K=64, 784 variables, batch
   128) for the Tucker circuit, the CP circuit and the Tucker circuit with
   plain (EM-ready) weights, through ``PipelineContext.compile`` and
   ``cc(x)``: the output's shape and finiteness, the kernel launches of the
   run against the kernel-bearing plan entries, agreement of 8 rows with a
   float64 CPU evaluation of the same store (rtol 1e-5), and the median
   forward time.

The line before the last is a JSON object with each kernel's launches on
the main path, its worst error and its median time beside the plain
version's; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SOURCE = "cirkit_tpu_torch/csrc/lse_einsum.cu"
REPLACES = "cirkit_tpu/ops/lse_einsum.py:335"
ATOL, RTOL = 1e-4, 1e-5
BATCH = 128
FLAGSHIPS = (  # (sum_product_layer, em_ready)
    ("tucker", False),
    ("cp", False),
    ("tucker", True),
)


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


def phase_slice(smi: str) -> dict[str, int]:
    """The flagship forwards through the kernels; returns the launches of
    each op over the main-path run."""
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
    for op in L.LAUNCHES:
        L.LAUNCHES[op] = 0
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
    launches = dict(L.LAUNCHES)
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
    return launches


def main() -> int:
    import torch

    if not (REPO / "cirkit_tpu_torch").is_dir():
        raise RuntimeError(f"no cirkit_tpu_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(REPO))
    smi = phase_device()
    phase_build()
    results = phase_kernels()
    launches = phase_slice(smi)
    kernels = [
        {
            "name": op,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES,
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
