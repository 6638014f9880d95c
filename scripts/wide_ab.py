"""Time the wide float32 kernels of two source trees side by side on one card.

Run on a machine with a CUDA card and the CUDA toolkit, from the root of a
checkout, with the ``csrc`` directory of another tree (for example the
parent commit unpacked by ``git archive`` into a directory that
``.gitignore`` lists):

    python3 scripts/wide_ab.py OTHER_CSRC

Each tree's ``lse_wide.cu`` is compiled alone (flags of
``cirkit_tpu_torch/ops/_build.py``) into a library of its own, and the
entries ``lse_fwd_ct``, ``lse_fwd_ct_softmax`` and ``lse_bwd_blocked`` (dx
only, dw only, both) of both are called on the same inputs at the K=128 entries of the flagship
(F=784, B=128, K1=K2=O=128; dense I=16384, O=128), in turns (other, this,
this, other): each time is the median of 20 CUDA-event timings after 3
warm-ups. Both trees' outputs are held to each other (forward in log space
to ``1e-4 + 1e-5 |other|``, gradients to ``1e-4 (max|other| + |other|)``).
The gy scratch is allocated with room for either tree's layout. Prints one
line a kernel and tree, and the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from cirkit_tpu_torch.ops._build import _SIGNATURES, NVCC_FLAGS, _nvcc  # noqa: E402

ENTRIES = ("lse_fwd_ct", "lse_fwd_ct_softmax", "lse_bwd_blocked")


def _library(csrc: Path, out: Path) -> ctypes.CDLL:
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(out), str(csrc / "lse_wide.cu")],
                   check=True)
    lib = ctypes.CDLL(str(out))
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = _SIGNATURES[name]
    return lib


def _median_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    trees = {"other": Path(sys.argv[1]), "this": REPO / "cirkit_tpu_torch" / "csrc"}
    tmp = Path(tempfile.mkdtemp(dir=REPO / "build")) if (REPO / "build").is_dir() else Path(
        tempfile.mkdtemp())
    libs = {name: _library(path, tmp / f"lib{name}.so") for name, path in trees.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    f, b, k = 784, 128, 128
    stream = torch.cuda.current_stream().cuda_stream

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x1, x2 = randn(f, b, k) * 3 - 2, randn(f, b, k) * 3 - 2
    for entry in ENTRIES[:2]:
        w = randn(f, k, k * k) if entry.endswith("softmax") else (
            torch.rand((f, k, k * k), generator=gen, device="cuda") * 0.99 + 0.01)
        outs = {name: torch.empty((f, b, k), device="cuda") for name in libs}

        def call(name, w=w, entry=entry, outs=outs):
            err = getattr(libs[name], entry)(x1.data_ptr(), x2.data_ptr(), w.data_ptr(),
                                             outs[name].data_ptr(), f, b, k, k, k, 0, stream)
            assert err == 0, err

        times = {name: [] for name in libs}
        for name in ("other", "this", "this", "other"):
            times[name].append(_median_ms(lambda name=name: call(name)))
        ref, got = outs["other"], outs["this"]
        err = float((got - ref).abs().max())
        assert bool(((got - ref).abs() <= 1e-4 + 1e-5 * ref.abs()).all()), err
        for name in libs:
            print(f"{entry:20s} {name:5s} ms {times[name]}  max|this - other| {err:.3e}")
        del w, outs

    i = k * k
    x = randn(f, b, i) * 3 - 2
    w = torch.rand((f, k, i), generator=gen, device="cuda") * 0.99 + 0.01
    m = x.amax(-1, keepdim=True)
    out = torch.log(torch.bmm(torch.exp(x - m), w.transpose(1, 2))) + m
    g = randn(f, b, k)
    gy = torch.empty((f, b, k, 2), device="cuda")
    grads = {name: (torch.empty_like(x), torch.empty_like(w)) for name in libs}

    def bwd(name, need=(True, True)):
        dx, dw = (d.data_ptr() if n else None for d, n in zip(grads[name], need))
        err = libs[name].lse_bwd_blocked(*(t.data_ptr() for t in (x, w, out, m, g)), dx, dw,
                                         gy.data_ptr(), f, b, i, k, 0, stream)
        assert err == 0, err

    # the gradients alone first (dx only, dw only), then both
    for need, label in (((True, False), "dx only"), ((False, True), "dw only")):
        part = {name: [] for name in libs}
        for name in ("other", "this", "this", "other"):
            part[name].append(_median_ms(lambda name=name: bwd(name, need)))
        for name in libs:
            print(f"{'lse_bwd_blocked':20s} {name:5s} ms {part[name]}  ({label})")
    times = {name: [] for name in libs}
    for name in ("other", "this", "this", "other"):
        times[name].append(_median_ms(lambda name=name: bwd(name)))
    torch.cuda.synchronize()
    errs = []
    for got, ref in zip(grads["this"], grads["other"]):
        err = (got - ref).abs()
        assert bool((err <= 1e-4 * (ref.abs().max() + ref.abs())).all()), float(err.max())
        errs.append(float(err.max()))
    for name in libs:
        print(f"{'lse_bwd_blocked':20s} {name:5s} ms {times[name]}  max|this - other| dx "
              f"{errs[0]:.3e} dw {errs[1]:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
