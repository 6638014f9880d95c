"""Time the float32 forward kernels and the wide backward of two source trees
side by side on one card.

Run on a machine with a CUDA card and the CUDA toolkit, from the root of a
checkout, with the ``csrc`` directory of another tree (for example the
parent commit unpacked by ``git archive`` into a directory that
``.gitignore`` lists):

    python3 scripts/wide_ab.py OTHER_CSRC

Each tree's ``lse_wide.cu`` and ``lse_einsum.cu`` are compiled (flags of
``cirkit_tpu_torch/ops/_build.py``) into a library of its own, and the
entries of both are called on the same inputs, in turns (other, this, this,
other): ``lse_fwd_ct`` and ``lse_fwd_ct_softmax`` at the K=128 Tucker entry
(F=784, B=128, K1=K2=O=128), ``lse_fwd_blocked`` (out and the row max) and
``lse_bwd_blocked`` (dx only, dw only, both) at the dense K=128 entry
(I=16384, O=128), and ``lse_fwd_tucker`` and ``lse_fwd_tucker_softmax`` at
the K=64 Tucker entry (F=784, B=128, K1=K2=O=64). Each time is the median
of 20 CUDA-event timings after 3 warm-ups. Both trees' outputs are held to
each other (forward in log space to ``1e-4 + 1e-5 |other|``, the row maxes
equal, gradients to ``1e-4 (max|other| + |other|)``). The gy scratch is
allocated with room for either tree's layout. Prints one line a kernel and
tree, and the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from ab_turns import in_turns  # noqa: E402

from cirkit_tpu_torch.ops._build import _SIGNATURES, NVCC_FLAGS, _nvcc  # noqa: E402

ENTRIES = ("lse_fwd_ct", "lse_fwd_ct_softmax", "lse_fwd_blocked", "lse_bwd_blocked",
           "lse_fwd_tucker", "lse_fwd_tucker_softmax")
SOURCES = ("lse_wide.cu", "lse_einsum.cu")


def _library(csrc: Path, out: Path) -> ctypes.CDLL:
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(out),
                    *(str(csrc / src) for src in SOURCES)], check=True)
    lib = ctypes.CDLL(str(out))
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = _SIGNATURES[name]
    return lib


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

    def fwd_close(got, ref) -> float:
        err = (got - ref).abs()
        assert torch.equal(torch.isneginf(got), torch.isneginf(ref))
        finite = torch.isfinite(ref)
        assert bool((err[finite] <= 1e-4 + 1e-5 * ref[finite].abs()).all()), float(err.max())
        return float(err[finite].max())

    # the Tucker forwards: K1-chunked at K=128, single-pass at K=64
    for entry, kt in (("lse_fwd_ct", k), ("lse_fwd_ct_softmax", k), ("lse_fwd_tucker", 64),
                      ("lse_fwd_tucker_softmax", 64)):
        x1, x2 = randn(f, b, kt) * 3 - 2, randn(f, b, kt) * 3 - 2
        w = randn(f, kt, kt * kt) if entry.endswith("softmax") else (
            torch.rand((f, kt, kt * kt), generator=gen, device="cuda") * 0.99 + 0.01)
        outs = {name: torch.empty((f, b, kt), device="cuda") for name in libs}

        def call(name, w=w, entry=entry, outs=outs, x1=x1, x2=x2, kt=kt):
            err = getattr(libs[name], entry)(x1.data_ptr(), x2.data_ptr(), w.data_ptr(),
                                             outs[name].data_ptr(), f, b, kt, kt, kt, 0, stream)
            assert err == 0, err

        times = in_turns(call, libs)
        err = fwd_close(outs["this"], outs["other"])
        for name in libs:
            print(f"{entry:22s} {name:5s} ms {times[name]}  max|this - other| {err:.3e}  "
                  f"(F={f} B={b} K1=K2=O={kt})")
        del x1, x2, w, outs

    i = k * k
    x = randn(f, b, i) * 3 - 2
    w = torch.rand((f, k, i), generator=gen, device="cuda") * 0.99 + 0.01
    fwd = {name: (torch.empty((f, b, k), device="cuda"), torch.empty((f, b, 1), device="cuda"))
           for name in libs}

    def blocked(name):
        out_, m_ = fwd[name]
        err = libs[name].lse_fwd_blocked(x.data_ptr(), w.data_ptr(), out_.data_ptr(),
                                         m_.data_ptr(), f, b, i, k, 0, stream)
        assert err == 0, err

    times = in_turns(blocked, libs)
    err = fwd_close(fwd["this"][0], fwd["other"][0])
    assert torch.equal(fwd["this"][1], fwd["other"][1])
    for name in libs:
        print(f"{'lse_fwd_blocked':22s} {name:5s} ms {times[name]}  max|this - other| {err:.3e}"
              f"  (F={f} B={b} I={i} O={k}; row maxes equal)")
    del fwd
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
        part = in_turns(lambda name, need=need: bwd(name, need), libs)
        for name in libs:
            print(f"{'lse_bwd_blocked':22s} {name:5s} ms {part[name]}  ({label})")
    times = in_turns(bwd, libs)
    torch.cuda.synchronize()
    errs = []
    for got, ref in zip(grads["this"], grads["other"]):
        err = (got - ref).abs()
        assert bool((err <= 1e-4 * (ref.abs().max() + ref.abs())).all()), float(err.max())
        errs.append(float(err.max()))
    for name in libs:
        print(f"{'lse_bwd_blocked':22s} {name:5s} ms {times[name]}  max|this - other| dx "
              f"{errs[0]:.3e} dw {errs[1]:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
