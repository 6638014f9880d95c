"""Time the signed and complex backward kernels (kernels 7 and 11) of one or
two source trees side by side on one card, with each launch's share.

Run on a machine with a CUDA card and the CUDA toolkit, from the root of a
checkout, alone or with the ``csrc`` directory of another tree (for example
the parent commit unpacked by ``git archive`` into a directory that
``.gitignore`` lists), or with ``--split``:

    python3 scripts/sos_bwd_ab.py [OTHER_CSRC | --split]

``--split`` takes as the other tree a copy of this one whose Tucker dx
always takes the K1 split (``tucker_dx_fits`` made to return false in both
sources), and times the K=64 Tucker entries only, where this tree's dx is
the single-block kernel.

Each tree's ``lse_einsum_bwd.cu`` and ``clse_einsum.cu`` are compiled (flags
of ``cirkit_tpu_torch/ops/_build.py``) into a library of its own. The
backward entries of both are called on the same inputs, in turns (other,
this, this, other), at the squared circuits' largest TensorDot entry (the
SoS entry: F=144, B*Kq=4096, I=O=32) and at the K=64 Tucker entry (F=784,
B=128, K1=K2=O=64): the signed entries (``slse_bwd_*``, float32 and
float64, plain weights and logits), the complex one (``clse_bwd``,
complex64 and complex128, complex and real weights) and, at the Tucker
entry, the float64 lse one (``lse_bwd_tucker_f64``, plain weights and
logits). The forward's outputs
come from the plain versions of ``cirkit_tpu_torch.ops``. Each time is the
median of 20 CUDA-event timings after 3 warm-ups. ``torch.profiler`` then
splits one call of each tree into its launches (device ms a call by kernel,
over 10 calls). The trees' gradients are held to each other (``1e-4
(max|other| + |other|)``, 1e-9 in float64) and two calls of this tree to the
bit. A tree that exports ``lse_bwd_gy_size``/``clse_bwd_gy_size`` gets a gy
scratch of that size (it keeps its partial sums there), another one of
(F, B, O). Prints one line a case and tree, and the card's name and power
limit first.
"""

from __future__ import annotations

import ctypes
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from cirkit_tpu_torch.ops import clse_einsum as C  # noqa: E402
from cirkit_tpu_torch.ops import lse_einsum as L  # noqa: E402
from cirkit_tpu_torch.ops import slse_einsum as S  # noqa: E402
from cirkit_tpu_torch.ops._build import _SIGNATURES, NVCC_FLAGS, _nvcc  # noqa: E402

SOURCES = ("lse_einsum_bwd.cu", "clse_einsum.cu")
SIGNED = ("slse_bwd_dense", "slse_bwd_dense_softmax", "slse_bwd_tucker",
          "slse_bwd_tucker_softmax")
LSE = ("lse_bwd_tucker_f64", "lse_bwd_tucker_softmax_f64")
# the head of the Tucker dx's route choice in both sources
FITS = "inline bool tucker_dx_fits(int K1, int K2) {"
SOS, K64 = (144, 4096, 32, 32), (784, 128, 64, 64)  # F, B, I (K), O
_SIZE = ctypes.c_size_t
_I = ctypes.c_int


def _library(csrc: Path, out: Path) -> ctypes.CDLL:
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(out),
                    *(str(csrc / src) for src in SOURCES)], check=True)
    lib = ctypes.CDLL(str(out))
    for name in (*SIGNED, *(f"{n}_f64" for n in SIGNED), *LSE, "clse_bwd"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = _SIGNATURES[name]
    for name, n_args in (("lse_bwd_gy_size", 7), ("lse_bwd_gy_size_f64", 7),
                         ("clse_bwd_gy_size", 8)):
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = (_I,) * n_args, _SIZE
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


def _split(fn, calls: int = 10) -> str:
    """Device ms a call by kernel (the name without its namespace and
    parameters), from torch.profiler over ``calls`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    parts: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            name = e.key.removeprefix("void ").replace("(anonymous namespace)::", "")
            name = name.split("(")[0]
            parts[name] = parts.get(name, 0.0) + e.self_device_time_total / 1e3 / calls
    total = sum(parts.values())
    return f"device {total:.4f} ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in sorted(parts.items(), key=lambda i: -i[1]))


def _split_copy(csrc: Path, out: Path) -> Path:
    """A copy of ``csrc`` whose Tucker dx always takes the K1 split."""
    shutil.copytree(csrc, out)
    for src in SOURCES:
        text = (out / src).read_text()
        if text.count(FITS) != 1:
            raise RuntimeError(f"{src}: no single {FITS!r}")
        (out / src).write_text(text.replace(FITS, FITS + "\n  return false;"))
    return out


def _signed_case(gen, entry: str, shape, dtype):
    """(inputs, outputs and cotangent, gradient shapes) of a signed entry."""
    f, b, k, o = shape
    tucker, softmax = "tucker" in entry, "softmax" in entry

    def randn(*s):
        return torch.randn(s, generator=gen, device="cuda", dtype=dtype)

    ins = []
    for _ in range(2 if tucker else 1):
        ins += [randn(f, b, k) * 3 - 2,
                torch.randint(-1, 2, (f, b, k), generator=gen, device="cuda").to(dtype)]
    ins.append(randn(f, o, k * k if tucker else k))
    op = ("slse_tucker2" if tucker else "slse_matmul") + ("_softmax" if softmax else "")
    oa, os_ = getattr(S, f"{op}_ref")(*ins)
    g = randn(f, b, o)
    g[0, :3] = 0.0
    return ins, (oa, os_, g), [*ins[:-1:2], ins[-1]]


def _complex_case(gen, tucker: bool, real_w: bool, shape, ctype):
    f, b, k, o = shape
    real = torch.float64 if ctype == torch.complex128 else torch.float32

    def randn(*s):
        return torch.randn(s, generator=gen, device="cuda", dtype=real)

    def value(*s):
        phase = (torch.rand(s, generator=gen, device="cuda", dtype=real) * 2 - 1) * math.pi
        return torch.complex(randn(*s) * 3 - 2, phase)

    xs = [value(f, b, k) for _ in range(2 if tucker else 1)]
    wshape = (f, o, k * k if tucker else k)
    w = randn(*wshape) if real_w else torch.complex(randn(*wshape), randn(*wshape))
    out = (C.clse_tucker2_ref if tucker else C.clse_matmul_ref)(*xs, w)
    g = torch.complex(randn(f, b, o), randn(f, b, o))
    g[0, :3] = 0.0
    return [*xs, w], (out, g)


def main() -> int:
    if len(sys.argv) > 2 or not torch.cuda.is_available():
        print(__doc__)
        return 2
    split = sys.argv[1:] == ["--split"]
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    trees = {"this": REPO / "cirkit_tpu_torch" / "csrc"}
    (REPO / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=REPO / "build"))
    if split:
        trees = {"other": _split_copy(trees["this"], tmp / "split"), **trees}
        print("other: this tree with every Tucker dx on the K1 split")
    elif len(sys.argv) == 2:
        trees = {"other": Path(sys.argv[1]), **trees}
    libs = {name: _library(path, tmp / f"lib{name}.so") for name, path in trees.items()}
    order = ("other", "this", "this", "other") if "other" in libs else ("this", "this")
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    def in_turns(call) -> dict[str, list[float]]:
        times = {name: [] for name in libs}
        for name in order:
            times[name].append(_median_ms(lambda name=name: call(name)))
        return times

    def report(label, call, grads, rel):
        times = in_turns(call)
        for name in libs:
            call(name)
        torch.cuda.synchronize()
        first = [g.clone() for g in grads["this"]]
        call("this")
        torch.cuda.synchronize()
        repeat = all(torch.equal(a, b) for a, b in zip(first, grads["this"]))
        errs = []
        if "other" in libs:
            for got, ref in zip(grads["this"], grads["other"]):
                err = (got - ref).abs()
                if not bool((err <= rel * (ref.abs().max() + ref.abs())).all()):
                    raise AssertionError(f"{label}: trees differ by {float(err.max()):.3e}")
                errs.append(float(err.max()))
        for name in libs:
            print(f"{label:44s} {name:5s} ms {[round(t, 4) for t in times[name]]}"
                  + (f"  max|this - other| {max(errs):.3e}" if errs else "")
                  + ("  two calls equal to the bit" if name == "this" and repeat else ""))
            print(f"{'':44s} {name:5s} {_split(lambda name=name: call(name))}")
        if not repeat:
            raise AssertionError(f"{label}: two calls of this tree differ")

    for shape, where in ((SOS, "SoS"), (K64, "K=64 Tucker"))[1 if split else 0:]:
        if where != "SoS":
            for entry in LSE:
                softmax = "softmax" in entry
                f, b, k, o = shape
                x1, x2 = (torch.randn((f, b, k), generator=gen, device="cuda",
                                      dtype=torch.float64) * 3 - 2 for _ in range(2))
                w = torch.randn((f, o, k * k), generator=gen, device="cuda",
                                dtype=torch.float64)
                if not softmax:
                    w = w.abs() / (k * k)
                out = (L.lse_tucker2_softmax_ref if softmax else L.lse_tucker2_ref)(x1, x2, w)
                g = torch.randn((f, b, o), generator=gen, device="cuda", dtype=torch.float64)
                g[0, :3] = 0.0
                grads = {name: [torch.empty_like(t) for t in (x1, x2, w)] for name in libs}
                scratch = {}
                for name, lib in libs.items():
                    size = getattr(lib, "lse_bwd_gy_size_f64", None)
                    n = size(0, 1, f, b, k, k, o) if size else f * b * o
                    scratch[name] = [torch.empty((f, b), device="cuda", dtype=torch.float64)
                                     for _ in range(2)]
                    scratch[name].append(torch.empty(n, device="cuda", dtype=torch.float64))
                    if softmax:
                        scratch[name].append(torch.empty_like(w))

                def call(name, ins=(x1, x2, w, out, g), entry=entry, grads=grads,
                         scratch=scratch, sizes=(f, b, k, k, o)):
                    err = getattr(libs[name], entry)(
                        *(t.data_ptr() for t in ins), *(d.data_ptr() for d in grads[name]),
                        *(t.data_ptr() for t in scratch[name]), *sizes, 0, stream)
                    assert err == 0, err

                report(f"{entry} {where}", call, grads, 1e-9)
                del x1, x2, w, out, g, grads, scratch
        for dtype, suffix in ((torch.float32, ""), (torch.float64, "_f64")):
            for entry in SIGNED:
                if ("tucker" in entry) != (where != "SoS"):
                    continue
                ins, (oa, os_, g), diff = _signed_case(gen, entry, shape, dtype)
                f, b, k, o = shape
                tucker, softmax = "tucker" in entry, "softmax" in entry
                k1, k2 = (k, k) if tucker else (k, 1)
                grads = {name: [torch.empty_like(t) for t in diff] for name in libs}
                scratch = {}
                for name, lib in libs.items():
                    size = getattr(lib, "lse_bwd_gy_size" + suffix, None)
                    n = size(1, int(tucker), f, b, k1, k2, o) if size else f * b * o
                    bufs = [torch.empty((f, b), device="cuda", dtype=dtype)
                            for _ in range(2 if tucker else 1)]
                    bufs.append(torch.empty(n, device="cuda", dtype=dtype))
                    if softmax:
                        bufs.append(torch.empty_like(ins[-1]))
                    scratch[name] = bufs

                def call(name, ins=ins, oa=oa, os_=os_, g=g, entry=entry + suffix,
                         grads=grads, scratch=scratch, sizes=(*shape[:2], *((k1, k2) if tucker
                                                                           else (k1,)), o)):
                    err = getattr(libs[name], entry)(
                        *(t.data_ptr() for t in (*ins, oa, os_, g)),
                        *(d.data_ptr() for d in grads[name]),
                        *(t.data_ptr() for t in scratch[name]), *sizes, 0, stream)
                    assert err == 0, err

                report(f"{entry + suffix} {where}", call, grads,
                       1e-9 if dtype == torch.float64 else 1e-4)
                del ins, oa, os_, g, diff, grads, scratch
        for ctype in (torch.complex64, torch.complex128):
            for real_w in (False, True):
                tucker = where != "SoS"
                ins, (out, g) = _complex_case(gen, tucker, real_w, shape, ctype)
                f, b, k, o = shape
                k1, k2 = (k, k) if tucker else (k, 1)
                real = torch.float64 if ctype == torch.complex128 else torch.float32
                grads = {name: [torch.empty_like(t) for t in ins] for name in libs}
                scratch = {}
                for name, lib in libs.items():
                    size = getattr(lib, "clse_bwd_gy_size", None)
                    n = (size(f, b, k1, k2, o, int(tucker), int(not real_w),
                              int(ctype == torch.complex128)) if size else f * b * o)
                    scratch[name] = [torch.empty((f, b), device="cuda", dtype=real)
                                     for _ in range(2)] + [
                        torch.empty(n, device="cuda", dtype=ctype)]

                def call(name, ins=ins, out=out, g=g, grads=grads, scratch=scratch, k1=k1,
                         k2=k2, tucker=tucker, real_w=real_w, ctype=ctype):
                    dx = grads[name]
                    sa, sb, gy = scratch[name]
                    err = libs[name].clse_bwd(
                        ins[0].data_ptr(), ins[1].data_ptr() if tucker else None,
                        ins[-1].data_ptr(), out.data_ptr(), g.data_ptr(), dx[0].data_ptr(),
                        dx[1].data_ptr() if tucker else None, dx[-1].data_ptr(),
                        sa.data_ptr(), sb.data_ptr() if tucker else None, gy.data_ptr(),
                        f, b, k1, k2, o, int(tucker), int(not real_w),
                        int(ctype == torch.complex128), 0, stream)
                    assert err == 0, err

                planes = {name: [p for d in gs for p in ((d.real, d.imag) if d.is_complex()
                                                         else (d,))]
                          for name, gs in grads.items()}
                tag = ("complex128" if ctype == torch.complex128 else "complex64") + (
                    ", real w" if real_w else ", complex w")
                report(f"clse_bwd {where} {tag}", call, planes,
                       1e-9 if ctype == torch.complex128 else 1e-4)
                del ins, out, g, grads, scratch, planes
    return 0


if __name__ == "__main__":
    sys.exit(main())
