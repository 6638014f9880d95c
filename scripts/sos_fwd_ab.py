"""Time the signed and complex forward kernels (kernels 6 and 10) of two
source trees side by side on one card, alone and inside the squared
circuits' forward, with each launch's share.

Run on a machine with a CUDA card and the CUDA toolkit, from the root of a
checkout, with the ``csrc`` directory of another tree (for example the
parent commit unpacked by ``git archive`` into a directory that
``.gitignore`` lists), or alone:

    python3 scripts/sos_fwd_ab.py [OTHER_CSRC] [--tucker]

Each tree's ``lse_einsum.cu`` and ``clse_einsum.cu`` are compiled (flags of
``cirkit_tpu_torch/ops/_build.py``) into a library of its own.

``--tucker`` times the Tucker forwards instead, each tree's whole library
built by its own ``ops/_build.py`` (the tree's root is two levels above its
``csrc``): at the K=64 Tucker entry (F=784, B=128, K1=K2=O=64) and at the
serving batch (F=196, B=512), the float32 signed Tucker entries in every
instance (``slse_fwd_tucker*``, plain weights and logits: f32-grade float32
and ``_w16`` weights, ``_fast``, ``_sr``, ``_w16_fast``, ``_w16_sr``) and
the complex64 one against a real weight (f32-grade, ``_fast``, ``_sr``:
``clse_fwd_tucker_rw*``, which both trees must hold), with the
unsigned Tucker forward of the same instance (``lse_fwd_tucker*``, rows 1
and 1', on ``|w|`` or the logits) beside each as its yardstick. The trees
are held to each other in linear space scaled by the row's absolute mass
(1e-5 in the f32-grade mode; in a fast mode, where two trees may round at
other points, 3 u with u the rounding's relative step, 2^-8 to the nearest
and 2^-7 stochastic) and two calls of this tree to the bit.

- **Kernels.** The forward entries of both are called on the same inputs,
  in turns (other, this, this, other), at the squared circuits' dense
  entries (every one has I = 32, and O = 32 but at the root): the largest
  of the 12x12 circuit (the SoS entry: F=144, B*Kq=4096), of the 28x28 one
  (F=784), its ``cc`` forward's (F=784, B=128) and ``zc``'s (F=784, B=32),
  and the root (F=1, B*Kq=4096, O=1): the signed entries
  (``slse_fwd_dense``, ``slse_fwd_dense_softmax``, float32 and float64) and
  the complex one (``clse_fwd``, complex64 and complex128, complex and real
  weights). Each time is the median of 20 CUDA-event timings after 3
  warm-ups, printed beside the bound (the bytes of the inputs and outputs
  over 3.35 TB/s, or the FMAs over the f32 or f64 peak if larger).
  ``torch.profiler`` then splits one call of each tree into its launches
  (device ms by kernel). The trees' outputs are held to each other in
  linear space scaled by the row's absolute mass (1e-5; 1e-12 in float64
  and complex128) and two calls of this tree to the bit.
- **Circuits.** ``chip_smoke.py``'s phase 9 and 10 circuits (``bench_sos``
  at 12x12 and 28x28 under ``signed-lse-sum``, and with complex weights
  under ``complex-lse-sum``, seed 0, batch 128) are compiled once; the
  forward of ``sq`` runs on this tree's package with each tree's library in
  turns (other, this, this, other): the median ms of 20 forwards and the
  device split of 3 by kernel category (``torch.profiler``).

Prints one line a case and tree, and the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from ab_turns import in_turns  # noqa: E402
from sos_bwd_ab import _library as _tree_library, _tree_build  # noqa: E402
from cirkit_tpu_torch.ops import _build  # noqa: E402
from cirkit_tpu_torch.ops import lse_einsum as L  # noqa: E402
from cirkit_tpu_torch.ops._build import _SIGNATURES, NVCC_FLAGS, _nvcc  # noqa: E402

SOURCES = ("lse_einsum.cu", "clse_einsum.cu")
SIGNED = ("slse_fwd_dense", "slse_fwd_dense_softmax")
# (label, (F, B, I, O)): the SoS circuits' dense entries
SHAPES = (("SoS", (144, 4096, 32, 32)), ("28x28 sq", (784, 4096, 32, 32)),
          ("28x28 cc", (784, 128, 32, 32)), ("28x28 zc", (784, 32, 32, 32)),
          ("root", (1, 4096, 32, 1)))


def _library(csrc: Path, out: Path) -> ctypes.CDLL:
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(out),
                    *(str(csrc / src) for src in SOURCES)], check=True)
    lib = ctypes.CDLL(str(out))
    for name, (argtypes, restype) in _SIGNATURES.items():
        if hasattr(lib, name):  # the entries of the two sources
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
    return lib


def _signed_case(gen, shape, dtype, softmax):
    f, b, i, o = shape
    a = torch.randn((f, b, i), generator=gen, device="cuda", dtype=dtype) * 3 - 2
    s = torch.randint(-1, 2, (f, b, i), generator=gen, device="cuda").to(dtype)
    w = torch.randn((f, o, i), generator=gen, device="cuda", dtype=dtype)
    wabs = torch.softmax(w, dim=-1) if softmax else w.abs()
    return [a, s, w], L.lse_matmul_ref(a, wabs)


def _complex_case(gen, shape, ctype, real_w):
    f, b, i, o = shape
    real = torch.float64 if ctype == torch.complex128 else torch.float32

    def randn(*s):
        return torch.randn(s, generator=gen, device="cuda", dtype=real)

    phase = (torch.rand((f, b, i), generator=gen, device="cuda", dtype=real) * 2 - 1) * math.pi
    x = torch.complex(randn(f, b, i) * 3 - 2, phase)
    w = randn(f, o, i) if real_w else torch.complex(randn(f, o, i), randn(f, o, i))
    return [x, w], L.lse_matmul_ref(x.real.contiguous(), w.abs())


def _bound_ms(ins, outs, fmas: int, double: bool, peak: float | None = None) -> float:
    moved = sum(t.numel() * t.element_size() for t in (*ins, *outs))
    peak = peak or (CS.F64_PEAK if double else CS.F32_PEAK)
    return max(moved / CS.HBM_RATE, 2 * fmas / peak) * 1e3


TUCKER_SHAPES = (("K=64", (784, 128, 64, 64)), ("B=512", (196, 512, 64, 64)))  # F, B, K, O
TUCKER_INSTANCES = (("", ""), ("_w16", ""), ("_fast", "bf16"), ("_sr", "sr"),
                    ("_w16_fast", "bf16"), ("_w16_sr", "sr"))
FAST_TOL = {"": 1e-5, "bf16": 3 * 2.0**-8, "sr": 3 * 2.0**-7}


def _tucker(libs, order, gen, stream) -> None:
    """The signed and complex Tucker forwards in every instance, each with
    the unsigned one of its instance beside it."""
    for where, (f, b, k, o) in TUCKER_SHAPES:
        sizes = (f, b, k, k, o)
        for softmax in (False, True):
            tail = "_softmax" if softmax else ""
            a1, a2 = (torch.randn((f, b, k), generator=gen, device="cuda") * 3 - 2
                      for _ in range(2))
            s1, s2 = (torch.randint(-1, 2, (f, b, k), generator=gen, device="cuda").float()
                      for _ in range(2))
            w32 = torch.randn((f, o, k * k), generator=gen, device="cuda")
            wabs = torch.softmax(w32, dim=-1) if softmax else w32.abs()
            mass = L.lse_tucker2_ref(a1, a2, wabs)
            for sfx, mode in TUCKER_INSTANCES:
                w = w32.to(torch.bfloat16) if sfx.startswith("_w16") else w32
                outs = {name: [torch.empty((f, b, o), device="cuda") for _ in range(2)]
                        for name in libs}

                def call(name, w=w, outs=outs, entry=f"slse_fwd_tucker{tail}{sfx}"):
                    err = getattr(libs[name], entry)(
                        *(t.data_ptr() for t in (a1, s1, a2, s2, w, *outs[name])), *sizes, 0,
                        stream)
                    assert err == 0, err

                def linear(name, outs=outs):
                    oa, os_ = outs[name]
                    return torch.where(torch.isneginf(mass), 0.0, os_ * torch.exp(oa - mass))

                peak = CS.BF16_PEAK if mode else CS.F32_PEAK
                _report(f"slse_fwd_tucker{tail}{sfx} {where}", libs, order, call, outs, linear,
                        FAST_TOL[mode],
                        _bound_ms((a1, s1, a2, s2, w), outs["this"], f * b * k * k * o, False,
                                  peak))
                # the unsigned forward of the same instance (rows 1 and 1')
                uw = w if softmax else w.abs()
                uouts = {name: [torch.empty((f, b, o), device="cuda")] for name in libs}

                def ucall(name, uw=uw, uouts=uouts, entry=f"lse_fwd_tucker{tail}{sfx}"):
                    err = getattr(libs[name], entry)(
                        *(t.data_ptr() for t in (a1, a2, uw, *uouts[name])), *sizes, 0, stream)
                    assert err == 0, err

                def ulinear(name, uouts=uouts):
                    return torch.where(torch.isneginf(mass), 0.0, torch.exp(uouts[name][0] - mass))

                _report(f"  unsigned lse_fwd_tucker{tail}{sfx} {where}", libs, order, ucall,
                        uouts, ulinear, FAST_TOL[mode],
                        _bound_ms((a1, a2, uw), uouts["this"], f * b * k * k * o, False, peak))
                del outs, uouts
            del a1, a2, s1, s2, w32, wabs, mass
        # the complex64 Tucker forward against a real weight
        phase = [(torch.rand((f, b, k), generator=gen, device="cuda") * 2 - 1) * math.pi
                 for _ in range(2)]
        x1, x2 = (torch.complex(torch.randn((f, b, k), generator=gen, device="cuda") * 3 - 2, p)
                  for p in phase)
        w = torch.randn((f, o, k * k), generator=gen, device="cuda")
        mass = L.lse_tucker2_ref(x1.real.contiguous(), x2.real.contiguous(), w.abs())
        for sfx, mode in (("", ""), ("_fast", "bf16"), ("_sr", "sr")):
            outs = {name: [torch.empty((f, b, o), device="cuda", dtype=torch.complex64)]
                    for name in libs}

            def call(name, outs=outs, entry="clse_fwd_tucker_rw" + sfx):
                ptrs = (x1.data_ptr(), x2.data_ptr(), w.data_ptr(), outs[name][0].data_ptr())
                err = getattr(libs[name], entry)(*ptrs, *sizes, 0, stream)
                assert err == 0, err

            def linear(name, outs=outs):
                return torch.where(torch.isneginf(mass), 0.0, torch.exp(outs[name][0] - mass))

            _report(f"clse_fwd_tucker_rw{sfx} {where} complex64, real w", libs, order, call,
                    outs, linear, FAST_TOL[mode],
                    _bound_ms((x1, x2, w), outs["this"], 2 * f * b * k * k * o, False,
                              CS.BF16_PEAK if mode else CS.F32_PEAK))
            del outs
        del x1, x2, w, mass


def _kernels(libs, order, gen, stream) -> None:
    for where, shape in SHAPES:
        f, b, i, o = shape
        for dtype, suffix in ((torch.float32, ""), (torch.float64, "_f64")):
            for entry in SIGNED:
                ins, mass = _signed_case(gen, shape, dtype, "softmax" in entry)
                outs = {name: [torch.empty((f, b, o), device="cuda", dtype=dtype)
                               for _ in range(2)] for name in libs}

                def call(name, ins=ins, outs=outs, entry=entry + suffix):
                    err = getattr(libs[name], entry)(
                        *(t.data_ptr() for t in (*ins, *outs[name])), f, b, i, o, 0, stream)
                    assert err == 0, err

                def linear(name, outs=outs, mass=mass):
                    oa, os_ = outs[name]
                    return torch.where(torch.isneginf(mass), 0.0, os_ * torch.exp(oa - mass))

                _report(f"{entry + suffix} {where}", libs, order, call, outs, linear,
                        1e-12 if dtype == torch.float64 else 1e-5,
                        _bound_ms(ins, outs["this"], f * b * i * o, dtype == torch.float64))
                del ins, mass, outs
        for ctype in (torch.complex64, torch.complex128):
            for real_w in (False, True):
                ins, mass = _complex_case(gen, shape, ctype, real_w)
                outs = {name: [torch.empty((f, b, o), device="cuda", dtype=ctype)]
                        for name in libs}
                double = int(ctype == torch.complex128)

                def call(name, ins=ins, outs=outs, real_w=real_w, double=double):
                    err = libs[name].clse_fwd(ins[0].data_ptr(), None, ins[1].data_ptr(),
                                              outs[name][0].data_ptr(), f, b, i, 1, o, 0,
                                              int(not real_w), double, 0, stream)
                    assert err == 0, err

                def linear(name, outs=outs, mass=mass):
                    return torch.where(torch.isneginf(mass), 0.0, torch.exp(outs[name][0] - mass))

                tag = ("complex128" if double else "complex64") + (
                    ", real w" if real_w else ", complex w")
                _report(f"clse_fwd {where} {tag}", libs, order, call, outs, linear,
                        1e-12 if double else 1e-5,
                        _bound_ms(ins, outs["this"], (2 if real_w else 4) * f * b * i * o,
                                  bool(double)))
                del ins, mass, outs


def _report(label, libs, order, call, outs, linear, tol, bound) -> None:
    times = in_turns(call, libs, order)
    for name in libs:
        call(name)
    torch.cuda.synchronize()
    first = [t.clone() for t in outs["this"]]
    call("this")
    torch.cuda.synchronize()
    repeat = all(torch.equal(a, b) for a, b in zip(first, outs["this"]))
    diff = ""
    if "other" in libs:
        err = float((linear("this") - linear("other")).abs().max())
        if not err <= tol:
            raise AssertionError(f"{label}: trees differ by {err:.3e} of the row's mass")
        diff = f"  max|this - other| {err:.3e} of the row's mass"
    for name in libs:
        print(f"{label:44s} {name:5s} ms {[round(t, 4) for t in times[name]]}  bound "
              f"{bound:.4f}" + diff + ("  two calls equal to the bit"
                                       if name == "this" and repeat else ""))
        print(f"{'':44s} {name:5s} {CS._kernel_split(lambda name=name: call(name))}")
    if not repeat:
        raise AssertionError(f"{label}: two calls of this tree differ")


def _circuits(libs, order) -> None:
    from cirkit_tpu_torch.pipeline import PipelineContext

    for semiring, circuit in (("signed-lse-sum", CS._sos_circuit),
                              ("complex-lse-sum", CS._complex_sos_circuit)):
        for side in CS.SOS_SIDES:
            ctx = PipelineContext(semiring=semiring, fold=True, optimize=True, device="cuda",
                                  seed=0)
            cc = ctx.compile(circuit(side))
            sq = ctx.multiply(ctx.conjugate(cc), cc)
            rng = np.random.default_rng(0)
            x = torch.as_tensor(rng.integers(0, 256, size=(CS.BATCH, side * side)),
                                device="cuda")
            times = {name: [] for name in libs}
            with torch.inference_mode():
                for name in order:
                    _build._LIB = libs[name]
                    times[name].append(CS._median_ms(lambda: sq(x)))
                for name in libs:
                    _build._LIB = libs[name]
                    print(f"{semiring} {side}x{side} sq forward {name:5s} ms "
                          f"{[round(t, 3) for t in times[name]]}; "
                          f"{CS._device_breakdown(lambda: sq(x), 3)}")
            del ctx, cc, sq


def main() -> int:
    args = sys.argv[1:]
    tucker = "--tucker" in args
    args = [a for a in args if a != "--tucker"]
    if len(args) > 1 or not torch.cuda.is_available():
        print(__doc__)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    trees = {"this": REPO / "cirkit_tpu_torch" / "csrc"}
    if args:
        trees = {"other": Path(args[0]).resolve(), **trees}
    (REPO / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=REPO / "build"))
    if tucker:
        libs = {name: _tree_library(_tree_build(path.parents[1], name))
                for name, path in trees.items()}
    else:
        libs = {name: _library(path, tmp / f"lib{name}.so") for name, path in trees.items()}
    order = ("other", "this", "this", "other") if "other" in libs else ("this", "this")
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        if tucker:
            _tucker(libs, order, gen, torch.cuda.current_stream().cuda_stream)
            return 0
        _kernels(libs, order, gen, torch.cuda.current_stream().cuda_stream)
    _circuits(libs, order)
    return 0


if __name__ == "__main__":
    sys.exit(main())
