"""Time the signed and complex backward kernels (kernels 7 and 11, and their
bf16-weight and fast-mode Tucker instances 7' and 11') of one or two source
trees side by side on one card, with each launch's share.

Run on a machine with a CUDA card and the CUDA toolkit, from the root of a
checkout, alone or with the root of another tree (for example the parent
commit unpacked by ``git archive`` into a directory that ``.gitignore``
lists), or with ``--split``; ``--tucker`` times the Tucker instances alone:

    python3 scripts/sos_bwd_ab.py [OTHER_ROOT | --split] [--tucker]

``--split`` takes as the other tree a copy of this one whose CUDA-core
Tucker dx always takes the K1 split (``tucker_dx_fits`` made to return
false in both sources), and times the K=64 entries of the CUDA-core Tucker
backwards only (float64, and complex weights), where this tree's dx is the
single-block kernel.

Each tree's kernel library is built by its own ``ops/_build.py``. The
backward entries of both are called on the same inputs, in turns (other,
this, this, other; ``ab_turns.py``):

- at the squared circuits' largest TensorDot entry (the SoS entry: F=144,
  B*Kq=4096, I=O=32): the signed dense entries (``slse_bwd_dense*``,
  float32 and float64, plain weights and logits) and the complex one
  (``clse_bwd``, complex64 and complex128, complex and real weights);
- at the K=64 Tucker entry (F=784, B=128, K1=K2=O=64) and at B=512 (F=196):
  the float32 signed Tucker entries in every instance (``slse_bwd_tucker*``:
  f32-grade float32 and ``_w16`` weights on the tensor cores' ``mma.sync``,
  ``_fast``, ``_sr``, ``_w16_fast``, ``_w16_sr`` on ``wgmma``; plain weights
  and logits) and the complex64 Tucker backward against a real weight
  (``clse_bwd_tucker_rw``, ``_fast``, ``_sr``), with the unsigned Tucker
  backward's instances of the same weight type and mode (``lse_bwd_tucker*``,
  rows 2 and 2') timed beside them as the aims' yardsticks;
- at the K=64 entry: the CUDA-core Tucker backwards (the float64 lse and
  signed entries, the complex one against complex weights and in
  complex128).

Both trees' float32 signed Tucker entries take the scratch of the lse
Tucker entries (gy and ws), and both have ``clse_bwd_tucker_rw``. The
forward's outputs come from the plain versions of ``cirkit_tpu_torch.ops``. Each time
is the median of 20 CUDA-event timings after 3 warm-ups. ``torch.profiler``
then splits one call of each tree into its launches (device ms a call by
kernel, over 10 calls). The trees' gradients are held to each other
(``1e-4 (max|other| + |other|)``, 1e-9 in float64, 1e-2 in a fast mode,
where the two trees may take the softmax VJP's row dot in two ways; half a
bf16 step more where either is bf16) and two calls of this tree to the bit.
Prints one line a case and tree, and the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import importlib.util
import math
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from ab_turns import in_turns  # noqa: E402

from cirkit_tpu_torch.ops import clse_einsum as C  # noqa: E402
from cirkit_tpu_torch.ops import lse_einsum as L  # noqa: E402
from cirkit_tpu_torch.ops import slse_einsum as S  # noqa: E402

SIGNED_DENSE = ("slse_bwd_dense", "slse_bwd_dense_softmax")
SIGNED_TUCKER = ("slse_bwd_tucker", "slse_bwd_tucker_softmax")
LSE = ("lse_bwd_tucker_f64", "lse_bwd_tucker_softmax_f64")
INSTANCES = (("", ""), ("_w16", ""), ("_fast", "bf16"), ("_sr", "sr"), ("_w16_fast", "bf16"),
             ("_w16_sr", "sr"))
COMPLEX_INSTANCES = (("", ""), ("_fast", "bf16"), ("_sr", "sr"))
# the head of the CUDA-core Tucker dx's route choice in both sources
FITS = "inline bool tucker_dx_fits(int K1, int K2) {"
SOS, K64 = (144, 4096, 32, 32), (784, 128, 64, 64)  # F, B, I (K), O
TUCKER_SHAPES = (K64, (196, 512, 64, 64))


def _tree_build(root: Path, name: str):
    """The tree's ``ops/_build.py``, loaded as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        f"_build_{name}", root / "cirkit_tpu_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _library(mod) -> ctypes.CDLL:
    """The tree's library, built by its own ``_build`` and bound with its
    own signatures."""
    lib = ctypes.CDLL(str(mod.build()))
    for name, (argtypes, restype) in mod._SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


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


def _split_copy(root: Path, out: Path) -> Path:
    """A copy of the package whose CUDA-core Tucker dx always takes the K1
    split; returns the copy's root."""
    shutil.copytree(root / "cirkit_tpu_torch", out / "cirkit_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for src in ("lse_einsum_bwd.cu", "clse_einsum.cu"):
        path = out / "cirkit_tpu_torch" / "csrc" / src
        text = path.read_text()
        if text.count(FITS) != 1:
            raise RuntimeError(f"{src}: no single {FITS!r}")
        path.write_text(text.replace(FITS, FITS + "\n  return false;"))
    return out


def _signed_case(gen, tucker: bool, softmax: bool, shape, dtype):
    """(inputs, outputs and cotangent) of a signed entry."""
    f, b, k, o = shape

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
    return ins, (oa, os_, g)


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


def _planes(ts):
    return [p for d in ts if d is not None for p in ((d.real, d.imag) if d.is_complex() else (d,))]


class Bench:
    """The trees' libraries and the report of one case at a time."""

    def __init__(self, libs: dict):
        self.libs = libs
        self.stream = torch.cuda.current_stream().cuda_stream

    def report(self, label, call, grads, rel, names=None):
        names = list(self.libs) if names is None else names
        order = ("other", "this", "this", "other") if "other" in names else ("this", "this")
        times = in_turns(call, names, order)
        for name in names:
            call(name)
        torch.cuda.synchronize()
        first = [g.clone() for g in _planes(grads["this"])]
        call("this")
        torch.cuda.synchronize()
        repeat = all(torch.equal(a, b) for a, b in zip(first, _planes(grads["this"])))
        errs = []
        if "other" in names:
            for got, ref in zip(_planes(grads["this"]), _planes(grads["other"])):
                g, r = got.double(), ref.double()
                err = (g - r).abs()
                bound = rel * (r.abs().max() + r.abs())
                if torch.bfloat16 in (got.dtype, ref.dtype):
                    bound = bound + 2.0**-8 * r.abs()
                if not bool((err <= bound).all()):
                    raise AssertionError(f"{label}: trees differ by {float(err.max()):.3e}")
                errs.append(float(err.max()))
        for name in names:
            print(f"{label:52s} {name:5s} ms {[round(t, 4) for t in times[name]]}"
                  + (f"  max|this - other| {max(errs):.3e}" if errs else "")
                  + ("  two calls equal to the bit" if name == "this" and repeat else ""))
            print(f"{'':52s} {name:5s} {_split(lambda name=name: call(name))}")
        if not repeat:
            raise AssertionError(f"{label}: two calls of this tree differ")


def signed_tucker(bench: Bench, gen) -> None:
    """The float32 signed Tucker backward in every instance, and the unsigned
    one of the same instance."""
    libs, stream = bench.libs, bench.stream
    for shape in TUCKER_SHAPES:
        f, b, k, o = shape
        where = f"F={f} B={b} K1=K2=O={k}"
        for entry in SIGNED_TUCKER:
            softmax = "softmax" in entry
            op = "slse_tucker2" + ("_softmax" if softmax else "")
            ins, (oa, os_, g) = _signed_case(gen, True, softmax, shape, torch.float32)
            for sfx, mode in INSTANCES:
                w = ins[-1].to(torch.bfloat16) if sfx.startswith("_w16") else ins[-1]
                args = (*ins[:-1], w)
                n = S.bwd_scratch(op, S.bwd_route(op, "", mode), f, b, k, k, o)
                grads = {name: [torch.empty_like(ins[0]), torch.empty_like(ins[2]),
                                torch.empty(w.shape, device="cuda",
                                            dtype=w.dtype if mode else torch.float32)]
                         for name in libs}
                scratch = {name: [*(torch.empty((f, b), device="cuda") for _ in range(2)),
                                  torch.empty((f, b, o), device="cuda"),
                                  torch.empty(n, device="cuda")] for name in libs}

                def call(name, args=args, oa=oa, os_=os_, g=g, entry=entry + sfx, grads=grads,
                         scratch=scratch):
                    err = getattr(libs[name], entry)(
                        *(t.data_ptr() for t in (*args, oa, os_, g)),
                        *(d.data_ptr() for d in grads[name]),
                        *(t.data_ptr() for t in scratch[name]), f, b, k, k, o, 0, stream)
                    assert err == 0, err

                bench.report(f"{entry + sfx} {where}", call, grads, 1e-2 if mode else 1e-4)
                del grads, scratch
                # the unsigned Tucker backward of the same instance (rows 2, 2')
                lop = op.removeprefix("s")
                x1, x2 = ins[0], ins[2]
                xw = w if softmax else w.abs()
                out = L._ENTRIES[lop][2](x1, x2, xw, mode=mode) if mode else \
                    L._ENTRIES[lop][2](x1, x2, xw)
                fast = bool(mode)
                ugrads = {name: [torch.empty_like(x1), torch.empty_like(x2),
                                 torch.empty(w.shape, device="cuda",
                                             dtype=w.dtype if fast else torch.float32)]
                          for name in libs}
                n = (L._tucker_bf16_bwd_scratch(softmax, f, b, k, k, o) if fast
                     else libs["this"].lse_bwd_scratch(1, int(softmax), f, b, k, k, o))
                ubufs = [torch.empty((f, b), device="cuda") for _ in range(2)] + [
                    torch.empty((f, b, o), device="cuda"), torch.empty(n, device="cuda")]

                def ucall(name, args=(x1, x2, xw, out, g), grads=ugrads, bufs=ubufs,
                          entry="lse_bwd_tucker" + ("_softmax" if softmax else "") + sfx):
                    err = getattr(libs[name], entry)(
                        *(t.data_ptr() for t in args), *(d.data_ptr() for d in grads[name]),
                        *(t.data_ptr() for t in bufs), f, b, k, k, o, 0, stream)
                    assert err == 0, err

                bench.report(f"  unsigned {'lse_bwd_tucker' + ('_softmax' if softmax else '')}"
                             f"{sfx} {where}", ucall, ugrads, 1e-2 if mode else 1e-4)
                del ugrads, ubufs, out
            del ins, oa, os_, g


def complex_tucker(bench: Bench, gen) -> None:
    """The complex64 Tucker backward against a real weight in every mode
    (``clse_bwd_tucker_rw*``)."""
    libs, stream = bench.libs, bench.stream
    for shape in TUCKER_SHAPES:
        f, b, k, o = shape
        ins, (out, g) = _complex_case(gen, True, True, shape, torch.complex64)
        for sfx, mode in COMPLEX_INSTANCES:
            n = (C._ctucker_bf16_scratch if mode else C._ctucker_tc_scratch)(f, b, k, k, o)
            grads = {name: [torch.empty_like(t) for t in ins] for name in libs}
            scratch = {name: [*(torch.empty((f, b), device="cuda") for _ in range(2)),
                              torch.empty(n, device="cuda")] for name in libs}

            def call(name, grads=grads, scratch=scratch, sfx=sfx):
                err = getattr(libs[name], "clse_bwd_tucker_rw" + sfx)(
                    *(t.data_ptr() for t in (*ins, out, g)),
                    *(d.data_ptr() for d in grads[name]),
                    *(t.data_ptr() for t in scratch[name]), f, b, k, k, o, 0, stream)
                assert err == 0, err

            bench.report(f"clse_bwd_tucker_rw{sfx} F={f} B={b} K1=K2=O={k} complex64, real w",
                         call, grads, 1e-2 if mode else 1e-4)
            del grads, scratch
        del ins, out, g


def cuda_core(bench: Bench, gen, shapes) -> None:
    """The entries whose layout no tree changed: the signed dense entries
    (float32 and float64) and the complex dense ones at the SoS entry; at the
    K=64 entry the CUDA-core Tucker backwards (float64 lse and signed, the
    complex ones against complex weights and in complex128)."""
    libs, stream = bench.libs, bench.stream
    for shape, where in shapes:
        tucker = where != "SoS"
        f, b, k, o = shape
        k1, k2 = (k, k) if tucker else (k, 1)
        if tucker:
            for entry in LSE:
                softmax = "softmax" in entry
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
                    scratch[name] = [torch.empty((f, b), device="cuda", dtype=torch.float64)
                                     for _ in range(2)]
                    scratch[name].append(torch.empty(lib.lse_bwd_gy_size_f64(0, 1, f, b, k, k, o),
                                                     device="cuda", dtype=torch.float64))
                    if softmax:
                        scratch[name].append(torch.empty_like(w))

                def call(name, ins=(x1, x2, w, out, g), entry=entry, grads=grads,
                         scratch=scratch):
                    err = getattr(libs[name], entry)(
                        *(t.data_ptr() for t in ins), *(d.data_ptr() for d in grads[name]),
                        *(t.data_ptr() for t in scratch[name]), f, b, k, k, o, 0, stream)
                    assert err == 0, err

                bench.report(f"{entry} {where}", call, grads, 1e-9)
                del x1, x2, w, out, g, grads, scratch
        for dtype, suffix in ((torch.float32, ""), (torch.float64, "_f64")):
            if tucker and dtype == torch.float32:
                continue  # the float32 Tucker instances: signed_tucker
            for entry in (SIGNED_TUCKER if tucker else SIGNED_DENSE):
                softmax = "softmax" in entry
                ins, (oa, os_, g) = _signed_case(gen, tucker, softmax, shape, dtype)
                grads = {name: [torch.empty_like(t) for t in (*ins[:-1:2], ins[-1])]
                         for name in libs}
                scratch = {}
                for name, lib in libs.items():
                    n = getattr(lib, "lse_bwd_gy_size" + suffix)(1, int(tucker), f, b, k1, k2, o)
                    bufs = [torch.empty((f, b), device="cuda", dtype=dtype)
                            for _ in range(2 if tucker else 1)]
                    bufs.append(torch.empty(n, device="cuda", dtype=dtype))
                    if softmax:
                        bufs.append(torch.empty_like(ins[-1]))
                    scratch[name] = bufs

                def call(name, ins=ins, oa=oa, os_=os_, g=g, entry=entry + suffix,
                         grads=grads, scratch=scratch,
                         sizes=(f, b, *((k1, k2) if tucker else (k1,)), o)):
                    err = getattr(libs[name], entry)(
                        *(t.data_ptr() for t in (*ins, oa, os_, g)),
                        *(d.data_ptr() for d in grads[name]),
                        *(t.data_ptr() for t in scratch[name]), *sizes, 0, stream)
                    assert err == 0, err

                bench.report(f"{entry + suffix} {where}", call, grads,
                             1e-9 if dtype == torch.float64 else 1e-4)
                del ins, oa, os_, g, grads, scratch
        for ctype in (torch.complex64, torch.complex128):
            for real_w in (False, True):
                if tucker and real_w and ctype == torch.complex64:
                    continue  # on the tensor cores: complex_tucker
                ins, (out, g) = _complex_case(gen, tucker, real_w, shape, ctype)
                real = torch.float64 if ctype == torch.complex128 else torch.float32
                grads = {name: [torch.empty_like(t) for t in ins] for name in libs}
                scratch = {}
                for name, lib in libs.items():
                    n = lib.clse_bwd_gy_size(f, b, k1, k2, o, int(tucker), int(not real_w),
                                             int(ctype == torch.complex128))
                    scratch[name] = [torch.empty((f, b), device="cuda", dtype=real)
                                     for _ in range(2)] + [
                        torch.empty(n, device="cuda", dtype=ctype)]

                def call(name, ins=ins, out=out, g=g, grads=grads, scratch=scratch,
                         tucker=tucker, real_w=real_w, ctype=ctype):
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

                tag = ("complex128" if ctype == torch.complex128 else "complex64") + (
                    ", real w" if real_w else ", complex w")
                bench.report(f"clse_bwd {where} {tag}", call, grads,
                             1e-9 if ctype == torch.complex128 else 1e-4)
                del ins, out, g, grads, scratch


def main() -> int:
    args = sys.argv[1:]
    tucker_only = "--tucker" in args
    args = [a for a in args if a != "--tucker"]
    if len(args) > 1 or not torch.cuda.is_available():
        print(__doc__)
        return 2
    split = args == ["--split"]
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    roots = {"this": REPO}
    (REPO / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=REPO / "build"))
    if split:
        roots = {"other": _split_copy(REPO, tmp / "split"), **roots}
        print("other: this tree with every CUDA-core Tucker dx on the K1 split")
    elif args:
        roots = {"other": Path(args[0]).resolve(), **roots}
    libs = {name: _library(_tree_build(root, name)) for name, root in roots.items()}
    bench = Bench(libs)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if not split:
        signed_tucker(bench, gen)
        complex_tucker(bench, gen)
    if not tucker_only:
        cuda_core(bench, gen, ((K64, "K=64 Tucker"),) if split
                  else ((SOS, "SoS"), (K64, "K=64 Tucker")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
