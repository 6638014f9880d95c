"""Time MAP's max-plus Tucker kernel (kernel 9) and the routing choice
(kernel 8) of two source trees side by side on one card, alone at the
Tucker flagship's entries and inside the queries, with each launch's share.

Run on a machine with a CUDA card and the CUDA toolkit, from the root of a
checkout, with the ``csrc`` directory of another tree (for example the
parent commit unpacked by ``git archive`` into a directory that
``.gitignore`` lists), or alone:

    python3 scripts/route_ab.py [OTHER_CSRC] [--no-queries] [--splits]

Each tree's ``tucker_route.cu`` is compiled (flags of
``cirkit_tpu_torch/ops/_build.py``) into a library of its own. A tree whose
source has no ``tropical_finish`` is called with the entries as they were
before the tropical kernel split its composite index and the route kernel
took teams of warps (no scratch, no split count, no team).

- **Kernels.** At the K=64 Tucker flagship's ten Tucker entries (F = 784,
  392, ..., 2; B=128, K1=K2=O=64, logits) and at K=128, F=784, on the same
  inputs in turns (other, this, this, other): the tropical kernel, and the
  route kernel's max and sample kinds. Each time is the median of 20
  CUDA-event timings after 3 warm-ups ("ms") and the device time a call of
  its kernels by ``torch.profiler`` ("device": each kernel's mean over the
  launches recorded, since the profiler may drop a call's; with the split,
  the second pass's too); the bound beside it (the tropical kernel: an FADD and an
  FMNMX per term at half the f32 peak; the route: the bytes of the weight
  rows the selection reads and of x1 and x2, or for the sample kind one
  exp per column at the MUFU rate if larger); the sums over the ten
  entries. The trees' tropical values are held to each other within
  ``1e-5 |v| + 1e-5`` and their max choices to the plain score bound.
- **Queries.** ``chip_smoke.py``'s Tucker flagship (K=64, seed 0) at batch
  128 with ``bench.py``'s 50% mask: ``MAPQuery``, ``SamplingQuery`` of 128
  samples and ``.conditional``, with each tree's routing kernels in turns
  (other, this, this, other; the forward kernels are this tree's): the
  median ms of 10 calls and the device ms of one call by kernel
  (``torch.profiler``: the routing kernels, the six largest others, the
  rest), and the device's idle share.
- **Splits** (``--splits``). This tree's tropical kernel at each of the
  ten entries with the split counts around ``_trop_splits``'s choice (1,
  half, the choice, twice, eight times), forced through the op: the device
  ms of the main kernel and of the second pass; and the SM clock and power
  during two seconds of F=784 launches.
- **SASS.** The instruction mix of the float32 tropical kernel's inner loop
  (the loop with the most FMNMX: FADD, FMNMX, LDS and the rest) and of the
  route kernel's loops (with logits, each kind), from ``cuobjdump -sass`` of
  each library.

Prints one line a case and tree, and the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from cirkit_tpu_torch.ops import routing as R  # noqa: E402
from cirkit_tpu_torch.ops._build import _SIGNATURES, NVCC_FLAGS, _nvcc  # noqa: E402

FLAGSHIP_F = (784, 392, 196, 98, 42, 22, 12, 8, 4, 2)
MUFU_RATE = 132 * 16 * 1.98e9  # exponentials a second: 16 an SM a clock at the f32 peak's clock
_P, _I, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
# the entries before the split and the teams
_OLD = {"tropical_tucker": ((*(_P,) * 4, *(_I,) * 7, _P), ctypes.c_int),
        "route_tucker": ((*(_P,) * 5, *(_I,) * 7, _U64, _I, _P), ctypes.c_int)}


class Tree:
    """One tree's routing kernels, called as its entries take them."""

    def __init__(self, csrc: Path, out: Path):
        subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(out),
                        str(csrc / "tucker_route.cu")], check=True)
        self.path = out
        self.lib = ctypes.CDLL(str(out))
        self.new = "tropical_finish" in (csrc / "tucker_route.cu").read_text()
        sigs = _SIGNATURES if self.new else _OLD
        for name in ("tropical_tucker", "route_tucker"):
            fn = getattr(self.lib, name)
            fn.argtypes, fn.restype = sigs[name]
        self.dev = torch.cuda.current_device()
        self.sms = torch.cuda.get_device_properties(self.dev).multi_processor_count

    def tropical(self, x1, x2, th, *, log_weights: bool):
        f, b, k1 = x1.shape
        k2, o = x2.shape[2], th.shape[1]
        out = torch.empty((f, b, o), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in (x1, x2, th, out)]
        if self.new:
            s = R._trop_splits(f, b, o, k1 * k2, self.sms)
            part = torch.empty((s, f, b, o), device="cuda") if s > 1 else None
            stats = torch.empty((2, s, f, o), device="cuda") if s > 1 and log_weights else None
            scratch = [None if t is None else t.data_ptr() for t in (part, stats)]
            err = self.lib.tropical_tucker(*ptrs, *scratch, f, b, k1, k2, o, s,
                                           int(log_weights), self.dev, stream)
        else:
            err = self.lib.tropical_tucker(*ptrs, f, b, k1, k2, o, int(log_weights), self.dev,
                                           stream)
        assert err == 0, err
        return out

    def route(self, x1, x2, th, sel, *, kind: str, log_weights: bool, seed=None):
        f, b, k1 = x1.shape
        k2, o = x2.shape[2], th.shape[1]
        out = torch.empty((f, b), device="cuda", dtype=torch.int64)
        sample = kind == "sample"
        args = [*(t.data_ptr() for t in (x1, x2, th, sel.contiguous(), out)), f, b, k1, k2, o,
                int(log_weights), int(sample), int(seed) % 2**64 if sample else 0]
        if self.new:
            args.append(R._route_team(f * b, k1 * k2, (k1 + k2) * 4, self.sms))
        err = self.lib.route_tucker(*args, self.dev, torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return out


def _launch_ms(fn, calls: int = 5) -> dict[str, float]:
    """Device ms a launch of each kernel ``fn`` launches once a call
    (``torch.profiler`` over ``calls`` calls after a warm-up): each kernel's
    total over the launches the profiler recorded, which it may drop a
    call of."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count}


def _device_ms(fn) -> float:
    return sum(_launch_ms(fn).values())


def _inputs(gen, f, k):
    x1 = torch.randn((f, 128, k), generator=gen, device="cuda") * 3.0 - 2.0
    x2 = torch.randn((f, 128, k), generator=gen, device="cuda") * 3.0 - 2.0
    th = torch.randn((f, k, k * k), generator=gen, device="cuda")
    sel = torch.randint(0, k, (f, 128), generator=gen, device="cuda")
    return x1, x2, th, sel


def _kernels(trees, order) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    sums: dict[tuple[str, str], float] = {}
    bound_sum = 0.0
    for f, k in [(f, 64) for f in FLAGSHIP_F] + [(784, 128)]:
        x1, x2, th, sel = _inputs(gen, f, k)
        m = k * k
        terms = f * 128 * k * m
        bound_t = 2 * terms / (CS.F32_PEAK / 2) * 1e3
        rows = torch.unique(torch.arange(f, device="cuda")[:, None] * k + sel).numel()
        moved = 4 * (x1.numel() + x2.numel() + rows * m) + 16 * f * 128
        bound_r = moved / CS.HBM_RATE * 1e3
        bound_s = max(bound_r, f * 128 * m / MUFU_RATE * 1e3)
        if k == 64:
            bound_sum += bound_t
        calls = {
            "tropical": lambda t: t.tropical(x1, x2, th, log_weights=True),
            "route max": lambda t: t.route(x1, x2, th, sel, kind="max", log_weights=True),
            "route sample": lambda t: t.route(x1, x2, th, sel, kind="sample", log_weights=True,
                                              seed=12345),
        }
        outs = {name: calls["tropical"](t) for name, t in trees.items()}
        if "other" in outs:
            a, b = outs["this"], outs["other"]
            fin = torch.isfinite(b)
            ok = torch.equal(torch.isneginf(a), torch.isneginf(b)) and bool(
                ((a[fin] - b[fin]).abs() <= 1e-5 + 1e-5 * b[fin].abs()).all())
            if not ok:
                raise AssertionError(f"F={f} K={k}: the trees' tropical values differ")
        scores = R.route_scores(x1, x2, th, sel, log_weights=True)
        best = scores.amax(dim=-1)
        for name, t in trees.items():
            idx = calls["route max"](t)
            at = torch.gather(scores, -1, idx[..., None])[..., 0]
            if not bool((at >= best - (1e-5 * best.abs() + 1e-5)).all()):
                raise AssertionError(f"F={f} K={k}: {name}'s route choice below the bound")
        del scores, best, outs
        for what, fn in calls.items():
            bound = {"tropical": bound_t, "route max": bound_r, "route sample": bound_s}[what]
            times = {name: [] for name in trees}
            for name in order:
                times[name].append(CS._median_ms(lambda name=name: fn(trees[name])))
            for name, t in trees.items():
                dev = _device_ms(lambda t=t: fn(t))
                if k == 64:
                    sums[(what, name)] = sums.get((what, name), 0.0) + dev
                print(f"F={f:3d} K={k:3d} {what:13s} {name:5s} ms "
                      f"{[round(v, 4) for v in times[name]]} device {dev:.4f} "
                      f"bound {bound:.4f}")
        del x1, x2, th, sel
    for (what, name), total in sums.items():
        print(f"sum over the ten K=64 entries: {what:13s} {name:5s} device {total:.4f} ms"
              + (f" (tropical work bound {bound_sum:.4f} ms)" if what == "tropical" else ""))


def _splits() -> None:
    """This tree's tropical kernel at each flagship entry with the split
    counts around ``_trop_splits``'s choice, forced through the op: the
    device ms of the main kernel and of the second pass (``_launch_ms``);
    then the SM clock and power that ``nvidia-smi`` reads during
    two seconds of F=784 launches."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    for f in FLAGSHIP_F:
        x1, x2, th, _ = _inputs(gen, f, 64)
        auto = R._trop_splits(f, 128, 64, 4096, torch.cuda.get_device_properties(0)
                              .multi_processor_count)
        tried = sorted({R._normal_splits(s, 4096, 16) for s in
                        (1, max(1, auto // 2), auto, 2 * auto, 8 * auto)})
        parts = []
        for s in tried:
            kernels = _launch_ms(lambda s=s: R.tropical_tucker2(x1, x2, th, log_weights=True,
                                                                splits=s))
            main = sum(v for k, v in kernels.items() if "tropical_tucker_kernel" in k)
            parts.append(f"S={s}{'*' if s == auto else ''} {main:.4f}+"
                         f"{sum(kernels.values()) - main:.4f}")
        print(f"splits F={f:3d}: main + second pass device ms: " + ", ".join(parts))
    x1, x2, th, _ = _inputs(gen, 784, 64)
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader", "-lms", "500"], stdout=subprocess.PIPE,
                           text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 2.0:
        for _ in range(50):
            R.tropical_tucker2(x1, x2, th, log_weights=True)
        torch.cuda.synchronize()
    smi.terminate()
    print("clocks.sm, power.draw during F=784 launches:",
          "; ".join(smi.communicate()[0].split("\n")[1:-1]))


def _queries(trees, order) -> None:
    from cirkit_tpu_torch.backend.torch import MAPQuery, SamplingQuery
    from cirkit_tpu_torch.backend.torch import queries as Q

    _, ctx, cc = CS._build_flagship("tucker", False, "cuda")
    rng = np.random.default_rng(0)  # the batch and 50% mask of bench.py:222-224
    x = torch.as_tensor(rng.integers(0, 256, size=(CS.BATCH, 784)), device="cuda")
    mask = torch.as_tensor(rng.random((CS.BATCH, 784)) < 0.5, device="cuda")
    mq, sq = MAPQuery(cc), SamplingQuery(cc)
    gen = torch.Generator().manual_seed(0)
    calls = {"map": lambda: mq(x, evidence_mask=mask),
             "sample": lambda: sq(CS.BATCH, generator=gen),
             "conditional": lambda: sq.conditional(x, evidence_mask=mask, generator=gen)}
    keep = (Q.tropical_tucker2, Q.route_tucker2)

    def use(name):
        if name == "this":
            Q.tropical_tucker2, Q.route_tucker2 = keep
        else:
            Q.tropical_tucker2, Q.route_tucker2 = trees[name].tropical, trees[name].route

    with torch.inference_mode():
        for what, fn in calls.items():
            times = {name: [] for name in trees}
            for name in order:
                use(name)
                times[name].append(CS._median_ms(fn, warmup=2, iters=10))
            for name in trees:
                use(name)
                print(f"{what:11s} {name:5s} ms {[round(v, 3) for v in times[name]]}; "
                      f"{_split(fn)}")
    use("this")


def _split(fn, top: int = 6) -> str:
    """Device ms of one call of ``fn`` (``torch.profiler``, 3 calls): the
    total, the routing kernels, the ``top`` largest other kernels by name,
    and the rest."""
    wall, kernels = CS._profile(fn, 3)
    parts: dict[str, float] = {}
    for key, ms in kernels.items():
        name = key.removeprefix("void ").replace("(anonymous namespace)::", "")
        name = name.replace("at::native::", "").split("(")[0][:60]
        parts[name] = parts.get(name, 0.0) + ms
    total = sum(parts.values())
    ours = {k: v for k, v in parts.items() if k.startswith(("tropical_", "route_tucker"))}
    rest = sorted(((v, k) for k, v in parts.items() if k not in ours), reverse=True)
    shown = ", ".join(f"{k} {v:.4f}" for k, v in sorted(ours.items(), key=lambda i: -i[1]))
    shown += "; " + ", ".join(f"{k} {v:.4f}" for v, k in rest[:top])
    return (f"wall {wall:.3f} ms under the profiler, device {total:.4f} ms "
            f"(idle {1 - total / wall:.1%}): {shown}; other {sum(v for v, _ in rest[top:]):.4f}")


_FUNC = re.compile(r"Function : (\S+)")
_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"\bBRA\b.*?(0x[0-9a-f]+)")


def _opcode(ins: str) -> str:
    """``@!P0 FMNMX.FTZ R1, ...`` -> ``FMNMX``."""
    words = ins.split()
    return (words[1] if words[0].startswith("@") else words[0]).split(".")[0]


def _sass_mix(lib: Path, names: tuple[str, ...], key: str, main: tuple[str, ...]) -> str:
    """The instruction mix of the loop with the most ``key`` instructions in
    the first kernel whose mangled name holds one of ``names`` (tried in
    order): the span from a backward branch's target to the branch, the
    ``main`` opcodes first."""
    tool = shutil.which("cuobjdump") or str(Path(_nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    funcs: dict[str, list[tuple[int, str]]] = {}
    name = None
    for line in sass.splitlines():
        if m := _FUNC.search(line):
            name = m.group(1)
            funcs[name] = []
        elif name and (m := _LINE.search(line)):
            funcs[name].append((int(m.group(1), 16), m.group(2)))
    body = next((b for tag in names for n, b in funcs.items() if tag in n), [])
    best = None
    for addr, ins in body:
        if (b := _BRA.search(ins)) and int(b.group(1), 16) < addr:
            loop = [op for a, op in body if int(b.group(1), 16) <= a <= addr]
            ops = Counter(_opcode(op) for op in loop)
            if best is None or ops[key] > best[key]:
                best = ops
    if not best:
        return "loop not found"
    head = {k: best.get(k, 0) for k in main}
    return (", ".join(f"{k} {v}" for k, v in head.items())
            + f", other {sum(best.values()) - sum(head.values())} "
            + f"({', '.join(f'{k} {v}' for k, v in best.most_common() if k not in head)})")


# (label, mangled-name tags tried in order, the loop's key opcode, the opcodes
# listed first): the float instances with logits
SASS_KERNELS = (
    ("tropical_tucker_kernel<float, true> inner loop",
     ("tropical_tucker_kernelIfLb1ELb1E", "tropical_tucker_kernelIfLb1EE"), "FMNMX",
     ("FADD", "FMNMX", "LDS")),
    ("route_tucker_kernel<float, true, max> pass", ("route_tucker_kernelIfLb1ELb0E",), "FADD",
     ("FADD", "FSETP", "LDG", "LDS")),
    ("route_tucker_kernel<float, true, sample> pass", ("route_tucker_kernelIfLb1ELb1E",),
     "MUFU", ("FADD", "FFMA", "MUFU", "LDG", "LDS")),
)


def main() -> int:
    args = [a for a in sys.argv[1:] if a not in ("--no-queries", "--splits")]
    if len(args) > 1 or not torch.cuda.is_available():
        print(__doc__)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dirs = {"this": REPO / "cirkit_tpu_torch" / "csrc"}
    if args:
        dirs = {"other": Path(args[0]), **dirs}
    (REPO / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=REPO / "build"))
    trees = {name: Tree(path, tmp / f"lib{name}.so") for name, path in dirs.items()}
    for label, tags, key, head in SASS_KERNELS:
        for name, t in trees.items():
            print(f"SASS {name:5s} {label}: {_sass_mix(t.path, tags, key, head)}")
    order = ("other", "this", "this", "other") if "other" in trees else ("this", "this")
    with torch.inference_mode():
        _kernels(trees, order)
        if "--splits" in sys.argv:
            _splits()
    if "--no-queries" not in sys.argv:
        _queries(trees, order)
    return 0


if __name__ == "__main__":
    sys.exit(main())
