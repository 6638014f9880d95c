"""Registers, spills and shared memory of every CUDA kernel of the port, as
``ptxas -v`` reports them, for one or more source trees side by side.

Run on a machine with the CUDA toolkit, from the root of a checkout:

    python3 scripts/ptxas_report.py cirkit_tpu_torch/csrc [OTHER_CSRC ...] [--only A.cu,B.cu]

Each ``*.cu`` of each directory (or those ``--only`` names) is compiled for sm_90a with the flags of
``cirkit_tpu_torch/ops/_build.py`` (to an object that is thrown away). The
report has one line per kernel (demangled, with the template arguments
that turn a variant off, ``false``, dropped from the end, and the scalar
type ``float`` dropped from the front, so a kernel keeps its name when a
later tree adds such an argument; a mode of 0 before them goes too) and one
column per tree: ``registers/spill stores/spill loads/static shared
bytes/SASS digest/tensor-core instructions``.
The digest is the first 10 hex digits of the SHA-256 of the kernel's machine
code as ``cuobjdump -sass`` lists it, without addresses and encodings and
with the offsets into the kernel-parameter bank masked (a template flag's
added parameters move the others): two trees give one digest for a kernel
when they compile it to the same instructions. The last field counts the
kernel's tensor-core instructions (``HMMA``, which ``mma.sync`` compiles
to, and ``HGMMA``, which ``wgmma`` compiles to) by instruction and operand
type (``HMMA.1688.F32.TF32``: "TF32 HMMA"; ``HGMMA.64x64x16.F32.BF16``:
"BF16 HGMMA"). A trailing mode argument of 0 (the f32-grade
mode, a template's default) is dropped from a kernel's name too, also where
it is the only one left, so a kernel that loses that argument keeps its
name.

``library_report(lib, tag)`` reads the same of a library that
``ops/_build.py`` has built, with no compile: registers, stack frame (where
ptxas puts spilled registers) and static shared memory from ``cuobjdump
-res-usage``, the digest and tensor-core instructions from ``cuobjdump
-sass``, for the kernels whose mangled names hold ``tag``, or one of several tags
(``chip_smoke.py`` phase 17 reads blocked_bf16.cu's ``bb_`` kernels so, phase
18 the Tucker backwards' ``tc_dx_tucker``, ``tc_dw_kernel`` and
``tucker_bwd_bf16``).
"""

from __future__ import annotations

import hashlib
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from cirkit_tpu_torch.ops._build import NVCC_FLAGS, _nvcc  # noqa: E402

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_FUNCTION = re.compile(r"Function : (\S+)")
_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
_PARAM = re.compile(r"c\[0x0\]\[0x[0-9a-f]+\]")
_RES_FUNCTION = re.compile(r"Function ([^\s:]+):")
_RES = re.compile(r"REG:(\d+) STACK:(\d+) SHARED:(\d+)")


def _cuobjdump() -> str:
    return shutil.which("cuobjdump") or str(Path(_nvcc()).parent / "cuobjdump")


def _sass_digests(obj: Path, names: tuple[str, ...] = ()) -> dict[str, str]:
    """mangled kernel name -> digest of its instructions in ``obj`` (only
    those of ``names``, if given) and the number of its tensor-core
    instructions by kind, as ``digest/count (kinds)``."""
    only = ("-fun", ",".join(names)) if names else ()
    out = subprocess.run([_cuobjdump(), "-sass", *only, str(obj)], capture_output=True,
                         text=True, check=True).stdout
    digests: dict[str, str] = {}
    name, body = None, []
    for line in [*out.splitlines(), "Function : <end>"]:
        if m := _FUNCTION.search(line):
            if name is not None:
                ops = [op.split()[0] for op in body if op.startswith(("HMMA", "HGMMA"))]
                kinds = "+".join(
                    f"{n} {t} {i}" for i in ("HMMA", "HGMMA") for t in ("TF32", "BF16")
                    if (n := sum(k.startswith(i + ".") and k.endswith(t) for k in ops)))
                digests[name] = (hashlib.sha256("\n".join(body).encode()).hexdigest()[:10]
                                 + f"/{len(ops)}" + (f" ({kinds})" if kinds else ""))
            name, body = m.group(1), []
        elif name is not None and (m := _INSTR.search(line)):
            body.append(_PARAM.sub("c[0x0][.]", m.group(1)))
    return digests


def _demangle(names: list[str]) -> list[str]:
    tool = shutil.which("cu++filt") or str(Path(_nvcc()).parent / "cu++filt")
    if not Path(tool).exists():
        return names
    out = subprocess.run([tool, *names], capture_output=True, text=True, check=True).stdout
    return out.splitlines()


def _key(name: str) -> str:
    """The kernel's name without its trailing ``false`` template arguments
    and without its parameter list (``cu++filt`` writes a bool template
    argument as ``(bool)0`` or ``(bool)1``)."""
    name = name.replace("(anonymous namespace)::", "").replace("<unnamed>::", "")
    name = name.removeprefix("void ")
    name = name.replace("(bool)0", "false").replace("(bool)1", "true").replace("(int)", "")
    name = name.split("(")[0]
    # the scalar type leads the arguments: a float instance keeps the name it
    # had before the kernels became templates over their scalar type
    name = name.replace("<float, ", "<").replace("<float>", "")
    while name.endswith((", 0>", ", false>")):  # a mode of 0 before flags that are off too
        name = name[: name.rindex(", ")] + ">"
    name = name.removesuffix("<0>")
    return name.removesuffix("<false>")


def report(csrc: Path, only: tuple[str, ...] = ()) -> dict[str, str]:
    """kernel -> "registers/spill stores/spill loads/smem" for one tree."""
    rows: dict[str, str] = {}
    with tempfile.TemporaryDirectory() as tmp:
        for src in sorted(csrc.glob("*.cu")):
            if only and src.name not in only:
                continue
            obj = Path(tmp) / f"{src.stem}.o"
            cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj), str(src)]
            log = subprocess.run(cmd, capture_output=True, text=True, check=True).stderr
            sass = _sass_digests(obj)
            entry, spill = None, ("0", "0")
            mangled, stats = [], []
            for line in log.splitlines():
                if m := _ENTRY.search(line):
                    entry = m.group(1)
                elif m := _SPILL.search(line):
                    spill = m.groups()
                elif (m := _USED.search(line)) and entry is not None:
                    mangled.append(entry)
                    stats.append(f"{m.group(1)}/{spill[0]}/{spill[1]}/{m.group(2) or 0}/"
                                 f"{sass.get(entry, '?')}")
                    entry = None
            for name, stat in zip(_demangle(mangled), stats):
                rows[f"{src.name}: {_key(name)}"] = stat
    return rows


def library_report(lib: Path, tag: str | tuple[str, ...], keep=None) -> dict[str, str]:
    """kernel -> "registers/stack bytes/smem/SASS digest/tensor-core
    instructions" of each kernel of the built library ``lib`` whose mangled
    name holds ``tag`` (or one of the tags) and, with ``keep``, whose report
    name ``keep`` accepts (only those are disassembled)."""
    tags = (tag,) if isinstance(tag, str) else tag
    out = subprocess.run([_cuobjdump(), "-res-usage", str(lib)], capture_output=True, text=True,
                         check=True).stdout
    usage: dict[str, str] = {}
    name = None
    for line in out.splitlines():
        if m := _RES_FUNCTION.search(line):
            name = m.group(1)
        elif name is not None and (m := _RES.search(line)):
            if any(t in name for t in tags):
                usage[name] = "/".join(m.groups())
            name = None
    mangled = sorted(usage)
    keys = dict(zip(mangled, map(_key, _demangle(mangled))))
    if keep is not None:
        mangled = [n for n in mangled if keep(keys[n])]
    sass = _sass_digests(lib, tuple(mangled)) if mangled else {}
    return {keys[n]: f"{usage[n]}/{sass.get(n, '?')}" for n in mangled}


def main() -> int:
    args = sys.argv[1:]
    only: tuple[str, ...] = ()
    if "--only" in args:
        at = args.index("--only")
        only = tuple(args[at + 1].split(","))
        del args[at : at + 2]
    trees = [Path(p) for p in args] or [REPO / "cirkit_tpu_torch" / "csrc"]
    reports = [report(t, only) for t in trees]
    names = sorted(set().union(*reports))
    print("kernel | " + " | ".join(str(t) for t in trees))
    for name in names:
        print(f"{name} | " + " | ".join(r.get(name, "-") for r in reports))
    return 0


if __name__ == "__main__":
    sys.exit(main())
