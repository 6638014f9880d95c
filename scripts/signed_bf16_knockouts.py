"""Knock-out builds of the signed fast Tucker forward (``csrc/tucker_bf16.cu``
with ``SIGNED``) on a bf16 weight's linear values, the ``_w16_fast`` and
``_w16_sr`` instances, where a stage is only its products and s1 is read
into registers: each variant changes one piece of their work, to find what
makes ``_w16_sr`` slower than its ``_w16_fast`` twin and than the unsigned
``_w16_sr``.

Run on a machine with a CUDA card and the CUDA toolkit, from the root of a
checkout:

    python3 scripts/signed_bf16_knockouts.py

The source is copied to ``build/signed_knockouts/`` with macros that switch
one piece off or swap it, and its parts 6 and 7 (the signed ``_w16_fast``
and ``_w16_sr`` entries; ``-DCIRKIT_BF16_PART``) are compiled for each
variant into a library of their own, with parts 2 and 3 (the unsigned
ones, the yardstick) in the base library, all side by side (the flags of
``cirkit_tpu_torch/ops/_build.py``). Variants: ``base`` (the source as it
is), ``s1_ring`` (s1 through the ring beside x1, as the signed instances
with a convert step take it), ``s1_one`` (every s1 read as +1: no s1 loads),
``e2_nearest`` (E2 rounded to the nearest in every mode: no stochastic bits
in its staging), ``no_sign_out`` (no store of sign y). For each variant and
instance the script prints the kernel's registers, stack frame (where ptxas
puts spilled registers) and shared memory (``scripts/ptxas_report.py``'s
``library_report``) and its time at the K=64 entry (F=784, B=128,
K1=K2=O=64) and at the serving batch (F=196, B=512): the lower of two
medians of 20 CUDA-event timings after 3 warm-ups, the variants timed in
turns (in order, then in reverse). Only the base build's outputs are
checked: against the plain version in its mode, in linear space scaled by
the row's absolute mass (1e-5). Prints the card's name and power limit
first.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from cirkit_tpu_torch.ops import _build  # noqa: E402
from cirkit_tpu_torch.ops import lse_einsum as L  # noqa: E402
from cirkit_tpu_torch.ops import slse_einsum as S  # noqa: E402
from ptxas_report import library_report  # noqa: E402

CSRC = REPO / "cirkit_tpu_torch" / "csrc"
OUT = REPO / "build" / "signed_knockouts"
MACROS = ("KO_S1_RING", "KO_S1_ONE", "KO_E2_NEAREST", "KO_NO_SIGN_OUT")
VARIANTS = {"base": (), "s1_ring": ("KO_S1_RING",), "s1_one": ("KO_S1_ONE",),
            "e2_nearest": ("KO_E2_NEAREST",), "no_sign_out": ("KO_NO_SIGN_OUT",)}
# (text of the source, its knocked-out form): each must occur once
PATCHES = (
    ("constexpr bool s1_in_ring = SIGNED && (SOFTMAX || sizeof(WT) == 4);",
     "constexpr bool s1_in_ring = SIGNED && (KO_S1_RING || SOFTMAX || sizeof(WT) == 4);"),
    ("            s1a = sa[rr];\n            s1b = sb[rr];\n",
     "            s1a = KO_S1_ONE ? 1.f : sa[rr];\n            s1b = KO_S1_ONE ? 1.f : sb[rr];\n"),
    ("pack_bf16x8<MODE>(v, idx, cirkit::ROLE_E);",
     "pack_bf16x8<(KO_E2_NEAREST ? cirkit::BF16 : MODE)>(v, idx, cirkit::ROLE_E);"),
    ("          *reinterpret_cast<float2*>(signf + k) = make_float2(sg[0], sg[1]);\n",
     "          if (!KO_NO_SIGN_OUT) *reinterpret_cast<float2*>(signf + k) = make_float2(sg[0], sg[1]);\n"),
    ("if (o + e < O) outf[k + e] = y[e], signf[k + e] = sg[e];",
     "if (o + e < O) outf[k + e] = y[e], signf[k + e] = KO_NO_SIGN_OUT ? signf[k + e] : sg[e];"),
)
# (entry suffix, mode, part of the signed entries, part of the unsigned ones)
INSTANCES = (("_w16_fast", "bf16", 6, 2), ("_w16_sr", "sr", 7, 3))
SHAPES = (("K=64", (784, 128, 64, 64)), ("B=512", (196, 512, 64, 64)))  # F, B, K, O


def _source() -> Path:
    """The knock-out copy of the source; the headers are found in ``CSRC``."""
    text = (CSRC / "tucker_bf16.cu").read_text()
    for old, new in PATCHES:
        if text.count(old) != 1:
            raise RuntimeError(f"the source no longer holds {old!r}")
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "tucker_bf16_ko.cu"
    src.write_text("".join(f"#ifndef {k}\n#define {k} 0\n#endif\n" for k in MACROS) + text)
    return src


def _library(src: Path, name: str, macros, parts) -> tuple[Path, ctypes.CDLL]:
    """The variant's parts compiled side by side and linked into one
    library, bound with the port's signatures."""
    nvcc = _build._nvcc()
    objs = [OUT / f"{name}{p}.o" for p in parts]
    cmds = [[nvcc, *_build.NVCC_FLAGS, f"-I{CSRC}", f"-DCIRKIT_BF16_PART={p}",
             *(f"-D{m}=1" for m in macros), "-c", "-o", str(obj), str(src)]
            for p, obj in zip(parts, objs)]
    with ThreadPoolExecutor(len(cmds)) as pool:
        procs = list(pool.map(lambda c: subprocess.run(c, capture_output=True, text=True,
                                                       check=False), cmds))
    out = OUT / f"lib{name}.so"
    for proc in procs:
        if proc.returncode != 0:
            raise RuntimeError(proc.stdout + proc.stderr)
    link = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(out), *map(str, objs)],
                          capture_output=True, text=True, check=False)
    if link.returncode != 0:
        raise RuntimeError(link.stdout + link.stderr)
    lib = ctypes.CDLL(str(out))
    for entry in ("lse_fwd_tucker", "slse_fwd_tucker"):
        for sfx, _, sp, up in INSTANCES:
            if (up if entry == "lse_fwd_tucker" else sp) in parts:
                fn = getattr(lib, entry + sfx)
                fn.argtypes, fn.restype = _build._SIGNATURES[entry + sfx]
    return out, lib


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__)
        return 2
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True, check=True).stdout.strip())
    src = _source()
    signed_parts = tuple(sp for _, _, sp, _ in INSTANCES)
    jobs = {name: (macros, signed_parts + (tuple(up for *_, up in INSTANCES)
                                           if name == "base" else ()))
            for name, macros in VARIANTS.items()}
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda kv: _library(src, kv[0], *kv[1]), jobs.items())))
    libs = {name: lib for name, (_, lib) in built.items()}
    for name, (path, _) in built.items():
        for kernel, stat in sorted(library_report(path, "tucker_fwd_bf16").items()):
            print(f"{name:12s} {kernel}: registers/stack/smem/digest/TC {stat}")
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    order = (*VARIANTS, *reversed(VARIANTS))
    with torch.inference_mode():
        for where, (f, b, k, o) in SHAPES:
            sizes = (f, b, k, k, o)
            a1, a2 = (torch.randn((f, b, k), generator=gen, device="cuda") * 3 - 2
                      for _ in range(2))
            s1, s2 = (torch.randint(-1, 2, (f, b, k), generator=gen, device="cuda").float()
                      for _ in range(2))
            w = torch.randn((f, o, k * k), generator=gen, device="cuda").to(torch.bfloat16)
            uw = w.abs()
            oa, os_ = torch.empty((f, b, o), device="cuda"), torch.empty((f, b, o), device="cuda")
            for sfx, mode, _, _ in INSTANCES:
                def call(name, sfx=sfx):
                    err = getattr(libs[name], "slse_fwd_tucker" + sfx)(
                        *(t.data_ptr() for t in (a1, s1, a2, s2, w, oa, os_)), *sizes, 0, stream)
                    assert err == 0, err

                def ucall(sfx=sfx):
                    err = getattr(libs["base"], "lse_fwd_tucker" + sfx)(
                        *(t.data_ptr() for t in (a1, a2, uw, oa)), *sizes, 0, stream)
                    assert err == 0, err

                call("base")
                ref = S._ENTRIES["slse_tucker2"][2](a1, s1, a2, s2, w, mode=mode)
                mass = L.lse_tucker2_ref(a1, a2, w.float().abs())
                lin = [torch.where(torch.isneginf(mass), 0.0, sg * torch.exp(la - mass))
                       for la, sg in ((oa, os_), ref)]
                err = float((lin[0] - lin[1]).abs().max())
                assert err <= 1e-5, f"base {sfx} {where}: {err} from the plain version"
                times: dict[str, list[float]] = {name: [] for name in VARIANTS}
                unsigned = []
                for name in order:
                    times[name].append(C._median_ms(lambda name=name: call(name)))
                    if name == "base":
                        unsigned.append(C._median_ms(ucall))
                base = min(times["base"])
                print(f"{where} slse_fwd_tucker{sfx}: unsigned lse_fwd_tucker{sfx} "
                      f"{min(unsigned):.4f} ms; base max_abs_err {err:.2e}", flush=True)
                for name, ts in times.items():
                    print(f"  {name:12s} {min(ts):.4f} ms ({', '.join(f'{t:.4f}' for t in ts)}); "
                          f"{min(ts) / base:.3f} of base, {min(ts) / min(unsigned):.3f} of the "
                          "unsigned", flush=True)
            del a1, a2, s1, s2, w, uw, oa, os_
    return 0


if __name__ == "__main__":
    sys.exit(main())
