"""Knock-out builds of ``csrc/blocked_bf16.cu``: the blocked instances with
one piece of their work removed, to see what bounds them.

Run on a machine with a CUDA card and the CUDA toolkit, from the root of a
checkout:

    python3 scripts/blocked_knockouts.py

The source is copied to ``build/knockouts/`` with macros that switch one
piece of the work off, and compiled whole once for each variant (the flags
of ``cirkit_tpu_torch/ops/_build.py``) into a library of its own, all side
by side. Variants: ``base`` (the source as it is), ``no_compute`` (the
consumers release each stage as it lands: the TMA copies alone),
``no_epilogue`` (no weight gradient leaves the backward), ``no_stores`` (no
dx and no dw stores to device memory), ``no_mma`` (no wgmma in the
backward), ``no_exp`` (the backward's exponentials replaced by their
arguments). The ``_fast``, ``_w16`` and ``_w16_fast`` instances' forward and
backward (both gradients, dx alone, dw alone) run at the dense K=128 entry
(F=784, B=128, I=16384, O=128) through the port's op wrappers pointed at
each library; each time is the median of 10 CUDA-event timings after 3
warm-ups. A knocked-out build's outputs are not checked. Prints the card's
name and power limit first.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from cirkit_tpu_torch.ops import _build  # noqa: E402
from cirkit_tpu_torch.ops import lse_einsum as L  # noqa: E402

CSRC = REPO / "cirkit_tpu_torch" / "csrc"
OUT = REPO / "build" / "knockouts"
MACROS = ("KO_COMPUTE", "KO_EPI", "KO_STORES", "KO_MMA", "KO_EXP")
VARIANTS = {"base": (), "no_compute": ("KO_COMPUTE",), "no_epilogue": ("KO_EPI",),
            "no_stores": ("KO_STORES",), "no_mma": ("KO_MMA",), "no_exp": ("KO_EXP",)}
RELEASE_BWD = ("if (KO_COMPUTE) { __syncwarp(); if (lane == 0) mbar_arrive(empty0 + 8 * slot); "
               "continue; }")
# (text of the source, its knocked-out form): each must occur once
PATCHES = (
    ("      mbar_wait(full0 + 8 * slot, (t / NS) & 1);\n",
     "      mbar_wait(full0 + 8 * slot, (t / NS) & 1);\n      " + RELEASE_BWD + "\n"),
    ("    mbar_wait(full0 + 8 * slot, (c / NS) & 1);\n",
     "    mbar_wait(full0 + 8 * slot, (c / NS) & 1);\n    " + RELEASE_BWD + "\n"),
    ("    if (do_dw) epilogue(f, c0);\n",
     "    if (do_dw && !KO_COMPUTE && !KO_EPI) epilogue(f, c0);\n"),
    ("      if (do_dx) {\n        float* dxf = dx",
     "      if (do_dx && !KO_STORES) {\n        float* dxf = dx"),
    ("          if (o >= Og || col >= I) continue;\n",
     "          if (o >= Og || col >= I || KO_STORES) continue;\n"),
    ("            if ((flags & bb::DW_VEC) && col < I) {", "            if (KO_STORES) {\n"
     "            } else if ((flags & bb::DW_VEC) && col < I) {"),
    ("      if (do_dx) {\n#pragma unroll\n        for (int p = 0; p < P; ++p)",
     "      if (do_dx && !KO_MMA) {\n#pragma unroll\n        for (int p = 0; p < P; ++p)"),
    ("      if (do_dw) {\n#pragma unroll\n        for (int u = 0; u < 2; ++u)\n",
     "      if (do_dw && !KO_MMA) {\n#pragma unroll\n        for (int u = 0; u < 2; ++u)\n"),
    ("ev[h][n][e] = in ? expf(pv[e] - mr[h]) : 0.f;",
     "ev[h][n][e] = in ? (KO_EXP ? pv[e] - mr[h] : expf(pv[e] - mr[h])) : 0.f;"),
)


def _source() -> Path:
    """The knock-out copy of the source, beside which the headers are found."""
    text = (CSRC / "blocked_bf16.cu").read_text()
    for old, new in PATCHES:
        if text.count(old) != 1:
            raise RuntimeError(f"the source no longer holds {old!r}")
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "blocked_ko.cu"
    src.write_text("".join(f"#ifndef {k}\n#define {k} 0\n#endif\n" for k in MACROS) + text)
    return src


def _library(src: Path, name: str, macros) -> ctypes.CDLL:
    out = OUT / f"lib{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", f"-I{CSRC}",
           *(f"-D{m}=1" for m in macros), "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(out))
    for entry in ("lse_fwd_blocked", "lse_bwd_blocked"):
        for sfx in L.INSTANCES:
            fn = getattr(lib, entry + sfx)
            fn.argtypes, fn.restype = _build._SIGNATURES[entry]
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__)
        return 2
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True, check=True).stdout.strip())
    src = _source()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda kv: _library(src, *kv), VARIANTS.items())))
    errors = _build.library()  # the error strings of a failed launch
    for lib in libs.values():
        lib.cirkit_cuda_error_string = errors.cirkit_cuda_error_string
    f, b, i, o = 784, 128, 128 * 128, 128
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((f, b, i), generator=gen, device="cuda") * 3 - 2
    w = torch.rand((f, o, i), generator=gen, device="cuda") * 0.99 + 0.01
    g = torch.randn((f, b, o), generator=gen, device="cuda")
    for sfx, mode in (("_fast", "bf16"), ("_w16", ""), ("_w16_fast", "bf16")):
        if sfx == "_w16":
            w = w.to(torch.bfloat16)
            torch.cuda.empty_cache()
        _build._LIB = errors
        with torch.inference_mode():
            out, m = L._launch_blocked_fwd(x, w, mode)
            for name, lib in libs.items():
                _build._LIB = lib
                fwd = C._median_ms(lambda: L._launch_blocked_fwd(x, w, mode), iters=10)
                bwd = [C._median_ms(lambda need=need: L._launch_blocked_bwd(
                    x, w, out, m, g, need, mode), iters=10)
                       for need in ((True, True), (True, False), (False, True))]
                print(f"{sfx:9s} {name:12s} forward {fwd:.3f} ms, backward {bwd[0]:.3f} ms "
                      f"(dx alone {bwd[1]:.3f}, dw alone {bwd[2]:.3f})", flush=True)
        _build._LIB = errors
        del out, m
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
