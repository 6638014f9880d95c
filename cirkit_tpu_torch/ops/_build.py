"""Build and load the hand-written CUDA kernels of ``cirkit_tpu_torch/csrc``.

The sources are compiled at first use by ``nvcc``, one process per source
(``lse_einsum.cu`` and ``clse_einsum.cu`` in three parts, ``blocked_bf16.cu``
in five, ``lse_einsum_bwd.cu`` and ``tucker_bf16_bwd.cu`` in six,
``tucker_bf16.cu`` in nine) started together, and linked into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
loaded with ``ctypes``; the signed log-einsum-exp kernels are template
instances in the lse kernels' two sources, the complex ones have a source of
their own, and so have the fast modes' Tucker forwards and backward on the
bf16 tensor cores (``tucker_bf16.cu``: the ``_fast``, ``_sr``, ``_w16_fast``
and ``_w16_sr`` entries of ``lse_fwd_tucker[_softmax]``, which kernel 5's
fast instances launch too, and of ``slse_fwd_tucker[_softmax]``, and the
``_fast`` and ``_sr`` ones of ``clse_fwd_tucker_rw``, the signed and the
complex Tucker forwards, whose float32-grade instances are
``lse_einsum.cu``'s tensor-core ones; ``tucker_bf16_bwd.cu``: those of
``lse_bwd_tucker[_softmax]``, kernel 5's backward too, and of
``slse_bwd_tucker[_softmax]`` and ``clse_bwd_tucker_rw``, the signed and the
complex Tucker backwards, whose float32-grade instances are
``lse_einsum_bwd.cu``'s tensor-core ones), and the blocked
dense kernels' bf16-weight and fast-mode instances (``blocked_bf16.cu``: the
``_w16``, ``_fast``, ``_sr``, ``_w16_fast`` and ``_w16_sr`` entries of
``lse_fwd_blocked`` and ``lse_bwd_blocked``). The library goes
to ``build/cirkit_tpu_torch/`` at the root of the checkout, under a name
keyed on a hash of the sources and the flags, so an edit rebuilds and an
unchanged tree reuses the build.
Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
_SOURCES = tuple(
    _PKG / "csrc" / name
    for name in (
        "lse_einsum.cu", "lse_einsum_bwd.cu", "lse_wide.cu", "tucker_route.cu", "clse_einsum.cu",
        "tucker_bf16.cu", "tucker_bf16_bwd.cu", "blocked_bf16.cu",
    )
)
_HEADERS = (_PKG / "csrc" / "lse_common.cuh", _PKG / "csrc" / "tc_common.cuh")
# the compile units, (source, extra flags): the sources that hold many
# instances in parts that compile side by side (each part's macro selects
# its entries), the others whole
_PARTS = {"lse_einsum.cu": ("CIRKIT_FWD_PART", 3), "lse_einsum_bwd.cu": ("CIRKIT_BWD_PART", 6),
          "clse_einsum.cu": ("CIRKIT_CLSE_PART", 3), "tucker_bf16.cu": ("CIRKIT_BF16_PART", 9),
          "tucker_bf16_bwd.cu": ("CIRKIT_BF16_BWD_PART", 6),
          "blocked_bf16.cu": ("CIRKIT_BLOCKED_PART", 5)}
_UNITS = tuple(
    unit
    for src in _SOURCES
    for unit in (
        [(src, (f"-D{_PARTS[src.name][0]}={part}",)) for part in range(_PARTS[src.name][1])]
        if src.name in _PARTS else [(src, ())]
    )
)
BUILD_DIR = _PKG.parent / "build" / "cirkit_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U64 = ctypes.c_uint64
# entry point -> (argument types, return type). Arguments are the inputs,
# the output, the sizes, the device and the stream; every pointer and the
# stream pass as c_void_p, so ctypes never cuts them to 32 bits.
_SIGNATURES = {
    "lse_fwd_dense": ((_P, _P, _P, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    "lse_fwd_dense_softmax": ((_P, _P, _P, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    "lse_fwd_tucker": ((_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    "lse_fwd_tucker_softmax": ((_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    # backward: inputs, weight, out, g; gradients (null skips one); scratch
    "lse_bwd_dense": ((*(_P,) * 8, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    "lse_bwd_dense_softmax": ((*(_P,) * 9, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    "lse_bwd_tucker": ((*(_P,) * 11, _I, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    "lse_bwd_tucker_softmax": ((*(_P,) * 12, _I, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    # the values of the CUDA-core instances' gy scratch (gy and their
    # partial sums): signed, tucker, F, B, K1, K2, O (dense: K1 = I, K2 = 1)
    "lse_bwd_gy_size": ((_I,) * 7, ctypes.c_size_t),
    # the signed entries of the same two sources: each input is a
    # (log-magnitude, sign) pair, the forward writes (log|y|, sign y), and
    # the backward reads both outputs beside g
    "slse_fwd_dense": ((*(_P,) * 5, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    "slse_fwd_dense_softmax": ((*(_P,) * 5, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    "slse_fwd_tucker": ((*(_P,) * 7, _I, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    "slse_fwd_tucker_softmax": ((*(_P,) * 7, _I, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    "slse_bwd_dense": ((*(_P,) * 10, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    "slse_bwd_dense_softmax": ((*(_P,) * 11, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    "slse_bwd_tucker": ((*(_P,) * 14, _I, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    "slse_bwd_tucker_softmax": ((*(_P,) * 15, _I, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    # lse_wide.cu: the K1-chunked Tucker forward (as lse_fwd_tucker); the
    # blocked dense forward (x, w, out, m) and backward (x, w, out, m, g,
    # dx, dw, gy scratch); their bf16-weight and fast-mode instances are
    # blocked_bf16.cu's, with the same arguments (dw of the weight's type)
    "lse_fwd_ct": ((_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    "lse_fwd_ct_softmax": ((_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    "lse_fwd_blocked": ((_P, _P, _P, _P, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    "lse_bwd_blocked": ((*(_P,) * 8, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    # tucker_route.cu: inputs, output (the tropical kernel: then its split
    # scratch, part and stats), F, B, K1, K2, O (the tropical kernel: then
    # its split count), log_weights (the route: then sample, seed and the
    # warps a row), device, stream
    "tropical_tucker": ((*(_P,) * 6, *(_I,) * 8, _P), ctypes.c_int),
    "route_tucker": ((*(_P,) * 5, *(_I,) * 7, _U64, _I, _I, _P), ctypes.c_int),
    # clse_einsum.cu: (xa, xb, w, out), F, B, K1, K2, O, then the flags
    # tucker, complex weight, complex128; the backward adds g, the gradients
    # (dxa, dxb, dw) and the scratch (sa, sb, gy) after out
    "clse_fwd": ((*(_P,) * 4, *(_I,) * 9, _P), ctypes.c_int),
    "clse_bwd": ((*(_P,) * 11, *(_I,) * 9, _P), ctypes.c_int),
    # the complex values of the backward's gy scratch: F, B, K1, K2, O and
    # the three flags
    "clse_bwd_gy_size": ((_I,) * 8, ctypes.c_size_t),
    "cirkit_cuda_error_string": ((_I,), ctypes.c_char_p),
}
# every source but clse_einsum.cu builds each entry for float (the plain
# name) and for double (the name with _f64), with the same signature, but
# for the float Tucker lse backward, whose tensor-core path takes a scratch
# (``lse_bwd_scratch`` floats) as its softmax entry does
_SIGNATURES.update({
    f"{name}_f64": sig for name, sig in list(_SIGNATURES.items())
    if not name.startswith(("clse_", "cirkit_"))
})
_SIGNATURES["lse_bwd_tucker"] = _SIGNATURES["lse_bwd_tucker_softmax"]
_SIGNATURES["lse_bwd_scratch"] = ((_I,) * 7, ctypes.c_size_t)
# the float signed Tucker entries run the lse Tucker entries' routes (the
# tensor cores, or tucker_bf16_bwd.cu in a fast mode) and take their scratch,
# gy and ws, after the row shifts
_SIGNATURES["slse_bwd_tucker"] = ((*(_P,) * 15, _I, _I, _I, _I, _I, _I, _P), ctypes.c_int)
_SIGNATURES["slse_bwd_tucker_softmax"] = _SIGNATURES["slse_bwd_tucker"]
# the complex64 Tucker forward and backward against a real weight: (x1, x2,
# w, out), F, B, K1, K2, O; the backward adds g, the gradients (dx1, dx2,
# dw) and the scratch (sa, sb, ws) after out
_SIGNATURES["clse_fwd_tucker_rw"] = ((*(_P,) * 4, *(_I,) * 6, _P), ctypes.c_int)
_SIGNATURES["clse_bwd_tucker_rw"] = ((*(_P,) * 11, *(_I,) * 6, _P), ctypes.c_int)
INSTANCES = ("_fast", "_sr", "_w16", "_w16_fast", "_w16_sr")
"""The entry suffixes of the bf16-weight (``_w16``) and fast-mode (``_fast``,
``_sr``) instances of kernels 1-7 (float32 activations), which take the
float entries' arguments. The K1-chunked Tucker forwards
(``lse_fwd_ct[_softmax]``) and the routing kernels 8 and 9 have a ``_w16``
entry alone (kernel 5's fast instances launch the single-pass Tucker
forwards' entries, one kernel for both), the complex kernels 10 and 11 the
fast ones alone (``COMPLEX_INSTANCES``)."""
COMPLEX_INSTANCES = ("_fast", "_sr")
"""The entry suffixes of the complex kernels' fast-mode instances
(complex64), which take the complex entries' arguments."""
_SIGNATURES.update({
    f"{name}{sfx}": _SIGNATURES[name]
    for name in ("lse_fwd_dense", "lse_fwd_dense_softmax", "lse_fwd_tucker",
                 "lse_fwd_tucker_softmax", "lse_bwd_dense", "lse_bwd_dense_softmax",
                 "lse_bwd_tucker", "lse_bwd_tucker_softmax", "lse_fwd_blocked", "lse_bwd_blocked",
                 "slse_fwd_dense", "slse_fwd_dense_softmax", "slse_fwd_tucker",
                 "slse_fwd_tucker_softmax", "slse_bwd_dense", "slse_bwd_dense_softmax",
                 "slse_bwd_tucker", "slse_bwd_tucker_softmax")
    for sfx in INSTANCES
})
_SIGNATURES.update({f"{name}{sfx}": _SIGNATURES[name]
                    for name in ("clse_fwd", "clse_bwd", "clse_fwd_tucker_rw",
                                 "clse_bwd_tucker_rw")
                    for sfx in COMPLEX_INSTANCES})
_SIGNATURES.update({f"{name}_w16": _SIGNATURES[name] for name in (
    "lse_fwd_ct", "lse_fwd_ct_softmax", "tropical_tucker", "route_tucker")})

_LIB: ctypes.CDLL | None = None
BUILD_SECONDS: float | None = None
"""Seconds the last ``nvcc`` run of this process took (None if it reused a build)."""
SOURCE_SECONDS: dict[str, float] = {}
"""Seconds each unit's ``nvcc`` took in that run (they run side by side)."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def library_path() -> Path:
    """Where the build of the current sources lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*_SOURCES, *_HEADERS):
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libcirkit_kernels-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a build of them exists; return its path."""
    global BUILD_SECONDS
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}{k}.o") for k, (src, _) in enumerate(_UNITS)]
    t0 = time.perf_counter()
    compiles = [[nvcc, *NVCC_FLAGS, *flags, "-c", "-o", str(obj), str(src)]
                for (src, flags), obj in zip(_UNITS, objs)]

    def compile_one(cmd):
        start = time.perf_counter()
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              check=False)
        return proc, time.perf_counter() - start

    with ThreadPoolExecutor(len(compiles)) as pool:  # one nvcc a unit, all at once
        done = list(pool.map(compile_one, compiles))
    failures = []
    for (src, flags), cmd, (proc, secs) in zip(_UNITS, compiles, done):
        SOURCE_SECONDS[" ".join((src.name, *flags))] = secs
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}")
    if not failures:
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            failures.append(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failures:
        raise RuntimeError("\n".join(failures))
    BUILD_SECONDS = time.perf_counter() - t0
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _LIB = lib
    return _LIB
