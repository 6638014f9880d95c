"""Build and load the hand-written CUDA kernels of ``cirkit_tpu_torch/csrc``.

The sources are compiled at first use by ``nvcc``, one process per source
started together, and linked into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), loaded with
``ctypes``; the signed log-einsum-exp kernels are template instances in
the lse kernels' two sources, and the complex ones have a source of their
own. The library goes to ``build/cirkit_tpu_torch/`` at the root of the
checkout, under a name keyed on a hash of the sources and the flags, so an
edit rebuilds and an unchanged tree reuses the build.
Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
_SOURCES = tuple(
    _PKG / "csrc" / name
    for name in (
        "lse_einsum.cu", "lse_einsum_bwd.cu", "lse_wide.cu", "tucker_route.cu", "clse_einsum.cu"
    )
)
_HEADERS = (_PKG / "csrc" / "lse_common.cuh", _PKG / "csrc" / "tc_common.cuh")
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
    # dx, dw, gy scratch)
    "lse_fwd_ct": ((_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    "lse_fwd_ct_softmax": ((_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    "lse_fwd_blocked": ((_P, _P, _P, _P, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    "lse_bwd_blocked": ((*(_P,) * 8, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    # tucker_route.cu: inputs, output, F, B, K1, K2, O, log_weights (and
    # for the route: sample, seed), device, stream
    "tropical_tucker": ((_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    "route_tucker": ((*(_P,) * 5, _I, _I, _I, _I, _I, _I, _I, _U64, _I, _P), ctypes.c_int),
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

_LIB: ctypes.CDLL | None = None
BUILD_SECONDS: float | None = None
"""Seconds the last ``nvcc`` run of this process took (None if it reused a build)."""


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
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in _SOURCES]
    t0 = time.perf_counter()
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(_SOURCES, objs)]
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cmd in compiles
    ]
    failures = []
    for cmd, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
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
