"""Build and load the hand-written CUDA kernels of ``cirkit_tpu_torch/csrc``.

The sources are compiled at first use by ``nvcc``, one process per source
started together, and linked into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), loaded with
``ctypes``. The library goes to ``build/cirkit_tpu_torch/``
at the root of the checkout, under a name keyed on a hash of the sources
and the flags, so an edit rebuilds and an unchanged tree reuses the build.
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
_SOURCES = (_PKG / "csrc" / "lse_einsum.cu", _PKG / "csrc" / "lse_einsum_bwd.cu")
_HEADERS = (_PKG / "csrc" / "lse_common.cuh",)
BUILD_DIR = _PKG.parent / "build" / "cirkit_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
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
    "lse_bwd_tucker_smem": ((_I, _I), ctypes.c_size_t),
    "cirkit_cuda_error_string": ((_I,), ctypes.c_char_p),
}

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
