"""Fused log-einsum-exp ops for the circuit hot path.

The counterpart of ``cirkit_tpu/ops/lse_einsum.py:1590-1687``. The log-space
(lse-sum) semiring evaluates every sum layer as a max-shifted
log-einsum-exp: shift each input row by its clamped max, exponentiate,
contract in linear space, take the log and add the shift back.

- :func:`lse_matmul` / :func:`lse_matmul_softmax`: the dense folded
  contraction ``(F, B, I) x (F, O, I) -> (F, B, O)``; the ``_softmax``
  variant takes raw logits and normalizes the weight rows inside the kernel.
- :func:`lse_tucker2` / :func:`lse_tucker2_softmax`: the arity-2 Tucker
  contraction ``(F, B, K1) x (F, B, K2) x (F, O, K1*K2) -> (F, B, O)``; the
  outer product of the two inputs never reaches device memory.

Each op is a wrapper around one entry of the hand-written CUDA kernel
``csrc/lse_einsum.cu``, beside a plain PyTorch version (``*_ref``) that
mirrors the JAX package's XLA fallbacks. The wrapper takes the plain
version only for tensors on the CPU; a CUDA tensor gets the kernel or an
exception. ``LAUNCHES`` counts the kernel launches of each wrapper.

The ops are forward-only: the backward kernel comes with training.
"""

from __future__ import annotations

import torch

from cirkit_tpu_torch.ops import _build

LAUNCHES: dict[str, int] = {
    "lse_matmul": 0,
    "lse_matmul_softmax": 0,
    "lse_tucker2": 0,
    "lse_tucker2_softmax": 0,
}
"""Kernel launches per wrapper; a wrapper adds one only where it launches."""

_MAX_GRID_YZ = 65535  # CUDA's limit on gridDim.y and gridDim.z
_BN, _BM = 64, 128  # the kernel's output-unit and batch-row tiles


def _clamp_max(x: torch.Tensor) -> torch.Tensor:
    """Trailing-axis max clamped to the finite range, so rows that are all
    -inf never produce NaNs via inf - inf."""
    info = torch.finfo(x.dtype)
    return x.amax(dim=-1, keepdim=True).clamp(info.min, info.max)


# --------------------------------------------------------------------------- #
# Plain PyTorch versions
# --------------------------------------------------------------------------- #


def lse_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``log(exp(x - m) @ w^T) + m``, composed from PyTorch ops."""
    m = _clamp_max(x)
    return torch.log(torch.bmm(torch.exp(x - m), w.transpose(1, 2))) + m


def lse_matmul_softmax_ref(x: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    return lse_matmul_ref(x, torch.softmax(theta, dim=-1))


def lse_tucker2_ref(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The Tucker contraction with the (F, B, K1*K2) outer product
    materialized, composed from PyTorch ops."""
    f, b, k1 = x1.shape
    k2 = x2.shape[2]
    m1 = _clamp_max(x1)
    m2 = _clamp_max(x2)
    e = torch.exp(x1 - m1)[..., :, None] * torch.exp(x2 - m2)[..., None, :]
    y = torch.bmm(e.reshape(f, b, k1 * k2), w.transpose(1, 2))
    return torch.log(y) + m1 + m2


def lse_tucker2_softmax_ref(
    x1: torch.Tensor, x2: torch.Tensor, theta: torch.Tensor
) -> torch.Tensor:
    return lse_tucker2_ref(x1, x2, torch.softmax(theta, dim=-1))


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #


def _check_dense(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or x.shape[2] != w.shape[2]:
        raise ValueError(f"Expected x (F, B, I) and w (F, O, I), found {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")


def _check_tucker(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor) -> None:
    if (
        x1.dim() != 3
        or x2.dim() != 3
        or w.dim() != 3
        or x1.shape[:2] != x2.shape[:2]
        or w.shape[0] != x1.shape[0]
        or w.shape[2] != x1.shape[2] * x2.shape[2]
    ):
        raise ValueError(
            f"Expected x1 (F, B, K1), x2 (F, B, K2) and w (F, O, K1*K2), found "
            f"{tuple(x1.shape)}, {tuple(x2.shape)} and {tuple(w.shape)}"
        )


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _launch(entry: str, op: str, ins: tuple[torch.Tensor, ...], sizes: tuple[int, ...],
            out_shape: tuple[int, int, int]) -> torch.Tensor:
    """Check the operands of a CUDA launch, allocate the output and launch
    ``entry`` of the kernel library on the current stream."""
    dev = ins[0].device
    if dev.type != "cuda":
        raise ValueError(f"{op}: tensors on {dev}; the op runs on CPU or CUDA tensors")
    for t in ins:
        if t.device != dev:
            raise ValueError(f"{op}: operands on {dev} and {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{op}: the CUDA kernel takes float32 operands, found {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: the CUDA kernel takes contiguous operands")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        raise NotImplementedError("backward kernel: training PR")
    f, b, o = out_shape
    if max(sizes) >= 2**31 or -(-o // _BN) > _MAX_GRID_YZ or -(-b // _BM) > _MAX_GRID_YZ:
        raise ValueError(f"{op}: sizes {sizes} exceed the kernel's launch grid")
    out = torch.empty(out_shape, device=dev, dtype=torch.float32)
    if out.numel() == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(lib, entry)(
        *(t.data_ptr() for t in ins), out.data_ptr(), *sizes, dev.index, stream
    )
    if err != 0:
        msg = lib.cirkit_cuda_error_string(err).decode()
        raise RuntimeError(f"{op}: kernel launch failed with CUDA error {err} ({msg})")
    LAUNCHES[op] += 1
    return out


def lse_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Fused ``log(exp(x - max) @ w^T) + max`` over the trailing axis.

    ``x``: (F, B, I) log-space values; ``w``: (F, O, I) linear-space weights.
    Returns (F, B, O) log-space values."""
    _check_dense(x, w)
    if _on_cpu(x, w):
        return lse_matmul_ref(x, w)
    f, b, i = x.shape
    o = w.shape[1]
    return _launch("lse_fwd_dense", "lse_matmul", (x, w), (f, b, i, o), (f, b, o))


def lse_matmul_softmax(x: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """:func:`lse_matmul` with ``w = softmax(theta, axis=-1)`` fused into the
    kernel: the normalized weights are never stored."""
    _check_dense(x, theta)
    if _on_cpu(x, theta):
        return lse_matmul_softmax_ref(x, theta)
    f, b, i = x.shape
    o = theta.shape[1]
    return _launch(
        "lse_fwd_dense_softmax", "lse_matmul_softmax", (x, theta), (f, b, i, o), (f, b, o)
    )


def lse_tucker2(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Fused arity-2 Tucker contraction under the lse-sum semiring.

    ``x1``: (F, B, K1) and ``x2``: (F, B, K2) log-space inputs; ``w``:
    (F, O, K1*K2) linear-space core weight, flattened row-major over (K1, K2).
    Returns (F, B, O) log-space values."""
    _check_tucker(x1, x2, w)
    if _on_cpu(x1, x2, w):
        return lse_tucker2_ref(x1, x2, w)
    f, b, k1 = x1.shape
    k2 = x2.shape[2]
    o = w.shape[1]
    return _launch(
        "lse_fwd_tucker", "lse_tucker2", (x1, x2, w), (f, b, k1, k2, o), (f, b, o)
    )


def lse_tucker2_softmax(
    x1: torch.Tensor, x2: torch.Tensor, theta: torch.Tensor
) -> torch.Tensor:
    """:func:`lse_tucker2` with ``w = softmax(theta, axis=-1)`` fused into
    the kernel (see :func:`lse_matmul_softmax`)."""
    _check_tucker(x1, x2, theta)
    if _on_cpu(x1, x2, theta):
        return lse_tucker2_softmax_ref(x1, x2, theta)
    f, b, k1 = x1.shape
    k2 = x2.shape[2]
    o = theta.shape[1]
    return _launch(
        "lse_fwd_tucker_softmax",
        "lse_tucker2_softmax",
        (x1, x2, theta),
        (f, b, k1, k2, o),
        (f, b, o),
    )
