"""Hand-written CUDA kernels for the hot circuit contractions, with their
plain PyTorch versions."""

from cirkit_tpu_torch.ops.lse_einsum import (
    LAUNCHES,
    lse_matmul,
    lse_matmul_softmax,
    lse_tucker2,
    lse_tucker2_softmax,
)

__all__ = [
    "LAUNCHES",
    "lse_matmul",
    "lse_matmul_softmax",
    "lse_tucker2",
    "lse_tucker2_softmax",
]
