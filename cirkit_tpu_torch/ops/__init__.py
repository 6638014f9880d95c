"""Hand-written CUDA kernels for the hot circuit contractions, with their
plain PyTorch versions."""

from cirkit_tpu_torch.ops.clse_einsum import COMPLEX_OPS, clse_matmul, clse_tucker2
from cirkit_tpu_torch.ops.lse_einsum import (
    LAUNCHES,
    OPS,
    WIDE_OPS,
    backward,
    lse_matmul,
    lse_matmul_softmax,
    lse_tucker2,
    lse_tucker2_softmax,
)
from cirkit_tpu_torch.ops.routing import ROUTING_OPS, route_tucker2, tropical_tucker2
from cirkit_tpu_torch.ops.slse_einsum import (
    SIGNED_OPS,
    slse_matmul,
    slse_matmul_softmax,
    slse_tucker2,
    slse_tucker2_softmax,
)

__all__ = [
    "COMPLEX_OPS",
    "LAUNCHES",
    "OPS",
    "ROUTING_OPS",
    "SIGNED_OPS",
    "WIDE_OPS",
    "backward",
    "clse_matmul",
    "clse_tucker2",
    "lse_matmul",
    "lse_matmul_softmax",
    "lse_tucker2",
    "lse_tucker2_softmax",
    "route_tucker2",
    "slse_matmul",
    "slse_matmul_softmax",
    "slse_tucker2",
    "slse_tucker2_softmax",
    "tropical_tucker2",
]
