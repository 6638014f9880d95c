"""Backends: compilers lowering the symbolic IR to executable plans.

The PyTorch backend (``cirkit_tpu_torch.backend.torch``) compiles circuits
into ``nn.Module`` evaluation plans over a parameter store.
"""

from cirkit_tpu_torch.backend.base import SUPPORTED_BACKENDS, AbstractCompiler

__all__ = ["SUPPORTED_BACKENDS", "AbstractCompiler"]
