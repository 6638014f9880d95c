"""cirkit-tpu-torch: the PyTorch and CUDA port of cirkit-tpu.

A second package beside the JAX one (``cirkit_tpu``), held against it as
its reference. The symbolic IR, region graphs and templates are copies of
the JAX package's modules that contain no JAX code; the backend
(``backend/torch``), the log-einsum-exp ops (``ops``, with hand-written
CUDA kernels under ``csrc``) and the pipeline are rebuilt in PyTorch.
Importing this package never imports ``jax``.
"""

__version__ = "0.1.1"

from cirkit_tpu_torch import models, ops, parallel, symbolic, utils  # noqa: E402,F401
from cirkit_tpu_torch.pipeline import (  # noqa: E402,F401
    PipelineContext,
    compile,
    concatenate,
    conjugate,
    differentiate,
    integrate,
    mixture,
    multiply,
)

__all__ = [
    "PipelineContext",
    "compile",
    "concatenate",
    "conjugate",
    "differentiate",
    "integrate",
    "mixture",
    "multiply",
    "models",
    "ops",
    "parallel",
    "symbolic",
    "utils",
]
