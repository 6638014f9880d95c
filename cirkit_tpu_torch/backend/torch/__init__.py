"""The PyTorch backend: compiled layers, parameter graphs, folding,
graph rewrites, the evaluation plan and the queries (the counterpart of
``cirkit_tpu.backend.jax``)."""

from cirkit_tpu_torch.backend.torch.queries import (
    IntegrateQuery,
    MAPQuery,
    SamplingQuery,
    masked_evaluate,
)

__all__ = ["IntegrateQuery", "MAPQuery", "SamplingQuery", "masked_evaluate"]
