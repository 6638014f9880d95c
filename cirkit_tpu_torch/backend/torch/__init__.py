"""The PyTorch backend: compiled layers, parameter graphs, folding,
graph rewrites, the evaluation plan, the queries and the cross-circuit
queries (the counterpart of ``cirkit_tpu.backend.jax``)."""

from cirkit_tpu_torch.backend.torch.cross import (
    cross_circuit_kl,
    expected_loglikelihood,
    expected_loglikelihood_mc,
    is_deterministic,
    kl_monte_carlo,
)
from cirkit_tpu_torch.backend.torch.entropy import (
    EntropyQuery,
    KLDivergenceQuery,
    renyi2_entropy,
)
from cirkit_tpu_torch.backend.torch.queries import (
    ExpectationQuery,
    IntegrateQuery,
    MAPQuery,
    SamplingQuery,
    masked_evaluate,
    mutual_information,
)

__all__ = [
    "EntropyQuery",
    "ExpectationQuery",
    "IntegrateQuery",
    "KLDivergenceQuery",
    "MAPQuery",
    "SamplingQuery",
    "cross_circuit_kl",
    "expected_loglikelihood",
    "expected_loglikelihood_mc",
    "is_deterministic",
    "kl_monte_carlo",
    "masked_evaluate",
    "mutual_information",
    "renyi2_entropy",
]
