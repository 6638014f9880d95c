"""The PyTorch backend: compiled layers, parameter graphs, folding,
graph rewrites, the evaluation plan, the queries, the cross-circuit
queries, structural pruning and growing, and tree distillation (the
counterpart of ``cirkit_tpu.backend.jax``)."""

from cirkit_tpu_torch.backend.torch.cross import (
    cross_circuit_kl,
    expected_loglikelihood,
    expected_loglikelihood_mc,
    is_deterministic,
    kl_monte_carlo,
)
from cirkit_tpu_torch.backend.torch.distill import distill_tree
from cirkit_tpu_torch.backend.torch.entropy import (
    EntropyQuery,
    KLDivergenceQuery,
    renyi2_entropy,
)
from cirkit_tpu_torch.backend.torch.pruning import (
    grow_circuit,
    grow_prune_loop,
    prune_circuit,
    selection_score,
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
    "distill_tree",
    "expected_loglikelihood",
    "expected_loglikelihood_mc",
    "grow_circuit",
    "grow_prune_loop",
    "is_deterministic",
    "kl_monte_carlo",
    "masked_evaluate",
    "mutual_information",
    "prune_circuit",
    "renyi2_entropy",
    "selection_score",
]
