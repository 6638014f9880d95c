"""The PyTorch backend: compiled layers, parameter graphs, folding,
graph rewrites, the evaluation plan, the queries, the cross-circuit
queries, structural pruning and growing, tree distillation, and serving
(bf16 weight stores, exported forwards, warm-start bundles) (the
counterpart of ``cirkit_tpu.backend.jax``)."""

from cirkit_tpu_torch.backend.torch.circuit import TorchCircuit
from cirkit_tpu_torch.backend.torch.compiler import TorchCompiler
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
    Query,
    SamplingQuery,
    masked_evaluate,
    mutual_information,
)
from cirkit_tpu_torch.backend.torch.semiring import (
    ComplexLSESumSemiring,
    LSESumSemiring,
    Semiring,
    SemiringImpl,
    SumProductSemiring,
)
from cirkit_tpu_torch.backend.torch.serving import (
    bf16_weight_store,
    export_circuit,
    load_exported,
    weight_slots,
)
from cirkit_tpu_torch.backend.torch.warmstart import (
    WarmBundle,
    WarmStartError,
    load_bundle,
    save_bundle,
)

__all__ = [
    "ComplexLSESumSemiring",
    "TorchCircuit",
    "TorchCompiler",
    "LSESumSemiring",
    "Semiring",
    "SemiringImpl",
    "SumProductSemiring",
    "EntropyQuery",
    "ExpectationQuery",
    "IntegrateQuery",
    "KLDivergenceQuery",
    "MAPQuery",
    "Query",
    "SamplingQuery",
    "WarmBundle",
    "WarmStartError",
    "bf16_weight_store",
    "cross_circuit_kl",
    "distill_tree",
    "export_circuit",
    "expected_loglikelihood",
    "expected_loglikelihood_mc",
    "grow_circuit",
    "grow_prune_loop",
    "is_deterministic",
    "kl_monte_carlo",
    "load_bundle",
    "load_exported",
    "masked_evaluate",
    "mutual_information",
    "prune_circuit",
    "renyi2_entropy",
    "save_bundle",
    "selection_score",
    "weight_slots",
]
