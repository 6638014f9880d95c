"""Layer-graph and parameter-graph optimization rewrites.

The counterpart of ``cirkit_tpu/backend/jax/optimization.py``: a
pattern-match-and-rewrite pass over the compiled (unfolded) layer graph,
run before folding.

- fuse rules: sum-collapse (sum of sum -> one sum with matmul'd weights),
  Tucker (sum of Kronecker -> one einsum), CP-T (sum of Hadamard).
- shatter rules: a dense sum (or tensor-dot) whose weight graph outputs a
  Kronecker product splits into two tensor-dot layers, reducing O(K^2)
  contractions to O(K sqrt(K)) (the sum layers of a squared circuit).
- parameter rules: log(softmax(x)) -> log_softmax(x); reduce-sum of an
  outer product -> a single einsum (never materializing the outer tensor).

Patterns are linear chains matched root-to-input on layer types with config
constraints and optional per-parameter sub-patterns; registries make the
pass user-extensible like the rest of the compiler.
"""

from __future__ import annotations

import itertools
from collections.abc import Callable, Mapping, Sequence
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any

from cirkit_tpu_torch.backend.torch import parameters as tp
from cirkit_tpu_torch.backend.torch.layers import (
    TorchHadamardLayer,
    TorchKroneckerLayer,
    TorchLayer,
    TorchSumLayer,
)
from cirkit_tpu_torch.backend.torch.optimized import (
    TorchCPTLayer,
    TorchTensorDotLayer,
    TorchTuckerLayer,
)
from cirkit_tpu_torch.backend.torch.parameters import TorchParameter, TorchParameterNode
from cirkit_tpu_torch.utils.algorithms import topological_ordering

if TYPE_CHECKING:
    from cirkit_tpu_torch.backend.torch.compiler import TorchCompiler


# --------------------------------------------------------------------------- #
# Pattern definitions
# --------------------------------------------------------------------------- #


@dataclass(frozen=True, eq=False)
class ParameterOptPattern:
    """A chain pattern over parameter-graph nodes, root first. If
    ``output_only`` the chain root must be the graph output."""

    entries: tuple[type, ...]
    output_only: bool = False


@dataclass(frozen=True, eq=False)
class LayerOptPattern:
    """A chain pattern over layers, root first, with per-entry config
    constraints and per-entry named-parameter sub-patterns."""

    entries: tuple[type, ...]
    configs: tuple[Mapping[str, Any], ...] = ()
    param_patterns: tuple[Mapping[str, ParameterOptPattern], ...] = ()


@dataclass
class LayerOptMatch:
    """A successful layer-pattern match."""

    pattern: LayerOptPattern
    entries: list[TorchLayer]
    sub_entries: list[dict[str, "ParameterOptMatch"]] = field(default_factory=list)

    @property
    def size(self) -> int:
        return len(self.entries)


@dataclass
class ParameterOptMatch:
    pattern: ParameterOptPattern
    entries: list[TorchParameterNode]


LayerOptApplyFunc = Callable[["TorchCompiler", LayerOptMatch], tuple[TorchLayer, ...]]
ParameterOptApplyFunc = Callable[
    ["TorchCompiler", ParameterOptMatch], tuple[TorchParameterNode, ...]
]


KroneckerOutParameterPattern = ParameterOptPattern(
    entries=(tp.TorchKroneckerParameter,), output_only=True
)
LogSoftmaxPattern = ParameterOptPattern(
    entries=(tp.TorchLogParameter, tp.TorchSoftmaxParameter)
)
ReduceSumOuterProductPattern = ParameterOptPattern(
    entries=(tp.TorchReduceSumParameter, tp.TorchOuterProductParameter)
)

SumCollapsePattern = LayerOptPattern(
    entries=(TorchSumLayer, TorchSumLayer), configs=({"arity": 1}, {})
)
TuckerPattern = LayerOptPattern(
    entries=(TorchSumLayer, TorchKroneckerLayer), configs=({"arity": 1}, {})
)
CandecompPattern = LayerOptPattern(
    entries=(TorchSumLayer, TorchHadamardLayer), configs=({"arity": 1}, {})
)
DenseKroneckerPattern = LayerOptPattern(
    entries=(TorchSumLayer,),
    configs=({"arity": 1},),
    param_patterns=({"weight": KroneckerOutParameterPattern},),
)
TensorDotKroneckerPattern = LayerOptPattern(
    entries=(TorchTensorDotLayer,),
    configs=({},),
    param_patterns=({"weight": KroneckerOutParameterPattern},),
)

# --------------------------------------------------------------------------- #
# Matching
# --------------------------------------------------------------------------- #


def _match_parameter_chain(
    graph: TorchParameter, pattern: ParameterOptPattern, root: TorchParameterNode
) -> ParameterOptMatch | None:
    """Match the chain pattern with the given node as its root."""
    if pattern.output_only and root is not graph.output:
        return None
    chain: list[TorchParameterNode] = []
    node = root
    for i, cls in enumerate(pattern.entries):
        if type(node) is not cls:
            return None
        chain.append(node)
        if i + 1 < len(pattern.entries):
            ins = graph.node_inputs(node)
            if len(ins) != 1 or len(graph.node_outputs(ins[0])) != 1:
                return None
            node = ins[0]
    return ParameterOptMatch(pattern, chain)


def _match_parameter_pattern(
    graph: TorchParameter, pattern: ParameterOptPattern
) -> ParameterOptMatch | None:
    """Match the chain pattern anywhere in the graph (outputs first)."""
    for root in reversed(list(graph.topological_ordering())):
        match = _match_parameter_chain(graph, pattern, root)
        if match is not None:
            return match
    return None


def _config_matches(layer: TorchLayer, constraints: Mapping[str, Any]) -> bool:
    cfg = layer.config
    return all(cfg.get(k) == v for k, v in constraints.items())


def _match_layer_pattern(
    root: TorchLayer,
    pattern: LayerOptPattern,
    in_layers: Mapping[TorchLayer, Sequence[TorchLayer]],
    consumers: Mapping[int, list[TorchLayer]],
    outputs: set[int],
) -> LayerOptMatch | None:
    chain: list[TorchLayer] = []
    node = root
    configs = pattern.configs or tuple({} for _ in pattern.entries)
    for i, cls in enumerate(pattern.entries):
        if type(node) is not cls or not _config_matches(node, configs[i]):
            return None
        chain.append(node)
        if i + 1 < len(pattern.entries):
            ins = in_layers.get(node, [])
            if len(ins) != 1:
                return None
            nxt = ins[0]
            # the intermediate layer must feed only this chain and not be an output
            if len(consumers.get(id(nxt), [])) != 1 or id(nxt) in outputs:
                return None
            node = nxt
    sub_entries: list[dict[str, ParameterOptMatch]] = []
    for i, layer in enumerate(chain):
        sub: dict[str, ParameterOptMatch] = {}
        if pattern.param_patterns:
            for name, ppat in pattern.param_patterns[i].items():
                m = _match_parameter_pattern(layer.params[name], ppat)
                if m is None:
                    return None
                sub[name] = m
        sub_entries.append(sub)
    return LayerOptMatch(pattern, chain, sub_entries)


# --------------------------------------------------------------------------- #
# Apply functions
# --------------------------------------------------------------------------- #


def apply_sum_collapse(compiler: "TorchCompiler", match: LayerOptMatch) -> tuple[TorchLayer, ...]:
    outer, inner = match.entries  # outer(arity=1) consumes inner
    weight = TorchParameter.from_nary(
        tp.TorchMatMulParameter(inner.weight.shape, outer.weight.shape),
        inner.weight,
        outer.weight,
    )
    return (
        TorchSumLayer(
            inner.num_input_units,
            outer.num_output_units,
            arity=inner.arity,
            weight=weight,
            semiring=compiler.semiring,
        ),
    )


def apply_tucker(compiler: "TorchCompiler", match: LayerOptMatch) -> tuple[TorchLayer, ...]:
    dense, kronecker = match.entries
    return (
        TorchTuckerLayer(
            kronecker.num_input_units,
            dense.num_output_units,
            kronecker.arity,
            weight=dense.weight,
            semiring=compiler.semiring,
        ),
    )


def apply_candecomp(compiler: "TorchCompiler", match: LayerOptMatch) -> tuple[TorchLayer, ...]:
    dense, hadamard = match.entries
    return (
        TorchCPTLayer(
            hadamard.num_input_units,
            dense.num_output_units,
            hadamard.arity,
            weight=dense.weight,
            semiring=compiler.semiring,
        ),
    )


def _apply_tensordot_rule(
    compiler: "TorchCompiler",
    num_input_units: int,
    num_output_units: int,
    weight: TorchParameter,
    kronecker: tp.TorchKroneckerParameter,
) -> tuple[TorchLayer, ...]:
    """Shatter W = A (x) B into two tensor-dot contractions."""
    in1, in2 = weight.node_inputs(kronecker)
    weight1 = _parameter_subgraph(weight, in1)
    weight2 = _parameter_subgraph(weight, in2)
    num_inner = weight1.shape[0] * (num_input_units // weight1.shape[1])
    tdot1 = TorchTensorDotLayer(
        num_input_units, num_inner, weight=weight1, semiring=compiler.semiring
    )
    tdot2 = TorchTensorDotLayer(
        num_inner, num_output_units, weight=weight2, semiring=compiler.semiring
    )
    return tdot1, tdot2


def _parameter_subgraph(graph: TorchParameter, root: TorchParameterNode) -> TorchParameter:
    sub = graph.subgraph(root)
    return TorchParameter(sub.nodes, sub.nodes_inputs, [root])


def apply_dense_tensordot(
    compiler: "TorchCompiler", match: LayerOptMatch
) -> tuple[TorchLayer, ...]:
    dense = match.entries[0]
    kron = match.sub_entries[0]["weight"].entries[0]
    return _apply_tensordot_rule(
        compiler, dense.num_input_units, dense.num_output_units, dense.weight, kron
    )


def apply_tensordot_tensordot(
    compiler: "TorchCompiler", match: LayerOptMatch
) -> tuple[TorchLayer, ...]:
    tdot = match.entries[0]
    kron = match.sub_entries[0]["weight"].entries[0]
    return _apply_tensordot_rule(
        compiler, tdot.num_input_units, tdot.num_output_units, tdot.weight, kron
    )


def apply_log_softmax(
    compiler: "TorchCompiler", match: ParameterOptMatch
) -> tuple[TorchParameterNode, ...]:
    softmax = match.entries[1]
    return (tp.TorchLogSoftmaxParameter(*softmax.in_shapes, axis=softmax.axis),)


def apply_sum_outer_prod_einsum(
    compiler: "TorchCompiler", match: ParameterOptMatch
) -> tuple[TorchParameterNode, ...]:
    """Fuse reduce-sum(outer-product) into one einsum (plus a flatten when the
    reduced axis is not the outer axis), avoiding the outer tensor."""
    reduce_sum, outer = match.entries
    in_shape1, in_shape2 = outer.in_shapes
    if len(in_shape1) > 4:
        raise NotImplementedError("Einsum fusion is implemented up to rank 4")
    outer_axis, reduce_axis = outer.axis, reduce_sum.axis
    rank = len(in_shape1)
    # axes: input1 uses 1..rank (0 = fold); input2 replaces the outer axis
    in_idx1 = tuple(range(1, rank + 1))
    in_idx2 = tuple(
        (rank + 1) if i == outer_axis else i + 1 for i in range(rank)
    )
    out_groups: list[tuple[int, ...]] = [
        (outer_axis + 1, rank + 1) if i == outer_axis else (i + 1,) for i in range(rank)
    ]
    del out_groups[reduce_axis]
    out_idx = tuple(itertools.chain.from_iterable(out_groups))
    letters = "abcdefghij"
    eq = (
        "z" + "".join(letters[i] for i in in_idx1)
        + ",z" + "".join(letters[i] for i in in_idx2)
        + "->z" + "".join(letters[i] for i in out_idx)
    )
    # output shape (unfolded): sizes of the out_idx axes
    sizes = {i + 1: d for i, d in enumerate(in_shape1)}
    sizes[rank + 1] = in_shape2[outer_axis]
    out_shape = tuple(sizes[i] for i in out_idx)
    einsum = tp.TorchEinsumParameter(
        in_shape1, in_shape2, equation=eq, out_shape=out_shape
    )
    if outer_axis == reduce_axis:
        return (einsum,)
    start = outer_axis - 1 if reduce_axis < outer_axis else outer_axis
    flatten = tp.TorchFlattenParameter(
        einsum.shape, start_dim=start, end_dim=start + 1
    )
    return einsum, flatten


DEFAULT_PARAMETER_OPT_RULES: dict[ParameterOptPattern, ParameterOptApplyFunc] = {
    LogSoftmaxPattern: apply_log_softmax,
    ReduceSumOuterProductPattern: apply_sum_outer_prod_einsum,
}
DEFAULT_LAYER_FUSE_OPT_RULES: dict[LayerOptPattern, LayerOptApplyFunc] = {
    SumCollapsePattern: apply_sum_collapse,
    TuckerPattern: apply_tucker,
    CandecompPattern: apply_candecomp,
}
DEFAULT_LAYER_SHATTER_OPT_RULES: dict[LayerOptPattern, LayerOptApplyFunc] = {
    DenseKroneckerPattern: apply_dense_tensordot,
    TensorDotKroneckerPattern: apply_tensordot_tensordot,
}


class OptimizationRuleRegistry:
    """A per-compiler pattern -> apply-function registry, user-extensible like
    the compilation registries (ref: ``backend/torch/optimization/registry.py:
    1-50``). Rules added later take precedence over earlier ones, so a
    user-registered rule for an already-covered pattern overrides the default
    and a rule for a new pattern is tried before the defaults."""

    def __init__(self, defaults: Mapping[Any, Callable] | None = None) -> None:
        self._rules: dict[Any, Callable] = dict(defaults or {})

    def add_rule(self, pattern: Any, func: Callable) -> None:
        rules = {pattern: func}
        for p, f in self._rules.items():
            if p is not pattern:
                rules[p] = f
        self._rules = rules

    def items(self):
        return self._rules.items()

    def __len__(self) -> int:
        return len(self._rules)


# --------------------------------------------------------------------------- #
# Rewrite passes
# --------------------------------------------------------------------------- #


def _rewrite_parameter_graph(
    compiler: "TorchCompiler",
    graph: TorchParameter,
    rules: Mapping[ParameterOptPattern, ParameterOptApplyFunc],
) -> TorchParameter | None:
    """Apply the first matching parameter rule at the graph output; returns
    the rewritten graph or None if nothing matched."""
    for pattern, rule in rules.items():
        match = _match_parameter_pattern(graph, pattern)
        if match is None:
            continue
        replacement = rule(compiler, match)
        root, tail = match.entries[0], match.entries[-1]
        tail_ins = list(graph.node_inputs(tail))
        matched = {id(n) for n in match.entries}
        keep = [n for n in graph.nodes if id(n) not in matched]
        nodes = keep + list(replacement)
        # splice: the chain tail's inputs feed the first replacement node, and
        # consumers of the chain root now read the last replacement node
        in_nodes = {
            n: [replacement[-1] if c is root else c for c in graph.node_inputs(n)]
            for n in keep
        }
        prev = None
        for i, r in enumerate(replacement):
            in_nodes[r] = tail_ins if i == 0 else [prev]
            prev = r
        output = replacement[-1] if graph.output is root else graph.output
        return TorchParameter(nodes, in_nodes, [output])
    return None


def optimize_parameter_graphs(
    compiler: "TorchCompiler",
    layers: Sequence[TorchLayer],
    rules: Mapping[ParameterOptPattern, ParameterOptApplyFunc]
    | OptimizationRuleRegistry
    | None = None,
) -> bool:
    """Rewrite every layer's parameter graphs in place; True if any changed."""
    if rules is None:
        rules = getattr(compiler, "parameter_opt_rules", None) or DEFAULT_PARAMETER_OPT_RULES
    changed = False
    for layer in layers:
        for name in list(layer.params):
            graph = layer.params[name]
            rewritten = False
            while True:
                new_graph = _rewrite_parameter_graph(compiler, graph, rules)
                if new_graph is None:
                    break
                graph = new_graph
                setattr(layer, name, graph)
                rewritten = changed = True
            if rewritten and name == "weight" and hasattr(layer, "_logits_slot"):
                # keep the softmax-fusion dispatch cache consistent with the
                # rewritten weight graph
                from cirkit_tpu_torch.backend.torch.layers import softmax_logits_slot

                layer._logits_slot = softmax_logits_slot(graph)
    return changed


def _rewrite_layer_graph(
    compiler: "TorchCompiler",
    layers: list[TorchLayer],
    in_layers: dict[TorchLayer, list[TorchLayer]],
    outputs: list[TorchLayer],
    rules: Mapping[LayerOptPattern, LayerOptApplyFunc],
) -> tuple[list[TorchLayer], dict[TorchLayer, list[TorchLayer]], list[TorchLayer], bool]:
    """One rewrite pass: match patterns in reverse topological order and
    splice in the replacement chains."""
    consumers: dict[int, list[TorchLayer]] = {}
    for l in layers:
        for c in in_layers.get(l, []):
            consumers.setdefault(id(c), []).append(l)
    output_ids = {id(o) for o in outputs}

    order = list(topological_ordering(layers, lambda l: in_layers.get(l, [])))
    consumed: set[int] = set()
    replacements: dict[int, tuple[LayerOptMatch, tuple[TorchLayer, ...]]] = {}
    for root in reversed(order):
        if id(root) in consumed:
            continue
        for pattern, rule in rules.items():
            match = _match_layer_pattern(root, pattern, in_layers, consumers, output_ids)
            if match is None:
                continue
            if any(id(l) in consumed for l in match.entries):
                continue
            replacements[id(root)] = (match, rule(compiler, match))
            consumed.update(id(l) for l in match.entries)
            break
    if not replacements:
        return layers, in_layers, outputs, False

    new_layers: list[TorchLayer] = []
    new_in: dict[TorchLayer, list[TorchLayer]] = {}
    # map from replaced chain roots/tails to their substitutes
    root_sub: dict[int, TorchLayer] = {}
    for match, chain in replacements.values():
        root_sub[id(match.entries[0])] = chain[-1]

    def resolve(l: TorchLayer) -> TorchLayer:
        return root_sub.get(id(l), l)

    matched_ids = consumed
    for l in layers:
        if id(l) in matched_ids:
            continue
        new_layers.append(l)
        new_in[l] = [resolve(c) for c in in_layers.get(l, [])]
    for match, chain in replacements.values():
        tail_inputs = [resolve(c) for c in in_layers.get(match.entries[-1], [])]
        prev = None
        # replacement chains run input-first: chain[0] consumes the tail inputs
        for i, r in enumerate(chain):
            new_layers.append(r)
            new_in[r] = tail_inputs if i == 0 else [prev]
            prev = r
    new_outputs = [resolve(o) for o in outputs]
    return new_layers, new_in, new_outputs, True


def optimize_layer_graph(
    compiler: "TorchCompiler",
    layers: Sequence[TorchLayer],
    in_layers: Mapping[TorchLayer, Sequence[TorchLayer]],
    outputs: Sequence[TorchLayer],
    *,
    max_passes: int = 5,
):
    """The full optimization pipeline: parameter fusions, then alternating
    shatter/fuse passes until a fixpoint (ref: ``compiler.py:509-555``)."""
    layers = list(layers)
    in_layers = {l: list(ins) for l, ins in in_layers.items()}
    outputs = list(outputs)

    shatter_rules = (
        getattr(compiler, "layer_shatter_opt_rules", None) or DEFAULT_LAYER_SHATTER_OPT_RULES
    )
    fuse_rules = getattr(compiler, "layer_fuse_opt_rules", None) or DEFAULT_LAYER_FUSE_OPT_RULES

    optimize_parameter_graphs(compiler, layers)
    for _ in range(max_passes):
        layers, in_layers, outputs, shattered = _rewrite_layer_graph(
            compiler, layers, in_layers, outputs, shatter_rules
        )
        layers, in_layers, outputs, fused = _rewrite_layer_graph(
            compiler, layers, in_layers, outputs, fuse_rules
        )
        if not (shattered or fused):
            break
    # restore a topological layer ordering (the plan executes in list order)
    layers = list(topological_ordering(layers, lambda l: in_layers.get(l, [])))
    return layers, in_layers, outputs
