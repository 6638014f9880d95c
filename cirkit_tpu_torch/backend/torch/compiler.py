"""The PyTorch compiler: symbolic circuits -> ``TorchCircuit`` evaluation plans.

The counterpart of ``cirkit_tpu/backend/jax/compiler.py``. Operand circuits
compile first (pipeline topological ordering over operator provenance);
each circuit lowers layer by layer through the rule registries, then the
layer graph is optimized (fusion rewrites) and folded. Slot names come from
a per-compiler counter, allocated in the same order as the JAX compiler, so
both packages name the slots of one symbolic circuit alike.

Flags: ``semiring`` (default "sum-product"), ``fold`` (default False),
``optimize`` (default False), and ``device``, where the compiled plan's
gather indices live.
"""

from __future__ import annotations

from typing import Any

import torch

from cirkit_tpu_torch.backend.base import (
    AbstractCompiler,
    CompilerInitializerRegistry,
    CompilerLayerRegistry,
    CompilerParameterRegistry,
)
from cirkit_tpu_torch.backend.torch.circuit import TorchCircuit
from cirkit_tpu_torch.backend.torch.folding import fold_graph, simplify_pointers
from cirkit_tpu_torch.backend.torch.layers import TorchInputLayer, TorchLayer
from cirkit_tpu_torch.backend.torch.optimization import (
    DEFAULT_LAYER_FUSE_OPT_RULES,
    DEFAULT_LAYER_SHATTER_OPT_RULES,
    DEFAULT_PARAMETER_OPT_RULES,
    OptimizationRuleRegistry,
    optimize_layer_graph,
)
from cirkit_tpu_torch.backend.torch.parameters import (
    InitFn,
    TorchParameter,
    TorchParameterNode,
)
from cirkit_tpu_torch.backend.torch.rules import (
    DEFAULT_INITIALIZER_COMPILATION_RULES,
    DEFAULT_LAYER_COMPILATION_RULES,
    default_parameter_rules,
)
from cirkit_tpu_torch.backend.torch.semiring import SemiringImpl
from cirkit_tpu_torch.symbolic.circuit import Circuit, pipeline_topological_ordering
from cirkit_tpu_torch.symbolic.layers import Layer
from cirkit_tpu_torch.symbolic.parameters import Parameter, TensorParameter


class TorchCompilerState:
    """Cross-circuit compiler state: the symbolic-tensor -> slot mapping and
    per-slot fold counts."""

    def __init__(self) -> None:
        self._counter = 0
        self._params: dict[TensorParameter, tuple[str, list[int]]] = {}
        self._slot_folds: dict[str, int] = {}

    def alloc_slot(self) -> str:
        slot = f"p{self._counter}"
        self._counter += 1
        self._slot_folds[slot] = 0
        return slot

    def has_parameter(self, p: TensorParameter) -> bool:
        return p in self._params

    def lookup(self, p: TensorParameter) -> tuple[str, list[int]]:
        if p not in self._params:
            raise KeyError(
                "The referenced tensor parameter has not been compiled: compile "
                "the operand circuit first (e.g. through the same PipelineContext)"
            )
        return self._params[p]

    def register(self, p: TensorParameter, slot: str) -> None:
        self._params[p] = (slot, [0])
        self._slot_folds[slot] = 1

    def apply_remap(self, slot_remap: dict[str, tuple[str, list[int]]]) -> None:
        """Retarget the state after folding merged slots."""
        for p, (slot, positions) in list(self._params.items()):
            if slot in slot_remap:
                new_slot, new_positions = slot_remap[slot]
                self._params[p] = (new_slot, [new_positions[i] for i in positions])
        for new_slot, new_positions in slot_remap.values():
            self._slot_folds[new_slot] = max(
                self._slot_folds.get(new_slot, 0), max(new_positions) + 1
            )

    @property
    def slot_folds(self) -> dict[str, int]:
        return self._slot_folds


class TorchCompiler(AbstractCompiler):
    """Compiles symbolic circuits into :class:`TorchCircuit` evaluation plans."""

    def __init__(
        self,
        semiring: str = "sum-product",
        fold: bool = False,
        optimize: bool = False,
        *,
        device: torch.device | str,
    ):
        layer_registry = CompilerLayerRegistry()
        for f in DEFAULT_LAYER_COMPILATION_RULES:
            layer_registry.add_rule(f)
        init_registry = CompilerInitializerRegistry()
        for f in DEFAULT_INITIALIZER_COMPILATION_RULES:
            init_registry.add_rule(f)
        super().__init__(
            layer_registry,
            CompilerParameterRegistry(default_parameter_rules()),
            init_registry,
            semiring=semiring,
            fold=fold,
            optimize=optimize,
        )
        self.semiring = SemiringImpl.from_name(semiring)
        self.device = torch.device(device)
        self.state = TorchCompilerState()
        self.layer_fuse_opt_rules = OptimizationRuleRegistry(DEFAULT_LAYER_FUSE_OPT_RULES)
        self.layer_shatter_opt_rules = OptimizationRuleRegistry(DEFAULT_LAYER_SHATTER_OPT_RULES)
        self.parameter_opt_rules = OptimizationRuleRegistry(DEFAULT_PARAMETER_OPT_RULES)

    @property
    def is_fold_enabled(self) -> bool:
        return bool(self._flags["fold"])

    @property
    def is_optimize_enabled(self) -> bool:
        return bool(self._flags["optimize"])

    # -- optimization-rule registration -------------------------------------------
    def add_layer_optimization_rule(self, pattern, func, *, shatter: bool = False) -> None:
        """Register a layer-graph rewrite; ``shatter=True`` runs it in the
        shatter half of each optimization pass (before fusions)."""
        registry = self.layer_shatter_opt_rules if shatter else self.layer_fuse_opt_rules
        registry.add_rule(pattern, func)

    def add_parameter_optimization_rule(self, pattern, func) -> None:
        """Register a parameter-graph rewrite applied before layer rewrites."""
        self.parameter_opt_rules.add_rule(pattern, func)

    # -- per-node compilation ----------------------------------------------------
    def compile_layer_node(self, sl: Layer) -> TorchLayer:
        rule = self.retrieve_layer_rule(type(sl))
        return rule(self, sl)

    def compile_parameter(self, p: Parameter) -> TorchParameter:
        nodes: dict[Any, TorchParameterNode] = {}
        in_nodes: dict[TorchParameterNode, list[TorchParameterNode]] = {}
        for node in p.topological_ordering():
            rule = self.retrieve_parameter_rule(type(node))
            tnode = rule(self, node)
            nodes[node] = tnode
            in_nodes[tnode] = [nodes[c] for c in p.node_inputs(node)]
        ordered = [nodes[n] for n in p.nodes if n in nodes]
        return TorchParameter(ordered, in_nodes, [nodes[p.output]])

    def compile_initializer(self, p: TensorParameter) -> InitFn:
        rule = self.retrieve_initializer_rule(type(p.initializer))
        return rule(self, p.initializer)

    # -- circuit compilation -------------------------------------------------------
    def compile_pipeline(self, sc: Circuit) -> TorchCircuit:
        for operand in pipeline_topological_ordering([sc]):
            if not self.is_compiled(operand):
                self._compile_circuit(operand)
        return self.get_compiled_circuit(sc)

    def _compile_circuit(self, sc: Circuit) -> TorchCircuit:
        # 1. Lower every layer in topological order.
        compiled: dict[Layer, TorchLayer] = {}
        layers: list[TorchLayer] = []
        in_layers: dict[TorchLayer, list[TorchLayer]] = {}
        for sl in sc.topological_ordering():
            tl_node = self.compile_layer_node(sl)
            compiled[sl] = tl_node
            layers.append(tl_node)
            in_layers[tl_node] = [compiled[c] for c in sc.layer_inputs(sl)]
        outputs = [compiled[sl] for sl in sc.outputs]

        # 2. Optimize: pattern-based fusion rewrites over the layer graph.
        if self.is_optimize_enabled:
            layers, in_layers, outputs = optimize_layer_graph(self, layers, in_layers, outputs)

        # 3. Fold (or build the trivial F=1 plan).
        if self.is_fold_enabled:
            folded, fold_inputs, fold_outputs, slot_remap, fold_of = fold_graph(
                layers, in_layers, outputs, self.state.alloc_slot
            )
            self.state.apply_remap(slot_remap)
            simplify_pointers(folded, self.state.slot_folds)
            plan_layers = folded
        else:
            index = {id(l): i for i, l in enumerate(layers)}
            fold_inputs = {
                index[id(l)]: [[(index[id(c)], 0) for c in in_layers[l]]]
                for l in layers
                if not isinstance(l, TorchInputLayer)
            }
            fold_outputs = [(index[id(o)], 0) for o in outputs]
            fold_of = {id(l): (index[id(l)], 0) for l in layers}
            plan_layers = layers

        cc = TorchCircuit(
            sc.scope,
            sc.num_variables,
            plan_layers,
            fold_inputs,
            fold_outputs,
            properties=sc.properties,
            semiring=self.semiring,
            device=self.device,
        )
        # symbolic layer -> (plan entry, fold), for parameter readback; None
        # when the optimizer rewrote the layer graph (fusions drop the 1:1
        # correspondence)
        cc._symbolic_fold = (
            None
            if self.is_optimize_enabled
            else {sl: fold_of[id(tl)] for sl, tl in compiled.items()}
        )
        self.register_compiled_circuit(sc, cc)
        return cc
