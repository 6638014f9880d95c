"""Circuit operators: the tractable-operator suite over symbolic circuits.

Rebuild of ``cirkit/symbolic/functional.py:31-651``. Every operator produces
a *new* symbolic circuit whose parameters are shared with the operands via
ReferenceParameters, and records provenance so that the pipeline can compile
operand circuits first and share parameter-store slots.
"""

from __future__ import annotations

import heapq
import itertools
from collections.abc import Sequence
from numbers import Number

import numpy as np

from cirkit_tpu_torch.symbolic.circuit import (
    Circuit,
    CircuitBlock,
    CircuitOperation,
    CircuitOperator,
    StructuralPropertyError,
    are_compatible,
)
from cirkit_tpu_torch.symbolic.layers import (
    EvidenceLayer,
    HadamardLayer,
    InputLayer,
    KroneckerLayer,
    Layer,
    LayerOperator,
    ProductLayer,
    SumLayer,
)
from cirkit_tpu_torch.symbolic.initializers import DirichletInitializer, NormalInitializer
from cirkit_tpu_torch.symbolic.parameters import (
    ConstantParameter,
    IndexParameter,
    KroneckerParameter,
    MixingWeightParameter,
    Parameter,
    ParameterFactory,
    SoftmaxParameter,
    TensorParameter,
    mixing_weight_factory,
)
from cirkit_tpu_torch.symbolic.registry import OPERATOR_REGISTRY, OperatorRegistry
from cirkit_tpu_torch.utils.scope import Scope


def _ambient_registry(registry: OperatorRegistry | None) -> OperatorRegistry:
    return OPERATOR_REGISTRY.get() if registry is None else registry


def _copy_blocks(
    scs: Sequence[Circuit],
) -> tuple[
    list[CircuitBlock],
    dict[CircuitBlock, list[CircuitBlock]],
    list[list[CircuitBlock]],
]:
    """Copy every operand's layers as parameter-SHARING blocks (copyref —
    the new circuit references the operands' parameters, it does not
    re-allocate them): ``(blocks, in_blocks, per-operand output blocks)``."""
    blocks: list[CircuitBlock] = []
    in_blocks: dict[CircuitBlock, list[CircuitBlock]] = {}
    outputs: list[list[CircuitBlock]] = []
    for sc in scs:
        block_of: dict[Layer, CircuitBlock] = {}
        for sl in sc.topological_ordering():
            b = CircuitBlock.from_layer(sl.copyref())
            blocks.append(b)
            in_blocks[b] = [block_of[sli] for sli in sc.layer_inputs(sl)]
            block_of[sl] = b
        outputs.append([block_of[sl] for sl in sc.outputs])
    return blocks, in_blocks, outputs


def concatenate(
    scs: Sequence[Circuit], *, registry: OperatorRegistry | None = None
) -> Circuit:
    """Concatenate circuits: a circuit whose outputs are all operand outputs.
    No structural property is required."""
    blocks, in_blocks, outputs = _copy_blocks(scs)
    return Circuit.from_operation(
        blocks,
        in_blocks,
        [b for out in outputs for b in out],
        operation=CircuitOperation(CircuitOperator.CONCATENATE, tuple(scs)),
    )


def mixture(
    scs: Sequence[Circuit],
    *,
    weights: Sequence[Number] | np.ndarray | None = None,
    weight_factory: ParameterFactory | None = None,
    em_ready: bool = False,
    registry: OperatorRegistry | None = None,
) -> Circuit:
    """A mixture (weighted model average) of same-scope circuits: copies
    every operand and adds one mixing :class:`SumLayer` over their roots.
    The ensemble combinator — train k circuits independently (different
    templates, seeds, or bagged data), then serve one circuit whose density
    is ``sum_i w_i p_i(x)``; every query (marginals, MAP, sampling,
    expectations) applies to the ensemble directly. An extension: the
    reference has no circuit-combination surface beyond concatenate
    (ref ``symbolic/functional.py:31``, outputs stacked, never mixed).

    Requirements: at least two circuits over identical scopes, each with a
    single output layer, all roots with the same number of output units K
    (K=1 for densities; K>1 mixes unit-wise through a block-diagonal
    Einsum-Networks-style mixing weight).

    ``weights``: fixed nonnegative mixture coefficients (length-n, stored
    as a frozen :class:`ConstantParameter`; the mixture is normalized when
    the operands are normalized and the weights sum to 1). Default:
    learnable softmax coefficients, so :func:`cirkit_tpu.parallel.fit`
    can tune the blend — pass ``fit(..., freeze="shared")`` to train the
    blend ALONE (stacking; components stay as trained), or omit it to
    fine-tune the components jointly through the shared pointer slots. ``weight_factory`` overrides the (K, n)
    coefficient parameterization; ``em_ready=True`` swaps the softmax
    default for plain Dirichlet-initialized coefficients so
    :func:`cirkit_tpu.parallel.fit_em` can train the blend (the classic
    EM-over-mixture-weights setting — components built with
    ``em_ready=True`` templates then train jointly)."""
    scs = list(scs)
    if len(scs) < 2:
        raise ValueError(f"A mixture needs at least two circuits, found {len(scs)}")
    scope = scs[0].scope
    for i, sc in enumerate(scs):
        if sc.scope != scope:
            raise ValueError(
                f"All mixture components must share one scope; circuit {i} "
                f"has {sc.scope} != {scope}"
            )
        if len(sc.outputs) != 1:
            raise ValueError(
                f"Each mixture component must have a single output layer; "
                f"circuit {i} has {len(sc.outputs)}"
            )
    k = scs[0].outputs[0].num_output_units
    for i, sc in enumerate(scs):
        if sc.outputs[0].num_output_units != k:
            raise ValueError(
                "All mixture components must have the same number of root "
                f"units; circuit {i} has {sc.outputs[0].num_output_units} != {k}"
            )
    n = len(scs)

    blocks, in_blocks, outputs = _copy_blocks(scs)
    root_blocks = [out[0] for out in outputs]

    if weights is not None:
        w = np.asarray(weights, dtype=np.float64)
        if w.shape != (n,):
            raise ValueError(f"weights must have shape ({n},), found {w.shape}")
        if np.any(w < 0) or not np.all(np.isfinite(w)):
            raise ValueError("Mixture weights must be finite and nonnegative")
        coeff = Parameter.from_input(
            ConstantParameter(k, n, value=np.broadcast_to(w, (k, n)).copy())
        )
        weight = Parameter.from_unary(MixingWeightParameter((k, n)), coeff)
    else:
        def _softmax_coeffs(cshape):
            return Parameter.from_unary(
                SoftmaxParameter(cshape),
                TensorParameter(*cshape, initializer=NormalInitializer()),
            )

        def _plain_dirichlet_coeffs(cshape):
            return Parameter.from_input(
                TensorParameter(*cshape, initializer=DirichletInitializer())
            )

        if weight_factory is not None:
            pf = weight_factory
        elif em_ready:
            pf = _plain_dirichlet_coeffs
        else:
            pf = _softmax_coeffs
        weight = mixing_weight_factory((k, n * k), param_factory=pf)

    mix = SumLayer(k, k, arity=n, weight=weight)
    mb = CircuitBlock.from_layer(mix)
    blocks.append(mb)
    in_blocks[mb] = root_blocks
    return Circuit.from_operation(
        blocks,
        in_blocks,
        [mb],
        operation=CircuitOperation(CircuitOperator.MIXTURE, tuple(scs)),
    )


def evidence(
    sc: Circuit,
    obs: dict[int, Number | tuple[Number, ...]],
    *,
    registry: OperatorRegistry | None = None,
) -> Circuit:
    """Pin some variables to an observation: affected input layers become
    EvidenceLayers over a constant observation parameter."""
    scope = Scope(obs.keys())
    if not scope:
        raise ValueError("There are no variables to observe")
    if not scope <= sc.scope:
        raise ValueError("The observed variables must be a subset of the circuit scope")

    blocks: list[CircuitBlock] = []
    in_blocks: dict[CircuitBlock, list[CircuitBlock]] = {}
    block_of: dict[Layer, CircuitBlock] = {}

    for sl in sc.topological_ordering():
        if isinstance(sl, InputLayer) and sl.scope & scope:
            if not sl.scope <= scope:
                raise NotImplementedError(
                    "Only complete evidence of multivariate input layers is supported"
                )
            values = np.array([obs[v] for v in sorted(sl.scope)])
            obs_param = Parameter.from_input(
                ConstantParameter(len(sl.scope), value=values)
            )
            b = CircuitBlock.from_layer(EvidenceLayer(sl.copyref(), observation=obs_param))
        else:
            b = CircuitBlock.from_layer(sl.copyref())
            in_blocks[b] = [block_of[sli] for sli in sc.layer_inputs(sl)]
        blocks.append(b)
        block_of[sl] = b

    return Circuit.from_operation(
        blocks,
        in_blocks,
        [block_of[sl] for sl in sc.outputs],
        operation=CircuitOperation(CircuitOperator.EVIDENCE, (sc,), {"scope": scope}),
    )


def integrate(
    sc: Circuit,
    scope: Scope | None = None,
    *,
    registry: OperatorRegistry | None = None,
) -> Circuit:
    """Integrate (marginalize) a smooth decomposable circuit over a scope:
    affected input layers are replaced via per-type INTEGRATION rules."""
    if not sc.is_smooth or not sc.is_decomposable:
        raise StructuralPropertyError(
            "Only smooth and decomposable circuits can be efficiently integrated"
        )
    if scope is None:
        scope = sc.scope
    if not scope:
        raise ValueError("There are no variables to integrate over")
    if not scope <= sc.scope:
        raise ValueError("The integration scope must be a subset of the circuit scope")
    registry = _ambient_registry(registry)

    blocks: list[CircuitBlock] = []
    in_blocks: dict[CircuitBlock, list[CircuitBlock]] = {}
    block_of: dict[Layer, CircuitBlock] = {}

    for sl in sc.topological_ordering():
        if isinstance(sl, InputLayer) and sl.scope & scope:
            rule = registry.retrieve_rule(LayerOperator.INTEGRATION, type(sl))
            b = rule(sl, scope=scope)
        else:
            b = CircuitBlock.from_layer(sl.copyref())
            in_blocks[b] = [block_of[sli] for sli in sc.layer_inputs(sl)]
        blocks.append(b)
        block_of[sl] = b

    return Circuit.from_operation(
        blocks,
        in_blocks,
        [block_of[sl] for sl in sc.outputs],
        operation=CircuitOperation(CircuitOperator.INTEGRATION, (sc,), {"scope": scope}),
    )


def multiply(sc1: Circuit, sc2: Circuit, *, registry: OperatorRegistry | None = None) -> Circuit:
    """Multiply two compatible circuits: pairwise layer products driven by the
    MULTIPLICATION rule registry; disjoint-scope pairs get a fresh Kronecker
    layer (ref: ``symbolic/functional.py:259-415``).

    Scope handling goes beyond the reference (which supports same-scope
    only, ref functional.py:295-296): fully DISJOINT scopes combine
    independent models into p(x) q(y) over the union, and PARTIAL overlap
    is supported whenever the operands are compatible over the shared
    scope — sums distribute one-sidedly (``(W x)(y) = W (x y)`` with a
    Kronecker-identity weight), product layers pair children by the
    equality of their shared-scope restrictions (private children splice
    through untouched), and mixed-width composites assemble via constant
    one-hot broadcast sums under a Hadamard. Every product block keeps the
    (i1, i2) row-major unit layout, so the standard sum/input rules apply
    unchanged. Operands whose shared-scope factorizations differ raise
    :class:`StructuralPropertyError` (the product is not tractable then)."""
    if sc1.scope != sc2.scope:
        for sc in (sc1, sc2):
            if not (sc.is_smooth and sc.is_decomposable):
                raise StructuralPropertyError(
                    "Only smooth and decomposable circuits can be multiplied"
                )
    elif not are_compatible(sc1, sc2):
        raise StructuralPropertyError("Only compatible circuits can be multiplied")
    registry = _ambient_registry(registry)

    prod_block: dict[tuple[Layer, Layer], CircuitBlock] = {}
    blocks: list[CircuitBlock] = []
    in_blocks: dict[CircuitBlock, list[CircuitBlock]] = {}
    splice_block: dict[tuple[int, Layer], CircuitBlock] = {}

    def _splice(sc: Circuit, root: Layer) -> CircuitBlock:
        """Copy a sub-circuit once per (operand, layer): repeated disjoint
        pairs (multi-output operands, DAG-shared sub-circuits) reuse the
        copies instead of duplicating the layer DAG per pair."""
        key = (id(sc), root)
        cached = splice_block.get(key)
        if cached is not None:
            return cached
        for l in sc.subgraph(root).topological_ordering():
            lk = (id(sc), l)
            if lk in splice_block:
                continue
            b = CircuitBlock.from_layer(l.copyref())
            blocks.append(b)
            in_blocks[b] = [
                splice_block[(id(sc), li)] for li in sc.layer_inputs(l)
            ]
            splice_block[lk] = b
        return splice_block[key]

    def _side_dims(layer: Layer) -> tuple[tuple[int, ...], str]:
        """A product operand's composite digit structure: Kronecker units
        concatenate one digit per child (row-major, first child major);
        Hadamard units are ONE digit shared by every child; anything else
        (input layers, disjoint splices) is a single digit of its width."""
        if isinstance(layer, KroneckerLayer):
            return (layer.num_input_units,) * layer.arity, "kron"
        if isinstance(layer, HadamardLayer):
            return (layer.num_input_units,), "had"
        return (layer.num_output_units,), "single"

    def _combine(
        dims1: tuple[int, ...],
        dims2: tuple[int, ...],
        children: list[tuple[CircuitBlock, tuple[int, ...], tuple[int, ...]]],
    ) -> CircuitBlock:
        """Assemble a product block in the (i1, i2) row-major layout from
        per-child blocks of MIXED widths: each child is broadcast into the
        composite index space by a constant one-hot selection sum (rows pick
        the child's digits out of (i1, i2)), and a Hadamard multiplies the
        broadcasts. ``children`` entries are (block, digit positions on
        side 1, digit positions on side 2) — pair blocks carry positions on
        both sides (their own (j1, j2) row-major index; a grouped virtual
        product owns several positions in ascending order), pass-through
        singles one side only. This is what makes partial-overlap products
        expressible without a mixed-width Kronecker layer type."""
        w1 = int(np.prod(dims1))
        w2 = int(np.prod(dims2))
        wout = w1 * w2
        idx = np.arange(wout)
        digs1 = np.stack(np.unravel_index(idx // w2, dims1))
        digs2 = np.stack(np.unravel_index(idx % w2, dims2))
        sel_blocks = []
        for cb, p1s, p2s in children:
            dims = [dims1[p] for p in p1s] + [dims2[p] for p in p2s]
            digs = [digs1[p] for p in p1s] + [digs2[p] for p in p2s]
            wc = int(np.prod(dims)) if dims else 1
            j = np.zeros(wout, dtype=np.int64)
            for d, dg in zip(dims, digs):
                j = j * d + dg
            sel = np.zeros((wout, wc))
            sel[idx, j] = 1.0
            sb = CircuitBlock.from_layer(
                SumLayer(
                    wc,
                    wout,
                    weight=Parameter.from_input(
                        ConstantParameter(wout, wc, value=sel)
                    ),
                )
            )
            blocks.append(sb)
            in_blocks[sb] = [cb]
            sel_blocks.append(sb)
        hb = CircuitBlock.from_layer(HadamardLayer(wout, arity=len(sel_blocks)))
        blocks.append(hb)
        in_blocks[hb] = sel_blocks
        return hb

    # Virtual product layers: when the two operands factor the shared scope
    # at DIFFERENT granularities (a restriction of a common vtree contracts
    # levels), the finer side's children group under a fresh product layer
    # of the same kind, and the recursion descends against it. These layers
    # exist only inside this multiply call.
    virt_in: dict[Layer, list[Layer]] = {}
    virt_scope: dict[Layer, Scope] = {}
    virt_memo: dict[tuple, Layer] = {}

    def _inputs(sc: Circuit, l: Layer) -> list[Layer]:
        got = virt_in.get(l)
        return got if got is not None else list(sc.layer_inputs(l))

    def _lscope(sc: Circuit, l: Layer) -> Scope:
        got = virt_scope.get(l)
        return got if got is not None else sc.layer_scope(l)

    def _virtual_group(sc: Circuit, template: ProductLayer, members: list[Layer]) -> Layer:
        # memoized on member identity: the stack revisits a pair after its
        # children resolve, and the recreated group must BE the same key
        key = (id(sc), id(template), tuple(id(m) for m in members))
        got = virt_memo.get(key)
        if got is not None:
            return got
        cls = type(template)
        v = cls(template.num_input_units, arity=len(members))
        virt_in[v] = list(members)
        virt_scope[v] = Scope.union(*[_lscope(sc, m) for m in members])
        virt_memo[key] = v
        return v

    stack: list[tuple[Layer, Layer]] = list(itertools.product(sc1.outputs, sc2.outputs))
    while stack:
        pair = stack[-1]
        if pair in prod_block:
            stack.pop()
            continue
        l1, l2 = pair

        s1, s2 = _lscope(sc1, l1), _lscope(sc2, l2)

        # Disjoint scopes: splice in copies of both sub-circuits and combine
        # their roots — a fresh Kronecker layer when widths match, the
        # generic mixed-width broadcast combine otherwise.
        if not s1 & s2:
            root_blocks = [_splice(sc1, l1), _splice(sc2, l2)]
            if l1.num_output_units == l2.num_output_units:
                kb = CircuitBlock.from_layer(
                    KroneckerLayer(l1.num_output_units, arity=2)
                )
                blocks.append(kb)
                in_blocks[kb] = root_blocks
            else:
                kb = _combine(
                    (l1.num_output_units,),
                    (l2.num_output_units,),
                    [(root_blocks[0], (0,), ()), (root_blocks[1], (), (0,))],
                )
            prod_block[pair] = kb
            stack.pop()
            continue

        # Overlapping scopes: recurse into matched input pairs first.
        # ``builder`` is set for the partial-overlap combinations the rule
        # registry cannot express; None means the registry rule applies.
        sigma: list[int] | None = None
        builder = None
        if isinstance(l1, InputLayer) and isinstance(l2, InputLayer):
            if s1 != s2:
                raise NotImplementedError(
                    "Products of partially-overlapping multivariate input "
                    "layers are not supported"
                )
            children: list[tuple[Layer, Layer]] = []
        elif isinstance(l1, SumLayer) and isinstance(l2, SumLayer):
            # all pairs + kron'd weights (the registry rule) — valid for
            # ANY scopes: pair blocks keep the (i1, i2) row-major layout
            # the rule's weight assumes
            children = list(itertools.product(_inputs(sc1, l1), _inputs(sc2, l2)))
        elif isinstance(l1, SumLayer):
            # distribute the left sum over l2: (W1 x) * y = (W1 (x) I) (x * y);
            # kron(W1, I) columns already run (a, i1, i2), the child layout
            children = [(c1, l2) for c1 in _inputs(sc1, l1)]

            def builder(child_blocks, l1=l1, l2=l2):
                w2 = l2.num_output_units
                weight = Parameter.from_binary(
                    KroneckerParameter(l1.weight.shape, (w2, w2)),
                    l1.weight.ref(),
                    Parameter.from_input(ConstantParameter(w2, w2, value=np.eye(w2))),
                )
                b = CircuitBlock.from_layer(
                    SumLayer(
                        l1.num_input_units * w2,
                        l1.num_output_units * w2,
                        arity=l1.arity,
                        weight=weight,
                    )
                )
                blocks.append(b)
                in_blocks[b] = child_blocks
                return b

        elif isinstance(l2, SumLayer):
            # distribute the right sum; kron(I, W2) columns run (i1, a, i2)
            # while the children concatenate (a, i1, i2) — permute when
            # both indices are nontrivial
            children = [(l1, c2) for c2 in _inputs(sc2, l2)]

            def builder(child_blocks, l1=l1, l2=l2):
                w1 = l1.num_output_units
                a2, k2i = l2.arity, l2.num_input_units
                weight = Parameter.from_binary(
                    KroneckerParameter((w1, w1), l2.weight.shape),
                    Parameter.from_input(ConstantParameter(w1, w1, value=np.eye(w1))),
                    l2.weight.ref(),
                )
                if w1 > 1 and a2 > 1:
                    perm = (
                        np.arange(w1 * a2 * k2i)
                        .reshape(w1, a2, k2i)
                        .transpose(1, 0, 2)
                        .ravel()
                    )
                    weight = Parameter.from_unary(
                        IndexParameter(weight.shape, indices=perm.tolist(), axis=1),
                        weight,
                    )
                b = CircuitBlock.from_layer(
                    SumLayer(
                        w1 * k2i,
                        w1 * l2.num_output_units,
                        arity=a2,
                        weight=weight,
                    )
                )
                blocks.append(b)
                in_blocks[b] = child_blocks
                return b

        elif isinstance(l1, ProductLayer) and not isinstance(l2, ProductLayer):
            # l2 is an input layer inside l1's scope: pair the one child
            # whose scope covers it; the other children pass through
            ins1 = _inputs(sc1, l1)
            host = [i for i, c1 in enumerate(ins1) if _lscope(sc1, c1) & s2]
            if len(host) != 1 or not s2 <= _lscope(sc1, ins1[host[0]]):
                raise NotImplementedError(
                    "An input layer straddling a product partition cannot "
                    "be multiplied in"
                )
            dims1, kind1 = _side_dims(l1)
            p1of = (lambda i: i) if kind1 == "kron" else (lambda i: 0)
            hi = host[0]
            children = [(ins1[hi], l2)]

            def builder(child_blocks, ins1=ins1, hi=hi, dims1=dims1, p1of=p1of, l2=l2):
                cc = [(child_blocks[0], (p1of(hi),), (0,))]
                cc += [
                    (_splice(sc1, ins1[i]), (p1of(i),), ())
                    for i in range(len(ins1))
                    if i != hi
                ]
                return _combine(dims1, (l2.num_output_units,), cc)

        elif isinstance(l2, ProductLayer) and not isinstance(l1, ProductLayer):
            # symmetric: l1 is an input layer inside l2's scope
            ins2 = _inputs(sc2, l2)
            host = [j for j, c2 in enumerate(ins2) if _lscope(sc2, c2) & s1]
            if len(host) != 1 or not s1 <= _lscope(sc2, ins2[host[0]]):
                raise NotImplementedError(
                    "An input layer straddling a product partition cannot "
                    "be multiplied in"
                )
            dims2, kind2 = _side_dims(l2)
            p2of = (lambda j: j) if kind2 == "kron" else (lambda j: 0)
            hj = host[0]
            children = [(l1, ins2[hj])]

            def builder(child_blocks, ins2=ins2, hj=hj, dims2=dims2, p2of=p2of, l1=l1):
                cc = [(child_blocks[0], (0,), (p2of(hj),))]
                cc += [
                    (_splice(sc2, ins2[j]), (), (p2of(j),))
                    for j in range(len(ins2))
                    if j != hj
                ]
                return _combine((l1.num_output_units,), dims2, cc)

        elif s1 != s2 or type(l1) is not type(l2):
            # both products, over partially-overlapping scopes OR of mixed
            # kinds (Hadamard x Kronecker has no registry rule). Children
            # match through the connected components of the shared-scope
            # restriction-intersection graph: 1-1 components pair directly;
            # a component where ONE side is finer (a common-vtree
            # restriction that contracted levels) groups the finer side
            # under a virtual product and recurses against it; interleaved
            # components (both sides > 1) are intractable; private children
            # (empty restriction) pass through as splices.
            ins1 = _inputs(sc1, l1)
            ins2 = _inputs(sc2, l2)
            shared = s1 & s2
            r1 = [_lscope(sc1, c) & shared for c in ins1]
            r2 = [_lscope(sc2, c) & shared for c in ins2]
            singles1 = [i for i, t in enumerate(r1) if not t]
            singles2 = [j for j, t in enumerate(r2) if not t]
            # connected components over the bipartite intersection graph
            seen1: set[int] = set(singles1)
            seen2: set[int] = set(singles2)
            components: list[tuple[list[int], list[int]]] = []
            for i0 in range(len(ins1)):
                if i0 in seen1:
                    continue
                ci, cj, front1 = [], [], [i0]
                seen1.add(i0)
                while front1:
                    front2 = []
                    for i in front1:
                        ci.append(i)
                        for j in range(len(ins2)):
                            if j not in seen2 and r1[i] & r2[j]:
                                seen2.add(j)
                                front2.append(j)
                    front1 = []
                    for j in front2:
                        cj.append(j)
                        for i in range(len(ins1)):
                            if i not in seen1 and r1[i] & r2[j]:
                                seen1.add(i)
                                front1.append(i)
                components.append((sorted(ci), sorted(cj)))
            dims1, kind1 = _side_dims(l1)
            dims2, kind2 = _side_dims(l2)
            p1of = (lambda i: i) if kind1 == "kron" else (lambda i: 0)
            p2of = (lambda j: j) if kind2 == "kron" else (lambda j: 0)
            pair_specs: list[tuple[Layer, Layer, tuple, tuple]] = []
            for ci, cj in components:
                if not cj:
                    raise StructuralPropertyError(
                        "Product layers whose shared-scope restrictions do "
                        f"not match cannot be multiplied: {tuple(r1[ci[0]])} "
                        "has no partner partition"
                    )
                if len(ci) > 1 and len(cj) > 1:
                    raise StructuralPropertyError(
                        "Product layers with interleaved shared-scope "
                        "partitions cannot be multiplied: "
                        f"{[tuple(r1[i]) for i in ci]} vs "
                        f"{[tuple(r2[j]) for j in cj]}"
                    )
                la = (
                    ins1[ci[0]]
                    if len(ci) == 1
                    else _virtual_group(sc1, l1, [ins1[i] for i in ci])
                )
                lb = (
                    ins2[cj[0]]
                    if len(cj) == 1
                    else _virtual_group(sc2, l2, [ins2[j] for j in cj])
                )
                p1s = tuple(dict.fromkeys(p1of(i) for i in ci))
                p2s = tuple(dict.fromkeys(p2of(j) for j in cj))
                pair_specs.append((la, lb, p1s, p2s))
            children = [(la, lb) for la, lb, _, _ in pair_specs]

            def builder(
                child_blocks,
                ins1=ins1, ins2=ins2, pair_specs=pair_specs,
                singles1=singles1, singles2=singles2,
                dims1=dims1, dims2=dims2, p1of=p1of, p2of=p2of,
            ):
                cc = [
                    (cb, p1s, p2s)
                    for (_, _, p1s, p2s), cb in zip(pair_specs, child_blocks)
                ]
                cc += [(_splice(sc1, ins1[i]), (p1of(i),), ()) for i in singles1]
                cc += [(_splice(sc2, ins2[j]), (), (p2of(j),)) for j in singles2]
                return _combine(dims1, dims2, cc)

        elif isinstance(l1, ProductLayer):
            ins1 = _inputs(sc1, l1)
            ins2 = _inputs(sc2, l2)
            if len(ins1) != len(ins2):
                raise NotImplementedError(
                    "Only products of equal-arity product layers are supported"
                )
            # Pair children by SCOPE in l1's own child order (decomposability
            # makes child scopes disjoint, so the match is a bijection). The
            # wiring must not be re-sorted by a TOTAL scope order: a
            # Kronecker layer's unit digits follow its own child order, and
            # the parent sum weights above were laid out against it. (The
            # reference "sorts" with Scope's subset PARTIAL order, ref
            # functional.py:380-382 — a stable no-op for disjoint sibling
            # scopes, i.e. positional own-order pairing — and its
            # order-sensitive compatibility check rejects operands whose
            # product layers enumerate the same partition in different
            # orders. We match by scope and fix the Kronecker digit order
            # below, so mixed-order operands multiply correctly — pinned in
            # tests/symbolic/test_operators.py::
            # test_multiply_kronecker_child_order.)
            scope_to_j = {sc2.layer_scope(c): j for j, c in enumerate(ins2)}
            sigma = [scope_to_j.get(sc1.layer_scope(c)) for c in ins1]
            if any(j is None for j in sigma):
                raise StructuralPropertyError(
                    "Product layers with mismatched child scope partitions "
                    f"cannot be multiplied: {[tuple(sc1.layer_scope(c)) for c in ins1]} "
                    f"vs {[tuple(sc2.layer_scope(c)) for c in ins2]}"
                )
            children = [(c1, ins2[j]) for c1, j in zip(ins1, sigma)]
        else:
            raise TypeError(f"Unexpected layer type {type(l1).__name__}")

        missing = [p for p in children if p not in prod_block]
        if missing:
            stack.extend(missing)
            continue

        child_blocks = [prod_block[p] for p in children]
        if builder is not None:
            prod_block[pair] = builder(child_blocks)
            stack.pop()
            continue
        rule = registry.retrieve_rule(LayerOperator.MULTIPLICATION, type(l1), type(l2))
        b = rule(l1, l2)
        blocks.append(b)
        in_blocks[b] = child_blocks
        if sigma is not None and isinstance(l1, KroneckerLayer) and sigma != list(range(len(sigma))):
            # Pair blocks are wired in l1's own child order, so the rule's
            # interleave permutation leaves the l2-side digits in l1-aligned
            # order (digit j carries l2 child sigma[j]); post-compose a
            # constant permutation restoring l2's own digit order so the
            # composite unit index is (i1 own, i2 own) — the layout the
            # kron'd parent sum weights assume.
            h = l1.arity
            k1, k2 = l1.num_input_units, l2.num_input_units
            k1h, k2h = k1**h, k2**h
            d = np.stack(np.unravel_index(np.arange(k2h), (k2,) * h))
            i2_al = np.ravel_multi_index(tuple(d[sigma, :]), (k2,) * h)
            mp = (np.arange(k1h)[:, None] * k2h + i2_al[None, :]).ravel()
            ko = k1h * k2h
            fix_sl = SumLayer(
                ko,
                ko,
                weight=Parameter.from_input(
                    ConstantParameter(ko, ko, value=np.eye(ko)[mp])
                ),
            )
            fb = CircuitBlock.from_layer(fix_sl)
            blocks.append(fb)
            in_blocks[fb] = [b]
            b = fb
        prod_block[pair] = b
        stack.pop()

    output_blocks = [
        prod_block[(l1, l2)] for l1, l2 in itertools.product(sc1.outputs, sc2.outputs)
    ]
    return Circuit.from_operation(
        blocks,
        in_blocks,
        output_blocks,
        operation=CircuitOperation(CircuitOperator.MULTIPLICATION, (sc1, sc2)),
    )


def differentiate(
    sc: Circuit, order: int = 1, *, registry: OperatorRegistry | None = None
) -> Circuit:
    """Differentiate a smooth decomposable circuit wrt each variable in its
    scope: sum rule through sum layers, product rule through product layers
    (ref: ``symbolic/functional.py:429-591``). The resulting circuit has, per
    original output, one output per scope variable plus a copy of the output."""
    if not sc.is_smooth or not sc.is_decomposable:
        raise StructuralPropertyError(
            "Only smooth and decomposable circuits can be efficiently differentiated"
        )
    if order <= 0:
        raise ValueError("The order of differentiation must be positive")
    registry = _ambient_registry(registry)

    # For each layer, a list of blocks: the diff wrt each scope variable in
    # ascending id order, followed by a plain copy of the layer at [-1].
    diffs: dict[Layer, list[CircuitBlock]] = {}
    in_blocks: dict[CircuitBlock, Sequence[CircuitBlock]] = {}

    for sl in sc.topological_ordering():
        sl_ins = sc.layer_inputs(sl)
        if isinstance(sl, InputLayer):
            rule = registry.retrieve_rule(LayerOperator.DIFFERENTIATION, type(sl))
            blocks = [rule(sl, var_idx=i, order=order) for i in range(len(sl.scope))]
        elif isinstance(sl, SumLayer):
            # d/dv (W @ x) = W @ dx/dv: one copy of the sum per variable,
            # wired to the matching diffs of every input.
            per_var_inputs = zip(*(diffs[sli][:-1] for sli in sl_ins))
            blocks = []
            for var_inputs in per_var_inputs:
                b = CircuitBlock.from_layer(sl.copyref())
                in_blocks[b] = list(var_inputs)
                blocks.append(b)
        elif isinstance(sl, ProductLayer):
            # Product rule under decomposability: the diff wrt v (in input
            # j's scope) replaces input j with its diff and keeps the rest.
            per_input: list[list[tuple[int, CircuitBlock, list[CircuitBlock]]]] = []
            for j, cur in enumerate(sl_ins):
                entries = []
                for var, dcur in zip(sorted(sc.layer_scope(cur)), diffs[cur][:-1]):
                    b = CircuitBlock.from_layer(sl.copyref())
                    wired = [
                        dcur if i == j else diffs[other][-1]
                        for i, other in enumerate(sl_ins)
                    ]
                    entries.append((var, b, wired))
                per_input.append(entries)
            merged = list(heapq.merge(*per_input, key=lambda e: e[0]))
            blocks = []
            for _, b, wired in merged:
                in_blocks[b] = wired
                blocks.append(b)
        else:
            raise TypeError(f"Unexpected layer type {type(sl).__name__}")

        copy_b = CircuitBlock.from_layer(sl.copyref())
        in_blocks[copy_b] = [diffs[sli][-1] for sli in sl_ins]
        blocks.append(copy_b)
        diffs[sl] = blocks

    all_blocks = [b for bs in diffs.values() for b in bs]
    output_blocks = [b for sl in sc.outputs for b in diffs[sl]]
    return Circuit.from_operation(
        all_blocks,
        in_blocks,
        output_blocks,
        operation=CircuitOperation(
            CircuitOperator.DIFFERENTIATION, (sc,), {"order": order}
        ),
    )


def conjugate(sc: Circuit, *, registry: OperatorRegistry | None = None) -> Circuit:
    """Complex-conjugate a circuit: product layers pass through, sum/input
    layers are conjugated via CONJUGATION rules."""
    registry = _ambient_registry(registry)

    blocks: list[CircuitBlock] = []
    in_blocks: dict[CircuitBlock, list[CircuitBlock]] = {}
    block_of: dict[Layer, CircuitBlock] = {}

    for sl in sc.topological_ordering():
        if isinstance(sl, ProductLayer):
            b = CircuitBlock.from_layer(sl)
        else:
            if not isinstance(sl, (InputLayer, SumLayer)):
                raise TypeError(f"Unexpected layer type {type(sl).__name__}")
            rule = registry.retrieve_rule(LayerOperator.CONJUGATION, type(sl))
            b = rule(sl)
        blocks.append(b)
        block_of[sl] = b
        in_blocks[b] = [block_of[sli] for sli in sc.layer_inputs(sl)]

    return Circuit.from_operation(
        blocks,
        in_blocks,
        [block_of[sl] for sl in sc.outputs],
        operation=CircuitOperation(CircuitOperator.CONJUGATION, (sc,)),
    )
