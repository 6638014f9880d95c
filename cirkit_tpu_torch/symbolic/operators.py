"""Default layer-operator rules.

Rebuild of ``cirkit/symbolic/operators.py:39-364``: how integration,
multiplication, differentiation and conjugation act on each layer type,
producing circuit blocks with parameters shared by reference.
"""

from __future__ import annotations

from collections.abc import Callable, Mapping, Sequence
from typing import Any, Protocol

import numpy as np

from cirkit_tpu_torch.symbolic.circuit import CircuitBlock
from cirkit_tpu_torch.symbolic.layers import (
    BinomialLayer,
    CategoricalLayer,
    ConstantValueLayer,
    EmbeddingLayer,
    GaussianLayer,
    HadamardLayer,
    KroneckerLayer,
    Layer,
    LayerOperator,
    PolynomialLayer,
    SumLayer,
)
from cirkit_tpu_torch.symbolic.parameters import (
    ConjugateParameter,
    ConstantParameter,
    GaussianProductLogPartition,
    GaussianProductMean,
    GaussianProductStddev,
    IndexParameter,
    KroneckerParameter,
    LogParameter,
    OuterProductParameter,
    OuterSumParameter,
    Parameter,
    PolynomialDifferential,
    PolynomialProduct,
    ReduceLSEParameter,
    ReduceSumParameter,
    SumParameter,
)
from cirkit_tpu_torch.utils.scope import Scope


def _check_same_scope(kind: str, sl1: Layer, sl2: Layer) -> None:
    if sl1.scope != sl2.scope:  # type: ignore[attr-defined]
        raise ValueError(f"Expected {kind} layers over the same scope")


def _check_integration_scope(kind: str, sl: Layer, scope: Scope) -> None:
    if not sl.scope & scope:  # type: ignore[attr-defined]
        raise ValueError(
            f"The scope of the {kind} layer must intersect the integration scope"
        )


# -- integration -------------------------------------------------------------


def integrate_embedding_layer(sl: EmbeddingLayer, *, scope: Scope) -> CircuitBlock:
    _check_integration_scope("Embedding", sl, scope)
    value = Parameter.from_unary(ReduceSumParameter(sl.weight.shape, axis=1), sl.weight.ref())
    return CircuitBlock.from_layer(
        ConstantValueLayer(sl.num_output_units, log_space=False, value=value)
    )


def integrate_categorical_layer(sl: CategoricalLayer, *, scope: Scope) -> CircuitBlock:
    _check_integration_scope("Categorical", sl, scope)
    if sl.logits is None:
        log_z = Parameter.from_input(ConstantParameter(sl.num_output_units, value=0.0))
    else:
        log_z = Parameter.from_unary(
            ReduceLSEParameter(sl.logits.shape, axis=1), sl.logits.ref()
        )
    return CircuitBlock.from_layer(
        ConstantValueLayer(sl.num_output_units, log_space=True, value=log_z)
    )


def integrate_binomial_layer(sl: BinomialLayer, *, scope: Scope) -> CircuitBlock:
    """Binomial units are always normalized, so the integral is the constant
    one (log-partition zero). An extension over the reference, which has no
    INTEGRATION rule for Binomial layers (ref: ``operators.py:341-346``)."""
    _check_integration_scope("Binomial", sl, scope)
    log_z = Parameter.from_input(ConstantParameter(sl.num_output_units, value=0.0))
    return CircuitBlock.from_layer(
        ConstantValueLayer(sl.num_output_units, log_space=True, value=log_z)
    )


def integrate_gaussian_layer(sl: GaussianLayer, *, scope: Scope) -> CircuitBlock:
    _check_integration_scope("Gaussian", sl, scope)
    if sl.log_partition is None:
        log_z = Parameter.from_input(ConstantParameter(sl.num_output_units, value=0.0))
    else:
        log_z = sl.log_partition.ref()
    return CircuitBlock.from_layer(
        ConstantValueLayer(sl.num_output_units, log_space=True, value=log_z)
    )


# -- multiplication ----------------------------------------------------------


def multiply_embedding_layers(sl1: EmbeddingLayer, sl2: EmbeddingLayer) -> CircuitBlock:
    _check_same_scope("Embedding", sl1, sl2)
    if sl1.num_states != sl2.num_states:
        raise ValueError("Expected Embedding layers with the same number of states")
    weight = Parameter.from_binary(
        OuterProductParameter(sl1.weight.shape, sl2.weight.shape, axis=0),
        sl1.weight.ref(),
        sl2.weight.ref(),
    )
    return CircuitBlock.from_layer(
        EmbeddingLayer(
            sl1.scope,
            sl1.num_output_units * sl2.num_output_units,
            num_states=sl1.num_states,
            weight=weight,
        )
    )


def _as_logits(sl: CategoricalLayer) -> Parameter:
    if sl.logits is not None:
        return sl.logits.ref()
    assert sl.probs is not None
    return Parameter.from_unary(LogParameter(sl.probs.shape), sl.probs.ref())


def multiply_categorical_layers(sl1: CategoricalLayer, sl2: CategoricalLayer) -> CircuitBlock:
    _check_same_scope("Categorical", sl1, sl2)
    if sl1.num_categories != sl2.num_categories:
        raise ValueError("Expected Categorical layers with the same number of categories")
    logits1, logits2 = _as_logits(sl1), _as_logits(sl2)
    logits = Parameter.from_binary(
        OuterSumParameter(logits1.shape, logits2.shape, axis=0), logits1, logits2
    )
    return CircuitBlock.from_layer(
        CategoricalLayer(
            sl1.scope,
            sl1.num_output_units * sl2.num_output_units,
            num_categories=sl1.num_categories,
            logits=logits,
        )
    )


def multiply_gaussian_layers(sl1: GaussianLayer, sl2: GaussianLayer) -> CircuitBlock:
    _check_same_scope("Gaussian", sl1, sl2)
    shapes = (sl1.mean.shape, sl1.stddev.shape, sl2.mean.shape, sl2.stddev.shape)
    refs = (sl1.mean.ref(), sl1.stddev.ref(), sl2.mean.ref(), sl2.stddev.ref())
    mean = Parameter.from_nary(GaussianProductMean(*shapes), *refs)
    stddev = Parameter.from_binary(
        GaussianProductStddev(sl1.stddev.shape, sl2.stddev.shape),
        sl1.stddev.ref(),
        sl2.stddev.ref(),
    )
    log_partition = Parameter.from_nary(
        GaussianProductLogPartition(*shapes),
        sl1.mean.ref(),
        sl1.stddev.ref(),
        sl2.mean.ref(),
        sl2.stddev.ref(),
    )
    # If either operand is unnormalized, add the outer sum of their log partitions
    if sl1.log_partition is not None or sl2.log_partition is not None:
        log_z1 = (
            sl1.log_partition.ref()
            if sl1.log_partition is not None
            else Parameter.from_input(ConstantParameter(sl1.num_output_units, value=0.0))
        )
        log_z2 = (
            sl2.log_partition.ref()
            if sl2.log_partition is not None
            else Parameter.from_input(ConstantParameter(sl2.num_output_units, value=0.0))
        )
        outer = Parameter.from_binary(
            OuterSumParameter(log_z1.shape, log_z2.shape, axis=0), log_z1, log_z2
        )
        log_partition = Parameter.from_binary(
            SumParameter(log_partition.shape, outer.shape), log_partition, outer
        )
    return CircuitBlock.from_layer(
        GaussianLayer(
            sl1.scope,
            sl1.num_output_units * sl2.num_output_units,
            mean=mean,
            stddev=stddev,
            log_partition=log_partition,
        )
    )


def multiply_polynomial_layers(sl1: PolynomialLayer, sl2: PolynomialLayer) -> CircuitBlock:
    _check_same_scope("Polynomial", sl1, sl2)
    coeff = Parameter.from_binary(
        PolynomialProduct(sl1.coeff.shape, sl2.coeff.shape), sl1.coeff.ref(), sl2.coeff.ref()
    )
    return CircuitBlock.from_layer(
        PolynomialLayer(
            sl1.scope,
            sl1.num_output_units * sl2.num_output_units,
            degree=sl1.degree + sl2.degree,
            coeff=coeff,
        )
    )


def multiply_hadamard_layers(sl1: HadamardLayer, sl2: HadamardLayer) -> CircuitBlock:
    return CircuitBlock.from_layer(
        HadamardLayer(
            sl1.num_input_units * sl2.num_input_units, arity=max(sl1.arity, sl2.arity)
        )
    )


def multiply_kronecker_layers(sl1: KroneckerLayer, sl2: KroneckerLayer) -> CircuitBlock:
    """Product of Kronecker layers = Kronecker layer + a constant permutation
    sum layer that interleaves the unit orderings (ref: ``symbolic/operators.py:234-257``)."""
    arity = max(sl1.arity, sl2.arity)
    kron_sl = KroneckerLayer(sl1.num_input_units * sl2.num_input_units, arity=arity)
    ko = kron_sl.num_output_units
    # The fresh Kronecker layer enumerates units as (a_1 b_1 a_2 b_2 ...); the
    # product semantics demands (a_1 a_2 ... b_1 b_2 ...). Encode the
    # reordering as a constant 0/1 permutation matrix applied by a sum layer.
    perm = np.eye(ko, dtype=np.float64).reshape(
        ko,
        *((sl1.num_input_units,) * sl1.arity),
        *((sl2.num_input_units,) * sl2.arity),
    )
    axes = (0,) + tuple(x for a in range(arity) for x in (1 + a, 1 + a + arity))
    perm = np.transpose(perm, axes=axes).reshape(ko, ko)
    perm_sl = SumLayer(
        ko, ko, weight=Parameter.from_input(ConstantParameter(ko, ko, value=perm))
    )
    return CircuitBlock.from_layer_composition(kron_sl, perm_sl)


def multiply_sum_layers(sl1: SumLayer, sl2: SumLayer) -> CircuitBlock:
    """Product of two sum layers: Kronecker of the weights, with a column
    permutation aligning the weight to the paired-children wiring when BOTH
    arities exceed 1 (ref: ``symbolic/operators.py:260-270`` — the reference
    omits the permutation, so its products of mixing-sum circuits, e.g.
    squaring an ensemble, are silently wrong; pinned by enumeration in
    ``tests/symbolic/test_operators.py::test_multiply_mixing_sums``).

    The product recursion wires the children of the product sum as all pairs
    in ``itertools.product`` order, so the flattened input axis runs
    (a1, a2, i1, i2) row-major. ``kron(W1, W2)`` columns run (a1, i1, a2, i2)
    — identical only when ``Ki1 == 1`` or ``A2 == 1``; otherwise reorder."""
    weight = Parameter.from_binary(
        KroneckerParameter(sl1.weight.shape, sl2.weight.shape),
        sl1.weight.ref(),
        sl2.weight.ref(),
    )
    a1, k1 = sl1.arity, sl1.num_input_units
    a2, k2 = sl2.arity, sl2.num_input_units
    if k1 > 1 and a2 > 1:
        perm = (
            np.arange(a1 * k1 * a2 * k2)
            .reshape(a1, k1, a2, k2)
            .transpose(0, 2, 1, 3)
            .ravel()
        )
        weight = Parameter.from_unary(
            IndexParameter(weight.shape, indices=perm.tolist(), axis=1), weight
        )
    return CircuitBlock.from_layer(
        SumLayer(
            k1 * k2,
            sl1.num_output_units * sl2.num_output_units,
            arity=a1 * a2,
            weight=weight,
        )
    )


# -- differentiation ---------------------------------------------------------


def differentiate_polynomial_layer(
    sl: PolynomialLayer, *, var_idx: int, order: int = 1
) -> CircuitBlock:
    if var_idx != 0:
        raise ValueError("Polynomial layers are univariate")
    if order <= 0:
        raise ValueError("The differentiation order must be positive")
    coeff = Parameter.from_unary(
        PolynomialDifferential(sl.coeff.shape, order=order), sl.coeff.ref()
    )
    return CircuitBlock.from_layer(
        PolynomialLayer(sl.scope, sl.num_output_units, degree=coeff.shape[-1] - 1, coeff=coeff)
    )


# -- conjugation -------------------------------------------------------------


def conjugate_embedding_layer(sl: EmbeddingLayer) -> CircuitBlock:
    weight = Parameter.from_unary(ConjugateParameter(sl.weight.shape), sl.weight.ref())
    return CircuitBlock.from_layer(
        EmbeddingLayer(sl.scope, sl.num_output_units, num_states=sl.num_states, weight=weight)
    )


def conjugate_categorical_layer(sl: CategoricalLayer) -> CircuitBlock:
    return CircuitBlock.from_layer(
        CategoricalLayer(
            sl.scope,
            sl.num_output_units,
            num_categories=sl.num_categories,
            logits=None if sl.logits is None else sl.logits.ref(),
            probs=None if sl.probs is None else sl.probs.ref(),
        )
    )


def conjugate_gaussian_layer(sl: GaussianLayer) -> CircuitBlock:
    return CircuitBlock.from_layer(
        GaussianLayer(sl.scope, sl.num_output_units, mean=sl.mean.ref(), stddev=sl.stddev.ref())
    )


def conjugate_polynomial_layer(sl: PolynomialLayer) -> CircuitBlock:
    coeff = Parameter.from_unary(ConjugateParameter(sl.coeff.shape), sl.coeff.ref())
    return CircuitBlock.from_layer(
        PolynomialLayer(sl.scope, sl.num_output_units, degree=sl.degree, coeff=coeff)
    )


def conjugate_sum_layer(sl: SumLayer) -> CircuitBlock:
    weight = Parameter.from_unary(ConjugateParameter(sl.weight.shape), sl.weight.ref())
    return CircuitBlock.from_layer(
        SumLayer(sl.num_input_units, sl.num_output_units, arity=sl.arity, weight=weight)
    )


class LayerOperatorFunc(Protocol):
    """A rule mapping one or more layers to a circuit block."""

    def __call__(self, *sl: Layer, **kwargs: Any) -> CircuitBlock: ...


DEFAULT_OPERATOR_RULES: Mapping[LayerOperator, Sequence[Callable[..., CircuitBlock]]] = {
    LayerOperator.INTEGRATION: [
        integrate_embedding_layer,
        integrate_categorical_layer,
        integrate_binomial_layer,
        integrate_gaussian_layer,
    ],
    LayerOperator.DIFFERENTIATION: [differentiate_polynomial_layer],
    LayerOperator.MULTIPLICATION: [
        multiply_embedding_layers,
        multiply_categorical_layers,
        multiply_gaussian_layers,
        multiply_polynomial_layers,
        multiply_hadamard_layers,
        multiply_kronecker_layers,
        multiply_sum_layers,
    ],
    LayerOperator.CONJUGATION: [
        conjugate_embedding_layer,
        conjugate_categorical_layer,
        conjugate_gaussian_layer,
        conjugate_polynomial_layer,
        conjugate_sum_layer,
    ],
}

LayerOperatorSign = tuple[type[Layer], ...]
LayerOperatorSpecs = dict[LayerOperatorSign, LayerOperatorFunc]
