"""Tensor-factorization circuit templates: CP, Tucker, TT/MPS.

Rebuild of ``cirkit/templates/tensor_factorizations.py:36-350``.
"""

from __future__ import annotations

from collections import defaultdict
from collections.abc import Mapping

import numpy as np
from scipy import linalg

from cirkit_tpu_torch.models.utils import (
    InputLayerFactory,
    Parameterization,
    name_to_input_layer_factory,
    named_parameterizations_to_factories,
    parameterization_to_factory,
)
from cirkit_tpu_torch.symbolic.circuit import Circuit
from cirkit_tpu_torch.symbolic.layers import (
    EmbeddingLayer,
    HadamardLayer,
    KroneckerLayer,
    Layer,
    SumLayer,
)
from cirkit_tpu_torch.symbolic.parameters import ConstantParameter, Parameter, ParameterFactory
from cirkit_tpu_torch.utils.scope import Scope


def _factor_factory(
    input_layer: str, dim: int, param_kwargs: Mapping[str, ParameterFactory]
) -> InputLayerFactory:
    dim_kwargs = {
        "categorical": {"num_categories": dim},
        "binomial": {"total_count": dim},
        "embedding": {"num_states": dim},
    }[input_layer]
    return name_to_input_layer_factory(input_layer, **dim_kwargs, **param_kwargs)


def _validate(shape: tuple[int, ...], rank: int, input_layer: str) -> None:
    if len(shape) < 1 or any(d < 1 for d in shape):
        raise ValueError("The tensor shape is not valid")
    if rank < 1:
        raise ValueError("The factorization rank must be a positive number")
    if input_layer not in ("categorical", "binomial", "embedding"):
        raise ValueError(f"The input layer {input_layer} is not valid")


def cp(
    shape: tuple[int, ...],
    rank: int,
    *,
    input_layer: str = "embedding",
    input_params: dict[str, Parameterization] | None = None,
    weight_param: Parameterization | None = None,
) -> Circuit:
    """A circuit computing a rank-R CP factorization of an n-dimensional
    tensor: per-axis factors -> Hadamard -> (optionally weighted) sum."""
    _validate(shape, rank, input_layer)
    if weight_param is None:
        weight = Parameter.from_input(ConstantParameter(1, rank, value=np.ones((1, rank))))
        weight_factory = None
    else:
        weight_factory = parameterization_to_factory(weight_param)
        weight = None
    param_kwargs = (
        {} if input_params is None else named_parameterizations_to_factories(input_params)
    )
    factors = [
        _factor_factory(input_layer, dim, param_kwargs)(Scope([i]), rank)
        for i, dim in enumerate(shape)
    ]
    hadamard = HadamardLayer(rank, arity=len(shape))
    sum_sl = SumLayer(rank, 1, arity=1, weight=weight, weight_factory=weight_factory)
    return Circuit(
        factors + [hadamard, sum_sl],
        {hadamard: factors, sum_sl: [hadamard]},
        [sum_sl],
    )


def tucker(
    shape: tuple[int, ...],
    rank: int,
    *,
    input_layer: str = "embedding",
    input_params: dict[str, Parameterization] | None = None,
    core_param: Parameterization | None = None,
) -> Circuit:
    """A circuit computing a rank-R Tucker factorization: per-axis factors ->
    Kronecker -> sum with the flattened core tensor as weights."""
    _validate(shape, rank, input_layer)
    if core_param is None:
        core_param = Parameterization(activation="none", initialization="normal")
    weight_factory = parameterization_to_factory(core_param)
    param_kwargs = (
        {} if input_params is None else named_parameterizations_to_factories(input_params)
    )
    factors = [
        _factor_factory(input_layer, dim, param_kwargs)(Scope([i]), rank)
        for i, dim in enumerate(shape)
    ]
    kronecker = KroneckerLayer(rank, arity=len(shape))
    sum_sl = SumLayer(int(rank ** len(shape)), 1, arity=1, weight_factory=weight_factory)
    return Circuit(
        factors + [kronecker, sum_sl],
        {kronecker: factors, sum_sl: [kronecker]},
        [sum_sl],
    )


def tensor_train(
    shape: tuple[int, ...],
    rank: int,
    *,
    factor_param: Parameterization | None = None,
) -> Circuit:
    """A circuit computing a Tensor-Train / MPS factorization: a chain of
    Hadamard products and constant block-diagonal sum layers encoding the
    left-to-right matrix-vector contractions. Supports complex parameters
    (``factor_param=Parameterization(dtype="complex")``) for quantum MPS."""
    if len(shape) < 1 or any(d < 1 for d in shape):
        raise ValueError("The tensor shape is not valid")
    if rank < 1:
        raise ValueError("The factorization rank must be a positive number")
    if factor_param is None:
        factor_param = Parameterization(activation="none", initialization="normal")
    embedding_factory = parameterization_to_factory(factor_param)

    if len(shape) == 1:
        emb = EmbeddingLayer(Scope([0]), 1, num_states=shape[0], weight_factory=embedding_factory)
        return Circuit([emb], {}, [emb])

    first = EmbeddingLayer(Scope([0]), rank, num_states=shape[0], weight_factory=embedding_factory)
    last = EmbeddingLayer(
        Scope([len(shape) - 1]), rank, num_states=shape[-1], weight_factory=embedding_factory
    )
    inner = [
        [
            EmbeddingLayer(Scope([i]), rank, num_states=dim, weight_factory=embedding_factory)
            for _ in range(rank)
        ]
        for i, dim in enumerate(shape[1:-1], start=1)
    ]

    # Constant weights: a (1, R) all-ones row encodes a dot product; its
    # R-fold block-diagonal stack encodes a matrix-vector contraction.
    dot_ones = np.ones((1, rank))
    mav_ones = linalg.block_diag(*((dot_ones,) * rank))

    layers: list[Layer] = [first, last] + [sl for sls in inner for sl in sls]
    in_layers: dict[Layer, list[Layer]] = defaultdict(list)
    cur: Layer = first
    for i in range(len(shape) - 1):
        if i == len(shape) - 2:
            prod = HadamardLayer(rank, arity=2)
            sum_sl = SumLayer(
                rank,
                1,
                arity=1,
                weight=Parameter.from_input(ConstantParameter(1, rank, value=dot_ones)),
            )
            layers.extend((prod, sum_sl))
            in_layers[prod] = [cur, last]
            in_layers[sum_sl] = [prod]
            cur = sum_sl
            continue
        prods: list[Layer] = [HadamardLayer(rank, arity=2) for _ in range(rank)]
        sum_sl = SumLayer(
            rank,
            rank,
            arity=rank,
            weight=Parameter.from_input(ConstantParameter(rank, rank * rank, value=mav_ones)),
        )
        layers.extend(prods)
        layers.append(sum_sl)
        in_layers[sum_sl] = prods
        for prod, emb in zip(prods, inner[i]):
            in_layers[prod] = [cur, emb]
        cur = sum_sl

    return Circuit(layers, dict(in_layers), [cur])
