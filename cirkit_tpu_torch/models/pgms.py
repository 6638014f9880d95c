"""Probabilistic-graphical-model templates: fully factorized models and HMMs.

Rebuild of ``cirkit/templates/pgms.py:15-180``.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence
from typing import Any

from cirkit_tpu_torch.models.utils import (
    Parameterization,
    name_to_input_layer_factory,
    named_parameterizations_to_factories,
    parameterization_to_factory,
)
from cirkit_tpu_torch.symbolic.circuit import Circuit
from cirkit_tpu_torch.symbolic.layers import HadamardLayer, Layer, SumLayer
from cirkit_tpu_torch.utils.scope import Scope


def _input_layer_kwargs_list(
    input_layer_kwargs: Mapping[str, Any] | list[Mapping[str, Any]] | None,
    num_variables: int,
) -> list[Mapping[str, Any]]:
    if input_layer_kwargs is None:
        return [{}] * num_variables
    if isinstance(input_layer_kwargs, Mapping):
        return [input_layer_kwargs] * num_variables
    if len(input_layer_kwargs) != num_variables:
        raise ValueError(
            f"The list of input layer kwargs must have length {num_variables}"
        )
    if not all(isinstance(k, Mapping) for k in input_layer_kwargs):
        raise ValueError("The input layer kwargs must be a list of dictionaries")
    return list(input_layer_kwargs)


def _input_factories(
    input_layer: str,
    input_params: Mapping[str, Parameterization] | None,
    kwargs_ls: list[Mapping[str, Any]],
):
    param_kwargs = (
        {} if input_params is None else named_parameterizations_to_factories(input_params)
    )
    return [
        name_to_input_layer_factory(input_layer, **kwargs, **param_kwargs)
        for kwargs in kwargs_ls
    ]


def fully_factorized(
    num_variables: int,
    input_layer: str = "categorical",
    input_params: Mapping[str, Parameterization] | None = None,
    input_layer_kwargs: Mapping[str, Any] | list[Mapping[str, Any]] | None = None,
) -> Circuit:
    """A fully-factorized circuit: one input unit per variable joined by a
    single Hadamard product."""
    if num_variables <= 0:
        raise ValueError("The number of variables must be a positive integer")
    if input_layer not in ("categorical", "binomial", "gaussian"):
        raise ValueError(f"Unknown input layer called {input_layer}")
    kwargs_ls = _input_layer_kwargs_list(input_layer_kwargs, num_variables)
    factories = _input_factories(input_layer, input_params, kwargs_ls)
    input_layers = [f(Scope([i]), 1) for i, f in enumerate(factories)]
    if len(input_layers) == 1:
        return Circuit(input_layers, {}, [input_layers[0]])
    prod = HadamardLayer(1, arity=len(input_layers))
    return Circuit(input_layers + [prod], {prod: input_layers}, [prod])


def hmm(
    ordering: Sequence[int],
    input_layer: str = "categorical",
    num_latent_states: int = 1,
    input_params: Mapping[str, Parameterization] | None = None,
    input_layer_kwargs: Mapping[str, Any] | list[Mapping[str, Any]] | None = None,
    weight_param: Parameterization | None = None,
) -> Circuit:
    """An inhomogeneous hidden Markov model over the given variable ordering:
    an alternating chain of emission input layers, Hadamard products, and
    transition sum layers."""
    if not ordering:
        raise ValueError("The ordering must be non-empty")
    num_variables = len(ordering)
    if set(ordering) != set(range(num_variables)):
        raise ValueError("The variable ordering is not a valid permutation")
    if input_layer not in ("categorical", "binomial", "gaussian"):
        raise ValueError(f"Unknown input layer called {input_layer}")
    kwargs_ls = _input_layer_kwargs_list(input_layer_kwargs, num_variables)
    factories = _input_factories(input_layer, input_params, kwargs_ls)

    if weight_param is None:
        weight_param = Parameterization(activation="softmax", initialization="normal")
    weight_factory = parameterization_to_factory(weight_param)

    layers: list[Layer] = []
    in_layers: dict[Layer, list[Layer]] = {}

    input_sl = factories[-1](Scope([ordering[-1]]), num_latent_states)
    layers.append(input_sl)
    num_units_out = 1 if num_variables == 1 else num_latent_states
    sum_sl = SumLayer(num_latent_states, num_units_out, weight_factory=weight_factory)
    layers.append(sum_sl)
    in_layers[sum_sl] = [input_sl]

    for i in reversed(range(num_variables - 1)):
        last_sum = layers[-1]
        input_sl = factories[i](Scope([ordering[i]]), num_latent_states)
        prod_sl = HadamardLayer(num_latent_states, 2)
        layers.extend((input_sl, prod_sl))
        in_layers[prod_sl] = [last_sum, input_sl]
        num_units_out = 1 if i == 0 else num_latent_states
        sum_sl = SumLayer(num_latent_states, num_units_out, weight_factory=weight_factory)
        layers.append(sum_sl)
        in_layers[sum_sl] = [prod_sl]

    return Circuit(layers, in_layers, [layers[-1]])
