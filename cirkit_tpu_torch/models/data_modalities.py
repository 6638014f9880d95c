"""Data-modality circuit templates: image and tabular circuits.

Rebuild of ``cirkit/templates/data_modalities.py:26-305``.
"""

from __future__ import annotations

import functools
from collections.abc import Mapping
from typing import Any

import numpy as np

from cirkit_tpu_torch.models.region_graph import (
    ChowLiuTree,
    PoonDomingos,
    QuadGraph,
    QuadTree,
    RandomBinaryTree,
    RegionGraph,
)
from cirkit_tpu_torch.models.utils import (
    InputLayerFactory,
    Parameterization,
    name_to_input_layer_factory,
    parameterization_to_factory,
)
from cirkit_tpu_torch.symbolic.circuit import Circuit
from cirkit_tpu_torch.symbolic.parameters import ParameterFactory, mixing_weight_factory
from cirkit_tpu_torch.utils.scope import Scope

_IMAGE_REGION_GRAPHS = (
    "quad-tree-2",
    "quad-tree-4",
    "quad-graph",
    "random-binary-tree",
    "poon-domingos",
)


def em_input_parameterizations(input_layer: str) -> dict[str, Parameterization]:
    """EM-eligible leaf parameterizations by input-layer name: plain
    (activation-free) parameter slots with positive/normalized initial
    values, so :func:`cirkit_tpu.parallel.fit_em` can update them in closed
    form (``parallel/em.py`` requires plain slots; the library defaults —
    softmax categorical probs, ScaledSigmoid Gaussian stddev — are not
    EM-eligible). The M-step keeps them valid by construction (renormalized
    probs, clamped variances)."""
    if input_layer == "categorical":
        return {"probs": Parameterization(activation="none", initialization="dirichlet")}
    if input_layer == "binomial":
        return {
            "probs": Parameterization(
                activation="none",
                initialization="uniform",
                initialization_kwargs={"a": 0.1, "b": 0.9},
            )
        }
    if input_layer == "gaussian":
        return {
            "mean": Parameterization(activation="none", initialization="normal"),
            "stddev": Parameterization(
                activation="none",
                initialization="uniform",
                initialization_kwargs={"a": 0.5, "b": 1.5},
            ),
        }
    raise ValueError(
        f"No EM-ready parameterization exists for input layer {input_layer!r}; "
        "EM updates categorical, binomial, and gaussian leaves"
    )


def _sum_weight_factories(
    sum_weight_param: Parameterization | None, use_mixing_weights: bool
) -> tuple[ParameterFactory, ParameterFactory]:
    if sum_weight_param is None:
        sum_weight_param = Parameterization(activation="softmax", initialization="normal")
    sum_weight_factory = parameterization_to_factory(sum_weight_param)
    if use_mixing_weights:
        nary = functools.partial(mixing_weight_factory, param_factory=sum_weight_factory)
    else:
        nary = sum_weight_factory
    return sum_weight_factory, nary


def image_data(
    image_shape: tuple[int, int, int],
    region_graph: str = "quad-graph",
    *,
    input_layer: str,
    num_input_units: int,
    sum_product_layer: str,
    num_sum_units: int,
    num_classes: int = 1,
    input_params: dict[str, Parameterization] | None = None,
    sum_weight_param: Parameterization | None = None,
    use_mixing_weights: bool = True,
    em_ready: bool = False,
) -> Circuit:
    """A symbolic circuit tailored for (C, H, W) image data: an image region
    graph + per-pixel input layers (256-state defaults) + cp/cp-t/tucker
    sum-product blocks with softmax sum weights.

    ``em_ready=True`` makes the whole circuit trainable by
    :func:`cirkit_tpu.parallel.fit_em`: leaf parameters default to the
    plain slots of :func:`em_input_parameterizations` (explicit
    ``input_params`` still win) and, unless given, ``sum_weight_param``
    defaults to plain Dirichlet-initialized weights."""
    if (
        not isinstance(image_shape, tuple)
        or len(image_shape) != 3
        or any(d <= 0 for d in image_shape)
    ):
        raise ValueError(f"Expected a (C, H, W) shape of positive sizes, found {image_shape}")
    if region_graph not in _IMAGE_REGION_GRAPHS:
        raise ValueError(f"Unknown region graph called {region_graph}")
    if input_layer not in ("categorical", "binomial", "embedding", "gaussian"):
        raise ValueError(f"Unknown input layer called {input_layer}")

    if region_graph == "quad-tree-2":
        rg = QuadTree(image_shape, num_patch_splits=2)
    elif region_graph == "quad-tree-4":
        rg = QuadTree(image_shape, num_patch_splits=4)
    elif region_graph == "quad-graph":
        rg = QuadGraph(image_shape)
    elif region_graph == "random-binary-tree":
        rg = RandomBinaryTree(int(np.prod(image_shape)))
    else:  # poon-domingos
        delta = int(max(np.ceil(image_shape[1] / 8), np.ceil(image_shape[2] / 8)))
        rg = PoonDomingos(image_shape, delta=delta)

    input_kwargs: dict[str, Any] = {
        "categorical": {"num_categories": 256},
        "binomial": {"total_count": 255},
        "embedding": {"num_states": 256},
        "gaussian": {},
    }[input_layer]
    if em_ready:
        merged = em_input_parameterizations(input_layer)
        merged.update(input_params or {})
        input_params = merged
        if sum_weight_param is None:
            sum_weight_param = Parameterization(
                activation="none", initialization="dirichlet"
            )
    if input_params is not None:
        input_kwargs.update(
            (f"{name}_factory", parameterization_to_factory(p))
            for name, p in input_params.items()
        )
    input_factory = name_to_input_layer_factory(input_layer, **input_kwargs)

    sum_weight_factory, nary_sum_weight_factory = _sum_weight_factories(
        sum_weight_param, use_mixing_weights
    )
    return rg.build_circuit(
        input_factory=input_factory,
        sum_product=sum_product_layer,
        sum_weight_factory=sum_weight_factory,
        nary_sum_weight_factory=nary_sum_weight_factory,
        num_input_units=num_input_units,
        num_sum_units=num_sum_units,
        num_classes=num_classes,
        factorize_multivariate=True,
    )


def tabular_data(
    region_graph: str = "random-binary-tree",
    *,
    num_features: int | None = None,
    data: np.ndarray | None = None,
    input_layers: dict | list[dict],
    num_input_units: int,
    sum_product_layer: str,
    num_sum_units: int,
    num_classes: int = 1,
    sum_weight_param: Parameterization | None = None,
    use_mixing_weights: bool = True,
    em_ready: bool = False,
) -> Circuit:
    """A symbolic circuit tailored for tabular data: a random binary tree or
    a data-learned Chow-Liu tree, with (possibly heterogeneous) per-feature
    input layers.

    ``em_ready=True`` injects the plain leaf parameterizations of
    :func:`em_input_parameterizations` into every input-layer spec that
    does not already fix its parameters, and defaults ``sum_weight_param``
    to plain Dirichlet-initialized weights, so the circuit trains under
    :func:`cirkit_tpu.parallel.fit_em`."""
    if region_graph == "random-binary-tree":
        if num_features is None:
            if data is None:
                raise ValueError(
                    "You must pass 'num_features' when asking for random-binary-tree"
                )
            num_features = data.shape[1]
        rg = RandomBinaryTree(num_features)
    elif region_graph == "chow-liu-tree":
        if data is None:
            raise ValueError("You must pass 'data' when asking for chow-liu-tree")
        rg_result = ChowLiuTree(
            data=np.asarray(data),
            input_type=(
                input_layers["name"]
                if isinstance(input_layers, dict)
                else [layer["name"] for layer in input_layers]
            ),
            num_categories=(
                input_layers["args"]["num_categories"]
                if isinstance(input_layers, dict) and input_layers["name"] == "categorical"
                else None
            ),
            as_region_graph=True,
        )
        assert isinstance(rg_result, RegionGraph)
        rg = rg_result
    else:
        raise ValueError(f"Unknown region graph called {region_graph}")

    if em_ready:
        if sum_weight_param is None:
            sum_weight_param = Parameterization(
                activation="none", initialization="dirichlet"
            )

        def _emify(spec: dict) -> dict:
            args = dict(spec.get("args", {}))
            fixed = ("probs", "logits", "mean", "stddev")
            if not any(k.endswith("_factory") or k in fixed for k in args):
                args.update(
                    (f"{name}_factory", parameterization_to_factory(p))
                    for name, p in em_input_parameterizations(spec["name"]).items()
                )
            return {**spec, "args": args}

        input_layers = (
            _emify(input_layers)
            if isinstance(input_layers, dict)
            else [_emify(s) for s in input_layers]
        )

    sum_weight_factory, nary_sum_weight_factory = _sum_weight_factories(
        sum_weight_param, use_mixing_weights
    )

    input_factories: InputLayerFactory | Mapping[Scope, InputLayerFactory]
    if isinstance(input_layers, dict):
        input_factories = name_to_input_layer_factory(
            input_layers["name"], **input_layers["args"]
        )
    else:
        if len(input_layers) != len(rg.scope):
            raise ValueError(
                f"The number of input layers ({len(input_layers)}) does not match "
                f"the number of features ({len(rg.scope)})"
            )
        input_factories = {
            Scope([i]): name_to_input_layer_factory(layer["name"], **layer["args"])
            for i, layer in enumerate(input_layers)
        }

    return rg.build_circuit(
        input_factory=input_factories,
        sum_product=sum_product_layer,
        sum_weight_factory=sum_weight_factory,
        nary_sum_weight_factory=nary_sum_weight_factory,
        num_input_units=num_input_units,
        num_sum_units=num_sum_units,
        num_classes=num_classes,
        factorize_multivariate=True,
    )
