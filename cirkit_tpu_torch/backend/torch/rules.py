"""Default compilation rules: symbolic nodes -> compiled PyTorch nodes.

The counterpart of ``cirkit_tpu/backend/jax/rules.py``: three type-keyed
tables mapping symbolic layers, parameter nodes and initializers to their
compiled forms. Symbolic types the port does not carry yet compile to a
rule that raises ``NotImplementedError`` (see the module queue of
``ROADMAP.md``).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from cirkit_tpu_torch.backend.torch import layers as tl
from cirkit_tpu_torch.backend.torch import parameters as tp
from cirkit_tpu_torch.backend.torch.utils import (
    default_complex_dtype,
    default_int_dtype,
    default_real_dtype,
    to_real_dtype,
)
from cirkit_tpu_torch.symbolic import initializers as syi
from cirkit_tpu_torch.symbolic import layers as syl
from cirkit_tpu_torch.symbolic import parameters as syp
from cirkit_tpu_torch.symbolic.dtypes import DataType

if TYPE_CHECKING:
    from cirkit_tpu_torch.backend.torch.compiler import TorchCompiler


def compiled_dtype(dtype: DataType) -> torch.dtype:
    if dtype == DataType.INTEGER:
        return default_int_dtype()
    if dtype == DataType.COMPLEX:
        return default_complex_dtype()
    return default_real_dtype()


# The item of ROADMAP.md's module queue that brings a symbolic type the port
# does not carry yet, where one names it.
_ROADMAP_ITEMS = {"EvidenceLayer": 14}


def _not_ported(kind: str, obj) -> NotImplementedError:
    item = _ROADMAP_ITEMS.get(type(obj).__name__)
    where = f"ROADMAP.md item {item}" if item else "see the module queue of ROADMAP.md"
    return NotImplementedError(
        f"The {kind} {type(obj).__name__} is not ported to the PyTorch backend yet ({where})"
    )


# --------------------------------------------------------------------------- #
# Initializer rules: symbolic Initializer -> InitFn(generator, shape, dtype, device)
# --------------------------------------------------------------------------- #


def compile_constant_tensor_initializer(
    compiler: "TorchCompiler", init: syi.ConstantTensorInitializer
) -> tp.InitFn:
    value = init.value

    def _init(generator, shape, dtype, device):
        return torch.as_tensor(np.asarray(value), dtype=dtype, device=device).expand(shape)

    _init.constant = np.asarray(value)
    return _init


def compile_uniform_initializer(
    compiler: "TorchCompiler", init: syi.UniformInitializer
) -> tp.InitFn:
    a, b = init.a, init.b

    def _init(generator, shape, dtype, device):
        u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
        return u * (b - a) + a

    _init.batch_key = ("uniform", a, b)
    return _init


def compile_normal_initializer(
    compiler: "TorchCompiler", init: syi.NormalInitializer
) -> tp.InitFn:
    mean, stddev = init.mean, init.stddev

    def _init(generator, shape, dtype, device):
        if dtype.is_complex:
            # independent real and imaginary parts, each of the given spread
            real = to_real_dtype(dtype)
            re = torch.randn(shape, generator=generator, dtype=real, device=device)
            im = torch.randn(shape, generator=generator, dtype=real, device=device)
            return torch.complex(re, im) * stddev + mean
        return torch.randn(shape, generator=generator, dtype=dtype, device=device) * stddev + mean

    _init.batch_key = ("normal", mean, stddev)
    return _init


def compile_dirichlet_initializer(
    compiler: "TorchCompiler", init: syi.DirichletInitializer
) -> tp.InitFn:
    alpha, axis = init.alpha, init.axis

    def _init(generator, shape, dtype, device):
        ax = axis if axis >= 0 else axis + len(shape)
        if not isinstance(alpha, list) and float(alpha) == 1.0:
            # Dirichlet(1, ..., 1) = normalized exponentials (-log U)
            u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
            e = -torch.log(u.clamp_min(torch.finfo(dtype).tiny))
            return e / e.sum(dim=ax, keepdim=True)
        # Other concentrations: torch's gamma sampler takes no generator, so
        # draw in numpy from a seed taken from the generator.
        seed = int(
            torch.randint(0, 2**62, (1,), generator=generator, device=generator.device).item()
        )
        k = shape[ax]
        a = np.asarray(alpha if isinstance(alpha, list) else [alpha] * k, dtype=float)
        batch_shape = shape[:ax] + shape[ax + 1 :]
        sample = np.random.default_rng(seed).dirichlet(a, size=batch_shape)
        return torch.as_tensor(np.moveaxis(sample, -1, ax), dtype=dtype, device=device)

    if axis < 0:
        # Negative axes resolve identically on the fold-extended shape, so a
        # single (F, ...) draw is valid for the batched-init fast path.
        alpha_key = tuple(alpha) if isinstance(alpha, list) else alpha
        _init.batch_key = ("dirichlet", alpha_key, axis)
    return _init


def compile_unported_initializer(compiler: "TorchCompiler", init: syi.Initializer):
    raise _not_ported("initializer", init)


DEFAULT_INITIALIZER_COMPILATION_RULES = [
    compile_unported_initializer,
    compile_constant_tensor_initializer,
    compile_uniform_initializer,
    compile_normal_initializer,
    compile_dirichlet_initializer,
]


# --------------------------------------------------------------------------- #
# Parameter node rules: symbolic ParameterNode -> TorchParameterNode
# --------------------------------------------------------------------------- #


def compile_tensor_parameter(
    compiler: "TorchCompiler", p: syp.TensorParameter
) -> tp.TorchParameterNode:
    state = compiler.state
    if state.has_parameter(p):
        # The same symbolic tensor already has a slot: share it via a pointer.
        slot, positions = state.lookup(p)
        return tp.TorchPointerSlot(
            slot, p.shape, fold_idx=np.asarray(positions), learnable=p.learnable
        )
    init_fn = compiler.compile_initializer(p)
    slot = state.alloc_slot()
    node = tp.TorchTensorSlot(
        slot,
        p.shape,
        dtype=compiled_dtype(p.dtype),
        learnable=p.learnable,
        inits=[init_fn],
        origins=[p],
    )
    state.register(p, slot)
    return node


def compile_reference_parameter(
    compiler: "TorchCompiler", p: syp.ReferenceParameter
) -> tp.TorchParameterNode:
    slot, positions = compiler.state.lookup(p.deref())
    return tp.TorchPointerSlot(
        slot,
        p.shape,
        fold_idx=np.asarray(positions),
        learnable=getattr(p.deref(), "learnable", False),
    )


def compile_unported_parameter(compiler: "TorchCompiler", p: syp.ParameterNode):
    raise _not_ported("parameter node", p)


def compile_index_parameter(
    compiler: "TorchCompiler", p: syp.IndexParameter
) -> tp.TorchParameterNode:
    return tp.TorchIndexParameter(*p.in_shapes, indices=p.indices, axis=p.axis)


def compile_polynomial_differential(
    compiler: "TorchCompiler", p: syp.PolynomialDifferential
) -> tp.TorchParameterNode:
    return tp.TorchPolynomialDifferential(*p.in_shapes, order=p.order)


_SIMPLE_PARAM_RULES: dict[type, type] = {
    syp.KroneckerParameter: tp.TorchKroneckerParameter,
    syp.PolynomialProduct: tp.TorchPolynomialProduct,
    syp.LogParameter: tp.TorchLogParameter,
    syp.ConjugateParameter: tp.TorchConjugateParameter,
    syp.MixingWeightParameter: tp.TorchMixingWeightParameter,
}

_AXIS_PARAM_RULES: dict[type, type] = {
    syp.OuterProductParameter: tp.TorchOuterProductParameter,
    syp.OuterSumParameter: tp.TorchOuterSumParameter,
    syp.ReduceSumParameter: tp.TorchReduceSumParameter,
    syp.ReduceLSEParameter: tp.TorchReduceLSEParameter,
    syp.SoftmaxParameter: tp.TorchSoftmaxParameter,
    syp.LogSoftmaxParameter: tp.TorchLogSoftmaxParameter,
}


def default_parameter_rules() -> dict[type, object]:
    rules: dict[type, object] = {
        syp.ParameterNode: compile_unported_parameter,
        syp.TensorParameter: compile_tensor_parameter,
        syp.ConstantParameter: compile_tensor_parameter,
        syp.ReferenceParameter: compile_reference_parameter,
        syp.IndexParameter: compile_index_parameter,
        syp.PolynomialDifferential: compile_polynomial_differential,
    }
    for sym_cls, torch_cls in _SIMPLE_PARAM_RULES.items():
        rules[sym_cls] = lambda compiler, p, _cls=torch_cls: _cls(*p.in_shapes)
    for sym_cls, torch_cls in _AXIS_PARAM_RULES.items():
        rules[sym_cls] = lambda compiler, p, _cls=torch_cls: _cls(*p.in_shapes, axis=p.axis)
    return rules


# --------------------------------------------------------------------------- #
# Layer rules: symbolic Layer -> TorchLayer
# --------------------------------------------------------------------------- #


def _scope_idx(sl: syl.InputLayer) -> np.ndarray:
    return np.asarray([sorted(sl.scope)], dtype=np.int64)


def compile_unported_layer(compiler: "TorchCompiler", sl: syl.Layer) -> tl.TorchLayer:
    raise _not_ported("layer", sl)


def compile_categorical_layer(
    compiler: "TorchCompiler", sl: syl.CategoricalLayer
) -> tl.TorchLayer:
    probs = None if sl.probs is None else compiler.compile_parameter(sl.probs)
    logits = None if sl.logits is None else compiler.compile_parameter(sl.logits)
    return tl.TorchCategoricalLayer(
        _scope_idx(sl),
        sl.num_output_units,
        num_categories=sl.num_categories,
        probs=probs,
        logits=logits,
        semiring=compiler.semiring,
    )


def compile_polynomial_layer(
    compiler: "TorchCompiler", sl: syl.PolynomialLayer
) -> tl.TorchLayer:
    return tl.TorchPolynomialLayer(
        _scope_idx(sl),
        sl.num_output_units,
        degree=sl.degree,
        coeff=compiler.compile_parameter(sl.coeff),
        semiring=compiler.semiring,
    )


def compile_constant_value_layer(
    compiler: "TorchCompiler", sl: syl.ConstantValueLayer
) -> tl.TorchLayer:
    return tl.TorchConstantValueLayer(
        sl.num_output_units,
        log_space=sl.log_space,
        value=compiler.compile_parameter(sl.value),
        semiring=compiler.semiring,
    )


def compile_hadamard_layer(compiler: "TorchCompiler", sl: syl.HadamardLayer) -> tl.TorchLayer:
    return tl.TorchHadamardLayer(sl.num_input_units, arity=sl.arity, semiring=compiler.semiring)


def compile_kronecker_layer(
    compiler: "TorchCompiler", sl: syl.KroneckerLayer
) -> tl.TorchLayer:
    return tl.TorchKroneckerLayer(sl.num_input_units, arity=sl.arity, semiring=compiler.semiring)


def compile_sum_layer(compiler: "TorchCompiler", sl: syl.SumLayer) -> tl.TorchLayer:
    return tl.TorchSumLayer(
        sl.num_input_units,
        sl.num_output_units,
        arity=sl.arity,
        weight=compiler.compile_parameter(sl.weight),
        semiring=compiler.semiring,
    )


DEFAULT_LAYER_COMPILATION_RULES = [
    compile_unported_layer,
    compile_categorical_layer,
    compile_polynomial_layer,
    compile_constant_value_layer,
    compile_hadamard_layer,
    compile_kronecker_layer,
    compile_sum_layer,
]
