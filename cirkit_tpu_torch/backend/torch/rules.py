"""Default compilation rules: symbolic nodes -> compiled PyTorch nodes.

The counterpart of ``cirkit_tpu/backend/jax/rules.py``: three type-keyed
tables mapping symbolic layers, parameter nodes and initializers to their
compiled forms, one rule for every symbolic type of the JAX package.
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


DEFAULT_INITIALIZER_COMPILATION_RULES = [
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


def compile_index_parameter(
    compiler: "TorchCompiler", p: syp.IndexParameter
) -> tp.TorchParameterNode:
    return tp.TorchIndexParameter(*p.in_shapes, indices=p.indices, axis=p.axis)


def compile_scaled_sigmoid_parameter(
    compiler: "TorchCompiler", p: syp.ScaledSigmoidParameter
) -> tp.TorchParameterNode:
    return tp.TorchScaledSigmoidParameter(*p.in_shapes, vmin=p.vmin, vmax=p.vmax)


def compile_clamp_parameter(
    compiler: "TorchCompiler", p: syp.ClampParameter
) -> tp.TorchParameterNode:
    return tp.TorchClampParameter(*p.in_shapes, vmin=p.vmin, vmax=p.vmax)


def compile_polynomial_differential(
    compiler: "TorchCompiler", p: syp.PolynomialDifferential
) -> tp.TorchParameterNode:
    return tp.TorchPolynomialDifferential(*p.in_shapes, order=p.order)


_SIMPLE_PARAM_RULES: dict[type, type] = {
    syp.SumParameter: tp.TorchSumParameter,
    syp.HadamardParameter: tp.TorchHadamardParameter,
    syp.KroneckerParameter: tp.TorchKroneckerParameter,
    syp.ExpParameter: tp.TorchExpParameter,
    syp.LogParameter: tp.TorchLogParameter,
    syp.SquareParameter: tp.TorchSquareParameter,
    syp.SoftplusParameter: tp.TorchSoftplusParameter,
    syp.SigmoidParameter: tp.TorchSigmoidParameter,
    syp.ConjugateParameter: tp.TorchConjugateParameter,
    syp.MixingWeightParameter: tp.TorchMixingWeightParameter,
    syp.GaussianProductMean: tp.TorchGaussianProductMean,
    syp.GaussianProductStddev: tp.TorchGaussianProductStddev,
    syp.GaussianProductLogPartition: tp.TorchGaussianProductLogPartition,
    syp.PolynomialProduct: tp.TorchPolynomialProduct,
}

_AXIS_PARAM_RULES: dict[type, type] = {
    syp.OuterProductParameter: tp.TorchOuterProductParameter,
    syp.OuterSumParameter: tp.TorchOuterSumParameter,
    syp.ReduceSumParameter: tp.TorchReduceSumParameter,
    syp.ReduceProductParameter: tp.TorchReduceProductParameter,
    syp.ReduceLSEParameter: tp.TorchReduceLSEParameter,
    syp.SoftmaxParameter: tp.TorchSoftmaxParameter,
    syp.LogSoftmaxParameter: tp.TorchLogSoftmaxParameter,
}


def default_parameter_rules() -> dict[type, object]:
    rules: dict[type, object] = {
        syp.TensorParameter: compile_tensor_parameter,
        syp.ConstantParameter: compile_tensor_parameter,
        syp.ReferenceParameter: compile_reference_parameter,
        syp.IndexParameter: compile_index_parameter,
        syp.ScaledSigmoidParameter: compile_scaled_sigmoid_parameter,
        syp.ClampParameter: compile_clamp_parameter,
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


def compile_embedding_layer(compiler: "TorchCompiler", sl: syl.EmbeddingLayer) -> tl.TorchLayer:
    return tl.TorchEmbeddingLayer(
        _scope_idx(sl),
        sl.num_output_units,
        num_states=sl.num_states,
        weight=compiler.compile_parameter(sl.weight),
        semiring=compiler.semiring,
    )


def compile_binomial_layer(compiler: "TorchCompiler", sl: syl.BinomialLayer) -> tl.TorchLayer:
    probs = None if sl.probs is None else compiler.compile_parameter(sl.probs)
    logits = None if sl.logits is None else compiler.compile_parameter(sl.logits)
    return tl.TorchBinomialLayer(
        _scope_idx(sl),
        sl.num_output_units,
        total_count=sl.total_count,
        probs=probs,
        logits=logits,
        semiring=compiler.semiring,
    )


def compile_gaussian_layer(compiler: "TorchCompiler", sl: syl.GaussianLayer) -> tl.TorchLayer:
    log_partition = (
        None if sl.log_partition is None else compiler.compile_parameter(sl.log_partition)
    )
    return tl.TorchGaussianLayer(
        _scope_idx(sl),
        sl.num_output_units,
        mean=compiler.compile_parameter(sl.mean),
        stddev=compiler.compile_parameter(sl.stddev),
        log_partition=log_partition,
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


def compile_evidence_layer(compiler: "TorchCompiler", sl: syl.EvidenceLayer) -> tl.TorchLayer:
    # the inner layer first, then the observation: the JAX compiler's slot order
    inner = compiler.compile_layer_node(sl.layer)
    return tl.TorchEvidenceLayer(
        inner,
        observation=compiler.compile_parameter(sl.observation),
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
    compile_categorical_layer,
    compile_embedding_layer,
    compile_binomial_layer,
    compile_gaussian_layer,
    compile_polynomial_layer,
    compile_constant_value_layer,
    compile_evidence_layer,
    compile_hadamard_layer,
    compile_kronecker_layer,
    compile_sum_layer,
]
