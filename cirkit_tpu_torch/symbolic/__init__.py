"""The symbolic circuit IR: layers, parameters, circuits and operators.

Symbolic objects never allocate tensors; the backend decides precision,
folding and kernels (see ``cirkit_tpu/backend``).
"""

from cirkit_tpu_torch.symbolic import functional
from cirkit_tpu_torch.symbolic.circuit import (
    Circuit,
    CircuitBlock,
    CircuitOperation,
    CircuitOperator,
    StructuralProperties,
    StructuralPropertyError,
    are_compatible,
    pipeline_topological_ordering,
)
from cirkit_tpu_torch.symbolic.dtypes import DataType, dtype_value
from cirkit_tpu_torch.symbolic.initializers import (
    ConstantTensorInitializer,
    DirichletInitializer,
    ElementwiseInitializer,
    Initializer,
    NormalInitializer,
    UniformInitializer,
)
from cirkit_tpu_torch.symbolic.layers import (
    BinomialLayer,
    CategoricalLayer,
    ConstantLayer,
    ConstantValueLayer,
    EmbeddingLayer,
    EvidenceLayer,
    GaussianLayer,
    HadamardLayer,
    InputLayer,
    KroneckerLayer,
    Layer,
    LayerOperator,
    PolynomialLayer,
    ProductLayer,
    SumLayer,
)
from cirkit_tpu_torch.symbolic.parameters import (
    ClampParameter,
    ConjugateParameter,
    ConstantParameter,
    ExpParameter,
    GaussianProductLogPartition,
    GaussianProductMean,
    GaussianProductStddev,
    HadamardParameter,
    IndexParameter,
    KroneckerParameter,
    LogParameter,
    LogSoftmaxParameter,
    MixingWeightParameter,
    OuterProductParameter,
    OuterSumParameter,
    Parameter,
    ParameterFactory,
    ParameterInput,
    ParameterNode,
    ParameterOp,
    PolynomialDifferential,
    PolynomialProduct,
    ReduceLSEParameter,
    ReduceProductParameter,
    ReduceSumParameter,
    ReferenceParameter,
    ScaledSigmoidParameter,
    SigmoidParameter,
    SoftmaxParameter,
    SoftplusParameter,
    SquareParameter,
    SumParameter,
    TensorParameter,
    mixing_weight_factory,
)
from cirkit_tpu_torch.symbolic.registry import OPERATOR_REGISTRY, OperatorRegistry
