"""Model templates: region graphs, data modalities, tensor factorizations,
probabilistic graphical models and logic circuits (the parts of
``cirkit_tpu.models`` that the port carries: the ensembles and the interop
formats call the backend and are not carried yet)."""

from cirkit_tpu_torch.models import logic, region_graph
from cirkit_tpu_torch.models.data_modalities import (
    em_input_parameterizations,
    image_data,
    tabular_data,
)
from cirkit_tpu_torch.models.pgms import fully_factorized, hmm
from cirkit_tpu_torch.models.structure_learning import learn_spn
from cirkit_tpu_torch.models.tensor_factorizations import cp, tensor_train, tucker
from cirkit_tpu_torch.models.utils import (
    InputLayerFactory,
    Parameterization,
    ProductLayerFactory,
    SumLayerFactory,
    name_to_dtype,
    name_to_initializer,
    name_to_input_layer_factory,
    name_to_parameter_activation,
    named_parameterizations_to_factories,
    parameterization_to_factory,
)
