"""Model templates: region graphs and data modalities (the parts of
``cirkit_tpu.models`` that the port carries so far)."""

from cirkit_tpu_torch.models import region_graph
from cirkit_tpu_torch.models.data_modalities import (
    em_input_parameterizations,
    image_data,
    tabular_data,
)
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
