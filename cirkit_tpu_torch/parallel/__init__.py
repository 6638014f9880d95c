"""Training and tensor parallelism: the counterpart of ``cirkit_tpu.parallel``
for maximum likelihood (one device, data parallelism and ZeRO-1 over a
``torch.distributed`` DeviceMesh), EM, and tensor parallelism over the unit
axis."""

from cirkit_tpu_torch.parallel.em import em_programs, em_slots, fit_em
from cirkit_tpu_torch.parallel.optimizers import AdamLowMem, adam_lowmem
from cirkit_tpu_torch.parallel.tensor import (
    shard_store_tp,
    tp_forward,
    tp_routing_descriptor,
    tp_slot_specs,
    tp_train_step,
)
from cirkit_tpu_torch.parallel.training import (
    Preempted,
    data_parallel_step,
    default_mesh,
    evaluate_ll,
    fit,
    replicate_store,
    shard_batch,
    shard_opt_state_zero1,
    split_trainable,
    zero1_state_shardings,
)

__all__ = [
    "AdamLowMem",
    "Preempted",
    "adam_lowmem",
    "data_parallel_step",
    "default_mesh",
    "em_programs",
    "em_slots",
    "evaluate_ll",
    "fit",
    "fit_em",
    "replicate_store",
    "shard_batch",
    "shard_opt_state_zero1",
    "shard_store_tp",
    "split_trainable",
    "tp_forward",
    "tp_routing_descriptor",
    "tp_slot_specs",
    "tp_train_step",
    "zero1_state_shardings",
]
