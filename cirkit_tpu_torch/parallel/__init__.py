"""Training on one device: the counterpart of ``cirkit_tpu.parallel`` for
maximum likelihood (EM, tensor parallelism and the device mesh are not
ported yet)."""

from cirkit_tpu_torch.parallel.optimizers import AdamLowMem, adam_lowmem
from cirkit_tpu_torch.parallel.training import (
    Preempted,
    data_parallel_step,
    evaluate_ll,
    fit,
    split_trainable,
)

__all__ = [
    "AdamLowMem",
    "Preempted",
    "adam_lowmem",
    "data_parallel_step",
    "evaluate_ll",
    "fit",
    "split_trainable",
]
