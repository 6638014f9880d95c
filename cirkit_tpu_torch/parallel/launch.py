"""Run a function on N ranks of a fresh ``torch.distributed`` process group.

:func:`run_ranks` spawns N processes (``torch.multiprocessing``'s ``spawn``
start method), joins them in one process group through a ``file://``
rendezvous in a temporary directory, calls ``fn(rank, *args)`` in each, and
returns the ranks' return values in rank order. A rank that raises fails the
launch: the exception is raised again in the parent (after the other ranks
are stopped). The tests run the distributed paths this way on the CPU with
the gloo backend; ``chip_smoke.py`` runs them on the card.

``fn`` and ``args`` are pickled by the spawn start method: ``fn`` must be a
module-level function of an importable module. Return values travel back
through ``torch.save``/``torch.load`` files of the temporary directory, so
they may hold tensors (move CUDA tensors to the CPU first: the parent may
hold no card context).

On a machine with several cards, train with ``torchrun --nproc-per-node=N``
and ``parallel.default_mesh()`` instead; this launcher is for tests and
one-machine checks.
"""

from __future__ import annotations

import os
import tempfile
from collections.abc import Callable
from datetime import timedelta
from typing import Any

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, fn: Callable, args: tuple, world_size: int, backend: str,
               root: str, threads: int | None, timeout_s: float) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    dist.init_process_group(
        backend, init_method=f"file://{root}/rendezvous", world_size=world_size, rank=rank,
        timeout=timedelta(seconds=timeout_s),
    )
    try:
        out = fn(rank, *args)
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(
    fn: Callable[..., Any],
    world_size: int,
    *args: Any,
    backend: str = "gloo",
    threads: int | None = 1,
    timeout_s: float = 600.0,
) -> list[Any]:
    """``[fn(0, *args), ..., fn(world_size - 1, *args)]``, each run in its own
    process of one ``backend`` process group of ``world_size`` ranks.

    ``threads`` sets each rank's ``torch.set_num_threads`` (None keeps
    PyTorch's default); ``timeout_s`` bounds each collective. Raises the
    exception of a rank that failed."""
    if world_size < 1:
        raise ValueError(f"world_size must be at least 1, got {world_size}")
    with tempfile.TemporaryDirectory(prefix="cirkit_ranks_") as root:
        mp.start_processes(
            _rank_main,
            args=(fn, args, world_size, backend, root, threads, timeout_s),
            nprocs=world_size,
            join=True,
            start_method="spawn",
        )
        return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]
