"""Which ``torch.distributed`` collectives a backend takes on CUDA tensors.

Run from the root of a checkout on a machine with a CUDA card:

    python3 scripts/collectives_probe.py

It starts one NCCL rank, then two gloo ranks sharing card 0 (NCCL refuses
two ranks on one card), with ``cirkit_tpu_torch.parallel.launch.run_ranks``,
and tries each collective the port's distributed paths use, and a few more,
on float32 and int64 CUDA tensors: plain, then on the group of a CUDA
``DeviceMesh``, then a ``torch.distributed.checkpoint`` save and load of a
sharded ``DTensor``. It prints, per backend and rank, ``ok`` with the first
values or the error.
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

COLLECTIVES = ("all_reduce", "all_reduce_max_int64", "broadcast", "all_gather",
               "all_gather_into_tensor", "reduce_scatter_tensor", "reduce_scatter", "barrier",
               "all_to_all_single")


def _try(op: str, rank: int, world: int, group) -> str:
    import torch
    import torch.distributed as dist

    t = torch.arange(8, dtype=torch.float32, device="cuda") + rank
    try:
        if op == "all_reduce":
            dist.all_reduce(t, group=group)
        elif op == "all_reduce_max_int64":
            t = t.long()
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        elif op == "broadcast":
            dist.broadcast(t, dist.get_global_rank(group, 0) if group else 0, group=group)
        elif op == "all_gather":
            parts = [torch.empty_like(t) for _ in range(world)]
            dist.all_gather(parts, t, group=group)
            t = torch.cat(parts)
        elif op == "all_gather_into_tensor":
            out = t.new_empty(world * 8)
            dist.all_gather_into_tensor(out, t, group=group)
            t = out
        elif op == "reduce_scatter_tensor":
            out = t.new_empty(8 // world)
            dist.reduce_scatter_tensor(out, t, group=group)
            t = out
        elif op == "reduce_scatter":
            out = t.new_empty(8 // world)
            dist.reduce_scatter(out, list(t.chunk(world)), group=group)
            t = out
        elif op == "barrier":
            dist.barrier(group=group)
        else:
            out = torch.empty_like(t)
            dist.all_to_all_single(out, t, group=group)
            t = out
        torch.cuda.synchronize()
        return f"ok {t.tolist()[:4]}"
    except Exception as exc:  # noqa: BLE001 - the probe reports every failure
        return f"FAIL {type(exc).__name__}: {str(exc)[:160]}"


def _rank(rank: int, ckdir: str) -> dict:
    import torch
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard

    torch.cuda.set_device(0)
    world = dist.get_world_size()
    out = {"plain": {op: _try(op, rank, world, None) for op in COLLECTIVES}}
    mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("data",))
    out["mesh"] = {op: _try(op, rank, world, mesh.get_group("data")) for op in COLLECTIVES}
    try:
        part = torch.full((2, 3), float(rank), device="cuda")
        dcp.save({"a": DTensor.from_local(part, mesh, [Shard(0)], run_check=False)},
                 checkpoint_id=ckdir)
        back = {"a": DTensor.from_local(torch.zeros(2, 3, device="cuda"), mesh, [Shard(0)],
                                        run_check=False)}
        dcp.load(back, checkpoint_id=ckdir)
        out["dcp"] = f"ok {back['a'].to_local()[:, 0].tolist()}"
    except Exception as exc:  # noqa: BLE001
        out["dcp"] = f"FAIL {type(exc).__name__}: {str(exc)[:160]}"
    return out


def main() -> int:
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from cirkit_tpu_torch.parallel.launch import run_ranks

    if not torch.cuda.is_available():
        raise RuntimeError("the probe needs a CUDA card")
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0))
    for backend, world in (("nccl", 1), ("gloo", 2)):
        with tempfile.TemporaryDirectory() as ckdir:
            results = run_ranks(_rank, world, ckdir, backend=backend, threads=None)
        for r, res in enumerate(results):
            print(backend, f"rank {r} of {world}", json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
