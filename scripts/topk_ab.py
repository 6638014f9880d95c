"""Time top-k MPE (``MAPQuery(top_k=4)``) on one card with four ways of
taking the top T of a row of candidates, all with the tie rule of a stable
descending sort, and the peak memory of each.

Run on a machine with a CUDA card, from the root of a checkout:

    python3 scripts/topk_ab.py

On ``chip_smoke.py``'s Tucker flagship (K=64, seed 0) with ``bench.py``'s
batch and 50% mask (the first 1 and 4 rows), each design replaces
``topk._top`` (the top T of a row) and ``topk._mix_topk`` (the top T of a
sum-style entry's (column, rank) candidates):

- ``sort``: every candidate row sorted, ``torch.sort(descending=True,
  stable=True)``, its first T taken as views (so each chunk's sorted
  buffers stay alive until the chunks are joined);
- ``cumsum``: the T-th value from ``torch.topk``, the candidates above it
  and the lowest-index ones equal to it by a cumulative count of the ties,
  a stable sort of the T kept;
- ``keys``: float32 score and index packed into distinct int64 keys, one
  ``torch.topk`` a row (``topk._top``);
- ``leaders`` (the shipped ``topk._mix_topk``): the T columns whose first
  candidates lead, then their T*T candidates, each through ``topk._top``.

The first three take every (column, rank) candidate of a sum-style entry
(3.3 GB a row at the F=784 entry). Each design's median ms of 5 calls after
a warm-up, its peak memory above what was allocated before the call,
whether its scores and assignments equal the shipped design's to the bit,
and at batch 4 the device ms of one call by ``torch.profiler``: in all and
for its five largest kernels. Prints the card's name and power limit first.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cirkit_tpu_torch.backend.torch import MAPQuery  # noqa: E402
from cirkit_tpu_torch.backend.torch import topk as TK  # noqa: E402
from cirkit_tpu_torch.models import image_data  # noqa: E402
from cirkit_tpu_torch.pipeline import PipelineContext  # noqa: E402


def _sort_views(cand, t):
    vals, idx = torch.sort(cand, dim=-1, descending=True, stable=True)
    return vals[..., :t], idx[..., :t]


def _cumsum(cand, t):
    n = cand.shape[-1]
    thr = torch.topk(cand, t, dim=-1).values.amin(dim=-1, keepdim=True)
    above, ties = cand > thr, cand == thr
    need = t - above.sum(dim=-1, keepdim=True, dtype=torch.int32)
    take = above | (ties & (torch.cumsum(ties, dim=-1, dtype=torch.int32) <= need))
    pos = torch.arange(n, 0, -1, dtype=torch.int32, device=cand.device)
    idx = torch.topk(torch.where(take, pos, 0), t, dim=-1).indices
    vals = torch.gather(cand, -1, idx)
    order = torch.sort(vals, dim=-1, descending=True, stable=True).indices
    return torch.gather(vals, -1, order), torch.gather(idx, -1, order)


def _all_candidates(w, lists, t):
    """The top t of every candidate ``w[..., c] + lists[..., c, r]``."""
    cand = w[..., None] + lists
    return TK._top(cand.reshape(*cand.shape[:-2], -1), t)


SHIPPED = (TK._top, TK._mix_topk)
DESIGNS = {
    "sort": (_sort_views, _all_candidates),
    "cumsum": (_cumsum, _all_candidates),
    "keys": (SHIPPED[0], _all_candidates),
    "leaders": SHIPPED,
}


def _median_ms(fn, iters=5):
    fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_split(fn) -> str:
    """Device ms of one call of ``fn`` (after a warm-up): in all, and of its
    five largest kernels by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    parts: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            name = e.key.removeprefix("void ").split("<")[0].split("(")[0].split("::")[-1]
            parts[name] = parts.get(name, 0.0) + e.self_device_time_total / 1e3
    top = sorted(parts.items(), key=lambda i: -i[1])[:5]
    return f"device {sum(parts.values()):.3f} ms: " + ", ".join(f"{k} {v:.3f}" for k, v in top)


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    sc = image_data((1, 28, 28), "quad-graph", input_layer="categorical", num_input_units=64,
                    sum_product_layer="tucker", num_sum_units=64)
    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True, device="cuda", seed=0)
    cc = ctx.compile(sc)
    rng = np.random.default_rng(0)  # the batch and 50% mask of bench.py:222-224
    x = torch.as_tensor(rng.integers(0, 256, size=(128, 784), dtype=np.int32).astype(np.int64),
                        device="cuda")
    mask = torch.as_tensor(rng.random((128, 784)) < 0.5, device="cuda")
    mq = MAPQuery(cc)
    for b in (1, 4):
        want = None
        for name in ("leaders", "keys", "cumsum", "sort"):
            TK._top, TK._mix_topk = DESIGNS[name]

            def call(b=b):
                return mq(x[:b], evidence_mask=mask[:b], top_k=4, store=ctx.parameters)

            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            asg, scores = call()
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 1e9
            if want is None:
                want = (asg, scores)
            same = torch.equal(asg, want[0]) and torch.equal(scores, want[1])
            print(f"[topk] {name:8s} batch {b}: {_median_ms(call):.3f} ms median of 5, peak "
                  f"{peak:.2f} GB above what was allocated, equal to leaders: {same} ({smi})")
            del asg, scores
            if b == 4:
                print(f"[topk] {name:8s} batch {b}: {_device_split(call)}")
        TK._top, TK._mix_topk = SHIPPED


if __name__ == "__main__":
    main()
