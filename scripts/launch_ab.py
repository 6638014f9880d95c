"""Time the host-bound forwards of two or more source trees side by side on
one card.

Run on a machine with a CUDA card and the CUDA toolkit, from the root of a
checkout, with the roots of the trees to compare (for example the parent
commit unpacked by ``git archive`` into a directory that ``.gitignore``
lists, and ``.`` for this one), in the order to run them:

    python3 scripts/launch_ab.py PARENT . . PARENT

Each tree runs in a process of its own, which imports that tree's
``cirkit_tpu_torch`` (building its kernels into that tree's ``build/``) and
times, at batch 128 on MNIST-sized inputs: the K=64 CP and Tucker flagship
forwards under ``lse-sum`` (``quad-graph``, ``fold=True, optimize=True``),
the CP flagship under ``signed-lse-sum`` on the same store, and the 12x12
squared circuit of ``bench_sos`` (K=32, ``quad-tree-2``, CP): ``sq``'s
forward, the normalized log-likelihood and ``IntegrateQuery`` marginals.
Each time is the median of 20 CUDA-event timings after 3 warm-ups (10 for
the marginals); ``host`` is the median wall time of the call's Python alone,
before the card is waited for, and ``launches`` the kernel launches of one
call. Prints the card's name and power limit, then one JSON line a tree.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

BATCH = 128


def _times(fn, launches, warmup: int = 3, iters: int = 20) -> dict[str, float]:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    before = sum(launches.values())
    fn()
    n = sum(launches.values()) - before
    dev, host = [], []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        dev.append(start.elapsed_time(end))
    return {"ms": statistics.median(dev), "host_ms": statistics.median(host), "launches": n}


def child() -> None:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    from cirkit_tpu_torch.backend.torch import IntegrateQuery
    from cirkit_tpu_torch.models import image_data
    from cirkit_tpu_torch.models.utils import Parameterization
    from cirkit_tpu_torch.ops import lse_einsum as L
    from cirkit_tpu_torch.pipeline import PipelineContext

    rng = np.random.default_rng(0)
    out: dict[str, dict] = {}
    with torch.inference_mode():
        x = torch.as_tensor(rng.integers(0, 256, (BATCH, 784)), device="cuda")
        for spl in ("cp", "tucker"):
            sc = image_data((1, 28, 28), "quad-graph", input_layer="categorical",
                            num_input_units=64, sum_product_layer=spl, num_sum_units=64)
            ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True, device="cuda",
                                  seed=0)
            cc = ctx.compile(sc)
            out[f"{spl} flagship forward"] = _times(lambda: cc(x), L.LAUNCHES)
            if spl == "cp":
                sctx = PipelineContext(semiring="signed-lse-sum", fold=True, optimize=True,
                                       device="cuda", seed=0)
                scc = sctx.compile(sc)
                sctx.update_parameters(ctx.parameters)
                sst = sctx.parameters
                out["cp flagship signed forward"] = _times(lambda: scc.evaluate(sst, x),
                                                           L.LAUNCHES)
                del sctx, scc, sst
            del ctx, cc
        sc = image_data((1, 12, 12), "quad-tree-2", input_layer="categorical",
                        num_input_units=32, sum_product_layer="cp", num_sum_units=32,
                        sum_weight_param=Parameterization(activation="none",
                                                          initialization="normal"))
        ctx = PipelineContext(semiring="signed-lse-sum", fold=True, optimize=True, device="cuda",
                              seed=0)
        cc = ctx.compile(sc)
        sq = ctx.multiply(ctx.conjugate(cc), cc)
        zc = ctx.integrate(sq)
        x = torch.as_tensor(rng.integers(0, 256, (BATCH, 144)), device="cuda")
        mask = torch.as_tensor(rng.random((BATCH, 144)) < 0.5, device="cuda")
        iq, st = IntegrateQuery(sq), ctx.parameters
        out["sos 12x12 sq forward"] = _times(lambda: sq(x), L.LAUNCHES)
        out["sos 12x12 normalized log-likelihood"] = _times(
            lambda: sq(x)[0] - zc(x[:1])[0][0, 0, 0], L.LAUNCHES)
        out["sos 12x12 marginals"] = _times(lambda: iq(x, integrate_vars=mask, store=st),
                                            L.LAUNCHES, iters=10)
    print(json.dumps({"tree": os.getcwd(), "times": out}))


def main() -> int:
    import torch

    if len(sys.argv) == 2 and sys.argv[1] == "--child":
        child()
        return 0
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print(__doc__)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    for tree in sys.argv[1:]:
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child"],
                       cwd=Path(tree).resolve(), check=True)
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
