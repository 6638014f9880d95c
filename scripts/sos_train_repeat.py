"""Whether maximum-likelihood training of a squared circuit repeats exactly.

Builds ``bench.py``'s sum-of-squares circuit (``bench_sos``: CP on a quad
tree, K=32, unconstrained normal sum weights) under the signed semiring on
the CUDA card, with the store (seed 0) and batch of phase 9 of
``chip_smoke.py``, and runs the loop of that phase twice from the same
store: ``--steps`` Adam(5e-2) steps on the SoS loss ``-mean(log|c(x)|^2) +
log Z``, first with PyTorch's default algorithms, then with
``torch.use_deterministic_algorithms(True)``. Prints each run's losses. The
signed kernels sum in a fixed order; where two default runs part, another
op of the backward does not.

    python3 scripts/sos_train_repeat.py [--side 12] [--steps 10]
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

# cuBLAS repeats its results only with a fixed workspace; set before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cirkit_tpu_torch.models import image_data  # noqa: E402
from cirkit_tpu_torch.models.utils import Parameterization  # noqa: E402
from cirkit_tpu_torch.parallel import split_trainable  # noqa: E402
from cirkit_tpu_torch.pipeline import PipelineContext  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--side", type=int, default=12)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()

    sc = image_data((1, args.side, args.side), "quad-tree-2", input_layer="categorical",
                    num_input_units=32, sum_product_layer="cp", num_sum_units=32,
                    sum_weight_param=Parameterization(activation="none", initialization="normal"))
    ctx = PipelineContext(semiring="signed-lse-sum", fold=True, optimize=True, seed=0)
    cc = ctx.compile(sc)
    sq = ctx.multiply(ctx.conjugate(cc), cc)
    zc = ctx.integrate(sq)
    rng = np.random.default_rng(0)  # the batch of bench.py:222-224
    d = args.side * args.side
    x = torch.as_tensor(rng.integers(0, 256, (128, d), dtype=np.int32).astype(np.int64),
                        device=ctx.device)
    trainable, _ = split_trainable(cc, ctx.parameters)
    frozen = {k: v.detach() for k, v in ctx.parameters.items() if k not in trainable}

    def run() -> list[float]:
        tr = {k: v.detach().clone().requires_grad_() for k, v in sorted(trainable.items())}
        opt = torch.optim.Adam(list(tr.values()), lr=5e-2)
        losses = []
        for _ in range(args.steps):
            opt.zero_grad(set_to_none=True)
            st = {**tr, **frozen}
            loss = -sq.evaluate(st, x)[0].mean() + zc.evaluate(st, x[:1])[0][0, 0, 0]
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        return losses

    for deterministic in (False, True):
        torch.use_deterministic_algorithms(deterministic)
        for n in (1, 2):
            losses = run()
            print(f"{'deterministic' if deterministic else 'default'} algorithms, run {n}: "
                  + " ".join(f"{v:.6f}" for v in losses))
    return 0


if __name__ == "__main__":
    sys.exit(main())
