"""Whether maximum-likelihood training of a squared circuit repeats exactly.

Builds ``bench.py``'s sum-of-squares circuit (``bench_sos``: CP on a quad
tree, K=32, unconstrained normal sum weights) under the signed semiring on
the CUDA card, with the store (seed 0) and batch of phase 9 of
``chip_smoke.py``, and runs the loop of that phase twice from the same
store: ``--steps`` Adam(5e-2) steps on the SoS loss ``-mean(log|c(x)|^2) +
log Z``, first with PyTorch's default algorithms, then with
``torch.use_deterministic_algorithms(True)``. Prints each run's losses and
the median time of a step (CUDA events around each step; the first run's
includes the kernels' build and warm-up). The
signed kernels sum in a fixed order; where two default runs part, another
op of the backward does not. ``--diagnose`` narrows it down: the gradients
of the first loss are taken twice with the default algorithms and the slots
whose bits differ are listed (a ``scatter_add_`` of atomic adds, such as
the backward of ``torch.gather``, adds three or more rows that share an
index in no fixed order). ``--semiring complex-lse-sum`` trains
the same circuit under the complex semiring, and ``--model tucker`` the K=64
Tucker flagship under ``lse-sum`` (batch 128, Adam(1e-2) on its
log-likelihood) instead.

    python3 scripts/sos_train_repeat.py [--side 12] [--steps 10] [--diagnose]
        [--semiring signed-lse-sum] [--model sos]
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


def diagnose(trainable, frozen, loss_of) -> int:
    """Name the slots whose gradient does not repeat between two backward
    passes of the first loss, with PyTorch's default algorithms."""
    grads = []
    for _ in range(2):
        tr = {k: v.detach().clone().requires_grad_() for k, v in sorted(trainable.items())}
        loss_of({**tr, **frozen}).backward()
        grads.append({k: v.grad for k, v in tr.items()})
    differ = {k: tuple(g.shape) for k, g in grads[0].items() if not torch.equal(g, grads[1][k])}
    print(f"slots whose gradient differs between two backward passes: {differ or 'none'}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--side", type=int, default=12)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--semiring", default="signed-lse-sum",
                    choices=["signed-lse-sum", "complex-lse-sum"])
    ap.add_argument("--model", default="sos", choices=["sos", "tucker"])
    ap.add_argument("--diagnose", action="store_true")
    args = ap.parse_args()

    rng = np.random.default_rng(0)  # the batch of bench.py:222-224
    if args.model == "tucker":
        sc = image_data((1, 28, 28), "quad-graph", input_layer="categorical",
                        num_input_units=64, sum_product_layer="tucker", num_sum_units=64)
        ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True, seed=0)
        cc = ctx.compile(sc)
        d, lr = 28 * 28, 1e-2
    else:
        sc = image_data((1, args.side, args.side), "quad-tree-2", input_layer="categorical",
                        num_input_units=32, sum_product_layer="cp", num_sum_units=32,
                        sum_weight_param=Parameterization(activation="none",
                                                          initialization="normal"))
        ctx = PipelineContext(semiring=args.semiring, fold=True, optimize=True, seed=0)
        cc = ctx.compile(sc)
        sq = ctx.multiply(ctx.conjugate(cc), cc)
        zc = ctx.integrate(sq)
        d, lr = args.side * args.side, 5e-2
    x = torch.as_tensor(rng.integers(0, 256, (128, d), dtype=np.int32).astype(np.int64),
                        device=ctx.device)
    trainable, _ = split_trainable(cc, ctx.parameters)
    frozen = {k: v.detach() for k, v in ctx.parameters.items() if k not in trainable}

    def value(out):  # the real part or log-magnitude of a circuit's output
        return out.real if torch.is_tensor(out) else out[0]

    def loss_of(st):
        if args.model == "tucker":
            return -cc.evaluate(st, x).mean()
        return -value(sq.evaluate(st, x)).mean() + value(zc.evaluate(st, x[:1]))[0, 0, 0]

    def run() -> tuple[list[float], float]:
        """The losses of ``--steps`` Adam steps and the median step's ms."""
        tr = {k: v.detach().clone().requires_grad_() for k, v in sorted(trainable.items())}
        opt = torch.optim.Adam(list(tr.values()), lr=lr)
        losses, ticks = [], [torch.cuda.Event(enable_timing=True) for _ in range(args.steps + 1)]
        ticks[0].record()
        for tick in ticks[1:]:
            opt.zero_grad(set_to_none=True)
            loss = loss_of({**tr, **frozen})
            loss.backward()
            opt.step()
            losses.append(loss.detach())
            tick.record()
        torch.cuda.synchronize()
        ms = sorted(a.elapsed_time(b) for a, b in zip(ticks, ticks[1:]))
        return [float(v) for v in losses], ms[len(ms) // 2]

    if args.diagnose:
        return diagnose(trainable, frozen, loss_of)

    for deterministic in (False, True):
        torch.use_deterministic_algorithms(deterministic)
        for n in (1, 2):
            losses, ms = run()
            print(f"{'deterministic' if deterministic else 'default'} algorithms, run {n}, "
                  f"median step {ms:.3f} ms: " + " ".join(f"{v:.6f}" for v in losses))
    return 0


if __name__ == "__main__":
    sys.exit(main())
