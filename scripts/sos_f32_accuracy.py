"""How far a squared circuit's float32 evaluation is from float64.

Builds ``bench.py``'s sum-of-squares circuit (``bench_sos``: CP on a quad
tree, unconstrained normal sum weights) with the PyTorch port, its store made
on ``--device`` from seed 0 (on ``cuda``, the store and batch of phase 9 of
``chip_smoke.py``), and evaluates ``cc``, its square ``sq =
multiply(conjugate(cc), cc)``, the integral ``zc = integrate(sq)`` and
``IntegrateQuery`` marginals (50% mask) on a random batch in float32 on that
device (on a card through the signed kernels; on the CPU through their plain
versions) and, when the device is a card, in float32 on the CPU and in
float64 on the card too (the kernels' double instances), each against
float64 on the CPU. Prints, per output and path, the
relative error of the log-values over the rows (max, 90th percentile,
median) and the signs that differ from float64; then the largest
cancellation ratio of a TensorDot entry (its absolute mass, the same
contraction with |w| and signs +1, over |y|), the factor by which that entry
amplifies its inputs' rounding; then, for each group of 8 rows, the
gradients of the SoS loss ``-mean(log|c(x)|^2) + log Z`` with respect to
``cc``'s learnable slots, as the worst share of ``chip_smoke.py``'s gradient
bound ``2e-3 max|slot| + 1e-4`` (max and median over the groups).

    python3 scripts/sos_f32_accuracy.py [--side 12] [--k 32] [--batch 128] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cirkit_tpu_torch.backend.torch import IntegrateQuery  # noqa: E402
from cirkit_tpu_torch.backend.torch.compiler import TorchCompiler  # noqa: E402
from cirkit_tpu_torch.backend.torch.optimized import TorchTensorDotLayer  # noqa: E402
from cirkit_tpu_torch.backend.torch.parameters import TorchTensorSlot  # noqa: E402
from cirkit_tpu_torch.models import image_data  # noqa: E402
from cirkit_tpu_torch.models.utils import Parameterization  # noqa: E402
from cirkit_tpu_torch.parallel import split_trainable  # noqa: E402
from cirkit_tpu_torch.pipeline import PipelineContext  # noqa: E402

GRAD_ROWS, GRAD_REL, GRAD_ABS = 8, 2e-3, 1e-4  # chip_smoke.py's gradient check


def _outputs(circuits, store, x, mask) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
    cc, sq, zc = circuits
    with torch.no_grad():
        outs = {"cc": cc.evaluate(store, x), "sq": sq.evaluate(store, x),
                "log Z": zc.evaluate(store, x[:1]),
                "marginals": IntegrateQuery(sq)(x, integrate_vars=mask, store=store)}
    return {k: (a.double().cpu(), s.double().cpu()) for k, (a, s) in outs.items()}


def _grads(circuits, store, x, trainable) -> dict[str, torch.Tensor]:
    _, sq, zc = circuits
    tr = {k: store[k].clone().requires_grad_() for k in trainable}
    st = {**store, **tr}
    loss = -sq.evaluate(st, x)[0].mean() + zc.evaluate(st, x[:1])[0][0, 0, 0]
    return {k: g.double().cpu() for k, g in zip(tr, torch.autograd.grad(loss, list(tr.values())))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--side", type=int, default=12)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()

    sc = image_data((1, args.side, args.side), "quad-tree-2", input_layer="categorical",
                    num_input_units=args.k, sum_product_layer="cp", num_sum_units=args.k,
                    sum_weight_param=Parameterization(activation="none", initialization="normal"))
    ctx = PipelineContext(semiring="signed-lse-sum", fold=True, optimize=True,
                          device=args.device, seed=0)
    cc = ctx.compile(sc)
    sq = ctx.multiply(ctx.conjugate(cc), cc)
    zc = ctx.integrate(sq)
    comp = TorchCompiler(semiring="signed-lse-sum", fold=True, optimize=True, device="cpu")
    on_cpu = tuple(comp.compile(ctx.get_symbolic_circuit(c)) for c in (cc, sq, zc))
    rng = np.random.default_rng(0)  # the batch and 50% mask of bench.py:222-224
    d = args.side * args.side
    x = torch.as_tensor(rng.integers(0, 256, (args.batch, d), dtype=np.int32).astype(np.int64))
    mask = torch.as_tensor(rng.random((args.batch, d)) < 0.5)

    store = {k: v.detach() for k, v in ctx.parameters.items()}
    st64 = {k: v.cpu().double() for k, v in store.items()}
    # each path held against float64 on the CPU: (circuits, store, batch, mask)
    paths = {f"float32 on {args.device}": ((cc, sq, zc), store, x.to(ctx.device),
                                           mask.to(ctx.device))}
    if ctx.device.type != "cpu":
        paths["float32 on cpu"] = (on_cpu, {k: v.cpu() for k, v in store.items()}, x, mask)
        paths[f"float64 on {args.device}"] = ((cc, sq, zc), {k: v.double() for k, v in store.items()},
                                              x.to(ctx.device), mask.to(ctx.device))

    want = _outputs(on_cpu, st64, x, mask)
    for label, (circuits, st, xs, ms) in paths.items():
        for name, (a, s) in _outputs(circuits, st, xs, ms).items():
            wa, ws = want[name]
            rel = ((a - wa) / wa).abs().flatten().numpy()
            print(f"{label}, {name}: relative error of the log-values max {rel.max():.3e}, "
                  f"p90 {np.quantile(rel, 0.9):.3e}, median {np.median(rel):.3e} over "
                  f"{rel.size}; {int((s != ws).sum())} signs differ")

    # the cancellation ratio of each TensorDot entry of sq, in float64
    weights = {n.slot for layer in cc.layers if hasattr(layer, "weight")
               for n in layer.weight.nodes if isinstance(n, TorchTensorSlot)}
    st_abs = {k: (v.abs() if k in weights else v) for k, v in st64.items()}
    worst = [0.0]

    def ratio(layer, store, xin):
        y = layer(store, xin)
        if isinstance(layer, TorchTensorDotLayer):
            mass = layer(st_abs, (xin[0], torch.ones_like(xin[1])))[0]
            worst[0] = max(worst[0], float(torch.exp(mass - y[0]).max()))
        return y

    with torch.no_grad():
        on_cpu[1].evaluate(st64, x, module_fn=ratio)
    print(f"largest cancellation ratio of a TensorDot entry of sq: {worst[0]:.3e}")

    # the SoS loss's gradients on each group of GRAD_ROWS rows
    trainable, _ = split_trainable(cc, ctx.parameters)
    shares: dict[str, list[float]] = {label: [] for label in paths}
    for r0 in range(0, args.batch - GRAD_ROWS + 1, GRAD_ROWS):
        rows = slice(r0, r0 + GRAD_ROWS)
        ref = _grads(on_cpu, st64, x[rows], trainable)
        for label, (circuits, st, xs, _) in paths.items():
            got = _grads(circuits, st, xs[rows], trainable)
            shares[label].append(max(
                float((got[k] - r).abs().max()) / (GRAD_REL * float(r.abs().max()) + GRAD_ABS)
                for k, r in ref.items()))
    for label, s in shares.items():
        print(f"{label}, SoS loss gradients of {len(trainable)} learnable slots on {len(s)} "
              f"groups of {GRAD_ROWS} rows: worst error per group max {max(s):.3f}, median "
              f"{np.median(s):.3f} of the bound {GRAD_REL} max|slot| + {GRAD_ABS}; "
              f"{sum(v > 1 for v in s)} groups above it (first group {s[0]:.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
