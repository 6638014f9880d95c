"""The paths of the signed and complex Tucker forwards and backwards, timed
in one or two source trees on one card: ``chip_smoke.py`` phase 9b's signed K=64 Tucker
flagships (logits, and the EM-ready store's linear weights) and phase 10b's
complex one (its softmaxed weights stay real), a forward and one backward
each in the f32-grade mode, ``CIRKIT_TPU_FAST=1`` and ``sr`` (phase 18's
modes), from phase 4's float32 store at batch 128.

Run on a machine with a CUDA card and the CUDA toolkit, from the root of a
checkout, alone or with the root of another tree (for example the parent
commit unpacked by ``git archive`` into a directory that ``.gitignore``
lists):

    python3 scripts/sos_path_ab.py [OTHER_ROOT]

Each tree runs in a process of its own, from its root, with its own
package, ``chip_smoke.py`` helpers and kernel library, the trees in turns
(other, this, this, other). A case's times are medians of 10 CUDA-event
timings after 2 warm-ups (``chip_smoke._median_ms``): the forward alone
(under ``torch.inference_mode``) and a forward with one backward
(``torch.autograd.grad`` of the mean log-likelihood over the store's
tensors); the backward is their difference. Each is then run 5 times under
``torch.profiler`` (``chip_smoke._profile``): the sum of its kernels'
device times a call is the device's busy ms, so a reading that grows while
its busy ms do not is time the card waits on the host. Prints the card's
name and power limit, then a line a case and tree with each turn's times.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
MODES = (("f32_grade", ""), ("bf16_fast", "1"), ("sr", "sr"))

WORKER = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
import chip_smoke as CS
from cirkit_tpu_torch.pipeline import PipelineContext

torch.backends.cuda.matmul.allow_tf32 = False
modes = json.loads(sys.argv[1])
x = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (CS.BATCH, 784)), device="cuda")
rows = {}
for em, semiring in ((False, "signed-lse-sum"), (True, "signed-lse-sum"),
                     (False, "complex-lse-sum")):
    sc, ctx, cc = CS._build_flagship("tucker", em, "cuda")
    sctx = PipelineContext(semiring=semiring, fold=True, optimize=True, device="cuda", seed=0)
    scc = sctx.compile(sc)
    sctx.update_parameters(ctx.parameters)
    st = sctx.parameters

    def value():
        out = scc.evaluate(st, x)
        return out[0] if isinstance(out, tuple) else out.real

    def forward():
        with torch.inference_mode():
            return value()

    def step():
        return torch.autograd.grad(-value().mean(), list(st.values()))

    for mode, env in modes:
        os.environ["CIRKIT_TPU_FAST"] = env
        fwd = CS._median_ms(forward, warmup=2, iters=10)
        both = CS._median_ms(step, warmup=2, iters=10)
        busy = [sum(CS._profile(fn, 5)[1].values()) for fn in (forward, step)]
        rows[f"{semiring} tucker em_ready={em} {mode}"] = (fwd, both, *busy)
    os.environ["CIRKIT_TPU_FAST"] = ""
    del sctx, scc, sc, ctx, cc
print("ROWS " + json.dumps(rows))
"""


def _run(root: Path) -> dict:
    env = {**os.environ, "PYTHONPATH": str(root)}
    proc = subprocess.run([sys.executable, "-c", WORKER, json.dumps(MODES)], cwd=root, env=env,
                          capture_output=True, text=True, check=False)
    line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("ROWS ")), None)
    if proc.returncode != 0 or line is None:
        raise RuntimeError(f"{root}: the worker failed ({proc.returncode}):\n"
                           f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    return json.loads(line.removeprefix("ROWS "))


def main() -> int:
    if len(sys.argv) > 2:
        print(__doc__)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    roots = {"this": REPO}
    if len(sys.argv) == 2:
        roots = {"other": Path(sys.argv[1]).resolve(), **roots}
    order = ("other", "this", "this", "other") if "other" in roots else ("this", "this")
    turns: dict[str, list[dict]] = {name: [] for name in roots}
    for name in order:
        turns[name].append(_run(roots[name]))
    for case in turns["this"][0]:
        for name in roots:
            fwd = [round(t[case][0], 3) for t in turns[name]]
            bwd = [round(t[case][1] - t[case][0], 3) for t in turns[name]]
            busy = [(round(t[case][2], 3), round(t[case][3] - t[case][2], 3))
                    for t in turns[name]]
            print(f"{case:50s} {name:5s} forward ms {fwd}, backward ms {bwd} "
                  f"(forward and backward {[round(t[case][1], 3) for t in turns[name]]}); "
                  f"device busy (forward, backward) ms {busy}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
