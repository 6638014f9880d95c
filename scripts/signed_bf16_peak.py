"""Device memory of the signed K=64 Tucker flagship's forward from a bf16
weight store against its float32 store, for one or more source trees.

Run on a machine with one CUDA card, from the root of a checkout:

    python3 scripts/signed_bf16_peak.py [ROOT ...]

Each ROOT (default: this checkout) is the root of a checkout of the port;
each runs in a process of its own that imports that tree's
``cirkit_tpu_torch`` (and builds its kernels there, under ``ROOT/build``).
The flagship of ``chip_smoke.py``'s phases 4 and 18b (the MNIST QuadGraph
Tucker circuit at K=64, batch 128) is compiled under ``signed-lse-sum`` with
the seed-0 store of its ``lse-sum`` compile loaded by slot name. For the
float32 store and its ``bf16_weight_store``, the script prints one JSON line:
the store's GB, the forward's device peak above the memory held before it
(``torch.cuda.max_memory_allocated`` after a reset) and its median ms of 10
(CUDA events, after 2 warm-ups). A tree whose signed ops widen a bf16 weight
before the kernel pays that copy in the peak.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

_CHILD = r"""
import json, statistics, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from cirkit_tpu_torch.backend.torch import bf16_weight_store
from cirkit_tpu_torch.models import image_data
from cirkit_tpu_torch.pipeline import PipelineContext

sc = image_data((1, 28, 28), "quad-graph", input_layer="categorical", num_input_units=64,
                sum_product_layer="tucker", num_sum_units=64)
lse = PipelineContext(semiring="lse-sum", fold=True, optimize=True, device="cuda", seed=0)
lse.compile(sc)
ctx = PipelineContext(semiring="signed-lse-sum", fold=True, optimize=True, device="cuda", seed=0)
cc = ctx.compile(sc)
ctx.update_parameters(lse.parameters)
st32 = {k: v.detach() for k, v in cc.restrict_store(ctx.parameters).items()}
stores = {"float32": st32, "bf16": bf16_weight_store(cc, st32)}
x = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (128, 784)), device="cuda")
out = {"root": sys.argv[1]}
with torch.inference_mode():
    for name, st in stores.items():
        cc.evaluate(st, x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        cc.evaluate(st, x)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        for _ in range(2):
            cc.evaluate(st, x)
        times = []
        for _ in range(10):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            cc.evaluate(st, x)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        gb = sum(v.numel() * v.element_size() for v in st.values()) / 1e9
        out[name] = {"store_gb": round(gb, 3), "forward_peak_gb": round(peak, 3),
                     "forward_ms": round(statistics.median(times), 3)}
print(json.dumps(out))
"""


def main() -> int:
    roots = [Path(p).resolve() for p in sys.argv[1:]] or [Path(__file__).resolve().parents[1]]
    for root in roots:
        proc = subprocess.run([sys.executable, "-c", _CHILD, str(root)], capture_output=True,
                              text=True, cwd=root, check=False)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip()
    print(json.dumps({"card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
