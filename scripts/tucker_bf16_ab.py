"""Time the fast-mode Tucker forwards (kernels 1 and 5: the ``_fast``,
``_sr``, ``_w16_fast`` and ``_w16_sr`` instances, linear and with logits),
their backward (kernel 2's fast Tucker instances, kernel 5's backward too)
and the serving forwards and the training backward that run them, of two
source trees side by side on one card.

Run on a machine with a CUDA card and the CUDA toolkit, from the root of a
checkout, with the root of another tree (for example the parent commit
unpacked by ``git archive`` into a directory that ``.gitignore`` lists):

    python3 scripts/tucker_bf16_ab.py OTHER_ROOT [--no-serving] [--no-forward]

Each tree's kernel library is built by its own ``ops/_build.py`` (into its
own ``build/``), and the port's op wrappers are pointed at one library or
the other in turns (other, this, this, other; ``ab_turns.py``), so both run
the same Python on the same inputs; the two libraries must have the same
entries and signatures:

- every instance of ``lse_fwd_tucker[_softmax]`` at the K=64 Tucker entry
  (F=784, B=128 and 512, K1=K2=O=64) and of ``lse_fwd_ct[_softmax]`` at the
  K=128 one (F=784, B=128, K1=K2=O=128), the f32-grade and ``_w16`` ones
  beside them; the outputs of the two trees held to each other in log space
  with the same -inf pattern: to ``1e-4 + 1e-5 |other|``, and in a fast mode,
  where two trees may round at other points, to the JAX package's fast bound
  ``chip_smoke.FAST_FWD_TOL`` (8e-3);
- every instance of ``lse_bwd_tucker[_softmax]`` (the f32-grade, ``_w16``
  and fast ones) at the K=64 entry (B=128 and 512) and at the K=128 one
  (F=784, B=128 and F=196, B=512), every gradient; the two trees' gradients
  held to each other to ``2e-4 (max|other| + |other|)`` and, where one of
  them is bf16 (a tree whose fast Tucker backward writes the weight's
  gradient in the weight's type, ``tucker_bf16_bwd.cu``), half a bf16 step
  more, ``2^-8 |other|``. A tree without that source gets the float32
  gradient and scratch its entries take (``lse_einsum._bf16_tucker_bwd``
  patched for its turn);
- one forward and backward of the K=64 Tucker flagship's mean NLL at batch
  128 through its bf16 store under ``CIRKIT_TPU_FAST=1`` (``chip_smoke.py``'s
  15c), each slot's gradient of the trees within ``2 chip_smoke.FAST_GRAD_REL
  max(1, max|slot|)`` of each other;
- the serving forward (``cc.evaluate`` of ``chip_smoke.py``'s flagships) of
  the K=64 Tucker flagship at batches 512 and 2048 and of the K=128 one at
  512, in the modes ``f32_grade`` (float32 store) and ``bf16_fast`` (bf16
  store, ``CIRKIT_TPU_FAST=1``), the outputs of the trees held to each other
  relative, to 1e-5 in ``f32_grade`` and to twice ``chip_smoke.SERVE_FAST_RTOL``
  in ``bf16_fast`` (each tree is within it of float64).

Each time is the median of 20 CUDA-event timings after 3 warm-ups (serving:
10 after 2). Prints the card's name and power limit first, then one line a
kernel or run with each tree's times.
"""

from __future__ import annotations

import importlib.util
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from ab_turns import in_turns  # noqa: E402

from cirkit_tpu_torch.ops import _build  # noqa: E402
from cirkit_tpu_torch.ops import lse_einsum as L  # noqa: E402

MODES = (("", ""), ("_w16", ""), ("_fast", "bf16"), ("_sr", "sr"), ("_w16_fast", "bf16"),
         ("_w16_sr", "sr"))
SHAPES = (("lse_tucker2", 784, 128, 64), ("lse_tucker2", 784, 512, 64),
          ("lse_tucker2_chunked", 784, 128, 128))
BWD_SHAPES = ((784, 128, 64), (784, 512, 64), (784, 128, 128), (196, 512, 128))
SERVING = (("tucker", 64, (512, 2048)), ("tucker", 128, (512,)))
FAST_FWD_TOL = 8e-3  # chip_smoke.FAST_FWD_TOL: JAX's fast bound, log space


def _other_build(root: Path):
    """The other tree's ``ops/_build.py``, loaded as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        "other_build", root / "cirkit_tpu_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# each tree's choice of the fast Tucker backward's path (patched into the op
# wrappers for its turn): a tree without tucker_bf16_bwd.cu takes a float32
# weight gradient and the f32-grade scratch
BRIDGE = {"this": L._bf16_tucker_bwd, "other": L._bf16_tucker_bwd}


def in_both(libs: dict, call, **kw) -> tuple[dict[str, float], dict]:
    """Each tree's ms of ``call()`` in turns (the lower of its two) and its
    output: the op wrappers are pointed at the tree's library for its turn."""

    def run(name):
        _build._LIB = libs[name]
        L._bf16_tucker_bwd = BRIDGE[name]
        return call()

    with torch.inference_mode():
        times = in_turns(run, libs, **kw)
        outs = {name: run(name) for name in libs}
    _build._LIB = libs["this"]
    L._bf16_tucker_bwd = BRIDGE["this"]
    return {name: min(ts) for name, ts in times.items()}, outs


def _close(label: str, got, ref, rel: float | None = None, tol: float | None = None) -> float:
    if got.shape != ref.shape or bool(torch.isnan(got).any()):
        raise AssertionError(f"{label}: shape or NaN")
    if not torch.equal(torch.isneginf(got), torch.isneginf(ref)):
        raise AssertionError(f"{label}: -inf patterns differ")
    fin = torch.isfinite(ref)
    err = (got[fin].double() - ref[fin].double()).abs()
    mag = ref[fin].double().abs()
    bound = rel * mag if rel else tol if tol else 1e-4 + 1e-5 * mag
    if not bool((err <= bound).all()):
        raise AssertionError(f"{label}: max|err| {float(err.max()):.3e} over the bound")
    return float(err.max()) if err.numel() else 0.0


def kernels(libs: dict) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    for fwd, f, b, k in SHAPES:
        x1 = torch.randn(f, b, k, device="cuda", generator=gen) * 3.0 - 2.0
        x2 = torch.randn(f, b, k, device="cuda", generator=gen) * 3.0 - 2.0
        for softmax in (False, True):
            key = fwd.replace("lse_tucker2", "lse_tucker2_softmax") if softmax else fwd
            w = (torch.randn(f, k, k * k, device="cuda", generator=gen) if softmax else
                 torch.rand(f, k, k * k, device="cuda", generator=gen) * 0.99 + 0.01)
            for sfx, mode in MODES:
                ins = (x1, x2, w.to(torch.bfloat16) if sfx.startswith("_w16") else w)
                t, outs = in_both(libs, lambda ins=ins, mode=mode: L._launch_fwd(key, ins, mode))
                err = _close(f"{key}{sfx}", outs["this"], outs["other"],
                             tol=FAST_FWD_TOL if mode else None)
                print(f"[ab] {key + sfx:36s} F={f} B={b} K={k}: other {t['other']:.3f} ms, "
                      f"this {t['this']:.3f} ms, max|this - other| {err:.2e}", flush=True)
                del ins, outs
            del w
        del x1, x2
        torch.cuda.empty_cache()


def _close_grads(label: str, got, ref) -> float:
    """Two trees' gradients: ``2e-4 (max|ref| + |ref|)``, and half a bf16
    step more where either is bf16."""
    if got.shape != ref.shape or bool(torch.isnan(got.float()).any()):
        raise AssertionError(f"{label}: shape or NaN")
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    bound = 2e-4 * (r.abs().max() + r.abs())
    if torch.bfloat16 in (got.dtype, ref.dtype):
        bound = bound + 2.0**-8 * r.abs()
    if not bool((err <= bound).all()):
        raise AssertionError(f"{label}: max|err| {float(err.max()):.3e} over the bound")
    return float(err.max())


def backward(libs: dict) -> None:
    gen = torch.Generator(device="cuda").manual_seed(1)
    for f, b, k in BWD_SHAPES:
        x1 = torch.randn(f, b, k, device="cuda", generator=gen) * 3.0 - 2.0
        x2 = torch.randn(f, b, k, device="cuda", generator=gen) * 3.0 - 2.0
        for op in ("lse_tucker2", "lse_tucker2_softmax"):
            w = (torch.randn(f, k, k * k, device="cuda", generator=gen) if "softmax" in op else
                 torch.rand(f, k, k * k, device="cuda", generator=gen) * 0.99 + 0.01)
            out = L._ENTRIES[op][2](x1, x2, w)
            g = torch.randn(out.shape, device="cuda", generator=gen)
            for sfx, mode in MODES:
                ins = (x1, x2, w.to(torch.bfloat16) if sfx.startswith("_w16") else w)
                t, outs = in_both(libs, lambda ins=ins, mode=mode, op=op: L._launch_bwd(
                    op, ins, out, g, (True, True, True), mode))
                err = max(_close_grads(f"{op}{sfx} {name}", a, r) for name, a, r in zip(
                    ("dx1", "dx2", "dw"), outs["this"], outs["other"]))
                print(f"[ab] {op + sfx + '_bwd':36s} F={f} B={b} K={k}: other "
                      f"{t['other']:.3f} ms, this {t['this']:.3f} ms, max|this - other| "
                      f"{err:.2e}", flush=True)
                del ins, outs
            del w, out, g
        del x1, x2
        torch.cuda.empty_cache()


def training(libs: dict) -> None:
    import chip_smoke as C

    from cirkit_tpu_torch.backend.torch import bf16_weight_store
    from cirkit_tpu_torch.parallel import split_trainable

    gen = torch.Generator().manual_seed(0)
    x = torch.randint(0, 256, (C.BATCH, 784), generator=gen).to("cuda")
    _, ctx, cc = C._build_flagship("tucker", False, "cuda", k=64)
    st32 = {s: v.detach() for s, v in cc.restrict_store(ctx.parameters).items()}
    tr, fr = split_trainable(cc, bf16_weight_store(cc, st32))
    with C._fast_env("1"), torch.enable_grad():
        times: dict[str, list[float]] = {"this": [], "other": []}
        outs = {}
        for name in ("other", "this", "this", "other"):
            _build._LIB = libs[name]
            L._bf16_tucker_bwd = BRIDGE[name]
            times[name].append(C._median_ms(lambda: C._gradients(cc, tr, fr, x), warmup=1,
                                            iters=5))
            outs[name] = C._gradients(cc, tr, fr, x)
        _build._LIB = libs["this"]
        L._bf16_tucker_bwd = BRIDGE["this"]
    worst = 0.0
    for k, r in outs["other"].items():
        share = float((outs["this"][k].float() - r.float()).abs().max()) / (
            2 * C.FAST_GRAD_REL * max(1.0, float(r.float().abs().max())))
        if not share <= 1.0:
            raise AssertionError(f"training backward: {k} off by {share:.3f} of the bound")
        worst = max(worst, share)
    print(f"[ab] train tucker K=64 batch {C.BATCH} bf16 store CIRKIT_TPU_FAST=1 forward and "
          f"backward: other {min(times['other']):.3f} ms, this {min(times['this']):.3f} ms, "
          f"worst slot {worst:.3f} of the bound", flush=True)
    del ctx, cc, st32, tr, fr, outs
    torch.cuda.empty_cache()


def serving(libs: dict) -> None:
    import chip_smoke as C

    from cirkit_tpu_torch.backend.torch import bf16_weight_store

    gen = torch.Generator().manual_seed(0)
    x_all = torch.randint(0, 256, (max(max(bs) for *_, bs in SERVING), 784), generator=gen)
    for spl, k, batches in SERVING:
        _, ctx, cc = C._build_flagship(spl, False, "cuda", k=k)
        st32 = {s: v.detach() for s, v in cc.restrict_store(ctx.parameters).items()}
        stores = {"f32_grade": (st32, ""), "bf16_fast": (bf16_weight_store(cc, st32), "1")}
        for batch in batches:
            x = x_all[:batch].to("cuda")
            for name, (store, env) in stores.items():
                with C._fast_env(env):
                    t, outs = in_both(libs, lambda store=store: cc.evaluate(store, x), warmup=2,
                                      iters=10)
                rel = 2 * C.SERVE_FAST_RTOL if env else 1e-5
                err = _close(f"{spl} K={k} {name}", outs["this"], outs["other"], rel)
                print(f"[ab] serve {spl} K={k} batch {batch} {name}: other "
                      f"{t['other']:.3f} ms, this {t['this']:.3f} ms, max|this - other| "
                      f"{err:.2e}", flush=True)
        del ctx, cc, st32, stores
        torch.cuda.empty_cache()


def main() -> int:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    if len(args) != 1 or not torch.cuda.is_available():
        print(__doc__)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True, check=True).stdout.strip())
    root = Path(args[0]).resolve()
    other = _other_build(root)
    if not (root / "cirkit_tpu_torch" / "csrc" / "tucker_bf16_bwd.cu").exists():
        BRIDGE["other"] = lambda *a: False
    with ThreadPoolExecutor(2) as pool:
        other_lib, this_lib = pool.map(lambda mod: mod.library(), (other, _build))
    libs = {"other": other_lib, "this": this_lib}
    if "--no-forward" not in sys.argv:
        kernels(libs)
    backward(libs)
    training(libs)
    if "--no-serving" not in sys.argv:
        serving(libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
