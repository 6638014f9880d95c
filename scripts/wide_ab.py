"""Time the wide kernels (the float32 forwards and blocked backward, and the
bf16-weight and fast-mode instances of the blocked dense kernels 3 and 4)
and the K=128 ``optimize=False`` paths that run the instances, of two source
trees side by side on one card.

Run on a machine with a CUDA card and the CUDA toolkit, from the root of a
checkout, with the root of another tree (for example the parent commit
unpacked by ``git archive`` into a directory that ``.gitignore`` lists):

    python3 scripts/wide_ab.py OTHER_ROOT

Each tree's kernel library is built by its own ``ops/_build.py`` (into its
own ``build/``). The two libraries need the same entries, signatures and
scratch: the blocked instances' gy scratch and weight-gradient type are
this tree's (``_blocked_gy_shape``, ``_blocked_gy_dtype``,
``_blocked_dw_dtype``), so the other tree holds ``csrc/blocked_bf16.cu``
too. Every call runs on both libraries in turns (other, this, this, other;
``ab_turns.py``), each time the median of 20 CUDA-event timings after 3
warm-ups (the paths: 3 after 1):

- the float32 entries, called directly:
  ``lse_fwd_ct`` and ``lse_fwd_ct_softmax`` at the K=128 Tucker entry
  (F=784, B=128, K1=K2=O=128), ``lse_fwd_blocked`` (out and the row max) and
  ``lse_bwd_blocked`` (dx only, dw only, both) at the dense K=128 entry
  (I=16384, O=128), and ``lse_fwd_tucker`` and ``lse_fwd_tucker_softmax`` at
  the K=64 Tucker entry (F=784, B=128, K1=K2=O=64); both trees' outputs held
  to each other (forward in log space to ``1e-4 + 1e-5 |other|``, the row
  maxes equal, gradients to ``1e-4 (max|other| + |other|)``);
- the ten instances ``lse_{fwd,bwd}_blocked{_fast,_sr,_w16,_w16_fast,_w16_sr}``
  through the port's op wrappers (``_launch_blocked_fwd``,
  ``_launch_blocked_bwd``, both gradients) at the dense K=128 entry (F=784,
  B=128) and at the serving batch (F=196, B=512: the same bytes of x): the
  forwards held to each other to ``1e-4 + 1e-5 |other|`` (``_w16``) or, where
  the trees may round over other chunks, to the JAX package's fast bound 8e-3
  in log space, the row maxes equal; the gradients to ``2e-4 (max|other| +
  |other|)``, half a bf16 step more where one of them is bf16;
- ``chip_smoke.py``'s phase 17a, the EM-ready K=128 Tucker flagship with
  ``optimize=False`` served from its bf16 store at batch 128, forward alone and forward and backward, in the modes ``f32_grade``,
  ``bf16_fast`` and ``sr``, and phase 17b, an SGD step of the K=128 softmax
  flagship with ``optimize=False`` from its float32 store in ``bf16_fast``
  and ``sr``; the trees' log-likelihoods held to each other relative, to
  twice ``chip_smoke.SERVE_FAST_RTOL``.

Prints the card's name and power limit first, then one line a kernel or
path with each tree's times.
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

FAST_FWD_TOL = 8e-3  # chip_smoke.FAST_FWD_TOL: JAX's fast bound, log space
INSTANCES = (("_fast", "bf16"), ("_sr", "sr"), ("_w16", ""), ("_w16_fast", "bf16"),
             ("_w16_sr", "sr"))
SHAPES = ((784, 128), (196, 512))  # (F, B) of the dense K=128 entry, I=16384, O=128


def _other_build(root: Path):
    """The other tree's ``ops/_build.py``, loaded as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        "other_build", root / "cirkit_tpu_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _point(libs: dict, name: str) -> None:
    _build._LIB = libs[name]


def timed(libs: dict, call, **kw) -> dict[str, float]:
    """Each tree's ms of ``call()`` in turns (the lower of its two), with
    autograd on: the op wrappers are pointed at the tree's library."""
    times: dict[str, list[float]] = {"this": [], "other": []}
    import chip_smoke as C

    for name in ("other", "this", "this", "other"):
        _point(libs, name)
        times[name].append(C._median_ms(call, **kw))
    _point(libs, "this")
    return {name: min(ts) for name, ts in times.items()}


def in_both(libs: dict, call, **kw) -> tuple[dict[str, float], dict]:
    """Each tree's ms of ``call()`` in turns (the lower of its two) and its
    output: the op wrappers are pointed at the tree's library for its turn."""

    def run(name):
        _point(libs, name)
        return call()

    with torch.inference_mode():
        times = in_turns(run, libs, **kw)
        outs = {name: run(name) for name in libs}
    _point(libs, "this")
    return {name: min(ts) for name, ts in times.items()}, outs


def _fwd_close(got, ref, tol: float | None = None) -> float:
    err = (got - ref).abs()
    assert torch.equal(torch.isneginf(got), torch.isneginf(ref))
    finite = torch.isfinite(ref)
    bound = tol if tol else 1e-4 + 1e-5 * ref[finite].abs()
    assert bool((err[finite] <= bound).all()), float(err[finite].max())
    return float(err[finite].max())


def _grad_close(label: str, got, ref) -> float:
    """Two trees' gradients: ``2e-4 (max|ref| + |ref|)``, and half a bf16
    step more where either is bf16."""
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    bound = 2e-4 * (r.abs().max() + r.abs())
    if torch.bfloat16 in (got.dtype, ref.dtype):
        bound = bound + 2.0**-8 * r.abs()
    if bool(torch.isnan(g).any()) or not bool((err <= bound).all()):
        raise AssertionError(f"{label}: max|err| {float(err.max()):.3e} over the bound")
    return float(err.max())


def float32_entries(libs: dict) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    f, b, k = 784, 128, 128
    stream = torch.cuda.current_stream().cuda_stream

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    # the Tucker forwards: K1-chunked at K=128, single-pass at K=64
    for entry, kt in (("lse_fwd_ct", k), ("lse_fwd_ct_softmax", k), ("lse_fwd_tucker", 64),
                      ("lse_fwd_tucker_softmax", 64)):
        x1, x2 = randn(f, b, kt) * 3 - 2, randn(f, b, kt) * 3 - 2
        w = randn(f, kt, kt * kt) if entry.endswith("softmax") else (
            torch.rand((f, kt, kt * kt), generator=gen, device="cuda") * 0.99 + 0.01)
        outs = {name: torch.empty((f, b, kt), device="cuda") for name in libs}

        def call(name, w=w, entry=entry, outs=outs, x1=x1, x2=x2, kt=kt):
            err = getattr(libs[name], entry)(x1.data_ptr(), x2.data_ptr(), w.data_ptr(),
                                             outs[name].data_ptr(), f, b, kt, kt, kt, 0, stream)
            assert err == 0, err

        times = in_turns(call, libs)
        err = _fwd_close(outs["this"], outs["other"])
        for name in libs:
            print(f"{entry:22s} {name:5s} ms {times[name]}  max|this - other| {err:.3e}  "
                  f"(F={f} B={b} K1=K2=O={kt})", flush=True)
        del x1, x2, w, outs

    i = k * k
    x = randn(f, b, i) * 3 - 2
    w = torch.rand((f, k, i), generator=gen, device="cuda") * 0.99 + 0.01
    fwd = {name: (torch.empty((f, b, k), device="cuda"), torch.empty((f, b, 1), device="cuda"))
           for name in libs}

    def blocked(name):
        out_, m_ = fwd[name]
        err = libs[name].lse_fwd_blocked(x.data_ptr(), w.data_ptr(), out_.data_ptr(),
                                         m_.data_ptr(), f, b, i, k, 0, stream)
        assert err == 0, err

    times = in_turns(blocked, libs)
    err = _fwd_close(fwd["this"][0], fwd["other"][0])
    assert torch.equal(fwd["this"][1], fwd["other"][1])
    for name in libs:
        print(f"{'lse_fwd_blocked':22s} {name:5s} ms {times[name]}  max|this - other| {err:.3e}"
              f"  (F={f} B={b} I={i} O={k}; row maxes equal)", flush=True)
    del fwd
    m = x.amax(-1, keepdim=True)
    out = torch.log(torch.bmm(torch.exp(x - m), w.transpose(1, 2))) + m
    g = randn(f, b, k)
    gy = torch.empty((f, b, k, 2), device="cuda")
    grads = {name: (torch.empty_like(x), torch.empty_like(w)) for name in libs}

    def bwd(name, need=(True, True)):
        dx, dw = (d.data_ptr() if n else None for d, n in zip(grads[name], need))
        err = libs[name].lse_bwd_blocked(*(t.data_ptr() for t in (x, w, out, m, g)), dx, dw,
                                         gy.data_ptr(), f, b, i, k, 0, stream)
        assert err == 0, err

    # the gradients alone first (dx only, dw only), then both
    for need, label in (((True, False), "dx only"), ((False, True), "dw only")):
        part = in_turns(lambda name, need=need: bwd(name, need), libs)
        for name in libs:
            print(f"{'lse_bwd_blocked':22s} {name:5s} ms {part[name]}  ({label})", flush=True)
    times = in_turns(bwd, libs)
    torch.cuda.synchronize()
    errs = []
    for got, ref in zip(grads["this"], grads["other"]):
        err = (got - ref).abs()
        assert bool((err <= 1e-4 * (ref.abs().max() + ref.abs())).all()), float(err.max())
        errs.append(float(err.max()))
    for name in libs:
        print(f"{'lse_bwd_blocked':22s} {name:5s} ms {times[name]}  max|this - other| dx "
              f"{errs[0]:.3e} dw {errs[1]:.3e}", flush=True)
    del x, w, out, g, gy, grads
    torch.cuda.empty_cache()


def instances(libs: dict) -> None:
    i, o = 128 * 128, 128
    for f, b in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(1)
        x = torch.randn((f, b, i), generator=gen, device="cuda") * 3.0 - 2.0
        x[0, 5] = float("-inf")
        w32 = torch.rand((f, o, i), generator=gen, device="cuda") * 0.99 + 0.01
        g = torch.randn((f, b, o), generator=gen, device="cuda")
        label = f"F={f} B={b} I={i} O={o}"
        for sfx, mode in INSTANCES:
            if sfx == "_w16":  # the bf16 instances from here on
                w32 = w32.to(torch.bfloat16)
                torch.cuda.empty_cache()
            w = w32
            t, outs = in_both(libs, lambda w=w, mode=mode: L._launch_blocked_fwd(x, w, mode))
            err = _fwd_close(outs["this"][0], outs["other"][0], FAST_FWD_TOL if mode else None)
            assert torch.equal(outs["this"][1], outs["other"][1])
            out, m = outs["this"]
            del outs
            print(f"[ab] {'lse_matmul_blocked' + sfx:31s} {label}: other {t['other']:.3f} ms, "
                  f"this {t['this']:.3f} ms, max|this - other| {err:.2e}, row maxes equal",
                  flush=True)
            t, outs = in_both(libs, lambda w=w, mode=mode, out=out, m=m: L._launch_blocked_bwd(
                x, w, out, m, g, (True, True), mode))
            err = max(_grad_close(f"{sfx} {name}", a, r) for name, a, r in zip(
                ("dx", "dw"), outs["this"], outs["other"]))
            print(f"[ab] {'lse_matmul_blocked' + sfx + '_bwd':31s} {label}: other "
                  f"{t['other']:.3f} ms, this {t['this']:.3f} ms, max|this - other| {err:.2e}",
                  flush=True)
            del outs, out, m
            torch.cuda.empty_cache()
        del x, w32, g
        torch.cuda.empty_cache()


def paths(libs: dict) -> None:
    """Phases 17a and 17b of chip_smoke.py, timed with each tree's kernels."""
    import chip_smoke as C

    from cirkit_tpu_torch.backend.torch import bf16_weight_store
    from cirkit_tpu_torch.parallel import data_parallel_step, split_trainable

    gen = torch.Generator().manual_seed(0)
    x = torch.randint(0, 256, (C.BATCH, 784), generator=gen).to("cuda")
    rel = 2 * C.SERVE_FAST_RTOL

    def held(label, outs):
        a, r = outs["this"].double(), outs["other"].double()
        err = float(((a - r).abs() / r.abs()).max())
        if not err <= rel:
            raise AssertionError(f"{label}: the trees differ by {err:.3e}")
        return err

    # (a) the EM-ready flagship served from its bf16 store
    _, ctx, cc = C._build_flagship("tucker", True, "cuda", k=C.WIDE_K, optimize=False)
    store = bf16_weight_store(cc, cc.restrict_store(ctx.parameters))
    ctx.parameters.clear()
    torch.cuda.empty_cache()
    for name, env in C.LOWPREC_MODES.items():
        with C._fast_env(env):
            t, outs = in_both(libs, lambda: cc.evaluate(store, x), warmup=1, iters=3)
            err = held(f"17a {name} forward", outs)
            print(f"[ab] 17a K={C.WIDE_K} optimize=False bf16 store {name} forward: other "
                  f"{t['other']:.3f} ms, this {t['this']:.3f} ms, rows within {err:.2e}",
                  flush=True)
            tr, fr = split_trainable(cc, store)
            tr = {k: v.detach().requires_grad_() for k, v in tr.items()}

            def grads(tr=tr, fr=fr):
                torch.autograd.grad(-cc.evaluate({**tr, **fr}, x).mean(), list(tr.values()))

            t = timed(libs, grads, warmup=1, iters=3)
            print(f"[ab] 17a K={C.WIDE_K} optimize=False bf16 store {name} forward and "
                  f"backward: other {t['other']:.3f} ms, this {t['this']:.3f} ms", flush=True)
            del tr, fr
    del ctx, cc, store
    torch.cuda.empty_cache()

    # (b) SGD steps of the softmax flagship from its float32 store
    _, ctx, cc = C._build_flagship("tucker", False, "cuda", k=C.WIDE_K, optimize=False)
    tr, fr = split_trainable(cc, ctx.parameters)
    opt = torch.optim.SGD(list(tr.values()), lr=C.SGD_LR)
    step = data_parallel_step(cc, opt)
    for name in ("bf16_fast", "sr"):
        with C._fast_env(C.LOWPREC_MODES[name]):
            t = timed(libs, lambda: step(tr, fr, x), warmup=1, iters=3)
        print(f"[ab] 17b K={C.WIDE_K} optimize=False float32 store {name} SGD step: other "
              f"{t['other']:.3f} ms, this {t['this']:.3f} ms", flush=True)
    del ctx, cc, tr, fr, opt, step
    torch.cuda.empty_cache()


def main() -> int:
    args = sys.argv[1:]
    if len(args) != 1 or not torch.cuda.is_available():
        print(__doc__)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True, check=True).stdout.strip())
    root = Path(args[0]).resolve()
    other = _other_build(root)
    with ThreadPoolExecutor(2) as pool:
        other_lib, this_lib = pool.map(lambda mod: mod.library(), (other, _build))
    libs = {"other": other_lib, "this": this_lib}
    float32_entries(libs)
    instances(libs)
    paths(libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
