"""The float32 signed Tucker backward (kernel 7 and its fast instances 7')
against its plain versions where the forward nearly cancels, on one card.

Run on a machine with a CUDA card, from the root of a checkout:

    python3 scripts/signed_bwd_cancel.py

On the inputs of ``tests/test_torch_cuda.py``'s
``test_signed_instance_kernels_match_plain`` (log-magnitudes and signs from
a CUDA generator of seed 0, fold 0 with a row of -inf inputs and a row whose
terms cancel exactly; the cotangent from seed 1), for each Tucker case and
instance the backward kernel runs on the plain forward's outputs in its
mode, and its gradients are held against four plain backwards in the same
mode: float32 on the card (P), float32 on the CPU (Pc; not at the K=64
entry), float64 on the card on the same inputs widened (D; an operand is
rounded to bf16 as its float32 value), and float64 with the rounded
cotangent of log|y|, ``r(g / y)``, taken from the float32 computation
(D32: the kernel's rounding points to the bit where its gy is the plain
float32 one); with logits in a fast mode also P against itself with the
softmax weights one float32 ulp up (Pu: what an ulp of the weights, whose
bf16 pair ``hi + lo`` holds 16 bits, does to the plain gradient). Each
pair's worst ratio of error to the test's bound (``1e-4 max|ref| + 1e-4
|ref|``, a bf16 weight gradient one bf16 ulp more against the reference
rounded to bf16; above 1 fails) is printed a gradient, with, for the kernel
against P, the row of its worst element, the largest |P| of that row as a
share of the largest of all, the smallest ``|y| / Y`` of its outputs (Y
the row's absolute mass) and its largest ``|g / y| Y``. Prints the card's
name and power limit first.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from cirkit_tpu_torch.ops import lse_einsum as T  # noqa: E402
from cirkit_tpu_torch.ops import slse_einsum as S  # noqa: E402

CASES = ((2, 13, 8, 16, 16), (2, 33, 4, 64, 64), (3, 37, 7, 10, 70), (2, 700, 7, 10, 70),
         (8, 512, 64, 64, 64), (784, 128, 64, 64, 64))
MODES = (("", ""), ("_w16", ""), ("_fast", "bf16"), ("_sr", "sr"), ("_w16_fast", "bf16"),
         ("_w16_sr", "sr"))
CANCEL_ROW, INF_ROW = 1, 2
_ROUND, _GY, _WEIGHTS = T.round_bf16, S._signed_gy, S._fast_softmax_weights


def _round_wide(v, mode, role):
    """``round_bf16`` that rounds a float64 operand as its float32 value."""
    if mode and v.dtype == torch.float64:
        return _ROUND(v.float(), mode, role).double()
    return _ROUND(v, mode, role)


def _gy_f32(g, oa, os, shift):
    """``g / y`` computed in float32 as the float32 plain version does."""
    return _GY(g.float(), oa.float(), os.float(), shift.float()).to(g.dtype)


def _ulp_up(theta):
    """The fast softmax weights, each one float32 ulp larger."""
    w = _WEIGHTS(theta)
    return torch.nextafter(w, torch.full_like(w, torch.inf))


def _inputs(op, f, b, k1, k2, o):
    gen = torch.Generator(device="cuda").manual_seed(0)
    ins = []
    for k in (k1, k2):
        ins += [torch.randn((f, b, k), generator=gen, device="cuda") * 3.0 - 2.0,
                torch.randint(-1, 2, (f, b, k), generator=gen, device="cuda").float()]
    ins.append(torch.randn((f, o, k1 * k2), generator=gen, device="cuda"))
    a1, s1, a2, s2, w = ins
    a1[0, INF_ROW] = float("-inf")
    a1[0, CANCEL_ROW] = a2[0, CANCEL_ROW] = 0.0
    s1[0, CANCEL_ROW] = 1.0
    alt = torch.tensor([1.0, -1.0], device="cuda").repeat(k2)[:k2]
    if k2 % 2:
        alt[-1] = 0.0
    s2[0, CANCEL_ROW] = alt
    if "softmax" in op:
        w[0] = 0.0
    else:
        pairs = torch.randint(-3, 4, (o, k1, (k2 + 1) // 2), device="cuda").float()
        w[0] = pairs.repeat_interleave(2, dim=-1)[..., :k2].reshape(o, k1 * k2)
    return [a1, s1, a2, s2, w]


def _ratio(got, ref) -> float:
    """The worst error over the test's bound (``_close_blocked_grad``): a bf16
    gradient against the reference rounded to bf16, one bf16 ulp more."""
    ref = ref.double().to(got.device)
    want, ulp = ref, 0.0
    if got.dtype == torch.bfloat16:
        want = ref.float().to(torch.bfloat16).double()
        exp = torch.frexp(want.abs().clamp_min(torch.finfo(torch.bfloat16).tiny)).exponent
        ulp = torch.ldexp(torch.ones_like(want), exp - 8)
    bound = 1e-4 * ref.abs().max() + 1e-4 * ref.abs() + ulp
    return float(((got.double() - want).abs() / bound.clamp_min(1e-300)).max())


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__)
        return 2
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True, check=True).stdout.strip())
    for op in ("slse_tucker2", "slse_tucker2_softmax"):
        for case in CASES:
            f, b, k1, k2, o = case
            for sfx, mode in MODES:
                ins = _inputs(op, f, b, k1, k2, o)
                if sfx.startswith("_w16"):
                    ins[-1] = ins[-1].to(torch.bfloat16)
                ref = S._ENTRIES[op][2](*ins, mode=mode)
                g = torch.randn(ref[0].shape, generator=torch.Generator(device="cuda")
                                .manual_seed(1), device="cuda")
                g[-1, 3:5] = 0.0
                needs = (True,) * 5
                got = S._launch_bwd(op, tuple(ins), *ref, g, needs, mode)
                plain = S._ENTRIES[op][3]
                runs = {"P": plain(*ins, *ref, g, needs, mode)}
                if f < 784:
                    runs["Pc"] = plain(*(t.cpu() for t in (*ins, *ref, g)), needs, mode)
                if mode and "softmax" in op:  # the softmax weights one float32 ulp up
                    S._fast_softmax_weights = _ulp_up
                    try:
                        runs["Pu"] = plain(*ins, *ref, g, needs, mode)
                    finally:
                        S._fast_softmax_weights = _WEIGHTS
                wide = [t.double() for t in (*ins, *ref, g)]
                S.round_bf16 = T.round_bf16 = _round_wide
                try:
                    runs["D"] = plain(*wide, needs, mode)
                    S._signed_gy = _gy_f32
                    runs["D32"] = plain(*wide, needs, mode)
                finally:
                    S.round_bf16, T.round_bf16, S._signed_gy = _ROUND, _ROUND, _GY
                torch.cuda.synchronize()
                # the row's absolute mass and |y| / Y, |g / y| Y of each output
                *xs, w = ins
                wabs = (torch.softmax(w.float(), dim=-1) if "softmax" in op
                        else w.float().abs())
                mass = T.lse_tucker2_ref(xs[0], xs[2], wabs)
                rel = torch.where(torch.isneginf(mass), 1.0, torch.exp(ref[0] - mass))
                for k in (0, 2, 4):
                    d = got[k]
                    pairs = {f"K-{n}": _ratio(d, r[k]) for n, r in runs.items()}
                    pairs.update({f"{n}-D32": _ratio(runs[n][k], runs["D32"][k])
                                  for n in ("P", "Pc") if n in runs})
                    if "Pu" in runs:
                        pairs["P-Pu"] = _ratio(runs["P"][k], runs["Pu"][k])
                    where = ""
                    if k < 4:  # the row of the worst element against P
                        err = (d.double() - runs["P"][k].double()).abs().amax(dim=-1)
                        fold, row = divmod(int(err.argmax()), b)
                        r_row = rel[fold, row]
                        top = float(runs["P"][k].abs().max())
                        where = (f"; worst K-P at fold {fold} row {row} (max|P| there "
                                 f"{float(runs['P'][k][fold, row].abs().max()) / top:.3f} of "
                                 f"max|P| {top:.4g}): min |y|/Y {float(r_row.min()):.2e}, "
                                 f"max |g/y| Y {float((g[fold, row].abs() / r_row).max()):.3e}")
                    print(f"{op}{sfx} {'x'.join(map(str, case))} d{['a1', '', 'a2', '', 'w'][k]}: "
                          + ", ".join(f"{n} {v:.3g}" for n, v in pairs.items()) + where,
                          flush=True)
                del ins, ref, g, got, runs, wide
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
