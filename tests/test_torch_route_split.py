"""The split path of the port's max-plus Tucker and the routing kernel's
draw (``cirkit_tpu_torch.ops.routing``), on the CPU.

- ``_trop_splits``: at the K=64 Tucker flagship's ten Tucker entries (F =
  784, 392, ..., 2 folds, B=128, O=64, M=4096) on a 132-SM card, the two
  largest entries are not split, and every entry's busiest SM reduces
  within 10% of the card's even share of the chunks with at most three
  blocks an SM; the same for the float64 kernel (8-column chunks).
- ``tropical_tucker2_split_ref``, the plain version of the kernel's split
  path: taken in S ranges of m and combined by max, it equals
  ``tropical_tucker2_ref`` bit for bit with linear weights (max is exact),
  and within 1e-12 in float64 with logits, whose normalizers are merged by
  log-sum-exp; a unit whose logits are all -inf gives -inf.
- ``inverse_cdf_draw``, the route kernel's search rule on given uniforms:
  a row that is all -inf gives 0, ``u S`` past the total the last column
  with mass, u = 0 the first column with mass, and a column of zero mass
  is never drawn; over many uniforms the draws follow ``softmax(scores)``.

The split path against the JAX kernel in interpret mode is a case of
``tests/test_torch_routing.py::test_tropical_ref_matches_jax_kernel``.
"""

import numpy as np
import pytest
import torch

from cirkit_tpu_torch.ops import routing as R

FLAGSHIP_F = (784, 392, 196, 98, 42, 22, 12, 8, 4, 2)
SMS = 132
INF = float("-inf")


@pytest.mark.parametrize("chunk,itemsize", [(16, 4), (8, 8)], ids=["float32", "float64"])
@pytest.mark.parametrize("f", FLAGSHIP_F)
def test_trop_splits_even_out_the_card_at_every_flagship_entry(f, chunk, itemsize):
    """The busiest SM's chunks within 10% of the card's even share of the
    work, with few splits (at most three blocks an SM)."""
    b, o, m = 128, 64, 4096
    s = R._trop_splits(f, b, o, m, SMS, chunk=chunk, itemsize=itemsize)
    chunks = m // chunk
    assert 1 <= s <= chunks and s == R._normal_splits(s, m, chunk)
    per = -(-chunks // s)
    assert -(-f * s // SMS) * per <= 1.1 * f * chunks / SMS
    assert f * s <= 3 * SMS or s == 1


def test_trop_splits_keep_the_large_entries_whole():
    """F=784 and F=392 fill every SM evenly unsplit (6 and 3 blocks an SM);
    F=196 splits in 2 (392 blocks, 3 an SM), not 4: the same work on the
    busiest SM and twice the partial maxima."""
    assert R._trop_splits(784, 128, 64, 4096, SMS) == 1
    assert R._trop_splits(784, 13, 64, 4096, SMS) == 1
    assert R._trop_splits(392, 128, 64, 4096, SMS) == 1
    assert R._trop_splits(196, 128, 64, 4096, SMS) == 2
    assert R._trop_splits(3, 8, 16, 16, SMS) == 1  # one chunk: nothing to split
    assert R._trop_splits(42, 128, 64, 4096, 2 * SMS) > R._trop_splits(42, 128, 64, 4096, SMS)


@pytest.mark.parametrize("m", [1, 15, 16, 17, 100, 4096, 4100])
@pytest.mark.parametrize("splits", [1, 2, 3, 7, 64, 1000])
def test_normal_splits_leave_no_range_empty(m, splits):
    chunks = -(-m // 16)
    s = R._normal_splits(splits, m, 16)
    per = -(-chunks // s)
    assert 1 <= s <= min(splits, chunks) and (s - 1) * per < chunks <= s * per


@pytest.mark.parametrize("f,team",
                         [(784, 1), (42, 1), (22, 1), (12, 2), (8, 4), (4, 8), (2, 8)])
def test_route_team_fills_the_card_at_few_folds(f, team):
    assert R._route_team(f * 128, 4096, 128 * 4, SMS) == team


def test_route_team_grows_until_the_rows_fit_shared_memory():
    assert R._route_team(10**6, 4096, 40000, SMS) == 2  # 4 rows of 40 KB a block
    assert R._route_team(10**6, 4096, R._MAX_SMEM // 8, SMS) == 1


def _tucker(seed, f, b, k1, k2, o, dtype, log_weights):
    rng = np.random.default_rng(seed)
    x1 = rng.standard_normal((f, b, k1)) * 3.0 - 2.0
    x2 = rng.standard_normal((f, b, k2)) * 3.0 - 2.0
    th = (rng.standard_normal((f, o, k1 * k2)) * 1.5 if log_weights
          else rng.uniform(0.01, 1.0, (f, o, k1 * k2)))
    x1[0, 1] = -np.inf  # a row of -inf children
    if not log_weights:
        th[:, :, 3] = 0.0  # a zero weight
    return [torch.as_tensor(a, dtype=dtype) for a in (x1, x2, th)]


# (F, B, K1, K2, O, S): M = 96 is 6 float32 chunks (3 ranges of 2, or 4 of
# 2 and a ragged last one short of it: 7 gives ranges of 1), M = 105 a
# ragged last chunk
SPLIT_CASES = [(3, 8, 8, 12, 16, 3), (2, 13, 8, 12, 5, 4), (2, 5, 7, 15, 3, 7),
               (1, 4, 16, 16, 70, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("f,b,k1,k2,o,s", SPLIT_CASES)
def test_split_max_plus_is_the_whole_one_bit_for_bit_with_linear_weights(f, b, k1, k2, o, s,
                                                                         dtype):
    x1, x2, th = _tucker(90, f, b, k1, k2, o, dtype, False)
    got = R.tropical_tucker2_split_ref(x1, x2, th, log_weights=False, splits=s)
    want = R.tropical_tucker2_ref(x1, x2, th, log_weights=False)
    assert torch.equal(got, want)
    assert torch.isneginf(got[0, 1]).all()


@pytest.mark.parametrize("f,b,k1,k2,o,s", SPLIT_CASES)
def test_split_max_plus_with_logits_merges_the_normalizers(f, b, k1, k2, o, s):
    x1, x2, th = _tucker(91, f, b, k1, k2, o, torch.float64, True)
    th[0, 0, : k1 * k2 // 2] = INF  # the first ranges of a unit without mass
    got = R.tropical_tucker2_split_ref(x1, x2, th, log_weights=True, splits=s)
    want = R.tropical_tucker2_ref(x1, x2, th, log_weights=True)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    assert bool(((got[fin] - want[fin]).abs() <= 1e-12 * (1 + want[fin].abs())).all())


def test_split_max_plus_gives_minus_inf_for_a_unit_without_mass():
    x1, x2, th = _tucker(92, 2, 5, 8, 12, 4, torch.float64, True)
    th[1, 2] = INF
    for s in (1, 3):
        got = R.tropical_tucker2_split_ref(x1, x2, th, log_weights=True, splits=s)
        assert torch.isneginf(got[1, :, 2]).all() and not torch.isnan(got).any()
        assert torch.isfinite(got[1, :, :2]).all()


def test_tropical_op_takes_the_split_path_on_cpu_when_asked():
    x1, x2, th = _tucker(93, 2, 5, 8, 12, 4, torch.float32, True)
    got = R.tropical_tucker2(x1, x2, th, log_weights=True, splits=5)
    want = R.tropical_tucker2_split_ref(x1, x2, th, log_weights=True, splits=5)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="splits"):
        R.tropical_tucker2(x1, x2, th, log_weights=True, splits=0)
    assert R.LAUNCHES["tropical_tucker2"] == 0


def test_inverse_cdf_draw_edges():
    s = torch.tensor([
        [INF, INF, INF, INF],        # no mass: 0
        [INF, 0.0, INF, 1.0],        # u = 0: the first column with mass
        [0.0, INF, 0.5, INF],        # u S past the total: the last column with mass
        [float("nan"), INF, 2.0, 2.0],  # NaN has no mass
        [1.0, 1.0, 1.0, 1.0],        # u = 1/2 reaches the second column's running sum
    ], dtype=torch.float64)
    u = torch.tensor([0.7, 0.0, 0.9, 0.0, 0.5], dtype=torch.float64)
    got = R.inverse_cdf_draw(s, u)
    assert got.dtype == torch.int64 and got.tolist() == [0, 1, 2, 2, 1]
    # u S past the running sums (u at 1 by rounding): the last column with mass
    assert R.inverse_cdf_draw(s[2:3], torch.tensor([1.0 + 1e-9])).tolist() == [2]


def test_inverse_cdf_draw_never_draws_zero_mass_and_follows_softmax():
    rng = np.random.default_rng(94)
    m, n = 12, 200000
    scores = torch.as_tensor(rng.standard_normal(m) * 2.0)
    scores[[2, 7]] = INF
    u = torch.as_tensor(rng.random(n))
    idx = R.inverse_cdf_draw(scores.expand(n, -1), u)
    assert not bool(((idx == 2) | (idx == 7)).any())
    p = torch.softmax(scores, dim=-1).numpy()
    freq = np.bincount(idx.numpy(), minlength=m) / n
    assert (np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / n) + 1e-3).all()
