"""Calls of two source trees timed in turns, for the A/B scripts of this
folder (``wide_ab.py``, ``sos_bwd_ab.py``, ``sos_fwd_ab.py``,
``tucker_bf16_ab.py``): each tree's median of CUDA-event times
(``chip_smoke._median_ms``) once a turn, in the order other, this, this,
other, so a drift of the card's clock over a run falls on both trees alike.
"""

from __future__ import annotations

import functools
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as CS  # noqa: E402

TURNS = ("other", "this", "this", "other")


def in_turns(call, names, order=TURNS, **kw) -> dict[str, list[float]]:
    """The ms of ``call(name)`` for each tree in ``names``, one a turn of
    ``order``; ``kw`` are ``chip_smoke._median_ms``'s warm-ups and
    iterations."""
    times: dict[str, list[float]] = {name: [] for name in names}
    for name in order:
        times[name].append(CS._median_ms(functools.partial(call, name), **kw))
    return times
