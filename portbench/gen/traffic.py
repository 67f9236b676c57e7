"""The one generator of prefill traffic, driven by a mix's parameters
(``traffic/<name>.json``).

Requests arrive in decks.  A deck holds, for every prompt length L in
``range(min_len, max_len + 1, step)``, ``B(L) = budget // L`` requests of
length L, so that a deck's requests are drawn with probability in
proportion to 1/L (log-uniform) and every seed serves the same set of sizes;
the seed orders each deck.  A forward takes the oldest waiting request's
length L and the next ``B(L)`` waiting requests of that length, in arrival
order: a batch of one length and no padding, at most ``budget`` tokens.
"""

from __future__ import annotations

from collections import deque
from typing import Iterator, NamedTuple

import numpy as np


class Forward(NamedTuple):
    index: int
    length: int
    requests: tuple  # request ids in arrival order


def lengths(p: dict) -> np.ndarray:
    return np.arange(p["min_len"], p["max_len"] + 1, p["step"], dtype=np.int64)


def batch_of(p: dict, length: int) -> int:
    return int(p["budget_tokens"] // length)


def seed_seq(seed: int, *stream: int) -> np.random.SeedSequence:
    """An independent numpy stream per purpose, for any whole-number seed."""
    return np.random.SeedSequence([int(seed) % 2**63, *stream])


def requests(p: dict, seed: int) -> Iterator[int]:
    """Request lengths in arrival order, deck after deck."""
    rng = np.random.default_rng(seed_seq(seed, 1))
    deck = np.concatenate([np.full(batch_of(p, int(L)), L) for L in lengths(p)])
    while True:
        yield from (int(L) for L in rng.permutation(deck))


def forwards(p: dict, seed: int) -> Iterator[Forward]:
    """The forwards of the closed loop, in order."""
    stream = requests(p, seed)
    waiting: dict[int, deque] = {}
    order: deque = deque()  # (request id, length) in arrival order
    served: set = set()
    next_id = 0
    index = 0
    while True:
        while order and order[0][0] in served:
            order.popleft()
        if not order:
            L = next(stream)
            order.append((next_id, L))
            waiting.setdefault(L, deque()).append(next_id)
            next_id += 1
            continue
        L = order[0][1]
        need = batch_of(p, L)
        while len(waiting[L]) < need:
            L2 = next(stream)
            order.append((next_id, L2))
            waiting.setdefault(L2, deque()).append(next_id)
            next_id += 1
        ids = tuple(waiting[L].popleft() for _ in range(need))
        served.update(ids)
        yield Forward(index, L, ids)
        index += 1
