"""The one general traffic generator: a traffic file's parameters -> a plan.

A traffic file (`tilebench/traffic/<name>.json`) holds only data:

- `clients`: the closed loop's callers, each sending its next request
  when its last answer has come;
- `zooms`, `scales`: the hot set is every tile of the city at those
  zooms, at each scale (`@2x` is scale 2);
- `zipf_s`, `ranking_seed`: the popularity law.  The keys are ranked
  once by `ranking_seed` (a property of the traffic, not of the run),
  and each request draws the key of rank r with a probability in
  proportion to 1 / r**zipf_s.

The run's `--seed` draws every request, one after another, from that
law: the same seed gives the same requests in the same order.  Which
key holds which rank stays the traffic's, so seeds share the law and
differ only in the draws.
"""

from __future__ import annotations

import itertools
import random
from typing import Dict, List, Sequence, Tuple

Key = Tuple[int, int, int, int]  # zoom, x, y, scale

# More requests a second than a closed loop of this server answers (a
# few hundred): the plan never runs out inside a window.
MAX_RATE_PER_S = 5000


def hot_keys(tiles_xy18: Sequence[Tuple[int, int]], zooms: Sequence[int],
             scales: Sequence[int], max_zoom: int = 18) -> List[Key]:
    """Every tile at `zooms` that holds data (from the max-zoom tile
    index `tiles_xy18`), at each of `scales`, sorted."""
    keys = set()
    for z in zooms:
        shift = max_zoom - int(z)
        for x, y in tiles_xy18:
            for s in scales:
                keys.add((int(z), int(x) >> shift, int(y) >> shift, int(s)))
    return sorted(keys)


def ranked(keys: Sequence[Key], ranking_seed: int) -> List[Key]:
    """The keys in popularity order, fixed by the traffic's own seed."""
    out = list(keys)
    random.Random(int(ranking_seed)).shuffle(out)
    return out


def zipf_weights(n_keys: int, zipf_s: float) -> List[float]:
    """The probability of the key of each rank (1-based ranks)."""
    w = [1.0 / (r ** float(zipf_s)) for r in range(1, n_keys + 1)]
    total = sum(w)
    return [x / total for x in w]


def request_sequence(n_keys: int, traffic: Dict, seed: int, n_requests: int) -> List[int]:
    """`n_requests` indices into the ranking, each drawn from the law by
    `seed`."""
    cum = list(itertools.accumulate(zipf_weights(n_keys, traffic["zipf_s"])))
    return random.Random(int(seed)).choices(range(n_keys), cum_weights=cum, k=n_requests)


def plan(ranking: Sequence[Key], traffic: Dict, seed: int, seconds: float) -> Dict:
    """The load generator's whole input: the keys, the callers and more
    requests than they can send in the window."""
    n = int(MAX_RATE_PER_S * seconds) + 1000
    return {"clients": int(traffic["clients"]), "keys": list(ranking),
            "sequence": request_sequence(len(ranking), traffic, seed, n),
            "seconds": float(seconds)}
