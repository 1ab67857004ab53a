"""FRI witness plans from the queries alone.

The positions fri_host.first_layer_witness and fri_host.inner_layer_witness
gather depend only on the queries, so they are computed here directly, in
work proportional to the number of queries and with nothing of a layer's
size allocated.  Each function returns exactly the positions its host twin
gathers, in the same order.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np


def inner_layer_positions(queries: Iterable[int]) -> np.ndarray:
    """The sibling k ^ 1 of each sorted distinct query k not itself queried."""
    qs = sorted(set(queries))
    qset = set(qs)
    return np.asarray([k ^ 1 for k in qs if (k ^ 1) not in qset], np.int64)


def first_layer_positions(raw_queries: Iterable[int], max_log: int, L: int) -> np.ndarray:
    """Positions of the first-layer group of log L that the verifier cannot
    derive.  fri_host's walk over the pairs of the shifted queries emits, for
    each pair, the members not queried, in pair order: the unqueried sibling
    of each distinct query, as in an inner layer."""
    return inner_layer_positions(q >> (max_log - L) for q in raw_queries)
