"""Geometric shape classes (ref: ``opentsdb_tpu/ops/shapes.py``).

The reference pads every pipeline shape up to the next value of the
form ``{1, 1.25, 1.5, 1.75} x 2^k`` to bound its compile space. The
port compiles nothing per shape and runs the true shapes, but it keeps
the rounding for one decision that must agree with the reference: the
host-tail placement (``query/engine.py::host_tail_for_dims``) budgets
padded cells, so a query is placed where the reference would place it.
"""

from __future__ import annotations

_FRACTIONS = (4, 5, 6, 7)  # x/4: 1, 1.25, 1.5, 1.75


def shape_bucket(n: int, min_size: int = 8) -> int:
    """Smallest value >= n of the form {4,5,6,7} * 2^k (k >= 0),
    floored at ``min_size``."""
    n = max(int(n), min_size)
    if n <= min_size:
        return min_size
    k = max(int(n - 1).bit_length() - 3, 0)
    while True:
        for f in _FRACTIONS:
            cand = f << k
            if cand >= n:
                return cand
        k += 1
