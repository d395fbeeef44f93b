"""Load a TSDB's contents from plain numpy arrays.

Another TSDB (the JAX reference's, for instance) can export one metric
as a tag dict per series plus row-padded timestamp/value arrays; this
module fills the port's UID tables and store from them, so both
engines can answer queries over the same data.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def load_arrays(tsdb, metric: str, tags_list: Sequence[dict[str, str]],
                ts2d: np.ndarray, values2d: np.ndarray,
                counts: np.ndarray) -> np.ndarray:
    """Write row i's first ``counts[i]`` points to the series tagged
    ``tags_list[i]``; returns the port's series ids. UIDs are created
    whatever the auto-create settings say: the data was accepted by the
    TSDB that exported it. Exporting series in creation order with each
    tag dict in tag-key UID order reproduces the exporter's UID order."""
    tsdb.uids.metrics.get_or_create_id(metric)
    tsdb.uids.tag_names.get_or_create_ids(
        k for tags in tags_list for k in tags)
    tsdb.uids.tag_values.get_or_create_ids(
        v for tags in tags_list for v in tags.values())
    return tsdb.add_series_points(metric, tags_list, ts2d, values2d,
                                  counts)
