"""The data lifecycle (ref: ``opentsdb_tpu/lifecycle/``): retention,
age-based demotion into the rollup tiers and the cold spill, which the
reference delegates to HBase TTLs and external rollup jobs (SURVEY.md
§5.4).

- :mod:`opentsdb_tpu_torch.lifecycle.policy`: per-metric policies
  (``tsd.lifecycle.*`` keys and ``/api/lifecycle``);
- :mod:`opentsdb_tpu_torch.lifecycle.manager`: the sweeper;
- :mod:`opentsdb_tpu_torch.lifecycle.stitch`: the stitched read view
  (cold segments, tier history, raw tail) the query engine selects.
"""

from opentsdb_tpu_torch.lifecycle.manager import LifecycleManager
from opentsdb_tpu_torch.lifecycle.policy import LifecyclePolicy, PolicySet

__all__ = ["LifecycleManager", "LifecyclePolicy", "PolicySet"]
