"""The cold tier (ref: ``opentsdb_tpu/coldstore/``): demoted rollup
history spilled from RAM into mmap-backed segment files
(:mod:`.format`), read back through :class:`ColdStatView` as the
oldest third of the lifecycle's stitched view
(:mod:`opentsdb_tpu_torch.lifecycle.stitch`)."""

from opentsdb_tpu_torch.coldstore.store import ColdStatView, ColdStore

__all__ = ["ColdStatView", "ColdStore"]
