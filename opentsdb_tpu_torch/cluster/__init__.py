"""The sharded cluster tier (ref: ``opentsdb_tpu/cluster/``).

A **router** TSD (``tsd.cluster.role = router``) owns a consistent-hash
series→shard map over ``tsd.cluster.peers`` shard TSDs
(``tsd.cluster.role = shard``), so

- writes forward as series-grouped columnar batches to the owning
  shards (one client body stays one WAL write + one fsync per shard;
  every replica owner at ``tsd.cluster.rf`` > 1), and an unreachable
  shard's batches land in a per-peer durable spool that replays when
  the peer's breaker half-opens;
- queries scatter to every shard, each answering through its own
  query engine (its kernels run there), and the router merges the
  per-shard group partials exactly (sum/count/min/max decompose,
  ``avg`` = merged sum / merged count, percentiles through sketches);
  at rf > 1 each replica set is read by one member
  (:mod:`~opentsdb_tpu_torch.cluster.replica`), the next one when it
  fails, and an anti-entropy pass re-copies what a replica missed;
- continuous queries registered at the router stand on every shard
  and merge there (:mod:`~opentsdb_tpu_torch.cluster.cq`).

A dead, hanging or flapping peer never turns into a 5xx: a read gets a
200 partial carrying a ``shardsDegraded`` marker that the result cache
refuses to retain. The router talks to shards over the binary wire
(:mod:`~opentsdb_tpu_torch.cluster.wire`) or, where a shard does not
speak it, JSON HTTP.

Every format that outlives a process is the reference's byte for
byte: the ring's MD5 placement, the spool and its offset sidecar, the
dirty tracker's and the reshard state's files, and the wire's frames.

The ring grows or shrinks online behind a fenced epoch
(:mod:`~opentsdb_tpu_torch.cluster.reshard`), and a retire pass deletes
the stale copies a finalized reshard leaves
(:mod:`~opentsdb_tpu_torch.cluster.retire`). Sibling routers behind one
load balancer keep their result caches coherent and hand a reshard on
over the gossip bus (:mod:`~opentsdb_tpu_torch.cluster.gossip`).
"""

from opentsdb_tpu_torch.cluster.gossip import GossipBus, Sibling
from opentsdb_tpu_torch.cluster.hashring import HashRing, series_shard_key
from opentsdb_tpu_torch.cluster.replica import DirtyTracker
from opentsdb_tpu_torch.cluster.reshard import ReshardState
from opentsdb_tpu_torch.cluster.router import ClusterRouter
from opentsdb_tpu_torch.cluster.spool import PeerSpool

__all__ = ["ClusterRouter", "DirtyTracker", "GossipBus", "HashRing",
           "PeerSpool", "ReshardState", "Sibling", "series_shard_key"]
