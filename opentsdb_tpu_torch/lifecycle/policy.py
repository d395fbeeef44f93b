"""Per-metric data-lifecycle policies (ref:
``opentsdb_tpu/lifecycle/policy.py``).

A policy says how long a metric's raw points live (``retention``),
when raw history is demoted into the configured rollup tiers
(``demote_after``, ``demote_tiers``) and when demoted tier history is
spilled from RAM into the mmap-backed cold store (``spill_after``,
:mod:`opentsdb_tpu_torch.coldstore`). Policies come from two places, lowest
precedence first:

1. config keys (read once at manager construction)::

       tsd.lifecycle.retention       = 90d        # default policy
       tsd.lifecycle.demote_after    = 6h
       tsd.lifecycle.demote_tiers    = 1m,1h
       tsd.lifecycle.spill_after     = 7d
       tsd.lifecycle.policy.sys.cpu.retention    = 30d   # per metric
       tsd.lifecycle.policy.sys.cpu.demote_after = 1h

2. the ``POST /api/lifecycle`` admin endpoint (runtime updates)::

       {"policies": [{"metric": "*", "retention": "90d"},
                     {"metric": "sys.cpu", "demoteAfter": "1h",
                      "demoteTiers": ["1m"], "spillAfter": "2d"}]}

The metric name ``*`` is the default policy; an exact metric name
overrides it wholesale (no field-level merging — the resolved policy is
the most specific one, like the reference resolves per-table HBase
TTLs).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Iterable

from opentsdb_tpu_torch.query.model import BadRequestError
from opentsdb_tpu_torch.utils import datetime_util

_KNOBS = ("retention", "demote_after", "demote_tiers",
          "spill_after")


def _parse_duration(value: str, what: str) -> int:
    """Duration string -> ms; '' / '0' mean disabled (0)."""
    value = (value or "").strip()
    if value in ("", "0"):
        return 0
    try:
        return datetime_util.parse_duration_ms(value)
    except ValueError as exc:
        raise BadRequestError(f"invalid {what} duration "
                              f"{value!r}: {exc}") from None


@dataclass(frozen=True)
class LifecyclePolicy:
    """One metric's lifecycle rules (``metric == '*'`` is the
    default). ``retention_ms == 0`` keeps points forever;
    ``demote_after_ms == 0`` never demotes; empty ``demote_tiers``
    means every configured rollup tier; ``spill_after_ms == 0`` keeps
    demoted history in RAM forever."""

    metric: str
    retention_ms: int = 0
    demote_after_ms: int = 0
    demote_tiers: tuple[str, ...] = field(default_factory=tuple)
    spill_after_ms: int = 0

    @property
    def active(self) -> bool:
        return self.retention_ms > 0 or self.demote_after_ms > 0

    def validate(self) -> None:
        if self.retention_ms and self.demote_after_ms \
                and self.demote_after_ms >= self.retention_ms:
            raise BadRequestError(
                f"policy for {self.metric!r}: demote_after "
                f"({self.demote_after_ms} ms) must be shorter than "
                f"retention ({self.retention_ms} ms) — demoted history "
                "would be purged the moment it lands in the tiers")
        if self.spill_after_ms:
            if not self.demote_after_ms:
                raise BadRequestError(
                    f"policy for {self.metric!r}: spill_after needs "
                    "demote_after — only demoted tier history spills "
                    "to the cold store")
            if self.spill_after_ms <= self.demote_after_ms:
                raise BadRequestError(
                    f"policy for {self.metric!r}: spill_after "
                    f"({self.spill_after_ms} ms) must be longer than "
                    f"demote_after ({self.demote_after_ms} ms) — "
                    "history demotes to RAM tiers first, spills to "
                    "disk later")
            if self.retention_ms and \
                    self.spill_after_ms >= self.retention_ms:
                raise BadRequestError(
                    f"policy for {self.metric!r}: spill_after "
                    f"({self.spill_after_ms} ms) must be shorter than "
                    f"retention ({self.retention_ms} ms) — spilled "
                    "history would be dropped the moment it lands on "
                    "disk")

    def to_json(self) -> dict[str, Any]:
        return {
            "metric": self.metric,
            "retention": _fmt_ms(self.retention_ms),
            "demoteAfter": _fmt_ms(self.demote_after_ms),
            "demoteTiers": list(self.demote_tiers),
            "spillAfter": _fmt_ms(self.spill_after_ms),
        }

    @classmethod
    def from_json(cls, obj: dict) -> "LifecyclePolicy":
        if not isinstance(obj, dict):
            raise BadRequestError("each policy must be an object")
        metric = obj.get("metric")
        if not metric or not isinstance(metric, str):
            raise BadRequestError(
                "policy needs a 'metric' name ('*' for the default)")
        tiers = obj.get("demoteTiers") or obj.get("demote_tiers") or []
        if isinstance(tiers, str):
            tiers = [t for t in tiers.split(",") if t.strip()]
        if not isinstance(tiers, list) or not all(
                isinstance(t, str) for t in tiers):
            raise BadRequestError("demoteTiers must be a list of "
                                  "interval strings")
        pol = cls(
            metric=metric,
            retention_ms=_parse_duration(
                str(obj.get("retention") or ""), "retention"),
            demote_after_ms=_parse_duration(
                str(obj.get("demoteAfter")
                    or obj.get("demote_after") or ""), "demoteAfter"),
            demote_tiers=tuple(t.strip() for t in tiers),
            spill_after_ms=_parse_duration(
                str(obj.get("spillAfter")
                    or obj.get("spill_after") or ""), "spillAfter"),
        )
        pol.validate()
        return pol


def _fmt_ms(ms: int) -> str:
    """Milliseconds back to the tersest duration string ('' = off)."""
    if ms <= 0:
        return ""
    for unit, size in (("d", 86400_000), ("h", 3600_000),
                       ("m", 60_000), ("s", 1000)):
        if ms % size == 0:
            return f"{ms // size}{unit}"
    return f"{ms}ms"


class PolicySet:
    """Thread-safe resolved policy table: exact metric name wins over
    the ``*`` default."""

    def __init__(self, policies: Iterable[LifecyclePolicy] = ()):
        self._lock = threading.Lock()
        self._by_metric: dict[str, LifecyclePolicy] = {}
        for pol in policies:
            pol.validate()
            self._by_metric[pol.metric] = pol

    @classmethod
    def from_config(cls, config) -> "PolicySet":
        """Build from ``tsd.lifecycle.*`` keys. Metric names may
        themselves contain dots, so per-metric keys parse by known
        suffix: ``tsd.lifecycle.policy.<metric>.<knob>``."""
        prefix = "tsd.lifecycle.policy."
        fields: dict[str, dict[str, str]] = {}
        for key, val in config:
            if not key.startswith(prefix):
                continue
            rest = key[len(prefix):]
            for knob in _KNOBS:
                if rest.endswith("." + knob):
                    metric = rest[:-len(knob) - 1]
                    if metric:
                        fields.setdefault(metric, {})[knob] = val
                    break
        policies = []
        default_fields = {
            "retention": config.get_string("tsd.lifecycle.retention",
                                           ""),
            "demote_after": config.get_string(
                "tsd.lifecycle.demote_after", ""),
            "demote_tiers": config.get_string(
                "tsd.lifecycle.demote_tiers", ""),
            "spill_after": config.get_string(
                "tsd.lifecycle.spill_after", ""),
        }
        if any(v.strip() for v in default_fields.values()):
            policies.append(_policy_from_fields("*", default_fields))
        for metric, fld in sorted(fields.items()):
            policies.append(_policy_from_fields(metric, fld))
        return cls(policies)

    def replace(self, policies: Iterable[LifecyclePolicy]) -> None:
        """Atomic wholesale replacement (the admin POST body is the
        full policy table — idempotent, no partial merges to reason
        about)."""
        table = {}
        for pol in policies:
            pol.validate()
            table[pol.metric] = pol
        with self._lock:
            self._by_metric = table

    def for_metric(self, metric: str) -> LifecyclePolicy | None:
        with self._lock:
            pol = self._by_metric.get(metric)
            if pol is None:
                pol = self._by_metric.get("*")
            return pol if pol is not None and pol.active else None

    def metrics_with_policies(self, all_metrics: Iterable[str]
                              ) -> list[tuple[str, LifecyclePolicy]]:
        """Resolve the policy of every metric that HAS one — the
        sweep's work list. With a ``*`` default, that is every metric
        in ``all_metrics``."""
        out = []
        for m in all_metrics:
            pol = self.for_metric(m)
            if pol is not None:
                out.append((m, pol))
        return out

    def to_json(self) -> list[dict]:
        with self._lock:
            return [self._by_metric[k].to_json()
                    for k in sorted(self._by_metric)]


def _policy_from_fields(metric: str, fld: dict[str, str]
                        ) -> LifecyclePolicy:
    tiers = tuple(t.strip() for t in
                  (fld.get("demote_tiers") or "").split(",")
                  if t.strip())
    pol = LifecyclePolicy(
        metric=metric,
        retention_ms=_parse_duration(fld.get("retention", ""),
                                     "retention"),
        demote_after_ms=_parse_duration(fld.get("demote_after", ""),
                                        "demote_after"),
        demote_tiers=tiers,
        spill_after_ms=_parse_duration(fld.get("spill_after", ""),
                                       "spill_after"))
    pol.validate()
    return pol
