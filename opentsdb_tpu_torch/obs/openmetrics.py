"""OpenMetrics exposition: ``GET /metrics`` for the Prometheus world
(ref: ``opentsdb_tpu/obs/openmetrics.py``).

The self-telemetry pump (obs/telemetry.py) lets the TSD monitor
itself; this module lets everything ELSE monitor the TSD without
adopting its stack. One renderer walks the full stats registry —
every ``collect_stats`` provider's counters and gauges, the
latency ``Histogram``\\ s in native cumulative ``_bucket``/``_sum``/
``_count`` form, and the SLO burn-rate gauges — and emits the
OpenMetrics text format with stable ``tsd_``-prefixed names:

- record names mangle ``.``/``-`` (and anything outside
  ``[a-zA-Z0-9_:]``) to ``_``: ``tsd.datapoints.added`` →
  ``tsd_datapoints_added``;
- record tags become labels, values escaped per the spec
  (``\\`` → ``\\\\``, ``"`` → ``\\"``, newline → ``\\n``);
- counters (everything :func:`opentsdb_tpu_torch.stats.stats.is_gauge`
  doesn't classify as a level) expose the spec-required ``_total``
  sample suffix;
- histograms render cumulative ``le``-labeled buckets (the registry's
  bucket UPPER bounds, ``+Inf`` last) with exact ``_count``/``_sum``;
- the document ends with ``# EOF``.

The renderer is read-only over snapshots: a scrape never blocks an
``add()`` beyond one bucket-list copy per histogram.
"""

from __future__ import annotations

import bisect
import re
from typing import Any

from opentsdb_tpu_torch.stats.stats import is_gauge

CONTENT_TYPE = ("application/openmetrics-text; version=1.0.0; "
                "charset=utf-8")

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def metric_name(raw: str) -> str:
    """Mangle one record name onto the metric-name charset; a leading
    digit gets an underscore prefix."""
    name = _NAME_BAD.sub("_", raw)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def escape_label(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _label_str(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{metric_name(str(k))}="{escape_label(v)}"'
        for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt(value: float) -> str:
    f = float(value)
    if f.is_integer() and abs(f) < 2 ** 53:
        return str(int(f))
    return repr(f)


def render(tsdb) -> bytes:
    """The full exposition document for one TSD (server-level
    providers — connections, admission — are registered into
    ``tsdb.stats`` by TSDServer, so their records ride along)."""
    out: list[str] = []

    # -- counters + gauges from the record stream ----------------------
    # (latency percentile records are suppressed: the same histograms
    # are served natively below)
    collector = tsdb.stats.collect(latency_percentiles=False)
    tsdb.collect_stats(collector)
    families: dict[str, list[tuple[dict[str, str], float]]] = {}
    kinds: dict[str, str] = {}
    for raw_name, value, tags in collector.records:
        fam = metric_name(raw_name)
        bare = raw_name.split(".", 1)[1] if "." in raw_name \
            else raw_name
        kind = "gauge" if is_gauge(bare) else "counter"
        # one family, one type: if any record under the name reads as
        # a gauge, the family is a gauge (summing would be wrong)
        if kinds.get(fam) == "gauge":
            kind = "gauge"
        kinds[fam] = kind
        families.setdefault(fam, []).append((dict(tags), value))
    for fam in sorted(families):
        kind = kinds[fam]
        out.append(f"# HELP {fam} stats record {fam}")
        out.append(f"# TYPE {fam} {kind}")
        suffix = "_total" if kind == "counter" else ""
        seen: dict[str, int] = {}
        for labels, value in families[fam]:
            ls = _label_str(labels)
            line = f"{fam}{suffix}{ls} {_fmt(value)}"
            # exact (family, labelset) duplicates keep the LAST value
            # (a provider re-reporting within one collect pass)
            if ls in seen:
                out[seen[ls]] = line
            else:
                seen[ls] = len(out)
                out.append(line)

    # -- histograms: native cumulative exposition ----------------------
    hist_families: dict[str, list[tuple[dict[str, str], dict]]] = {}
    for fam, labels, hist in tsdb.stats.histograms():
        hist_families.setdefault(metric_name(fam), []).append(
            (labels, hist.snapshot()))
    for fam in sorted(hist_families):
        out.append(f"# HELP {fam} latency histogram {fam}")
        out.append(f"# TYPE {fam} histogram")
        for labels, snap in hist_families[fam]:
            render_histogram(out, fam, labels, snap)

    # (SLO burn-rate gauges ride the record stream above — the
    # tracker's collect_stats emits slo.burn_rate per endpoint/slo/
    # window, classified gauge by is_gauge)

    out.append("# EOF")
    return ("\n".join(out) + "\n").encode("utf-8")


# exposition bucket ladder (ms): the registry's 1ms-linear histograms
# have ~8000 internal buckets — full fidelity belongs to the fleet
# merge (/api/stats/raw), not to a scrape body. Each ladder value maps
# to the LARGEST internal bound <= it, so every emitted cumulative
# count is EXACT for its printed `le` threshold (never interpolated).
_EXPO_LADDER = (1, 2, 3, 5, 8, 13, 21, 34, 55, 90, 150, 250, 400,
                650, 1000, 1700, 2800, 4600, 8000, 16000)


def exposition_points(bounds: list) -> list[tuple[int, float]]:
    """(internal bucket index, bound) pairs for the scrape ladder —
    always includes the last internal bound so `le=<max>` meets
    `+Inf`."""
    out: list[tuple[int, float]] = []
    for ladder in _EXPO_LADDER:
        i = bisect.bisect_right(bounds, ladder) - 1
        if i >= 0 and (not out or out[-1][0] != i):
            out.append((i, float(bounds[i])))
    last = len(bounds) - 1
    if not out or out[-1][0] != last:
        out.append((last, float(bounds[last])))
    return out


def render_histogram(out: list[str], fam: str,
                     labels: dict[str, Any], snap: dict) -> None:
    """Append one label-set's cumulative bucket series."""
    bounds, buckets = snap["bounds"], snap["buckets"]
    prev_idx = -1
    acc = 0
    for idx, bound in exposition_points(bounds):
        acc += sum(buckets[prev_idx + 1:idx + 1])
        prev_idx = idx
        ls = _label_str({**labels, "le": _fmt(bound)})
        out.append(f"{fam}_bucket{ls} {acc}")
    ls = _label_str({**labels, "le": "+Inf"})
    out.append(f"{fam}_bucket{ls} {snap['count']}")
    base = _label_str(labels)
    out.append(f"{fam}_sum{base} {_fmt(snap['sum'])}")
    out.append(f"{fam}_count{base} {snap['count']}")


__all__ = ["CONTENT_TYPE", "escape_label", "metric_name", "render",
           "render_histogram"]
