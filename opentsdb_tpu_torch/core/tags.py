"""Tag parsing and validation (ref: ``src/core/Tags.java``).

String rules match Tags.validateString (Tags.java:549): ASCII
alphanumerics, ``-  _  .  /``, plus any Unicode letter.
"""

from __future__ import annotations

from opentsdb_tpu_torch.core import const

_ALLOWED_PUNCT = set("-_./")


def validate_string(what: str, s: str) -> None:
    """(ref: Tags.java:549-566)"""
    if s is None:
        raise ValueError(f"Invalid {what}: null")
    if s == "":
        raise ValueError(f"Invalid {what}: empty string")
    for c in s:
        if not (c.isalnum() and c.isascii()
                or c in _ALLOWED_PUNCT or c.isalpha()):
            raise ValueError(
                f"Invalid {what} (\"{s}\"): illegal character: {c}")


def parse_put_value(raw: str, allow_special: bool = False
                    ) -> int | float:
    """Strictly parse a put value string (ref: Tags.parseLong and the
    value parse of PutDataPointRpc). Python's bare ``int()``/``float()``
    accept underscore digit separators, surrounding whitespace and
    non-ASCII digits (``int("1_0")`` is 10), so a malformed value would
    write the wrong number instead of failing. ``allow_special`` also
    admits the nan/inf spellings (the telnet ``put``)."""
    if not raw or not raw.isascii() or "_" in raw \
            or raw != raw.strip():
        raise ValueError(f"invalid value: {raw!r}")
    low = raw.lower()
    if low in ("nan", "-nan", "inf", "-inf", "infinity", "-infinity"):
        if allow_special:
            return float(raw)
        raise ValueError(f"invalid value: {raw!r}")
    try:
        if "." in raw or "e" in low:
            return float(raw)
        return int(raw)
    except ValueError:
        raise ValueError(f"invalid value: {raw!r}") from None


def parse(tag: str) -> tuple[str, str]:
    """Parse one ``name=value`` tag (ref: Tags.parse, Tags.java:60)."""
    eq = tag.find("=")
    if eq <= 0 or eq != tag.rfind("=") or eq == len(tag) - 1:
        raise ValueError(f"invalid tag: {tag}")
    return tag[:eq], tag[eq + 1:]


def check_tag_count(metric: str, tags: dict[str, str]) -> None:
    """The tag-count half of :func:`check_metric_and_tags`."""
    if not tags:
        raise ValueError(
            f"Need at least one tag (metric={metric}, tags={tags})")
    if len(tags) > const.MAX_NUM_TAGS:
        raise ValueError(
            f"Too many tags: {len(tags)} maximum allowed: "
            f"{const.MAX_NUM_TAGS} (metric={metric})")


def check_metric_and_tags(metric: str, tags: dict[str, str]) -> None:
    """Validate a write (ref: IncomingDataPoints.checkMetricAndTags)."""
    check_tag_count(metric, tags)
    validate_string("metric name", metric)
    for k, v in tags.items():
        validate_string("tag name", k)
        validate_string("tag value", v)
