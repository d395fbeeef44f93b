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
