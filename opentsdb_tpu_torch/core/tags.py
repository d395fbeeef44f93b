"""Tag parsing and validation (ref: ``src/core/Tags.java``).

String rules match Tags.validateString (Tags.java:549): ASCII
alphanumerics, ``-  _  .  /``, plus any Unicode letter.

The batch surface (:func:`check_metric_and_tags_batch`, ref: the same
function; the cluster router's put validation) screens a batch's
distinct series in one byte-lookup pass over the concatenated names
and falls back to the scalar validators for a series the screen cannot
prove valid, so the messages and the accept set are the scalar path's.
"""

from __future__ import annotations

import numpy as np

from opentsdb_tpu_torch.core import const

_ALLOWED_PUNCT = set("-_./")

# byte -> allowed, for the batched ASCII fast path (the scalar rule
# minus unicode letters, which fall back to validate_string)
_ASCII_OK = np.zeros(256, dtype=bool)
for _ch in ("0123456789abcdefghijklmnopqrstuvwxyz"
            "ABCDEFGHIJKLMNOPQRSTUVWXYZ-_./"):
    _ASCII_OK[ord(_ch)] = True
del _ch


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


def parse_with_metric(arg: str) -> tuple[str, dict[str, str]]:
    """Parse ``metric{tag=value,...}`` (ref: Tags.parseWithMetric)."""
    brace = arg.find("{")
    if brace < 0:
        return arg, {}
    if not arg.endswith("}"):
        raise ValueError(f"missing '}}' in {arg!r}")
    metric = arg[:brace]
    tags: dict[str, str] = {}
    body = arg[brace + 1:-1].strip()
    if body:
        for part in body.split(","):
            k, v = parse(part.strip())
            tags[k] = v
    return metric, tags


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


def check_metric_and_tags_batch(series: list[tuple[str, dict]]
                                ) -> list[str | None]:
    """Batched :func:`check_metric_and_tags` over distinct series:
    returns one error message (or ``None``) per input, byte-for-byte
    what the scalar check raises. The common all-ASCII case is ONE
    lookup-table pass over the concatenated strings; anything the
    screen cannot prove valid re-runs the scalar validators for the
    exact message and the unicode-letter allowance."""
    n = len(series)
    out: list[str | None] = [None] * n
    strs: list[str] = []
    owner: list[int] = []    # strs index -> series index
    fallback: set[int] = set()
    for i, (metric, tags) in enumerate(series):
        if not tags or not isinstance(tags, dict) \
                or len(tags) > const.MAX_NUM_TAGS \
                or not isinstance(metric, str):
            fallback.add(i)
            continue
        row = [metric]
        ok_types = True
        for k, v in tags.items():
            if not (isinstance(k, str) and isinstance(v, str)):
                ok_types = False
                break
            row.append(k)
            row.append(v)
        if not ok_types:
            fallback.add(i)
            continue
        strs.extend(row)
        owner.extend([i] * len(row))
    if strs:
        joined = "".join(strs)
        lens = np.fromiter((len(s) for s in strs), dtype=np.int64,
                           count=len(strs))
        if joined.isascii():
            buf = np.frombuffer(joined.encode("ascii"),
                                dtype=np.uint8)
            bad = ~_ASCII_OK[buf]
            cbad = np.concatenate(
                (np.zeros(1, dtype=np.int64), np.cumsum(bad)))
            ends = np.cumsum(lens)
            str_ok = (cbad[ends] - cbad[ends - lens]) == 0
            str_ok &= lens > 0
        else:
            # mixed batch: screen each still-ASCII string, punt the
            # unicode ones (letters may be legal) to the scalar path
            str_ok = np.zeros(len(strs), dtype=bool)
            for j, s in enumerate(strs):
                if s and s.isascii():
                    b = np.frombuffer(s.encode("ascii"),
                                      dtype=np.uint8)
                    str_ok[j] = bool(_ASCII_OK[b].all())
        for j in np.nonzero(~str_ok)[0]:
            fallback.add(owner[j])
    for i in fallback:
        metric, tags = series[i]
        try:
            check_metric_and_tags(metric, tags)
        except (KeyError, TypeError, ValueError) as exc:
            out[i] = str(exc)
    return out
