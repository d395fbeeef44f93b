"""``tsdb check`` — Nagios-compatible threshold alerting over a live TSD
(ref: ``tools/check_tsd``, ``opentsdb_tpu/tools/check_tsd.py``: queries
``/q?...&ascii`` and compares the returned datapoints against
warning/critical thresholds).

Same flag surface and exit-code contract as the reference script
(0 = OK, 1 = WARNING, 2 = CRITICAL), reimplemented with
argparse + urllib over the same ``/q`` ascii endpoint.
"""

from __future__ import annotations

import argparse
import operator
import time
import urllib.error
import urllib.request

COMPARATORS = {"gt": operator.gt, "ge": operator.ge, "lt": operator.lt,
               "le": operator.le, "eq": operator.eq, "ne": operator.ne}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tsdb check",
        description="Simple TSDB data extractor for Nagios.")
    p.add_argument("-H", "--host", default="localhost")
    p.add_argument("-p", "--port", type=int, default=4242)
    p.add_argument("-m", "--metric", required=True)
    p.add_argument("-t", "--tag", action="append", default=[])
    p.add_argument("-d", "--duration", type=int, default=600,
                   help="How far back to look for data (seconds).")
    p.add_argument("-D", "--downsample", default="none")
    p.add_argument("-W", "--downsample-window", type=int, default=60)
    p.add_argument("-F", "--downsample-fill-policy", default="none",
                   choices=("none", "nan", "null", "zero"))
    p.add_argument("-a", "--aggregator", default="sum")
    p.add_argument("-x", "--method", dest="comparator", default="gt",
                   choices=sorted(COMPARATORS))
    p.add_argument("-r", "--rate", action="store_true")
    p.add_argument("-w", "--warning", type=float)
    p.add_argument("-c", "--critical", type=float)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-T", "--timeout", type=int, default=10)
    p.add_argument("-E", "--no-result-ok", action="store_true")
    p.add_argument("-I", "--ignore-recent", type=int, default=0)
    p.add_argument("-P", "--percent-over", type=float, default=0.0)
    p.add_argument("-N", "--now", type=int, default=None,
                   help='Unix timestamp for "now" (testing).')
    p.add_argument("-S", "--ssl", action="store_true")
    return p


def build_url(o) -> str:
    tags = ",".join(o.tag)
    tags = "{" + tags + "}" if tags else ""
    ds = ("" if o.downsample == "none" else
          f"{o.downsample_window}s-{o.downsample}-"
          f"{o.downsample_fill_policy}:")
    rate = "rate:" if o.rate else ""
    start = (f"{o.now - o.duration}" if o.now
             else f"{o.duration}s-ago")
    scheme = "https" if o.ssl else "http"
    return (f"{scheme}://{o.host}:{o.port}/q?start={start}"
            f"&m={o.aggregator}:{ds}{rate}{o.metric}{tags}&ascii&nagios")


def main(argv: list[str]) -> int:
    parser = build_parser()
    o = parser.parse_args(argv)
    if o.duration <= 0:
        parser.error("Duration must be strictly positive.")
    if o.downsample_window <= 0:
        parser.error("Downsample window must be strictly positive.")
    if o.critical is None and o.warning is None:
        parser.error("You must specify at least a warning threshold "
                     "(-w) or a critical threshold (-c).")
    if o.ignore_recent < 0:
        parser.error("--ignore-recent must be positive.")
    if not 0 <= o.percent_over <= 100:
        parser.error("--percent-over must be in the range 0..100.")
    percent_over = o.percent_over / 100.0
    if o.critical is None:
        o.critical = o.warning
    elif o.warning is None:
        o.warning = o.critical

    url = build_url(o)
    if o.verbose:
        print(f"GET {url}")
    try:
        with urllib.request.urlopen(url, timeout=o.timeout) as resp:
            status = resp.status
            body = resp.read().decode("utf-8", "replace")
    except urllib.error.HTTPError as e:
        print(f"CRITICAL: status = {e.code} when talking to "
              f"{o.host}:{o.port}")
        if o.verbose:
            print("TSD said:")
            print(e.read().decode("utf-8", "replace"))
        return 2
    except OSError as e:
        print(f"ERROR: couldn't GET {url}: {e}")
        return 2
    if status not in (200, 202):
        print(f"CRITICAL: status = {status} when talking to "
              f"{o.host}:{o.port}")
        return 2

    def no_data_point() -> int:
        if o.no_result_ok:
            print("OK: query did not return any data point "
                  "(--no-result-ok)")
            return 0
        print("CRITICAL: query did not return any data point")
        return 2

    lines = [ln for ln in body.splitlines() if ln.strip()]
    if not lines:
        return no_data_point()

    cmp_fn = COMPARATORS[o.comparator]
    now = o.now or int(time.time())
    npoints = nwarn = ncrit = 0
    badval = badts = None
    for line in lines:
        fields = line.split()
        ts = int(fields[1])
        delta = now - ts
        if delta > o.duration or delta <= o.ignore_recent:
            if delta < 0:
                break
            continue
        raw = fields[2]
        try:
            val = float(raw)
        except ValueError:
            continue  # unparseable cell
        if val != val:  # NaN fill (-F nan) — no data, not a violation
            continue
        npoints += 1
        bad = False
        if cmp_fn(val, o.critical):
            bad = True
            ncrit += 1
            nwarn += 1
        elif cmp_fn(val, o.warning):
            bad = True
            nwarn += 1
        if bad and (badval is None or cmp_fn(val, badval)):
            badval, badts = val, ts
    if not npoints:
        return no_data_point()
    if ncrit > 0 and ncrit / npoints > percent_over:
        rv, nbad, thresh = 2, ncrit, o.critical
    elif nwarn > 0 and nwarn / npoints > percent_over:
        rv, nbad, thresh = 1, nwarn, o.warning
    else:
        rv, nbad, thresh = 0, 0, None
    state = {0: "OK", 1: "WARNING", 2: "CRITICAL"}[rv]
    if rv:
        when = time.asctime(time.localtime(badts))
        print(f"{state}: {nbad}/{npoints} points {o.comparator} "
              f"{thresh} for {o.metric} (worst: {badval} @ {when})")
    else:
        print(f"{state}: {npoints} points within thresholds for "
              f"{o.metric}")
    return rv
