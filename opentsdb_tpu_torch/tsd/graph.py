"""The ``/q`` graphing endpoint (ref: ``src/tsd/GraphHandler.java:61``,
``opentsdb_tpu/tsd/graph.py``).

The reference shells out to gnuplot (:785) writing PNG files to a disk
cache; here charts render with matplotlib (Agg backend), imported when a
chart is drawn, and the endpoint also serves the ASCII and JSON outputs
the reference supports (``ascii``, ``json`` query params). Without
matplotlib a PNG request runs its query, then answers 501 (the JAX
package's contract). File caching honors ``tsd.http.cachedir`` like the
reference's ``/q`` cache (:517).

The query runs on the port's engine, on the card: a PNG render first
sets the query's pixel budget from ``wxh``, so the M4 reduction runs
after the kernels. A PNG still in the cache (younger than
``max_age``) is served before the query runs, as the Java reference's
GraphHandler checks its disk cache first (``isDiskCacheHit``); the JAX
package runs the query and then serves the cached file (ROADMAP Queue
3 item 30).

Plot option surface (ref: ``src/graph/Plot.java:40`` setParams and the
query params GraphHandler forwards): ``wxh``, ``title``, ``ylabel`` /
``y2label``, ``yrange`` / ``y2range`` (gnuplot ``[lo:hi]`` form),
``ylog`` / ``y2log``, ``yformat`` / ``y2format``, ``key`` (position
words) / ``nokey``, ``bgcolor`` / ``fgcolor`` (gnuplot ``xRRGGBB``),
``style`` (linespoint/points/circles/dots), ``smooth``, and per-metric
``o`` options where ``axis x1y2`` routes that sub-query to the right
axis (ref: GraphHandler parsing the per-metric options list).
"""

from __future__ import annotations

import hashlib
import io
import os
import re
import time

import numpy as np

from opentsdb_tpu_torch.query.model import parse_uri_query


def _parse_range(spec: str) -> tuple[float | None, float | None]:
    """gnuplot ``[lo:hi]`` (either side may be empty)."""
    m = re.match(r"^\[([^:\]]*):([^:\]]*)\]$", spec.strip())
    if not m:
        raise ValueError(f"invalid range {spec!r} (want [lo:hi])")
    lo = float(m.group(1)) if m.group(1).strip() else None
    hi = float(m.group(2)) if m.group(2).strip() else None
    return lo, hi


def _color(spec: str) -> str:
    """gnuplot ``xRRGGBB`` -> matplotlib ``#RRGGBB``."""
    s = spec.strip()
    return "#" + s[1:] if s.lower().startswith("x") else s


_KEY_LOC = {
    # gnuplot key position words -> matplotlib legend loc
    "top right": "upper right", "top left": "upper left",
    "bottom right": "lower right", "bottom left": "lower left",
    "center": "center",
}

_STYLES = {
    # ref: Plot.java style parameter values
    "linespoint": {"linestyle": "-", "marker": "o", "markersize": 3},
    "points": {"linestyle": "", "marker": "o", "markersize": 3},
    "circles": {"linestyle": "", "marker": "o", "markersize": 5,
                "fillstyle": "none"},
    "dots": {"linestyle": "", "marker": ",", "markersize": 1},
}


def _smooth(xs: np.ndarray, ys: np.ndarray
            ) -> tuple[np.ndarray, np.ndarray]:
    """gnuplot ``smooth csplines`` analogue: dense monotone
    interpolation through the points (numpy-only)."""
    if len(xs) < 3:
        return xs, ys
    dense = np.linspace(xs[0], xs[-1], max(len(xs) * 8, 256))
    return dense, np.interp(dense, xs, ys)


def series_label(r) -> str:
    """Legend label for one result series: ``metric{k=v,...}``."""
    label = r.metric
    if r.tags:
        label += "{" + ",".join(f"{k}={v}"
                                for k, v in sorted(r.tags.items())) + "}"
    return label


def plot_results_basic(ax, results, smooth=None, style_kw=None,
                       axis_for=None) -> None:
    """Plot each result series (shared by the /q renderer and the CLI
    ``tsdb query --graph`` output). ``axis_for(r)`` may route a series
    to another axes (the /q per-metric ``o=axis x1y2`` option)."""
    style_kw = style_kw or {}
    for r in results:
        xs = np.asarray([ts / 1000 for ts, _ in r.dps])
        ys = np.asarray([v for _, v in r.dps], dtype=float)
        if smooth and not style_kw.get("linestyle") == "":
            xs, ys = _smooth(xs, ys)
        target = axis_for(r) if axis_for is not None else ax
        target.plot(xs, ys, label=series_label(r), linewidth=1,
                    **style_kw)


def handle_graph(router, request):
    from opentsdb_tpu_torch.stats.stats import QueryStats
    from opentsdb_tpu_torch.tsd.http_api import HttpError, HttpResponse
    tsq = parse_uri_query(request.params)
    if not tsq.queries:
        raise HttpError(400, "Missing 'm' parameter",
                        "Nothing to graph without a metric query")
    # PNG renders know their own pixel budget: the chart is `wxh` wide,
    # so M4-reduce the query output to that width unless the caller
    # set an explicit `downsample=<N>px` (or opted out with `0px`).
    # Visually lossless by construction — the renderer rasterizes onto
    # exactly those columns — and it caps the points matplotlib has to
    # draw. ascii/json outputs are data exports: never auto-reduced.
    render_png = not (request.flag("ascii")
                      or request.param("format") == "ascii"
                      or request.flag("json")
                      or request.param("format") == "json")
    if render_png and request.param("downsample") is None \
            and not any(q.pixels or q.percentiles
                        for q in tsq.queries) \
            and router.tsdb.config.get_bool(
                "tsd.http.graph.auto_pixels", True):
        try:
            tsq.pixels = int((request.param("wxh")
                              or "1024x768").split("x")[0])
        except (ValueError, IndexError):
            pass  # a malformed wxh fails below in the renderer
    tsq.validate()
    if render_png:
        cached = _cached_png(router, request)
        if cached is not None:
            return HttpResponse(200, cached, content_type="image/png")
    stats = QueryStats(
        request.remote, tsq,
        allow_duplicates=router.tsdb.config.get_bool(
            "tsd.query.allow_simultaneous_duplicates", True))
    try:
        results = router.tsdb.new_query().run(tsq, stats)
        response = _render(router, request, tsq, results)
        stats.mark_serialization_successful()
        return response
    finally:
        # query OR render failures stay executed=False
        stats.mark_complete()


def _cache_file(router, request) -> str:
    """The request's PNG in ``tsd.http.cachedir``, named by a hash of
    its parameters (ref: GraphHandler's cache under ``tsd.http.cachedir``,
    :517)."""
    key = hashlib.sha1(repr(sorted(request.params.items()))
                       .encode()).hexdigest()
    return os.path.join(router.tsdb.config.get_string("tsd.http.cachedir"),
                        f"{key}.png")


def _cached_png(router, request) -> bytes | None:
    """The cached PNG of this request when it is younger than
    ``max_age`` seconds (default 60), else None."""
    path = _cache_file(router, request)
    max_age = int(request.param("max_age", "60"))
    if os.path.isfile(path) and \
            time.time() - os.path.getmtime(path) < max_age:
        with open(path, "rb") as fh:
            return fh.read()
    return None


def _render(router, request, tsq, results):
    from opentsdb_tpu_torch.tsd.http_api import HttpError, HttpResponse

    if request.flag("ascii") or request.param("format") == "ascii":
        # one line per point: metric timestamp value tags (ref:
        # GraphHandler ascii output == `tsdb query` format)
        lines = []
        for r in results:
            tag_str = " ".join(f"{k}={v}" for k, v in sorted(r.tags.items()))
            for ts, v in r.dps:
                lines.append(f"{r.metric} {ts // 1000} {v:g} {tag_str}"
                             .rstrip())
        return HttpResponse(200, "\n".join(lines).encode(),
                            content_type="text/plain")
    if request.flag("json") or request.param("format") == "json":
        body = request.serializer.format_query(tsq, results)
        return HttpResponse(200, body)

    # PNG rendering
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        raise HttpError(
            501, "Graphing requires matplotlib",
            "Install matplotlib or request ?json / ?ascii") from None

    cache_file = _cache_file(router, request)
    os.makedirs(os.path.dirname(cache_file), exist_ok=True)

    wxh = (request.param("wxh") or "1024x768").split("x")
    fig, ax = plt.subplots(
        figsize=(int(wxh[0]) / 100, int(wxh[1]) / 100), dpi=100)
    fg = request.param("fgcolor")
    bg = request.param("bgcolor")
    if bg:
        fig.patch.set_facecolor(_color(bg))
        ax.set_facecolor(_color(bg))
    if fg:
        for spine in ax.spines.values():
            spine.set_color(_color(fg))
        ax.tick_params(colors=_color(fg))
        ax.xaxis.label.set_color(_color(fg))
        ax.yaxis.label.set_color(_color(fg))
        ax.title.set_color(_color(fg))

    # per-metric option strings align with the m= sub-queries; the one
    # recognized directive routes a sub-query to the right-hand axis
    # (ref: GraphHandler "o" parameter, gnuplot "axis x1y2")
    opts = request.params.get("o", [])
    ax2 = None
    if any("x1y2" in o for o in opts):
        ax2 = ax.twinx()
    style_kw = _STYLES.get(request.param("style", ""), {})
    smooth = request.flag("smooth") or request.param("smooth")

    def axis_for(r):
        if ax2 is not None and r.sub_query_index < len(opts) and \
                "x1y2" in opts[r.sub_query_index]:
            return ax2
        return ax

    plot_results_basic(ax, results, smooth=smooth, style_kw=style_kw,
                       axis_for=axis_for)

    # annotation markers: dashed vertical lines at each note's start
    # (ref: Plot.java renders annotations as gnuplot arrows/labels on
    # the legacy UI's charts)
    seen_notes = set()
    for r in results:
        for a in list(getattr(r, "annotations", [])) + \
                list(getattr(r, "global_annotations", [])):
            key = (a.tsuid, a.start_time)
            if key in seen_notes:
                continue
            seen_notes.add(key)
            ax.axvline(a.start_time, color="#996515", linestyle="--",
                       linewidth=0.9, alpha=0.8)
            if a.description:
                ax.annotate(a.description[:24], xy=(a.start_time, 1.0),
                            xycoords=("data", "axes fraction"),
                            fontsize=7, color="#996515", rotation=90,
                            va="top", ha="right")

    if request.param("title"):
        ax.set_title(request.param("title"))
    if request.param("ylabel"):
        ax.set_ylabel(request.param("ylabel"))
    if ax2 is not None and request.param("y2label"):
        ax2.set_ylabel(request.param("y2label"))
    if request.param("yrange"):
        lo, hi = _parse_range(request.param("yrange"))
        ax.set_ylim(bottom=lo, top=hi)
    if ax2 is not None and request.param("y2range"):
        lo, hi = _parse_range(request.param("y2range"))
        ax2.set_ylim(bottom=lo, top=hi)
    if request.flag("ylog"):
        ax.set_yscale("log")
    if ax2 is not None and request.flag("y2log"):
        ax2.set_yscale("log")
    if request.param("yformat"):
        from matplotlib.ticker import FormatStrFormatter
        ax.yaxis.set_major_formatter(
            FormatStrFormatter(request.param("yformat")))
    if ax2 is not None and request.param("y2format"):
        from matplotlib.ticker import FormatStrFormatter
        ax2.yaxis.set_major_formatter(
            FormatStrFormatter(request.param("y2format")))
    if not request.flag("nokey") and results:
        loc = _KEY_LOC.get(" ".join(
            (request.param("key") or "").replace("out", "")
            .split()), "best")
        handles, labels = ax.get_legend_handles_labels()
        if ax2 is not None:
            h2, l2 = ax2.get_legend_handles_labels()
            handles += h2
            labels += l2
        ax.legend(handles, labels, loc=loc, fontsize=8)
    ax.grid(True, alpha=0.3)
    fig.autofmt_xdate()
    buf = io.BytesIO()
    fig.savefig(buf, format="png",
                facecolor=fig.get_facecolor() if bg else "white")
    plt.close(fig)
    png = buf.getvalue()
    with open(cache_file, "wb") as fh:
        fh.write(png)
    return HttpResponse(200, png, content_type="image/png")
