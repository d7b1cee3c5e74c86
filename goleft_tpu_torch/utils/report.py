"""Interactive HTML (chart.js) + static PNG (matplotlib) report writers.

Covers the reference's reporting layer (indexcov/plot.go, 577 LoC +
indexcov/template.go) with our own template: each page is a self-contained
HTML document loading chart.js from a CDN, mirroring the reference's output
surface (<base>-depth-<chrom>.html, <base>-roc-<chrom>.html, index.html,
and .png twins). Honors the same environment knobs: INDEXCOV_FMT (extra
static formats, plot.go:528-536).

A copy of the JAX package's utils/report.py (host code, no device work):
the same page and PNG bytes. PNGs need Pillow, or matplotlib as the
fallback; with neither installed ``save_png`` writes nothing.
"""

from __future__ import annotations

import json
import os
import random


_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<script src="https://cdn.jsdelivr.net/npm/chart.js@2.9.4/dist/Chart.min.js"></script>
<style>
body {{ font-family: sans-serif; margin: 20px; }}
.chartbox {{ display: inline-block; margin: 10px; }}
h2 {{ font-weight: normal; }}
nav a {{ margin-right: 12px; }}
</style></head>
<body>
{nav}
{body}
<script>
{scripts}
</script>
</body></html>
"""


_HTML_MAX_POINTS = 2048  # per series; INDEXCOV_HTML_MAX_POINTS overrides


def _html_max_points() -> int:
    """Per-series point cap for interactive charts. The reference
    subsamples its static plots 1/5-1/10 at whole-genome sizes for
    exactly this reason (indexcov/plot.go:484-487); an 850px canvas
    cannot show more than ~1700 distinct x anyway, and chart.js with
    30x15k points is unusably slow in-browser. 0 disables."""
    try:
        return max(0, int(os.environ.get("INDEXCOV_HTML_MAX_POINTS",
                                         str(_HTML_MAX_POINTS))))
    except ValueError:
        return _HTML_MAX_POINTS


def _subsample_xy(x, y, cap: int):
    """Stride-subsample to <= cap+1 points, always keeping the last
    point so the x-extent (chromosome end) is preserved."""
    import numpy as np

    if not cap or len(x) <= cap:
        return x, y
    xa = np.asarray(x)
    ya = np.asarray(y)
    stride = -(-len(xa) // cap)
    idx = np.arange(0, len(xa), stride)
    if idx[-1] != len(xa) - 1:
        idx = np.append(idx, len(xa) - 1)
    return xa[idx], ya[idx]


def _n_backgrounds() -> int:
    """INDEXCOV_N_BACKGROUNDS: the first n samples plot gray
    (reference plot.go:85-96)."""
    try:
        return int(os.environ.get("INDEXCOV_N_BACKGROUNDS", "") or 0)
    except ValueError:
        return 0


def _color_rgb(i: int, background: bool = False) -> tuple[int, int, int]:
    if background:
        return (180, 180, 180)
    rng = random.Random(i)
    return (rng.randrange(256), rng.randrange(256), rng.randrange(256))


def _color(i: int, background: bool = False) -> str:
    r, g, b = _color_rgb(i, background)
    return f"rgba({r},{g},{b},0.94)"


def line_chart(
    chart_id: str,
    series: list[dict],
    xlabel: str,
    ylabel: str,
    y_max: float | None = None,
    stepped: bool = True,
    legend: bool = True,
    per_sample: bool = True,
) -> tuple[str, str]:
    """Return (div html, js) for a multi-series line chart.

    series entries: {"label", "x": list, "y": list, optional "color"}.
    ``per_sample`` marks series as one-per-sample, which honors
    INDEXCOV_N_BACKGROUNDS (first n gray — reference randomColor(i,
    check=true), plot.go:98-107; scatter/group charts pass check=false).
    """
    from ..io import native

    n_bg = _n_backgrounds() if per_sample else 0
    dataset_parts = []
    for i, s in enumerate(series):
        meta = {
            "label": s["label"],
            "fill": False,
            "pointRadius": 0,
            "borderWidth": s.get("width", 0.75),
            "borderColor": s.get("color", _color(i, background=i < n_bg)),
            "backgroundColor": s.get("color",
                                     _color(i, background=i < n_bg)),
            "steppedLine": stepped,
            "pointHitRadius": 6,
        }
        # whole-genome series are stride-subsampled to the canvas's
        # useful resolution before serialization — at 30 samples x 25
        # chroms this cuts the written html ~7x and was 60% of the
        # indexcov e2e wall on slow filesystems
        sx, sy = _subsample_xy(s["x"], s["y"], _html_max_points())
        # point serialization is the report writer's hot loop at
        # whole-genome sizes — C++ formats the pair array directly; the
        # Python fallback emits the SAME bytes (%.10g/%.5g, null for
        # non-finite — json.dumps would write invalid NaN literals)
        b = native.format_xy_json(sx, sy)
        if b is not None:
            data_json = b.decode("ascii")
        else:
            import math

            def _pt(v, prec):
                v = float(v)
                return format(v, f".{prec}g") if math.isfinite(v) \
                    else "null"

            data_json = "[" + ",".join(
                f'{{"x":{_pt(x, 10)},"y":{_pt(y, 5)}}}'
                for x, y in zip(sx, sy)
            ) + "]"
        mjson = json.dumps(meta)
        dataset_parts.append(mjson[:-1] + ',"data":' + data_json + "}")
    datasets_json = "[" + ",".join(dataset_parts) + "]"
    opts = {
        "responsive": False,
        "animation": False,
        "legend": {"display": legend},
        "tooltips": {"mode": "nearest"},
        "scales": {
            "xAxes": [
                {
                    "type": "linear",
                    "position": "bottom",
                    "scaleLabel": {"display": True, "labelString": xlabel,
                                   "fontSize": 16},
                }
            ],
            "yAxes": [
                {
                    "type": "linear",
                    "position": "left",
                    "ticks": ({"min": 0, "max": y_max} if y_max else {}),
                    "scaleLabel": {"display": True, "labelString": ylabel,
                                   "fontSize": 16},
                }
            ],
        },
    }
    div = (
        f'<div class="chartbox"><canvas id="{chart_id}" width="850" '
        f'height="550"></canvas></div>'
    )
    js = (
        f'new Chart(document.getElementById("{chart_id}").getContext("2d"),'
        f'{{"type":"line","data":{{"datasets":{datasets_json}}},'
        f'"options":{json.dumps(opts)}}});'
    )
    return div, js


def scatter_chart(
    chart_id: str,
    points: list[dict],
    xlabel: str,
    ylabel: str,
    labels: list[str] | None = None,
) -> tuple[str, str]:
    """points: [{"label", "x": [..], "y": [..], "names": [..]}] groups."""
    datasets = []
    for i, g in enumerate(points):
        data = [
            {"x": round(float(x), 4), "y": round(float(y), 4)}
            for x, y in zip(g["x"], g["y"])
        ]
        datasets.append(
            {
                "label": g["label"],
                "data": data,
                "pointRadius": 4,
                "pointHitRadius": 6,
                "showLine": False,
                "fill": False,
                "backgroundColor": g.get("color", _color(i + 7)),
                "borderColor": g.get("color", _color(i + 7)),
            }
        )
    names = json.dumps([g.get("names", []) for g in points])
    opts = {
        "responsive": False,
        "animation": False,
        "tooltips": {"mode": "nearest"},
        "scales": {
            "xAxes": [{"type": "linear", "position": "bottom",
                       "scaleLabel": {"display": True,
                                      "labelString": xlabel}}],
            "yAxes": [{"type": "linear", "position": "left",
                       "scaleLabel": {"display": True,
                                      "labelString": ylabel}}],
        },
    }
    div = (
        f'<div class="chartbox"><canvas id="{chart_id}" width="650" '
        f'height="550"></canvas></div>'
    )
    js = (
        f'(function(){{var names={names};'
        f'var cfg={{"type":"scatter","data":{{"datasets":'
        f'{json.dumps(datasets)}}},"options":{json.dumps(opts)}}};'
        f'cfg.options.tooltips.callbacks={{label:function(t,d){{'
        f'return (names[t.datasetIndex][t.index]||"")+" ("+t.xLabel+", "+'
        f't.yLabel+")";}}}};'
        f'new Chart(document.getElementById("{chart_id}").getContext("2d"),'
        f"cfg);}})();"
    )
    return div, js


def write_page(path: str, title: str, charts: list[tuple[str, str]],
               nav_html: str = "", extra_html: str = "") -> None:
    body = "\n".join(div for div, _ in charts) + extra_html
    scripts = "\n".join(js for _, js in charts)
    page = _PAGE.format(title=title, nav=nav_html, body=body,
                        scripts=scripts)
    # binary write: these pages are tens of MB at whole-genome sizes and
    # the text-codec write path costs ~2x a single encode
    with open(path, "wb") as fh:
        fh.write(page.encode("utf-8"))


def _nice_ticks(lo: float, hi: float, n: int = 5) -> list[float]:
    """~n round tick positions covering [lo, hi]."""
    import math

    span = hi - lo
    if span <= 0 or not math.isfinite(span):
        return [lo]
    raw = span / n
    mag = 10.0 ** math.floor(math.log10(raw))
    for mult in (1.0, 2.0, 2.5, 5.0, 10.0):
        if raw <= mult * mag:
            step = mult * mag
            break
    t0 = math.ceil(lo / step) * step
    out = []
    t = t0
    while t <= hi + step * 1e-9:
        out.append(0.0 if abs(t) < step * 1e-9 else t)
        t += step
    return out


def _tick_label(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        a = abs(int(v))
        if a >= 10_000_000:  # genomic positions: Mb units read better
            return f"{v / 1e6:g}M"
        return str(int(v))
    return f"{v:g}"


def save_png(path: str, series: list[dict], xlabel: str, ylabel: str,
             y_max: float | None = None, kind: str = "line",
             subsample: int = 1) -> None:
    """Static twin of the html charts (the reference renders PNGs via
    gonum/plot with 1/5-1/10 subsampling, plot.go:484-487).

    Rasterized directly with Pillow: the former matplotlib renderer cost
    ~180ms per whole-genome panel (axes machinery + path drawing was
    ~40% of indexcov e2e wall); drawing the polylines into an RGB canvas
    is ~100x cheaper. matplotlib remains the fallback when INDEXCOV_FMT
    requests non-png formats (svg/pdf/...)."""
    extra = os.environ.get("INDEXCOV_FMT", "")
    if extra:
        _save_matplotlib(path, series, xlabel, ylabel, y_max, kind,
                         subsample, extra)
        return
    try:
        from PIL import Image, ImageDraw, ImageFont
    except Exception:  # pragma: no cover - pillow always in image
        _save_matplotlib(path, series, xlabel, ylabel, y_max, kind,
                         subsample, "")
        return
    import numpy as np

    W, H = 480, 360
    ML, MR, MT, MB = 58, 12, 10, 44
    img = Image.new("RGB", (W, H), (255, 255, 255))
    draw = ImageDraw.Draw(img)
    font = ImageFont.load_default()

    # data ranges
    xlo, xhi = np.inf, -np.inf
    ylo, yhi = 0.0, -np.inf
    pre = []
    for s in series:
        x = np.asarray(s["x"], dtype=np.float64)[::subsample]
        y = np.asarray(s["y"], dtype=np.float64)[::subsample]
        # a 480-pixel panel cannot show more than ~2500 distinct steps
        if len(x) > 2500:
            step = (len(x) + 2499) // 2500
            x = x[::step]
            y = y[::step]
        ok = np.isfinite(x) & np.isfinite(y)
        x, y = x[ok], y[ok]
        pre.append((x, y))
        if len(x):
            xlo = min(xlo, float(x.min()))
            xhi = max(xhi, float(x.max()))
            ylo = min(ylo, float(y.min()))
            yhi = max(yhi, float(y.max()))
    if not np.isfinite(xlo) or xhi <= xlo:
        xlo, xhi = 0.0, 1.0
    if y_max is not None:
        ylo, yhi = 0.0, float(y_max)
    if not np.isfinite(yhi) or yhi <= ylo:
        ylo, yhi = 0.0, 1.0
    xspan, yspan = xhi - xlo, yhi - ylo
    pw, ph = W - ML - MR, H - MT - MB

    def px(x):
        return ML + (x - xlo) * (pw / xspan)

    def py(y):
        return MT + (yhi - y) * (ph / yspan)

    axis = (60, 60, 60)
    # frame + ticks + labels
    draw.rectangle([ML, MT, W - MR, H - MB], outline=axis)
    for t in _nice_ticks(xlo, xhi):
        xp = px(t)
        draw.line([xp, H - MB, xp, H - MB + 4], fill=axis)
        draw.text((xp, H - MB + 6), _tick_label(t), fill=axis, font=font,
                  anchor="ma")
    for t in _nice_ticks(ylo, yhi):
        yp = py(t)
        draw.line([ML - 4, yp, ML, yp], fill=axis)
        draw.text((ML - 6, yp), _tick_label(t), fill=axis, font=font,
                  anchor="rm")
    draw.text((ML + pw / 2, H - 16), xlabel, fill=(0, 0, 0), font=font,
              anchor="ma")
    # vertical y label rendered into a side strip
    if ylabel:
        strip = Image.new("RGB", (ph, 14), (255, 255, 255))
        ImageDraw.Draw(strip).text((ph // 2, 1), ylabel, fill=(0, 0, 0),
                                   font=font, anchor="ma")
        img.paste(strip.transpose(Image.ROTATE_90), (2, MT))

    n_bg = _n_backgrounds() if kind == "line" else 0
    for i, (x, y) in enumerate(pre):
        if not len(x):
            continue
        rgb = series[i].get("_rgb") or _color_rgb(i, background=i < n_bg)
        xs = px(x)
        ys = py(np.clip(y, ylo, yhi))
        if kind == "line":
            if len(x) > 1:
                # stepped (where="post"): insert (x[k+1], y[k]) knees
                fx = np.empty(2 * len(x) - 1)
                fy = np.empty_like(fx)
                fx[0::2] = xs
                fx[1::2] = xs[1:]
                fy[0::2] = ys
                fy[1::2] = ys[:-1]
            else:
                fx, fy = xs, ys
            flat = np.empty(2 * len(fx))
            flat[0::2] = fx
            flat[1::2] = fy
            draw.line(flat.tolist(), fill=rgb, width=1)
        else:
            for xp, yp in zip(xs, ys):
                draw.ellipse([xp - 3, yp - 3, xp + 3, yp + 3], fill=rgb)
    img.save(path, compress_level=1)


import threading as _threading

_MPL_LOCK = _threading.Lock()


def _save_matplotlib(path, series, xlabel, ylabel, y_max, kind,
                     subsample, extra) -> None:
    # indexcov renders pages from worker threads; pyplot's global
    # figure manager is not thread-safe, so the fallback serializes
    with _MPL_LOCK:
        _save_matplotlib_locked(path, series, xlabel, ylabel, y_max,
                                kind, subsample, extra)


def _save_matplotlib_locked(path, series, xlabel, ylabel, y_max, kind,
                            subsample, extra) -> None:
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # pragma: no cover - matplotlib always in image
        return
    fig, ax = plt.subplots(figsize=(4, 3), dpi=120)
    for i, s in enumerate(series):
        x = s["x"][::subsample]
        y = s["y"][::subsample]
        # a 480-pixel-wide panel cannot show more than ~2500 distinct
        # steps; cap the vertex count so whole-genome renders don't pay
        # matplotlib path costs for invisible detail
        if len(x) > 2500:
            step = (len(x) + 2499) // 2500
            x = x[::step]
            y = y[::step]
        if kind == "line":
            ax.step(x, y, lw=0.5, where="post")
        else:
            ax.plot(x, y, "o", ms=3)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    if y_max is not None:
        ax.set_ylim(0, y_max)
    fig.tight_layout()
    fmts = [path]
    if extra:
        base = path.rsplit(".", 1)[0]
        fmts += [f"{base}.{e}" for e in extra.split(",") if e]
    for p in fmts:
        fig.savefig(p)
    plt.close(fig)
