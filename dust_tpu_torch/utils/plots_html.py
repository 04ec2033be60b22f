"""Interactive HTML charts with no dependency but numpy (counterpart of
`dust_tpu/utils/plots_html.py`).

Self-contained HTML pages (inline SVG and a little vanilla JavaScript, no
network) with a tooltip on the nearest point, a legend that toggles its
series and a dragged interval that zooms x (a double click resets):

* `html_mean_results(columns, value=..., save_path=...)`
* `html_stein_particles(columns, save_path=...)`
* `html_part2d_cost(costs_list, save_path=...)`
* `html_part2d_traj(model, trajectories, save_path=...)`

and the vega-lite v5 spec of the mean-results chart
(`vega_lite_mean_results`, `vega_embed_html`).

Where JAX takes a DataFrame, these take the column mapping that
`PendulumSimulation.run` returns (a dict of numpy arrays, one row per
step; a "Case" column of labels where several cases are combined). A
DataFrame is a mapping of columns too and gives the same page. Groups
are formed with numpy, with pandas' arithmetic (`group_mean_std`), so on
the same data each function returns JAX's string to the character.
"""

from __future__ import annotations

import json
import math

import numpy as np

from .helper import to_np

_PALETTE = ["#4c78a8", "#f58518", "#54a24b", "#e45756", "#72b7b2",
            "#b279a2", "#9d755d", "#eeca3b"]

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ font: 13px sans-serif; margin: 16px; }}
 .tip {{ position: absolute; pointer-events: none; background: #222;
        color: #fff; padding: 4px 7px; border-radius: 3px;
        font-size: 12px; display: none; white-space: pre; }}
 .legend span {{ cursor: pointer; margin-right: 14px;
                user-select: none; }}
 .legend .off {{ opacity: 0.3; text-decoration: line-through; }}
 svg {{ background: #fff; }}
</style></head>
<body>
<h3>{title}</h3>
<div class="legend" id="legend"></div>
<svg id="chart" width="{w}" height="{h}"></svg>
<div class="tip" id="tip"></div>
<script>
const DATA = {data};
const W = {w}, H = {h}, M = {{l: 55, r: 15, t: 10, b: 38}};
const svg = document.getElementById("chart");
const tip = document.getElementById("tip");
const NS = "http://www.w3.org/2000/svg";
let xdom = null;           // [lo, hi] zoom window (null = full)
const hidden = new Set();

function extent(vals) {{
  let lo = Infinity, hi = -Infinity;
  for (const v of vals) {{ if (v < lo) lo = v; if (v > hi) hi = v; }}
  if (lo === hi) {{ lo -= 1; hi += 1; }}
  return [lo, hi];
}}
function visible() {{
  return DATA.series.filter(s => !hidden.has(s.name));
}}
function draw() {{
  while (svg.firstChild) svg.removeChild(svg.firstChild);
  const vis = visible();
  const xs = [], ys = [];
  for (const s of vis) for (let i = 0; i < s.x.length; i++) {{
    if (xdom && (s.x[i] < xdom[0] || s.x[i] > xdom[1])) continue;
    xs.push(s.x[i]); ys.push(s.y[i]);
    if (s.lo) {{ ys.push(s.lo[i]); ys.push(s.hi[i]); }}
  }}
  if (!xs.length) return;
  const xe = xdom || extent(xs), ye = extent(ys);
  const sx = v => M.l + (v - xe[0]) / (xe[1] - xe[0]) * (W - M.l - M.r);
  const sy = v => H - M.b - (v - ye[0]) / (ye[1] - ye[0]) * (H - M.t - M.b);
  // background image (occupancy grid), if any
  if (DATA.image) {{
    const im = document.createElementNS(NS, "image");
    im.setAttribute("href", DATA.image.href);
    im.setAttribute("x", sx(DATA.image.x0));
    im.setAttribute("y", sy(DATA.image.y1));
    im.setAttribute("width", sx(DATA.image.x1) - sx(DATA.image.x0));
    im.setAttribute("height", sy(DATA.image.y0) - sy(DATA.image.y1));
    im.setAttribute("preserveAspectRatio", "none");
    im.style.imageRendering = "pixelated";
    svg.appendChild(im);
  }}
  // axes
  for (const [p1, p2] of [[[M.l, H - M.b], [W - M.r, H - M.b]],
                          [[M.l, M.t], [M.l, H - M.b]]]) {{
    const ln = document.createElementNS(NS, "line");
    ln.setAttribute("x1", p1[0]); ln.setAttribute("y1", p1[1]);
    ln.setAttribute("x2", p2[0]); ln.setAttribute("y2", p2[1]);
    ln.setAttribute("stroke", "#888");
    svg.appendChild(ln);
  }}
  for (let i = 0; i <= 5; i++) {{
    const xv = xe[0] + (xe[1] - xe[0]) * i / 5;
    const yv = ye[0] + (ye[1] - ye[0]) * i / 5;
    const tx = document.createElementNS(NS, "text");
    tx.setAttribute("x", sx(xv)); tx.setAttribute("y", H - M.b + 16);
    tx.setAttribute("text-anchor", "middle");
    tx.textContent = xv.toPrecision(4);
    svg.appendChild(tx);
    const ty = document.createElementNS(NS, "text");
    ty.setAttribute("x", M.l - 6); ty.setAttribute("y", sy(yv) + 4);
    ty.setAttribute("text-anchor", "end");
    ty.textContent = yv.toPrecision(4);
    svg.appendChild(ty);
  }}
  const lbx = document.createElementNS(NS, "text");
  lbx.setAttribute("x", (M.l + W - M.r) / 2);
  lbx.setAttribute("y", H - 4);
  lbx.setAttribute("text-anchor", "middle");
  lbx.textContent = DATA.xlabel;
  svg.appendChild(lbx);
  // series
  for (const s of vis) {{
    if (s.band && s.lo) {{
      let dp = "";
      for (let i = 0; i < s.x.length; i++)
        dp += (i ? "L" : "M") + sx(s.x[i]) + "," + sy(s.lo[i]);
      for (let i = s.x.length - 1; i >= 0; i--)
        dp += "L" + sx(s.x[i]) + "," + sy(s.hi[i]);
      const path = document.createElementNS(NS, "path");
      path.setAttribute("d", dp + "Z");
      path.setAttribute("fill", s.color); path.setAttribute("opacity", 0.15);
      svg.appendChild(path);
    }}
    if (s.kind === "line") {{
      let d = "";
      for (let i = 0; i < s.x.length; i++)
        d += (i ? "L" : "M") + sx(s.x[i]) + "," + sy(s.y[i]);
      const path = document.createElementNS(NS, "path");
      path.setAttribute("d", d);
      path.setAttribute("fill", "none");
      path.setAttribute("stroke", s.color);
      path.setAttribute("stroke-width", s.width || 1.5);
      if (s.opacity) path.setAttribute("opacity", s.opacity);
      svg.appendChild(path);
    }} else {{
      for (let i = 0; i < s.x.length; i++) {{
        const c = document.createElementNS(NS, "circle");
        c.setAttribute("cx", sx(s.x[i])); c.setAttribute("cy", sy(s.y[i]));
        c.setAttribute("r", 3.5);
        c.setAttribute("fill", s.colors ? s.colors[i] : s.color);
        svg.appendChild(c);
      }}
    }}
  }}
  svg._scales = {{sx, sy, xe, ye}};
}}
// legend
const leg = document.getElementById("legend");
for (const s of DATA.series) {{
  if (s.nolegend) continue;
  const el = document.createElement("span");
  el.innerHTML = "&#9632; " + s.name;
  el.style.color = s.color;
  el.onclick = () => {{
    hidden.has(s.name) ? hidden.delete(s.name) : hidden.add(s.name);
    el.classList.toggle("off");
    draw();
  }};
  leg.appendChild(el);
}}
// tooltip: nearest visible point
svg.addEventListener("mousemove", ev => {{
  const r = svg.getBoundingClientRect();
  const mx = ev.clientX - r.left, my = ev.clientY - r.top;
  const {{sx, sy}} = svg._scales || {{}};
  if (!sx) return;
  let best = null, bd = 400;
  for (const s of visible()) for (let i = 0; i < s.x.length; i++) {{
    const dx = sx(s.x[i]) - mx, dy = sy(s.y[i]) - my;
    const d = dx * dx + dy * dy;
    if (d < bd) {{ bd = d; best = [s, i]; }}
  }}
  if (best) {{
    const [s, i] = best;
    tip.style.display = "block";
    tip.style.left = (ev.pageX + 12) + "px";
    tip.style.top = (ev.pageY + 12) + "px";
    tip.textContent = s.name + "\\n" + DATA.xlabel + ": "
      + s.x[i].toPrecision(5) + "\\ny: " + s.y[i].toPrecision(5)
      + (s.extra ? "\\n" + s.extra[i] : "");
  }} else tip.style.display = "none";
}});
svg.addEventListener("mouseleave", () => tip.style.display = "none");
// interval x-zoom
let drag = null, band = null;
svg.addEventListener("mousedown", ev => {{
  const r = svg.getBoundingClientRect();
  drag = ev.clientX - r.left;
  band = document.createElementNS(NS, "rect");
  band.setAttribute("y", M.t); band.setAttribute("height", H - M.t - M.b);
  band.setAttribute("fill", "#4c78a8"); band.setAttribute("opacity", 0.2);
  svg.appendChild(band);
}});
svg.addEventListener("mousemove", ev => {{
  if (drag === null || !band) return;
  const r = svg.getBoundingClientRect();
  const x = ev.clientX - r.left;
  band.setAttribute("x", Math.min(drag, x));
  band.setAttribute("width", Math.abs(x - drag));
}});
svg.addEventListener("mouseup", ev => {{
  const r = svg.getBoundingClientRect();
  const x = ev.clientX - r.left;
  const {{sx, xe}} = svg._scales;
  if (Math.abs(x - drag) > 8) {{
    const inv = px => xe[0] + (px - M.l) / (W - M.l - M.r) * (xe[1] - xe[0]);
    xdom = [inv(Math.min(drag, x)), inv(Math.max(drag, x))];
  }}
  drag = null; draw();
}});
svg.addEventListener("dblclick", () => {{ xdom = null; draw(); }});
draw();
</script></body></html>
"""


def _render(title, series, xlabel="x", w=760, h=430, image=None,
            save_path=None):
    data = {"series": series, "xlabel": xlabel, "image": image}
    html = _TEMPLATE.format(title=title, w=w, h=h,
                            data=json.dumps(data))
    if save_path is not None:
        with open(save_path, "w") as f:
            f.write(html)
    return html


def _f(arr):
    return [float(v) for v in np.asarray(arr, dtype=float)]


def column(data, name):
    """Column `name` of a mapping of columns (a dict of arrays, tensors or
    lists, or a DataFrame) as a numpy array (an object array where the
    cells are lists or arrays of different lengths)."""
    col = data[name]
    if hasattr(col, "to_numpy"):
        return col.to_numpy()
    if not isinstance(col, (list, tuple)):
        return to_np(col)
    try:
        return np.asarray(col)
    except ValueError:
        cells = np.empty(len(col), dtype=object)
        for i, cell in enumerate(col):
            cells[i] = cell
        return cells


def selected_rows(data, timesteps=None):
    """Indices of the rows of `data`, all or those whose "Timestep" is in
    `timesteps`."""
    timestep = column(data, "Timestep")
    if timesteps is None:
        return np.arange(len(timestep))
    return np.flatnonzero(np.isin(timestep, list(timesteps)))


def group_mean_std(keys, values):
    """`pandas` `groupby(keys)[values].agg(["mean", "std"])` in numpy:
    (sorted unique keys, means, sample standard deviations), NaN skipped.
    As pandas' group kernels compute them: the mean by compensated (Kahan)
    summation in the values' float dtype, the deviation by Welford's
    update in float64 (NaN for a group of one), both returned in the
    values' dtype, so the numbers are pandas' to the bit."""
    keys = np.asarray(keys)
    values = np.asarray(values)
    if values.dtype.kind != "f":
        values = values.astype(np.float64)
    uniq, inverse, counts = np.unique(keys, return_inverse=True,
                                      return_counts=True)
    inverse = inverse.reshape(-1)
    g = len(uniq)
    order = np.argsort(inverse, kind="stable")
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    rank = np.empty(len(keys), np.int64)
    rank[order] = np.arange(len(keys)) - np.repeat(starts, counts)
    total = np.zeros(g, values.dtype)
    comp = np.zeros(g, values.dtype)
    n = np.zeros(g, np.int64)
    mean = np.zeros(g)
    m2 = np.zeros(g)
    # the rows of each group in their order, one position at a time
    for r in range(int(counts.max(initial=0))):
        sel = rank == r
        grp, val = inverse[sel], values[sel]
        ok = ~np.isnan(val)
        grp, val = grp[ok], val[ok]
        y = val - comp[grp]
        t = total[grp] + y
        c = (t - total[grp]) - y
        comp[grp] = np.where(np.isnan(c), 0, c)
        total[grp] = t
        n[grp] += 1
        v64 = val.astype(np.float64)
        old = mean[grp]
        mean[grp] = old + (v64 - old) / n[grp]
        m2[grp] += (v64 - mean[grp]) * (v64 - old)
    with np.errstate(invalid="ignore", divide="ignore"):
        means = np.where(n > 0, total / n.astype(values.dtype), np.nan)
        stds = np.where(n > 1, np.sqrt(m2 / (n - 1)), np.nan)
    return uniq, means.astype(values.dtype), stds.astype(values.dtype)


def case_rows(data):
    """(label, row mask) per case of a mapping with "Timestep" rows,
    labels sorted (pandas' groupby order); one group "run" without a
    "Case" column."""
    if "Case" not in data:
        return [("run", np.ones(len(column(data, "Timestep")), bool))]
    case = column(data, "Case")
    return [(label, case == label) for label in np.unique(case)]


def html_mean_results(df, value="AvgCumCost", save_path=None):
    """Interactive per-case mean cost over time with std bands: tooltip,
    legend selection, interval zoom. `df`: a mapping of columns with
    "Timestep", `value` and optionally "Case"."""
    series = []
    timestep, values = column(df, "Timestep"), column(df, value)
    for i, (case, rows) in enumerate(case_rows(df)):
        steps, mean, std = group_mean_std(timestep[rows], values[rows])
        std = np.where(np.isnan(std), std.dtype.type(0.0), std)
        series.append({
            "name": str(case), "kind": "line",
            "color": _PALETTE[i % len(_PALETTE)], "band": True,
            "x": _f(steps), "y": _f(mean),
            "lo": _f(mean - std), "hi": _f(mean + std),
        })
    return _render(f"Mean {value} per case", series, xlabel="Timestep",
                   save_path=save_path)


def _weight_color(w):
    # viridis-ish 3-stop ramp
    w = float(min(max(w, 0.0), 1.0))
    stops = [(68, 1, 84), (33, 145, 140), (253, 231, 37)]
    seg, frac = (0, w * 2) if w < 0.5 else (1, (w - 0.5) * 2)
    a, b = stops[seg], stops[seg + 1]
    rgb = [round(a[i] + (b[i] - a[i]) * frac) for i in range(3)]
    return f"rgb({rgb[0]},{rgb[1]},{rgb[2]})"


def html_stein_particles(df, timesteps=None, save_path=None):
    """Interactive policy-particle scatter colored by posterior weight; the
    tooltip shows the weight."""
    timestep = column(df, "Timestep")
    particles_col = column(df, "PolParticles")
    weights_col = column(df, "Weights")
    xs, ys, colors, extra = [], [], [], []
    for i in selected_rows(df, timesteps):
        particles = np.asarray(particles_col[i], dtype=float).ravel()
        weights = np.asarray(weights_col[i], dtype=float).ravel()
        for p, w in zip(particles, weights):
            xs.append(float(timestep[i]))
            ys.append(float(p))
            colors.append(_weight_color(w))
            extra.append(f"weight: {w:.3f}")
    series = [{"name": "particles", "kind": "scatter", "color": "#444",
               "x": xs, "y": ys, "colors": colors, "extra": extra}]
    return _render("Stein policy particles (color = posterior weight)",
                   series, xlabel="Timestep", save_path=save_path)


def html_part2d_cost(costs_list, labels=None, save_path=None):
    """Interactive cost curves with std bands across runs. costs_list: a
    list of [T] arrays or a [N, T] array."""
    arr = np.asarray(costs_list, dtype=float)
    if arr.ndim == 1:
        arr = arr[None]
    t = _f(np.arange(arr.shape[1]))
    mean = np.nanmean(arr, axis=0)
    std = np.nanstd(arr, axis=0)
    name = labels if isinstance(labels, str) else "cost"
    series = [{"name": name, "kind": "line", "color": _PALETTE[0],
               "band": True, "x": t, "y": _f(mean),
               "lo": _f(mean - std), "hi": _f(mean + std)}]
    return _render("Instantaneous cost", series, xlabel="step",
                   save_path=save_path)


def _native(v):
    """A numpy scalar as its Python value (as `DataFrame.to_dict` gives
    it)."""
    return v.item() if isinstance(v, np.generic) else v


def map_coords(model, xy):
    """World coordinates [..., 2] -> map-cell coordinates as numpy
    (`Particle.to_map_coord` on the model's device)."""
    return to_np(model.to_map_coord(to_np(xy)))


def html_part2d_traj(model, trajectories, save_path=None, rollouts=None):
    """Interactive trajectory overlays on the occupancy map: the obstacle
    grid as an inline-PNG background, per-step tooltips on the paths.
    `model` is the port's `Particle`."""
    import base64
    import struct
    import zlib

    image = None
    if model.with_obstacle:
        grid = (np.asarray(model.obst_map.map).T > 0).astype(np.uint8)
        hgt, wid = grid.shape
        # minimal PNG writer (grayscale): obstacle=dark, free=white
        px = np.where(grid > 0, 120, 255).astype(np.uint8)
        raw = b"".join(b"\x00" + px[hgt - 1 - r].tobytes()
                       for r in range(hgt))

        def chunk(tag, payload):
            return (struct.pack(">I", len(payload)) + tag + payload
                    + struct.pack(">I", zlib.crc32(tag + payload)))

        png = (b"\x89PNG\r\n\x1a\n"
               + chunk(b"IHDR", struct.pack(">IIBBBBB", wid, hgt, 8, 0,
                                            0, 0, 0))
               + chunk(b"IDAT", zlib.compress(raw))
               + chunk(b"IEND", b""))
        href = "data:image/png;base64," + base64.b64encode(png).decode()
        image = {"href": href, "x0": 0.0, "y0": 0.0,
                 "x1": float(wid), "y1": float(hgt)}

    series = []
    for i, traj in enumerate(trajectories):
        m = np.stack([map_coords(model, p[:2]) for p in to_np(traj)])
        series.append({
            "name": f"trajectory {i}", "kind": "line",
            "color": _PALETTE[i % len(_PALETTE)],
            "x": _f(m[:, 0]), "y": _f(m[:, 1]),
        })
    if rollouts is not None:
        for j, ro in enumerate(to_np(rollouts)):
            m = np.stack([map_coords(model, p[:2]) for p in ro])
            series.append({
                "name": f"rollout {j}", "kind": "line", "opacity": 0.3,
                "width": 0.8, "color": "#999", "nolegend": True,
                "x": _f(m[:, 0]), "y": _f(m[:, 1]),
            })
    if model.init_state is not None:
        start = map_coords(model, to_np(model.init_state)[:2])
        series.append({"name": "start", "kind": "scatter",
                       "color": "#d62728", "x": [float(start[0])],
                       "y": [float(start[1])]})
    tgt = map_coords(model, to_np(model.target)[:2])
    series.append({"name": "goal", "kind": "scatter", "color": "#2ca02c",
                   "x": [float(tgt[0])], "y": [float(tgt[1])]})
    return _render("Trajectories on the occupancy map", series,
                   xlabel="map x", w=620, h=620, image=image,
                   save_path=save_path)


# --------------------------------------------------------------- vega
# The altair-compatible artifact: a vega-lite v5 JSON spec with the layers
# of the reference's altair chart (a basis-interpolated mean line,
# invisible nearest-x hover selectors, highlighted points, a gray rule,
# value labels, category10 colors, 1000x400, bound-scales zoom), loadable
# by altair (`alt.Chart.from_json`), vega-embed or other vega tooling.

def vega_lite_mean_results(df, value="AvgCumCost", title=None,
                           x_key="Timestep", x_label="Timestep",
                           y_label=None, color_key="Case",
                           save_path=None):
    """Vega-lite v5 spec of the mean-results chart: layer = line +
    selectors + points + rules + text, a nearest-point hover param, the
    mean aggregated in the encoding. Returns the spec dict; `save_path`
    writes it as JSON (pair with `vega_embed_html` for a page). `df`: a
    mapping of columns; a "CumCost" column (AvgCumCost x (Timestep + 1))
    is derived where both exist."""
    source = {name: column(df, name) for name in df.keys()}
    if "AvgCumCost" in source and "Timestep" in source:
        source["CumCost"] = source["AvgCumCost"] * (source["Timestep"] + 1)
    columns = [c for c in (color_key, value, x_key) if c in source]

    def _cell(k, v):
        if k == color_key:
            return str(v)
        if isinstance(v, (int, float, np.number)):
            v = float(v)
            # json.dump would write bare NaN/Infinity, which is not JSON;
            # vega-lite reads null as missing
            return v if math.isfinite(v) else None
        return v

    n = len(source[columns[0]]) if columns else 0
    records = [{k: _cell(k, _native(source[k][i])) for k in columns}
               for i in range(n)]

    x_enc = {"field": x_key, "type": "quantitative", "title": x_label}
    y_enc = {"field": value, "aggregate": "mean",
             "type": "quantitative", "title": y_label or value}
    color_enc = {"field": color_key, "type": "nominal",
                 "scale": {"scheme": "category10"}}
    line_enc = {"x": x_enc, "y": y_enc, "color": color_enc}
    nearest = {
        "name": "nearest",
        "select": {"type": "point", "nearest": True, "on": "mouseover",
                   "fields": [x_key], "clear": "mouseout"},
    }
    spec = {
        "$schema": "https://vega.github.io/schema/vega-lite/v5.json",
        "title": title or f"Mean {value} per case",
        "width": 1000,
        "height": 400,
        "data": {"values": records},
        "layer": [
            {
                "mark": {"type": "line", "interpolate": "basis",
                         "clip": True},
                "encoding": line_enc,
                "params": [{"name": "grid", "select": "interval",
                            "bind": "scales"}],  # .interactive()
            },
            {
                "mark": "point",
                "encoding": {"x": x_enc, "opacity": {"value": 0}},
                "params": [nearest],
            },
            {
                "mark": "point",
                "encoding": {
                    **line_enc,
                    "opacity": {
                        "condition": {"param": "nearest",
                                      "empty": False, "value": 1},
                        "value": 0,
                    },
                },
            },
            {
                "mark": {"type": "rule", "color": "gray"},
                "encoding": {"x": x_enc},
                "transform": [{"filter": {"param": "nearest",
                                          "empty": False}}],
            },
            {
                "mark": {"type": "text", "align": "left", "dx": 5,
                         "dy": -5},
                "encoding": {
                    **line_enc,
                    "text": {
                        "condition": {"param": "nearest",
                                      "empty": False, "field": value,
                                      "aggregate": "mean",
                                      "type": "quantitative"},
                        "value": " ",
                    },
                },
            },
        ],
    }
    if save_path is not None:
        with open(save_path, "w") as f:
            json.dump(spec, f, indent=1)
    return spec


def vega_embed_html(spec, save_path=None):
    """Wrap a vega-lite spec in the standard vega-embed HTML page (the
    page altair's `chart.save(*.html)` writes). The page loads vega from
    the jsdelivr CDN, so showing it needs the network; the spec itself
    and the exporters above need none."""
    page = (
        "<!DOCTYPE html>\n<html><head><meta charset=\"utf-8\">\n"
        "<script src=\"https://cdn.jsdelivr.net/npm/vega@5\"></script>\n"
        "<script src=\"https://cdn.jsdelivr.net/npm/vega-lite@5\">"
        "</script>\n"
        "<script src=\"https://cdn.jsdelivr.net/npm/vega-embed@6\">"
        "</script>\n</head><body>\n<div id=\"vis\"></div>\n<script>\n"
        f"vegaEmbed('#vis', {json.dumps(spec)});\n"
        "</script>\n</body></html>\n"
    )
    if save_path is not None:
        with open(save_path, "w") as f:
            f.write(page)
    return page
