"""Scope Lens: a dependency-free single-file HTML dashboard.

A copy of the JAX package's ``obs/dashboard.py``, which is JAX-free.

Renders one self-contained page -- inline CSS + inline SVG, no external
scripts, fonts, or fetches -- from the same artifacts the CLIs already
produce:

* a :class:`~repro_torch.obs.Tracer` -> an SVG **timeline** (one row per
  ``group/lane``, spans as rects, instants as markers, fault->recovery
  spans shaded as windows) plus **sparklines** for every counter track
  (queue depths, KV occupancy);
* ``Solution.explain()`` -> per-stage **cost breakdown tables** (where did
  the solver's latency go: compute / NoP / seam / DRAM / staging, with the
  bottleneck ranking);
* ``report.explain()`` (whole-request or token-level) -> per-model
  **latency waterfall tables** (queue wait, batch delay, service, dead
  time by cause | prefill, hand-off, admission, decode).

Everything is simulated/derived data -- the page is bytewise deterministic
for a deterministic run (no wall-clock stamps), so CI can diff it.

Front doors: ``python -m repro solve ... --dashboard out.html`` and
``python -m repro serve ... --dashboard out.html``, or
:func:`write_dashboard` directly.
"""
from __future__ import annotations

import html
import json

__all__ = ["render_dashboard", "write_dashboard"]

# muted categorical palette, keyed per group in first-use order
_PALETTE = ("#4c9be8", "#e8a33d", "#53b87f", "#c96fc9", "#d96c5f",
            "#8a8fe8", "#b5a642", "#5fc9c0")

_CSS = """
body { background:#14171c; color:#d7dce2; font:13px/1.45 system-ui,
       -apple-system, 'Segoe UI', sans-serif; margin:24px; }
h1 { font-size:20px; margin:0 0 4px; }
h2 { font-size:15px; margin:28px 0 8px; color:#9fb3c8;
     border-bottom:1px solid #2a2f37; padding-bottom:4px; }
h3 { font-size:13px; margin:14px 0 4px; color:#8aa0b4; }
.sub { color:#6c7a89; margin-bottom:18px; }
table { border-collapse:collapse; margin:6px 0 14px; }
th, td { padding:3px 10px; text-align:right; border-bottom:1px solid #242a32;
         font-variant-numeric:tabular-nums; }
th { color:#8aa0b4; font-weight:600; }
td.l, th.l { text-align:left; }
.bar { display:inline-block; height:9px; background:#4c9be8;
       vertical-align:middle; border-radius:2px; }
.bound { padding:1px 7px; border-radius:9px; font-size:11px;
         background:#26303b; color:#9fc1e0; }
.ok { color:#53b87f; } .bad { color:#d96c5f; }
svg { background:#181c22; border:1px solid #242a32; border-radius:4px; }
.lane-label { fill:#8aa0b4; font-size:10px; }
.tick { fill:#5a6673; font-size:9px; }
.spark-name { color:#8aa0b4; display:inline-block; width:240px; }
.legend span { margin-right:16px; }
.fault-window { fill:#d96c5f; fill-opacity:0.16; }
.marker-fault { stroke:#d96c5f; } .marker-recovered { stroke:#53b87f; }
.marker-redeploy { stroke:#e8a33d; } .marker-admit { stroke:#8a8fe8; }
"""


def _esc(s) -> str:
    return html.escape(str(s), quote=True)


def _fmt_s(v: float) -> str:
    """Engineering-ish seconds: ms below 1s, µs below 1ms."""
    a = abs(v)
    if a >= 1.0 or v == 0.0:
        return f"{v:.4g} s"
    if a >= 1e-3:
        return f"{v * 1e3:.4g} ms"
    return f"{v * 1e6:.4g} µs"


# ---------------------------------------------------------------- timeline

def _marker_class(name: str) -> str:
    if name.startswith("fault"):
        return "marker-fault"
    if name.startswith("recovered"):
        return "marker-recovered"
    if name.startswith("redeploy"):
        return "marker-redeploy"
    if name.startswith("admit"):
        return "marker-admit"
    return "marker-redeploy"


def _timeline_svg(events, max_spans_per_lane: int = 400) -> str:
    """Inline SVG Gantt of the tracer's span events.

    One row per ``(group, lane)`` in first-use order; instants become
    vertical markers; ``fault:fail`` .. ``recovered`` instant pairs shade
    a translucent window across every row.
    """
    spans: dict[tuple, list] = {}
    instants: list[tuple] = []
    for ph, name, group, lane, t0, t1, _args in events:
        if ph == "X":
            spans.setdefault((group, lane), []).append((t0, t1, name))
        elif ph == "i":
            instants.append((t0, name, group))
    if not spans and not instants:
        return "<p class='sub'>(no span events)</p>"

    ts = [t for evs in spans.values() for t0, t1, _ in evs for t in (t0, t1)]
    ts += [t for t, _, _ in instants]
    tmin, tmax = min(ts), max(ts)
    rng = max(tmax - tmin, 1e-12)

    gutter, width, row_h = 190, 860, 16
    lanes = sorted(spans) or [("", "")]
    h = len(lanes) * row_h + 28

    def x(t: float) -> float:
        return gutter + (t - tmin) / rng * width

    groups: list = []
    parts = [f"<svg width='{gutter + width + 16}' height='{h}' "
             f"xmlns='http://www.w3.org/2000/svg'>"]

    # fault->recovery windows first, behind everything
    open_fault = None
    for t, name, _g in sorted(instants):
        if name.startswith("fault:fail") and open_fault is None:
            open_fault = t
        elif name.startswith("recovered") and open_fault is not None:
            parts.append(
                f"<rect class='fault-window' x='{x(open_fault):.1f}' y='14' "
                f"width='{max(1.0, x(t) - x(open_fault)):.1f}' "
                f"height='{h - 28}'/>")
            open_fault = None
    if open_fault is not None:           # failure never recovered in-run
        parts.append(
            f"<rect class='fault-window' x='{x(open_fault):.1f}' y='14' "
            f"width='{max(1.0, x(tmax) - x(open_fault)):.1f}' "
            f"height='{h - 28}'/>")

    for row, key in enumerate(lanes):
        group, lane = key
        if group not in groups:
            groups.append(group)
        color = _PALETTE[groups.index(group) % len(_PALETTE)]
        y = 16 + row * row_h
        label = f"{group}/{lane}" if lane else group
        parts.append(f"<text class='lane-label' x='4' y='{y + 11}'>"
                     f"{_esc(label[:34])}</text>")
        evs = sorted(spans.get(key, ()))
        dropped = max(0, len(evs) - max_spans_per_lane)
        if dropped:
            # keep the widest spans so the picture stays representative
            evs = sorted(sorted(evs, key=lambda e: e[0] - e[1])
                         [:max_spans_per_lane])
        for t0, t1, name in evs:
            w = max(0.75, x(t1) - x(t0))
            parts.append(
                f"<rect x='{x(t0):.2f}' y='{y + 2}' width='{w:.2f}' "
                f"height='{row_h - 5}' fill='{color}' fill-opacity='0.8'>"
                f"<title>{_esc(name)} [{_fmt_s(t0)} .. {_fmt_s(t1)}]"
                f"</title></rect>")
        if dropped:
            parts.append(f"<text class='tick' x='{gutter + width + 2}' "
                         f"y='{y + 11}'>+{dropped}</text>")

    for t, name, _g in instants:
        parts.append(
            f"<line class='{_marker_class(name)}' x1='{x(t):.2f}' y1='14' "
            f"x2='{x(t):.2f}' y2='{h - 14}' stroke-width='1.25' "
            f"stroke-dasharray='3,2'><title>{_esc(name)} @ {_fmt_s(t)}"
            f"</title></line>")

    for frac in (0.0, 0.25, 0.5, 0.75, 1.0):
        t = tmin + frac * rng
        parts.append(f"<text class='tick' x='{x(t):.1f}' y='{h - 3}' "
                     f"text-anchor='middle'>{_fmt_s(t)}</text>")
    parts.append("</svg>")
    n_faults = sum(1 for _, n, _ in instants if n.startswith("fault"))
    legend = (f"<p class='legend sub'><span>spans: "
              f"{sum(len(v) for v in spans.values())}</span>"
              f"<span>instants: {len(instants)}</span>"
              f"<span class='bad'>fault events: {n_faults}</span></p>")
    return "".join(parts) + legend


def _sparklines(events, w: int = 560, h: int = 46) -> str:
    """One sparkline per counter track (queue depths, KV occupancy, ...)."""
    tracks: dict[tuple, list] = {}
    for ph, name, group, _lane, t0, _t1, args in events:
        if ph == "C":
            v = args.get("value", 0)
            tracks.setdefault((group, name), []).append((t0, float(v)))
    if not tracks:
        return ""
    out = ["<h2>Counter tracks</h2>"]
    for (group, name), pts in sorted(tracks.items()):
        pts.sort()
        tmin, tmax = pts[0][0], pts[-1][0]
        vmax = max(v for _, v in pts)
        rng_t = max(tmax - tmin, 1e-12)
        rng_v = max(vmax, 1e-12)
        # step-wise polyline (counters hold their value between samples)
        coords = []
        last_y = h - 2
        for t, v in pts:
            px = 2 + (t - tmin) / rng_t * (w - 4)
            py = h - 2 - (v / rng_v) * (h - 8)
            coords.append(f"{px:.1f},{last_y:.1f} {px:.1f},{py:.1f}")
            last_y = py
        out.append(
            f"<div><span class='spark-name'>{_esc(group)}/{_esc(name)} "
            f"(max {vmax:g})</span>"
            f"<svg width='{w}' height='{h}'><polyline fill='none' "
            f"stroke='#4c9be8' stroke-width='1.2' "
            f"points='{' '.join(coords)}'/></svg></div>")
    return "".join(out)


# ------------------------------------------------------------- breakdowns

def _share_bar(share: float, width: int = 90) -> str:
    return (f"<span class='bar' style='width:{max(1, int(share * width))}px'>"
            f"</span> {share:.0%}")


def _solution_tables(ex: dict) -> str:
    """Tables from ``Solution.explain()``: one row per stage, component
    columns, the solver's own scalar, and the conservation verdict."""
    stages = ex.get("stages") or []
    if not stages:
        return ""
    comp_names: list = []
    for st in stages:
        for c in st.get("breakdown", {}).get("components", {}):
            if c not in comp_names:
                comp_names.append(c)
    out = [
        "<h2>DSE cost attribution</h2>",
        f"<p class='sub'>strategy {_esc(ex.get('strategy'))} &middot; "
        f"package {_esc(ex.get('package'))} &middot; "
        f"{ex.get('chips')} chips</p>",
        "<table><tr><th class='l'>stage</th><th>chips</th><th>latency</th>"
        "<th>bound</th>",
    ]
    out += [f"<th>{_esc(c)}</th>" for c in comp_names]
    out.append("<th>conserved</th></tr>")
    for st in stages:
        bd = st.get("breakdown", {})
        comps = bd.get("components", {})
        total = max(st.get("latency") or 0.0, 1e-300)
        cons = st.get("conserved")
        out.append(
            f"<tr><td class='l'>{_esc(st.get('label'))}</td>"
            f"<td>{st.get('chips')}</td>"
            f"<td>{_fmt_s(st.get('latency') or 0.0)}</td>"
            f"<td><span class='bound'>{_esc(st.get('bound'))}</span></td>")
        out += [f"<td>{_share_bar(comps.get(c, 0.0) / total)}</td>"
                for c in comp_names]
        out.append(f"<td class='{'ok' if cons else 'bad'}'>"
                   f"{'yes' if cons else 'NO'}</td></tr>")
    out.append("</table>")
    rank = ex.get("ranking") or []
    if rank:
        out.append("<h3>Bottleneck ranking</h3><table>"
                   "<tr><th class='l'>stage</th><th>bound</th>"
                   "<th>latency</th></tr>")
        for r in rank:
            out.append(f"<tr><td class='l'>{_esc(r['label'])}</td>"
                       f"<td><span class='bound'>{_esc(r['bound'])}</span>"
                       f"</td><td>{_fmt_s(r['latency'])}</td></tr>")
        out.append("</table>")
    return "".join(out)


def _waterfall_tables(ex: dict, title: str) -> str:
    """Tables from ``report.explain()``: per-model mean waterfalls."""
    rows = {k: v for k, v in ex.items()
            if isinstance(v, dict) and "components" in v}
    rows.update({k: v for k, v in ex.get("per_model", {}).items()
                 if isinstance(v, dict) and "components" in v})
    if not rows:
        return ""
    comp_names: list = []
    for r in rows.values():
        for c in r["components"]:
            if c not in comp_names:
                comp_names.append(c)
    cons = ex.get("conserved")
    out = [
        f"<h2>{_esc(title)}</h2>",
        f"<p class='sub'>latency conservation: "
        f"<span class='{'ok' if cons else 'bad'}'>"
        f"{'exact' if cons else 'VIOLATED'}</span></p>",
        "<table><tr><th class='l'>model</th><th>requests</th>"
        "<th>mean latency</th><th>dominant</th>",
    ]
    out += [f"<th>{_esc(c)}</th>" for c in comp_names]
    out.append("</tr>")
    ordered = sorted(k for k in rows if k != "overall")
    if "overall" in rows:
        ordered.append("overall")
    for name in ordered:
        r = rows[name]
        out.append(
            f"<tr><td class='l'>{_esc(name)}</td><td>{r['requests']}</td>"
            f"<td>{_fmt_s(r['latency_mean_s'])}</td>"
            f"<td><span class='bound'>{_esc(r.get('dominant'))}</span></td>")
        out += [f"<td>{_share_bar(r['components'].get(c, {}).get('share', 0.0))}"
                f"</td>" for c in comp_names]
        out.append("</tr>")
    out.append("</table>")
    dead = ex.get("dead_time_s")
    if dead:
        out.append("<h3>Dead time by cause</h3><table><tr>")
        out += [f"<th>{_esc(k)}</th>" for k in dead]
        out.append("</tr><tr>")
        out += [f"<td>{_fmt_s(v)}</td>" for v in dead.values()]
        out.append("</tr></table>")
    return "".join(out)


# ------------------------------------------------------------------ entry

def render_dashboard(*, title: str = "Scope Lens", tracer=None,
                     solution_explain: dict | None = None,
                     serving_explain: dict | None = None,
                     serving_title: str = "Serving latency waterfalls",
                     meta: dict | None = None) -> str:
    """Build the dashboard HTML string from any subset of artifacts."""
    body = [f"<h1>{_esc(title)}</h1>"]
    if meta:
        body.append("<p class='sub'>" + " &middot; ".join(
            f"{_esc(k)}: {_esc(v)}" for k, v in meta.items()) + "</p>")
    if solution_explain:
        body.append(_solution_tables(solution_explain))
    if serving_explain:
        body.append(_waterfall_tables(serving_explain, serving_title))
    if tracer is not None and getattr(tracer, "events", None):
        body.append("<h2>Timeline</h2>")
        body.append(_timeline_svg(tracer.events))
        body.append(_sparklines(tracer.events))
    if len(body) == 1:
        body.append("<p class='sub'>(nothing to show)</p>")
    return ("<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{_esc(title)}</title><style>{_CSS}</style></head>"
            f"<body>{''.join(body)}</body></html>\n")


def write_dashboard(path: str, **kwargs) -> str:
    """Render and write the dashboard; returns ``path``."""
    with open(path, "w") as fh:
        fh.write(render_dashboard(**kwargs))
    return path


def _json_default(o):
    return repr(o)


def dump_explain(path: str, explain: dict) -> str:
    """Write an ``explain()`` dict as JSON next to a dashboard (debug aid)."""
    with open(path, "w") as fh:
        json.dump(explain, fh, indent=1, sort_keys=True,
                  default=_json_default)
        fh.write("\n")
    return path
