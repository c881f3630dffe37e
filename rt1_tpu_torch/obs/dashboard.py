"""Ops console rendering: sparklines + alert table, HTML and terminal.

The port's copy of `rt1_tpu/obs/dashboard.py` (the port imports nothing of the
JAX package); it keeps the JAX module's names, wire format and behaviour.

One render path, two skins. ``render_dashboard_html`` produces a single
self-contained page — inline CSS, inline SVG sparklines, zero external
assets, a meta-refresh tag instead of JavaScript — served by the
router's ``/dashboard`` endpoint; ``render_console`` produces the same
story as terminal text (unicode block sparklines) for
`python -m rt1_tpu_torch.obs.console`. Both read the TSDB/AlertManager/Collector
objects directly when in-process, or the snapshot/status JSON when
remote, so the dashboard can never disagree with the store it renders.

Stdlib-only (``html.escape`` is the only import beyond typing) — this
must stay importable in the torch-free router process.
"""

from __future__ import annotations

import html
from typing import Any, Dict, List, Optional, Sequence, Tuple

_BLOCKS = "▁▂▃▄▅▆▇█"


def spark_line(values: Sequence[float], width: int = 40) -> str:
    """Unicode block sparkline, newest right. Downsamples by striding
    when more values than columns; flat series render mid-height."""
    vals = [float(v) for v in values]
    if not vals:
        return ""
    if len(vals) > width:
        stride = len(vals) / width
        vals = [vals[int(i * stride)] for i in range(width - 1)] + [vals[-1]]
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return _BLOCKS[3] * len(vals)
    return "".join(
        _BLOCKS[
            min(len(_BLOCKS) - 1, int((v - lo) / span * (len(_BLOCKS) - 1)))
        ]
        for v in vals
    )


def spark_svg(
    points: Sequence[Tuple[float, float]],
    width: int = 240,
    height: int = 36,
) -> str:
    """Inline SVG polyline over (t, value) points — the HTML dashboard's
    sparkline. Degenerate inputs (no points, zero span) render a flat
    midline so every series row keeps its shape."""
    if not points:
        return f'<svg width="{width}" height="{height}"></svg>'
    ts = [p[0] for p in points]
    vs = [p[1] for p in points]
    t_lo, t_hi = min(ts), max(ts)
    v_lo, v_hi = min(vs), max(vs)
    t_span = (t_hi - t_lo) or 1.0
    v_span = (v_hi - v_lo) or 1.0
    pad = 2
    coords = " ".join(
        f"{pad + (t - t_lo) / t_span * (width - 2 * pad):.1f},"
        f"{height - pad - (v - v_lo) / v_span * (height - 2 * pad):.1f}"
        for t, v in points
    )
    return (
        f'<svg width="{width}" height="{height}" '
        f'viewBox="0 0 {width} {height}">'
        f'<polyline fill="none" stroke="#4a90d9" stroke-width="1.5" '
        f'points="{coords}"/></svg>'
    )


def _series_rows(
    tsdb, window_s: float, max_series: int
) -> List[Dict[str, Any]]:
    """The flattened per-series view both skins iterate: family, labels,
    latest value, and the windowed points for the sparkline."""
    rows: List[Dict[str, Any]] = []
    for entry in tsdb.series_index():
        if len(rows) >= max_series:
            break
        pts = tsdb.points(
            entry["family"], labels=entry["labels"] or None,
            window_s=window_s,
        )
        if not pts:
            continue
        rows.append(
            {
                "family": entry["family"],
                "labels": entry["labels"],
                "latest": pts[-1][1],
                "points": pts,
            }
        )
    return rows


def _label_text(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


_SEVERITY_COLORS = {"page": "#d9534a", "warn": "#e8a33d", "info": "#4a90d9"}

_CSS = """
body{font-family:ui-monospace,Menlo,Consolas,monospace;background:#11151a;
color:#cdd6e0;margin:1.5em;font-size:13px}
h1{font-size:16px;color:#e8edf2}h2{font-size:14px;color:#9fb3c8;
border-bottom:1px solid #2a3440;padding-bottom:4px}
table{border-collapse:collapse;width:100%}
td,th{padding:3px 10px;text-align:left;border-bottom:1px solid #1d242c;
vertical-align:middle}th{color:#7d8fa3}
.num{text-align:right;font-variant-numeric:tabular-nums}
.state-firing{color:#d9534a;font-weight:bold}
.state-pending{color:#e8a33d}
.ok{color:#5cb85c}.muted{color:#5d6b7a}
"""


def render_dashboard_html(
    tsdb,
    alert_manager=None,
    collector=None,
    fleet_status: Optional[Dict[str, Any]] = None,
    deploy_status: Optional[Dict[str, Any]] = None,
    title: str = "rt1 ops",
    window_s: float = 900.0,
    max_series: int = 120,
    refresh_s: int = 5,
) -> str:
    """The whole ops story as one self-contained HTML document."""
    e = html.escape
    parts: List[str] = [
        "<!doctype html><html><head>",
        f"<meta charset='utf-8'><title>{e(title)}</title>",
        f"<meta http-equiv='refresh' content='{int(refresh_s)}'>",
        f"<style>{_CSS}</style></head><body>",
        f"<h1>{e(title)}</h1>",
    ]
    # --- alerts -----------------------------------------------------------
    if alert_manager is not None:
        active = alert_manager.active()
        parts.append("<h2>Alerts</h2>")
        if not active:
            parts.append("<p class='ok'>no active alerts</p>")
        else:
            parts.append(
                "<table><tr><th>alert</th><th>severity</th><th>state</th>"
                "<th>labels</th><th class='num'>value</th>"
                "<th>summary</th></tr>"
            )
            for a in active:
                color = _SEVERITY_COLORS.get(a["severity"], "#cdd6e0")
                parts.append(
                    f"<tr><td>{e(a['alert'])}</td>"
                    f"<td style='color:{color}'>{e(a['severity'])}</td>"
                    f"<td class='state-{e(a['state'])}'>{e(a['state'])}"
                    f"</td><td>{e(_label_text(a['labels']))}</td>"
                    f"<td class='num'>{a['value']:.4g}</td>"
                    f"<td class='muted'>"
                    f"{e(a['annotations'].get('summary', ''))}</td></tr>"
                )
            parts.append("</table>")
        history = alert_manager.history()
        if history:
            parts.append("<h2>Alert history</h2><table>")
            parts.append(
                "<tr><th>t</th><th>event</th><th>alert</th>"
                "<th>labels</th><th class='num'>value</th></tr>"
            )
            for ev in reversed(history[-20:]):
                parts.append(
                    f"<tr><td class='muted'>{ev['t']:.1f}</td>"
                    f"<td class='state-{e(ev['event'])}'>"
                    f"{e(ev['event'])}</td><td>{e(ev['alert'])}</td>"
                    f"<td>{e(_label_text(ev['labels']))}</td>"
                    f"<td class='num'>{ev['value']:.4g}</td></tr>"
                )
            parts.append("</table>")
    # --- fleet / deploy state --------------------------------------------
    for name, status in (("Fleet", fleet_status), ("Deploy", deploy_status)):
        if not status:
            continue
        parts.append(f"<h2>{name}</h2><table>")
        for key in sorted(status):
            value = status[key]
            if isinstance(value, (dict, list)):
                continue
            parts.append(
                f"<tr><td>{e(str(key))}</td>"
                f"<td class='num'>{e(str(value))}</td></tr>"
            )
        parts.append("</table>")
    # --- collector --------------------------------------------------------
    if collector is not None:
        stats = collector.stats()
        parts.append("<h2>Collector</h2><table>")
        parts.append(
            "<tr><th>target</th><th class='num'>up</th>"
            "<th class='num'>scrapes</th><th class='num'>errors</th>"
            "<th class='num'>samples</th><th class='num'>last (ms)</th>"
            "</tr>"
        )
        for tname in sorted(stats["targets"]):
            t = stats["targets"][tname]
            up = "<span class='ok'>1</span>" if t["up"] else (
                "<span class='state-firing'>0</span>"
            )
            parts.append(
                f"<tr><td>{e(tname)}</td><td class='num'>{up}</td>"
                f"<td class='num'>{int(t['scrapes_total'])}</td>"
                f"<td class='num'>{int(t['scrape_errors_total'])}</td>"
                f"<td class='num'>{int(t['samples_ingested_total'])}</td>"
                f"<td class='num'>"
                f"{t['last_scrape_duration_s'] * 1e3:.1f}</td></tr>"
            )
        parts.append("</table>")
    # --- history sparklines ----------------------------------------------
    rows = _series_rows(tsdb, window_s, max_series)
    parts.append(
        f"<h2>History ({len(rows)} series, last {window_s:g}s)</h2>"
    )
    if rows:
        parts.append("<table>")
        for row in rows:
            parts.append(
                f"<tr><td>{e(row['family'])}"
                f"<span class='muted'>"
                f"{e(_label_text(row['labels']))}</span></td>"
                f"<td>{spark_svg(row['points'])}</td>"
                f"<td class='num'>{row['latest']:.6g}</td></tr>"
            )
        parts.append("</table>")
    else:
        parts.append("<p class='muted'>no samples yet</p>")
    parts.append("</body></html>")
    return "".join(parts)


def render_console(
    tsdb,
    alert_manager=None,
    collector=None,
    window_s: float = 900.0,
    max_series: int = 40,
    width: int = 40,
) -> str:
    """The terminal skin: same sections as the HTML, block sparklines."""
    lines: List[str] = []
    if alert_manager is not None:
        active = alert_manager.active()
        lines.append(f"ALERTS ({len(active)} active)")
        if not active:
            lines.append("  none")
        for a in active:
            lines.append(
                f"  [{a['severity']:>4}] {a['state']:<7} {a['alert']}"
                f"{_label_text(a['labels'])} = {a['value']:.4g}"
            )
        history = alert_manager.history()
        if history:
            lines.append("RECENT EVENTS")
            for ev in history[-8:]:
                lines.append(
                    f"  t={ev['t']:.1f} {ev['event']:<8} {ev['alert']}"
                    f"{_label_text(ev['labels'])}"
                )
    if collector is not None:
        stats = collector.stats()
        lines.append(f"COLLECTOR (cycles={stats['cycles_total']})")
        for tname in sorted(stats["targets"]):
            t = stats["targets"][tname]
            state = "up" if t["up"] else "DOWN"
            lines.append(
                f"  {tname:<16} {state:<4} scrapes="
                f"{int(t['scrapes_total'])} errors="
                f"{int(t['scrape_errors_total'])} samples="
                f"{int(t['samples_ingested_total'])}"
            )
    rows = _series_rows(tsdb, window_s, max_series)
    lines.append(f"HISTORY ({len(rows)} series, last {window_s:g}s)")
    name_w = max(
        [len(r["family"] + _label_text(r["labels"])) for r in rows],
        default=0,
    )
    for row in rows:
        name = row["family"] + _label_text(row["labels"])
        spark = spark_line([v for _, v in row["points"]], width=width)
        lines.append(
            f"  {name:<{name_w}} {spark:<{width}} {row['latest']:.6g}"
        )
    return "\n".join(lines) + "\n"
