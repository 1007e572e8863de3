"""The notebook HTML repr of an array: its shape, bytes and chunk count beside
a picture of its chunk grid (the trailing two axes). Counterpart of
``cubed_tpu/array_api/html_repr.py``."""

from __future__ import annotations

from ..utils import memory_repr


def _grid_svg(chunks, max_px: int = 240) -> str:
    """An SVG of the chunk grid of the trailing (up to) two axes."""
    if len(chunks) == 0:
        return ""
    if len(chunks) == 1:
        rows, cols = (1,), chunks[0]
    else:
        rows, cols = chunks[-2], chunks[-1]
    total_h, total_w = sum(rows), sum(cols)
    if total_h == 0 or total_w == 0:
        return ""
    scale = max_px / max(total_h, total_w)
    h, w = total_h * scale, total_w * scale
    lines = [
        f'<svg width="{w + 2:.0f}" height="{h + 2:.0f}" '
        'style="stroke:#333;fill:#8fbcbb;fill-opacity:0.35">',
        f'<rect x="1" y="1" width="{w:.1f}" height="{h:.1f}" />',
    ]
    y = 0.0
    for r in rows[:-1]:
        y += r * scale
        lines.append(f'<line x1="1" y1="{y + 1:.1f}" x2="{w + 1:.1f}" y2="{y + 1:.1f}" />')
    x = 0.0
    for c in cols[:-1]:
        x += c * scale
        lines.append(f'<line x1="{x + 1:.1f}" y1="1" x2="{x + 1:.1f}" y2="{h + 1:.1f}" />')
    lines.append("</svg>")
    return "\n".join(lines)


def array_html_repr(arr) -> str:
    rows = [
        ("Array", f"{arr.shape}", f"{arr.chunksize}"),
        ("Bytes", memory_repr(arr.nbytes), memory_repr(arr.chunkmem)),
        ("Count", f"{arr.npartitions} chunks", f"dtype: {arr.dtype}"),
    ]
    table = "".join(f"<tr><th>{a}</th><td>{b}</td><td>{c}</td></tr>" for a, b, c in rows)
    return f"""
<div style="display:flex;align-items:center;gap:16px;font-family:monospace">
  <table>
    <tr><th></th><th>Array</th><th>Chunk</th></tr>
    {table}
  </table>
  {_grid_svg(arr.chunks)}
</div>
"""
