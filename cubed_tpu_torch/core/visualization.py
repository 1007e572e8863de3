"""Plan visualization: the plan's graph as graphviz DOT text, with a tooltip
for each op (its tasks, projected memory and the caller's frames) and the
user's variable names on the arrays.

Counterpart of ``cubed_tpu/core/visualization.py``. It imports no graphviz
binding: the DOT text is built here, and the ``dot`` program renders it only
where one is installed; else the ``.dot`` file is the result.
"""

from __future__ import annotations

import subprocess
from typing import Optional

from ..utils import memory_repr

_OP_COLORS = {
    "blockwise": "#dcbeff",
    "rechunk": "#aaffc3",
    "create-arrays": "#ffd8b1",
}


def _escape(s: str) -> str:
    return str(s).replace('"', "'").replace("\n", "\\n")


def build_dot(dag, rankdir="TB", show_hidden=False) -> str:
    """The DOT text of *dag* (a plan's ``Dag``); hidden nodes (templates,
    seeds, block ids) are left out unless *show_hidden*."""
    lines = [
        "digraph {",
        f'  rankdir="{rankdir}";',
        '  node [fontname="helvetica", shape=box, fontsize=10];',
    ]
    for name, d in dag.nodes.items():
        if d.get("hidden") and not show_hidden:
            continue
        if d.get("type") == "op":
            op = d.get("primitive_op")
            label = d.get("op_display_name", name)
            tooltip_parts = [f"name: {name}"]
            if op is not None:
                tooltip_parts.append(f"tasks: {op.num_tasks}")
                tooltip_parts.append(f"projected memory: {memory_repr(op.projected_mem)}")
            for ss in d.get("stack_summaries") or []:
                if not ss.is_cubed():
                    tooltip_parts.append(f"calls: {ss.name} ({ss.filename}:{ss.lineno})")
            color = _OP_COLORS.get(d.get("op_name", ""), "#ffffff")
            lines.append(
                f'  "{name}" [label="{_escape(label)}", style=filled, '
                f'fillcolor="{color}", tooltip="{_escape(chr(10).join(tooltip_parts))}"];'
            )
        else:
            target = d.get("target")
            shape_info = ""
            if target is not None and hasattr(target, "shape"):
                shape_info = f"\\nshape: {target.shape}\\nchunks: {getattr(target, 'chunks', '?')}"
            # the user's variable name for the array, from the frames of the
            # op that made it
            var_name = None
            for pred in dag.predecessors(name):
                for ss in dag.nodes[pred].get("stack_summaries") or []:
                    if name in ss.array_names_to_variable_names:
                        var_name = ss.array_names_to_variable_names[name]
            label = f"{name}" + (f" ({var_name})" if var_name else "") + shape_info
            lines.append(f'  "{name}" [label="{_escape(label)}", shape=ellipse];')
    for u, v in dag.edges():
        if (dag.nodes[u].get("hidden") or dag.nodes[v].get("hidden")) and not show_hidden:
            continue
        lines.append(f'  "{u}" -> "{v}";')
    lines.append("}")
    return "\n".join(lines)


def visualize_dag(dag, filename: str = "cubed", format: Optional[str] = None, rankdir: str = "TB",
                  show_hidden: bool = False):
    """Write *dag*'s DOT text to ``filename.dot`` and render it to
    ``filename.<format>`` (svg by default) with the ``dot`` program; the
    rendered path, or the ``.dot`` path where ``dot`` is not installed or
    fails."""
    dot = build_dot(dag, rankdir=rankdir, show_hidden=show_hidden)
    fmt = format or "svg"
    dot_path = f"{filename}.dot"
    with open(dot_path, "w") as f:
        f.write(dot)
    out_path = f"{filename}.{fmt}"
    try:
        subprocess.run(["dot", f"-T{fmt}", dot_path, "-o", out_path], check=True, capture_output=True,
                       timeout=60)
    except (OSError, subprocess.SubprocessError):
        return dot_path
    return out_path
