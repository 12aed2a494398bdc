"""Self-contained interactive HTML viewer for evaluation results (the
port's own copy of ``dbsr_tpu/evaluation/html_viewer.py``: for the same
entries it writes the same bytes).

One ``index.html`` (no dependencies, works from ``file://``) over the
per-pane PNGs that ``evaluation/visualize.py`` writes:
  * mouse wheel          zoom (about the cursor)
  * drag                 pan
  * number keys 1..9     toggle between panes (base / prediction / GT / ...)
  * arrow keys           previous / next burst
  * ``r``                reset view

``write_viewer(out_dir, title, entries)`` with entries =
``[{"name": str, "info": str, "panes": {label: relpath}}]``.
"""

from __future__ import annotations

import html
import json
import os
from typing import Dict, List

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ margin:0; background:#111; color:#ddd;
        font:13px/1.4 system-ui, sans-serif; }}
 #bar {{ padding:6px 10px; background:#1b1b1b; position:sticky; top:0;
        display:flex; gap:14px; align-items:center; flex-wrap:wrap; }}
 #bar b {{ color:#fff; }}
 #view {{ position:relative; overflow:hidden; width:100vw;
         height:calc(100vh - 40px); cursor:grab; }}
 #img {{ position:absolute; transform-origin:0 0;
        image-rendering:pixelated; user-select:none; -webkit-user-drag:none; }}
 .key {{ background:#333; border-radius:3px; padding:0 5px; color:#fff; }}
 select {{ background:#222; color:#ddd; border:1px solid #444; }}
</style></head><body>
<div id="bar">
 <b id="name"></b> <span id="info"></span>
 <span>pane: <b id="pane"></b></span>
 <span><span class="key">1-9</span> pane
 <span class="key">&larr;/&rarr;</span> burst
 <span class="key">wheel</span> zoom
 <span class="key">drag</span> pan
 <span class="key">r</span> reset</span>
 <select id="sel"></select>
</div>
<div id="view"><img id="img" draggable="false"></div>
<script>
const DATA = {data};
let bi = 0, pi = 0, scale = 1, ox = 0, oy = 0;
const img = document.getElementById('img');
const view = document.getElementById('view');
const sel = document.getElementById('sel');
DATA.forEach((e, i) => {{
  const o = document.createElement('option');
  o.value = i; o.textContent = e.name; sel.appendChild(o);
}});
function labels() {{ return Object.keys(DATA[bi].panes); }}
function render(keepView) {{
  const e = DATA[bi], ls = labels();
  if (pi >= ls.length) pi = 0;
  document.getElementById('name').textContent = e.name;
  document.getElementById('info').textContent = e.info || '';
  document.getElementById('pane').textContent =
      (pi + 1) + '/' + ls.length + ' ' + ls[pi];
  img.src = e.panes[ls[pi]];
  sel.value = bi;
  if (!keepView) {{ scale = 1; ox = 0; oy = 0; }}
  apply();
}}
function apply() {{
  img.style.transform =
      `translate(${{ox}}px,${{oy}}px) scale(${{scale}})`;
}}
view.addEventListener('wheel', ev => {{
  ev.preventDefault();
  const f = ev.deltaY < 0 ? 1.25 : 0.8;
  const r = view.getBoundingClientRect();
  const mx = ev.clientX - r.left, my = ev.clientY - r.top;
  ox = mx - (mx - ox) * f; oy = my - (my - oy) * f; scale *= f;
  apply();
}}, {{passive: false}});
let drag = null;
view.addEventListener('pointerdown', ev => {{
  drag = [ev.clientX - ox, ev.clientY - oy];
  view.setPointerCapture(ev.pointerId);
}});
view.addEventListener('pointermove', ev => {{
  if (drag) {{ ox = ev.clientX - drag[0]; oy = ev.clientY - drag[1];
              apply(); }}
}});
view.addEventListener('pointerup', () => drag = null);
sel.addEventListener('change', () => {{ bi = +sel.value; render(); }});
document.addEventListener('keydown', ev => {{
  if (ev.key >= '1' && ev.key <= '9') {{
    const k = +ev.key - 1;
    if (k < labels().length) {{ pi = k; render(true); }}
  }} else if (ev.key === 'ArrowRight') {{
    bi = (bi + 1) % DATA.length; render();
  }} else if (ev.key === 'ArrowLeft') {{
    bi = (bi + DATA.length - 1) % DATA.length; render();
  }} else if (ev.key === 'r') {{ scale = 1; ox = 0; oy = 0; apply(); }}
}});
render();
</script></body></html>
"""


def write_viewer(out_dir: str, title: str,
                 entries: List[Dict]) -> str:
    """Write ``index.html`` over per-pane images.

    ``entries``: one dict per burst with keys ``name`` (display name),
    ``info`` (free-form metrics string) and ``panes`` (ordered mapping
    label -> image path relative to ``out_dir``).
    """
    if not entries:
        raise ValueError("no entries to visualize")
    path = os.path.join(out_dir, "index.html")
    page = _PAGE.format(title=html.escape(title),
                        data=json.dumps(entries))
    with open(path, "w") as f:
        f.write(page)
    return path
