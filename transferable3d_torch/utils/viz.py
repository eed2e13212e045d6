"""Point-cloud / 3D-box visualization.

Port of `transferable3d_tpu/utils/viz.py` (the reference's mayavi
`draw_lidar` / `draw_gt_boxes3d` tooling, SURVEY.md C15), numpy only:
  - PNG renders: a 3-view (BEV / front / side) frustum figure and a
    scene's bird's-eye view, drawn with matplotlib on the Agg backend
    (imported only when a figure is drawn);
  - `export_html`: an interactive, self-contained HTML viewer (orbit /
    zoom with the mouse, vanilla canvas JS, no network or package
    dependencies), byte for byte the JAX package's file on the same
    inputs.
Box corners come from the port's `core/box_np.box_corners_np`.
"""

from __future__ import annotations

import html as _html
import json
from typing import Optional, Sequence, Tuple

import numpy as np

from transferable3d_torch.core.box_np import box_corners_np


def _html_escape(s: str) -> str:
    return _html.escape(str(s), quote=True)


# Top-face ring + verticals of the canonical corner ordering.
_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0),
          (4, 5), (5, 6), (6, 7), (7, 4),
          (0, 4), (1, 5), (2, 6), (3, 7)]
_DPI = 110


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _draw_box_2d(ax, corners: np.ndarray, dims: Tuple[int, int],
                 color: str, label: Optional[str] = None):
    for a, b in _EDGES:
        ax.plot([corners[a, dims[0]], corners[b, dims[0]]],
                [corners[a, dims[1]], corners[b, dims[1]]],
                color=color, linewidth=1.0,
                label=label if (a, b) == (0, 1) else None)


def _corners(box: Tuple) -> np.ndarray:
    """(center, size, heading) -> [8, 3] corners."""
    return box_corners_np(*[np.asarray(x, np.float32) for x in box])


def draw_frustum(points: np.ndarray,
                 gt_box: Optional[Tuple] = None,
                 pred_box: Optional[Tuple] = None,
                 seg: Optional[np.ndarray] = None,
                 path: str = "frustum.png",
                 title: str = "") -> str:
    """3-view render of one frustum. Boxes are (center, size, heading).

    Returns the written path.
    """
    views = [("BEV (x-z)", (0, 2)), ("front (x-y)", (0, 1)),
             ("side (z-y)", (2, 1))]
    colors = (seg if seg is not None
              else np.zeros(points.shape[0]))
    drawn = [(_corners(b), c, l) for b, c, l in
             ((gt_box, "green", "GT"), (pred_box, "red", "pred"))
             if b is not None]
    plt = _pyplot()
    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    for ax, (name, dims) in zip(axes, views):
        ax.scatter(points[:, dims[0]], points[:, dims[1]], c=colors,
                   s=1, cmap="coolwarm")
        for corners, color, label in drawn:
            _draw_box_2d(ax, corners, dims, color, label)
        ax.set_title(name)
        ax.set_aspect("equal")
        if dims[1] == 1:
            ax.invert_yaxis()  # Y is down in our frame
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=_DPI)
    plt.close(fig)
    return path


def draw_scene_bev(points: np.ndarray,
                   gt_boxes: Sequence[Tuple] = (),
                   pred_boxes: Sequence[Tuple] = (),
                   path: str = "scene_bev.png",
                   title: str = "") -> str:
    """Bird's-eye-view of a whole scene (reference `draw_lidar` analog)."""
    drawn = ([(_corners(b), "green") for b in gt_boxes]
             + [(_corners(b), "red") for b in pred_boxes])
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 10))
    ax.scatter(points[:, 0], points[:, 2], s=0.5, c="gray")
    for corners, color in drawn:
        _draw_box_2d(ax, corners, (0, 2), color)
    ax.set_xlabel("x (m)")
    ax.set_ylabel("z (m)")
    ax.set_aspect("equal")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=_DPI)
    plt.close(fig)
    return path


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title><style>
body{margin:0;background:#111;color:#ccc;font:13px sans-serif;overflow:hidden}
#hud{position:fixed;top:8px;left:10px;pointer-events:none}
canvas{display:block}
</style></head><body>
<div id="hud">__TITLE__ &mdash; drag: orbit &middot; wheel: zoom &middot;
dblclick: reset</div>
<canvas id="c"></canvas>
<script>
const DATA = __DATA__;
const cv = document.getElementById("c"), g = cv.getContext("2d");
let yaw = 0.6, pitch = 0.35, dist = DATA.radius * 2.8, drag = null;
const EDGES = [[0,1],[1,2],[2,3],[3,0],[4,5],[5,6],[6,7],[7,4],
               [0,4],[1,5],[2,6],[3,7]];
function resize(){cv.width=innerWidth;cv.height=innerHeight;draw();}
function proj(p){
  // world -> camera (orbit around DATA.center, Y-down data frame)
  const cx=p[0]-DATA.center[0], cy=p[1]-DATA.center[1],
        cz=p[2]-DATA.center[2];
  const sy=Math.sin(yaw), cyw=Math.cos(yaw);
  const sp=Math.sin(pitch), cp=Math.cos(pitch);
  const x1=cx*cyw+cz*sy, z1=-cx*sy+cz*cyw;
  const y2=-cy*cp-z1*sp, z2=-(-cy)*sp+z1*cp;
  const zc=dist-z2;
  if(zc<0.05) return null;
  const f=0.9*Math.min(cv.width,cv.height)/(zc/dist);
  return [cv.width/2+x1*f/dist, cv.height/2-y2*f/dist, zc];
}
function draw(){
  g.fillStyle="#111";g.fillRect(0,0,cv.width,cv.height);
  const pts=DATA.points, col=DATA.colors;
  for(let i=0;i<pts.length;i++){
    const q=proj(pts[i]); if(!q) continue;
    g.fillStyle=col[i]; const r=Math.max(1,2.2-q[2]/dist);
    g.fillRect(q[0],q[1],r,r);
  }
  for(const box of DATA.boxes){
    g.strokeStyle=box.color;g.lineWidth=1.4;g.beginPath();
    for(const e of EDGES){
      const a=proj(box.corners[e[0]]), b=proj(box.corners[e[1]]);
      if(!a||!b) continue;
      g.moveTo(a[0],a[1]);g.lineTo(b[0],b[1]);
    }
    g.stroke();
    const t=proj(box.corners[0]);
    if(t&&box.label){g.fillStyle=box.color;g.fillText(box.label,t[0],t[1]-4);}
  }
}
cv.onmousedown=e=>drag=[e.clientX,e.clientY];
window.onmouseup=()=>drag=null;
window.onmousemove=e=>{if(!drag)return;
  yaw+=(e.clientX-drag[0])*0.008;
  pitch=Math.max(-1.5,Math.min(1.5,pitch+(e.clientY-drag[1])*0.008));
  drag=[e.clientX,e.clientY];draw();};
cv.onwheel=e=>{e.preventDefault();
  dist=Math.max(DATA.radius*0.3,dist*Math.pow(1.1,e.deltaY>0?1:-1));draw();};
cv.ondblclick=()=>{yaw=0.6;pitch=0.35;dist=DATA.radius*2.8;draw();};
window.onresize=resize;resize();
</script></body></html>
"""

# Default point colormap for export_html: gray points, warm for seg=1.
_SEG_COLORS = ("#8899aa", "#ff7043")


def export_html(points: np.ndarray,
                boxes: Sequence[dict] = (),
                seg: Optional[np.ndarray] = None,
                path: str = "scene.html",
                title: str = "transferable3d_torch scene",
                max_points: int = 60000) -> str:
    """Write a self-contained interactive 3D viewer (no dependencies).

    The headless equivalent of the reference's mayavi windows: orbit /
    zoom the point cloud and wireframe boxes in any browser, from one
    file.

    Args: points [N,3+] (extra columns ignored); boxes: dicts with
    'center'/'size'/'heading' (+ optional 'color', 'label') OR
    'corners' [8,3]; seg: optional [N] 0/1 mask coloring object points.
    Above `max_points` points, evenly spaced ones are kept.
    Returns the written path.
    """
    pts = np.asarray(points, np.float32)[:, :3]
    if len(pts) > max_points:
        idx = np.linspace(0, len(pts) - 1, max_points).astype(np.int64)
        pts = pts[idx]
        seg = None if seg is None else np.asarray(seg)[idx]
    if seg is not None:
        colors = [_SEG_COLORS[int(v > 0.5)] for v in np.asarray(seg)]
    else:
        # depth-shaded gray
        z = pts[:, 2]
        lo, hi = float(z.min() or 0), float(z.max() or 1)
        shade = (120 + 100 * (z - lo) / max(1e-6, hi - lo)).astype(int)
        colors = ["#%02x%02x%02x" % (s, s, min(255, s + 20))
                  for s in shade]
    box_list = []
    for b in boxes:
        if "corners" in b:
            corners = np.asarray(b["corners"], np.float32)
        else:
            corners = box_corners_np(
                np.asarray(b["center"], np.float32),
                np.asarray(b["size"], np.float32),
                np.float32(b["heading"]))
        box_list.append({
            "corners": np.round(corners, 4).tolist(),
            "color": b.get("color", "#4caf50"),
            "label": b.get("label", ""),
        })
    center = pts.mean(axis=0) if len(pts) else np.zeros(3)
    radius = float(np.abs(pts - center).max()) if len(pts) else 1.0
    data = {
        "points": np.round(pts, 4).tolist(),
        "colors": colors,
        "boxes": box_list,
        "center": np.round(center, 4).tolist(),
        "radius": max(radius, 1e-3),
    }
    # Escape '<' in the embedded JSON so a '</script>' (or any tag) in a
    # box label cannot break out of the script element; HTML-escape the
    # title for the same reason.
    html = (_HTML_TEMPLATE
            .replace("__TITLE__", _html_escape(title))
            .replace("__DATA__", json.dumps(data).replace("<", "\\u003c")))
    with open(path, "w") as f:
        f.write(html)
    return path
