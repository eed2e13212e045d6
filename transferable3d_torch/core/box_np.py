"""Host-side (numpy) 3D box IoU and polygon utilities for offline eval.

JAX-free copy of `transferable3d_tpu/core/box_np.py`: the Sutherland-
Hodgman clip (`polygon_clip`, its vectorised `_clip_halfplane_np`),
`polygon_area`, `convex_hull_intersection`, the 3D / BEV IoU of two
boxes (`box3d_iou_np`), of all pairs (`box3d_iou_pairs_np`) and from
parameters (`box3d_iou_params_np`), and `in_hull_np`, which the data
code calls to label points. AP runs on the host in both packages, so
these stay numpy. The JAX package's `core/__init__.py` imports JAX, so
the port cannot import the original; tests/test_torch_eval.py holds this
copy equal to it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from transferable3d_torch.core.geometry import box_corners_np


def polygon_clip(subject: Sequence[Tuple[float, float]],
                 clip: Sequence[Tuple[float, float]]
                 ) -> Optional[List[Tuple[float, float]]]:
    """Sutherland–Hodgman: clip `subject` polygon by convex `clip` polygon.

    Both polygons are sequences of (x, z) vertices in consistent winding.
    Returns the clipped vertex list or None if empty.
    """

    def inside(p, a, b):
        # Tolerant test: points exactly ON the clip edge count as inside.
        # A strict '>' drops shared vertices/edges, which collapsed the
        # intersection of IDENTICAL polygons at some headings (found by
        # the hypothesis property test: unit cube at heading 2.0 gave
        # self-IoU 0.22).
        cross = ((b[0] - a[0]) * (p[1] - a[1])
                 - (b[1] - a[1]) * (p[0] - a[0]))
        scale = (abs(b[0] - a[0]) + abs(b[1] - a[1])) * (
            abs(p[0] - a[0]) + abs(p[1] - a[1])) + 1e-12
        return cross >= -1e-9 * scale

    def intersection(p, q, a, b):
        dc = (a[0] - b[0], a[1] - b[1])
        dp = (p[0] - q[0], p[1] - q[1])
        n1 = a[0] * b[1] - a[1] * b[0]
        n2 = p[0] * q[1] - p[1] * q[0]
        den = dc[0] * dp[1] - dc[1] * dp[0]
        if den == 0:
            return q
        return ((n1 * dp[0] - n2 * dc[0]) / den,
                (n1 * dp[1] - n2 * dc[1]) / den)

    output = list(subject)
    a = clip[-1]
    for b in clip:
        if not output:
            return None
        inputs, output = output, []
        p = inputs[-1]
        for q in inputs:
            if inside(q, a, b):
                if not inside(p, a, b):
                    output.append(intersection(p, q, a, b))
                output.append(q)
            elif inside(p, a, b):
                output.append(intersection(p, q, a, b))
            p = q
        a = b
    return output if output else None


def polygon_area(verts: np.ndarray) -> float:
    """Shoelace area of polygon verts [K, 2].

    Centered + float64: the raw shoelace on camera-frame coordinates
    (z tens of meters) has cross terms ~x*z that cancel catastrophically
    for small boxes — a 10cm box at z=30 lost 0.3% of its area in fp32
    (hypothesis property test finding)."""
    v = np.asarray(verts, np.float64)
    v = v - v.mean(axis=0)
    x, z = v[:, 0], v[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(z, -1))
                           - np.dot(z, np.roll(x, -1))))


def _bev_polygon(corners: np.ndarray) -> np.ndarray:
    """Top-face BEV polygon (x, z) from canonical [8, 3] corners."""
    return corners[:4][:, [0, 2]]


def _signed_area(verts: np.ndarray) -> float:
    x, z = verts[:, 0], verts[:, 1]
    return 0.5 * float(np.dot(x, np.roll(z, -1)) - np.dot(z, np.roll(x, -1)))


def convex_hull_intersection(p1: np.ndarray, p2: np.ndarray) -> float:
    """Intersection area of two convex BEV polygons [K, 2].

    The clip polygon winding is normalized to counter-clockwise (the
    orientation `polygon_clip`'s inside-test assumes) — a 180-degree
    heading flip reverses a box ring's winding, and guessing the
    orientation by retry mis-clipped identical-boundary cases (found by
    the hypothesis flip-invariance property test).
    """
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    if _signed_area(p2) < 0:
        p2 = p2[::-1]
    # Clip in a centered frame: with raw camera coordinates (z up to ~80m)
    # the line-line solves for near-coincident edges are catastrophically
    # ill-conditioned (self-IoU of a 10cm box at z=30 came out 1.006 —
    # found by the hypothesis property test). Area is translation-
    # invariant, so shift both polygons near the origin first.
    offset = p1.mean(axis=0)
    inter = polygon_clip([tuple(v) for v in p1 - offset],
                         [tuple(v) for v in p2 - offset])
    if not inter:
        return 0.0
    return polygon_area(np.asarray(inter))


def box3d_iou_np(corners_a: np.ndarray, corners_b: np.ndarray
                 ) -> Tuple[float, float]:
    """(3D IoU, BEV IoU) from canonical [8, 3] corner arrays.

    Y is down: top face y = corners[:4, 1], bottom face y = corners[4:, 1].
    """
    poly_a = _bev_polygon(corners_a)
    poly_b = _bev_polygon(corners_b)
    inter_area = convex_hull_intersection(poly_a, poly_b)
    area_a = polygon_area(poly_a)
    area_b = polygon_area(poly_b)
    iou_bev = inter_area / max(area_a + area_b - inter_area, 1e-8)

    ymin = max(corners_a[:, 1].min(), corners_b[:, 1].min())
    ymax = min(corners_a[:, 1].max(), corners_b[:, 1].max())
    h_overlap = max(ymax - ymin, 0.0)
    inter_vol = inter_area * h_overlap
    vol_a = area_a * (corners_a[:, 1].max() - corners_a[:, 1].min())
    vol_b = area_b * (corners_b[:, 1].max() - corners_b[:, 1].min())
    iou3d = inter_vol / max(vol_a + vol_b - inter_vol, 1e-8)
    return float(iou3d), float(iou_bev)


def _clip_halfplane_np(verts: np.ndarray, count: np.ndarray,
                       p1: np.ndarray, p2: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized Sutherland–Hodgman step against one clip edge.

    verts [..., K, 2] (first `count` valid), count [...], edge p1->p2
    [..., 2] with the polygon interior on the LEFT (CCW clip ring).
    Tolerant inside test identical to `polygon_clip` (on-edge counts as
    inside), so the batched path matches the scalar path bit-for-bit on
    the golden fixtures.
    """
    k = verts.shape[-2]
    idx = np.arange(k)
    cnt = count[..., None]
    active = idx < cnt
    nxt = np.mod(idx + 1, np.maximum(cnt, 1))
    p = verts
    q = np.take_along_axis(verts, nxt[..., None], axis=-2)

    e = p2 - p1  # [..., 2]
    def signed(v):
        return (e[..., None, 0] * (v[..., 1] - p1[..., None, 1])
                - e[..., None, 1] * (v[..., 0] - p1[..., None, 0]))

    def tol(v):
        scale = ((np.abs(e[..., None, 0]) + np.abs(e[..., None, 1]))
                 * (np.abs(v[..., 0] - p1[..., None, 0])
                    + np.abs(v[..., 1] - p1[..., None, 1])) + 1e-12)
        return 1e-9 * scale

    dp, dq = signed(p), signed(q)
    in_p = (dp >= -tol(p)) & active
    in_q = dq >= -tol(q)
    denom = dp - dq
    denom = np.where(denom == 0, 1e-300, denom)
    inter = p + (dp / denom)[..., None] * (q - p)
    crossing = ((dp >= -tol(p)) != in_q) & active

    # Emit [p_i (if inside), intersection_i (if crossing)] per edge and
    # compact order-preservingly via cumsum target slots.
    cand = np.stack([p, inter], axis=-2).reshape(*verts.shape[:-2], 2 * k, 2)
    emit = np.stack([in_p, crossing], axis=-1).reshape(
        *verts.shape[:-2], 2 * k)
    pos = np.cumsum(emit, axis=-1) - 1
    pos = np.where(emit, pos, 2 * k)  # park non-emissions in a spare slot
    out = np.zeros((*verts.shape[:-2], 2 * k + 1, 2), verts.dtype)
    np.put_along_axis(out, np.repeat(pos[..., None], 2, axis=-1), cand,
                      axis=-2)
    return out[..., :k, :], emit.sum(axis=-1).astype(np.int64)


def box3d_iou_pairs_np(corners_a: np.ndarray, corners_b: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """All-pairs (3D IoU, BEV IoU): corners_a [..., M, 8, 3] x
    corners_b [..., N, 8, 3] -> two [..., M, N] arrays, with any shared
    leading batch dims (round 3: one padded call per class covers every
    frame, removing the per-frame python loop from eval/ap.py).

    Fully numpy-vectorized twin of `box3d_iou_np` (the per-pair scalar
    clip is minutes-slow at real val-set scale — SURVEY.md C12 /
    round-1 verdict item 8). Same tolerant inside test and the same
    centered-frame conditioning, so results agree with the scalar path
    to float64 round-off. Degenerate (zero-area padding) boxes produce
    IoU 0 against anything.
    """
    a = np.asarray(corners_a, np.float64)
    b = np.asarray(corners_b, np.float64)
    m, n = a.shape[-3], b.shape[-3]
    lead = np.broadcast_shapes(a.shape[:-3], b.shape[:-3])
    if m == 0 or n == 0:
        return (np.zeros((*lead, m, n)), np.zeros((*lead, m, n)))
    pa = a[..., :4, :][..., [0, 2]]  # [..., M, 4, 2] BEV top faces
    pb = b[..., :4, :][..., [0, 2]]

    # Normalize clip rings to CCW (winding flips with 180-degree heading).
    def signed_area(v):
        x, z = v[..., 0], v[..., 1]
        return 0.5 * (np.einsum("...k,...k->...", x, np.roll(z, -1, -1))
                      - np.einsum("...k,...k->...", z, np.roll(x, -1, -1)))

    pb = np.where(signed_area(pb)[..., None, None] < 0, pb[..., ::-1, :],
                  pb)

    # Pairwise grid, centered at the subject's mean (conditioning: the
    # raw camera-frame solves are catastrophically ill-conditioned).
    offset = pa.mean(axis=-2)  # [..., M, 2]
    subj = pa[..., :, None, :, :] - offset[..., :, None, None, :]
    clip = pb[..., None, :, :, :] - offset[..., :, None, None, :]
    subj, clip = np.broadcast_arrays(subj, clip)  # [..., M, N, 4, 2]
    verts = np.concatenate(
        [subj, np.zeros_like(subj)], axis=-2)  # pad to 8 slots
    count = np.full(subj.shape[:-2], 4, np.int64)
    for e in range(4):
        verts, count = _clip_halfplane_np(
            verts, count, clip[..., e, :], clip[..., (e + 1) % 4, :])

    # Masked shoelace over the first `count` vertices (centered already).
    k = verts.shape[-2]
    idx = np.arange(k)
    nxt = np.mod(idx + 1, np.maximum(count[..., None], 1))
    x, z = verts[..., 0], verts[..., 1]
    xn = np.take_along_axis(x, nxt, axis=-1)
    zn = np.take_along_axis(z, nxt, axis=-1)
    valid = idx < count[..., None]
    inter_area = 0.5 * np.abs(np.sum((x * zn - xn * z) * valid, axis=-1))

    area_a = np.abs(signed_area(pa))  # [..., M]
    area_b = np.abs(signed_area(pb))  # [..., N]
    union_bev = np.maximum(
        area_a[..., :, None] + area_b[..., None, :] - inter_area, 1e-8)
    iou_bev = inter_area / union_bev

    ya_min, ya_max = a[..., 1].min(-1), a[..., 1].max(-1)  # [..., M]
    yb_min, yb_max = b[..., 1].min(-1), b[..., 1].max(-1)  # [..., N]
    h_overlap = np.maximum(
        np.minimum(ya_max[..., :, None], yb_max[..., None, :])
        - np.maximum(ya_min[..., :, None], yb_min[..., None, :]), 0.0)
    inter_vol = inter_area * h_overlap
    vol_a = area_a * (ya_max - ya_min)
    vol_b = area_b * (yb_max - yb_min)
    iou3d = inter_vol / np.maximum(
        vol_a[..., :, None] + vol_b[..., None, :] - inter_vol, 1e-8)
    return iou3d, iou_bev


def box3d_iou_params_np(center_a, size_a, heading_a,
                        center_b, size_b, heading_b) -> Tuple[float, float]:
    """Param-form convenience wrapper over `box3d_iou_np`."""
    ca = box_corners_np(np.asarray(center_a, np.float32),
                        np.asarray(size_a, np.float32),
                        np.asarray(heading_a, np.float32))
    cb = box_corners_np(np.asarray(center_b, np.float32),
                        np.asarray(size_b, np.float32),
                        np.asarray(heading_b, np.float32))
    return box3d_iou_np(ca, cb)


def in_hull_np(points: np.ndarray, corners: np.ndarray) -> np.ndarray:
    """Boolean mask of points [N, 3] inside the (possibly rotated) box.

    Exact for our boxes: transform into the box frame and test the three
    axis-aligned extents — no Delaunay needed (the reference used
    scipy.spatial.Delaunay for arbitrary hulls; ours are always boxes).
    """
    center = corners.mean(axis=0)
    # Recover axes from canonical ordering: x-axis = c0 - c3, z-axis = c0 - c1.
    x_axis = corners[0] - corners[3]
    z_axis = corners[0] - corners[1]
    y_axis = corners[4] - corners[0]
    l = np.linalg.norm(x_axis)
    w = np.linalg.norm(z_axis)
    h = np.linalg.norm(y_axis)
    x_axis, z_axis, y_axis = x_axis / l, z_axis / w, y_axis / h
    rel = points - center
    px = rel @ x_axis
    py = rel @ y_axis
    pz = rel @ z_axis
    return ((np.abs(px) <= l / 2 + 1e-6)
            & (np.abs(py) <= h / 2 + 1e-6)
            & (np.abs(pz) <= w / 2 + 1e-6))
