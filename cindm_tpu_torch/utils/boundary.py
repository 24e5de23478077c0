"""Boundary post-processing: designed mask+offset → polygon.

The port's own copy of ``cindm_tpu/utils/boundary.py`` (numpy and
``scipy.ndimage``; the port imports nothing of the JAX package).

Re-designs the reference reconstruction pipeline
(`utils.py:300-602`: isolated-point filtering, DBSCAN clustering, BFS
boundary trace, Pareto-frontier ordering; driven from
`inference/inverse_design_2d.py:261-342`). This is cheap post-hoc host-side
work, so it is plain numpy/scipy:

- threshold mask (`mask_denoise`, done by the caller)
- drop isolated cells (`utils.py:310-323`)
- connected-component clustering (scipy.ndimage.label replaces DBSCAN —
  identical result for 8-connected binary masks)
- boundary cells = cluster cells adjacent to a non-cluster cell
  (`find_cluster_boundary`)
- order boundary cells by polar angle around the centroid (replaces the
  Pareto-frontier walk `utils.py:421-520`; equivalent for the star-convex
  airfoil/ellipse shapes this pipeline produces)
- restore points as (cell + 0.5) + offset (`reconstruct_boundary`
  `utils.py:581-601`)
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def filter_isolated_points(mask: np.ndarray, min_neighbors: int = 1) -> np.ndarray:
    """Remove cells with fewer than `min_neighbors` 8-connected neighbors
    (`utils.py:310-323`)."""
    kernel = np.ones((3, 3))
    kernel[1, 1] = 0
    neighbors = ndimage.convolve(mask.astype(np.float32), kernel, mode="constant")
    return np.where(neighbors >= min_neighbors, mask, 0.0)


def find_clusters(mask: np.ndarray, min_size: int = 4, bridge: int = 2) -> np.ndarray:
    """Label connected components, dropping tiny ones. Returns int labels
    [H, W], 0 = background. Like the reference DBSCAN (eps≈2,
    `utils.py:324-395`), cells within ``bridge`` cells of each other join the
    same cluster: labeling runs on the dilated mask and is mapped back."""
    binary = mask > 0.5
    dilated = ndimage.binary_dilation(binary, iterations=bridge, structure=np.ones((3, 3)))
    labels, n = ndimage.label(dilated, structure=np.ones((3, 3)))
    labels = labels * binary  # keep labels only on original cells
    out = np.zeros_like(labels)
    k = 0
    for lbl in range(1, n + 1):
        if (labels == lbl).sum() >= min_size:
            k += 1
            out[labels == lbl] = k
    return out


def find_cluster_boundary(labels: np.ndarray, cluster: int) -> np.ndarray:
    """Cells of `cluster` adjacent (4-connected) to a non-cluster cell.
    Returns [P, 2] (x=col, y=row) like `find_cluster_boundary`."""
    m = labels == cluster
    interior = ndimage.binary_erosion(m, structure=np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]]))
    edge = m & ~interior
    ys, xs = np.nonzero(edge)
    return np.stack([xs, ys], axis=-1)


def order_boundary_points(points: np.ndarray) -> np.ndarray:
    """Order boundary cells by polar angle around their centroid."""
    if len(points) < 3:
        return points
    c = points.mean(axis=0)
    ang = np.arctan2(points[:, 1] - c[1], points[:, 0] - c[0])
    return points[np.argsort(ang)]


def reconstruct_boundary(mask: np.ndarray, offset: np.ndarray) -> list[np.ndarray]:
    """mask [H, W] binary, offset [H, W, 2] → list of ordered polygons
    [P, 2] in grid units; `restored = (cell + 0.5) + offset`
    (`utils.py:581-601`)."""
    mask = filter_isolated_points(mask)
    labels = find_clusters(mask)
    polys = []
    for cluster in range(1, labels.max() + 1):
        bd = find_cluster_boundary(labels, cluster)
        if len(bd) < 3:
            continue
        bd = order_boundary_points(bd)
        off = offset[bd[:, 1], bd[:, 0], :]
        polys.append(bd + 0.5 + off)
    return polys


def polygons_overlap(poly_masks: np.ndarray) -> bool:
    """Mask-level pairwise overlap check, replacing the shapely
    `do_overlap` filter (`inverse_design_2d.py:250-259`).
    poly_masks: [K, H, W] binary masks (one per designed boundary)."""
    K = poly_masks.shape[0]
    for i in range(K):
        for j in range(i + 1, K):
            if np.any(poly_masks[i] * poly_masks[j] > 0):
                return True
    return False
