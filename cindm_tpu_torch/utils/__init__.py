from .boundary import (
    filter_isolated_points,
    find_cluster_boundary,
    find_clusters,
    order_boundary_points,
    polygons_overlap,
    reconstruct_boundary,
)
from .eval2d import evaluate_designs, metric, metric_batch

__all__ = [
    "evaluate_designs",
    "filter_isolated_points",
    "find_cluster_boundary",
    "find_clusters",
    "metric",
    "metric_batch",
    "order_boundary_points",
    "polygons_overlap",
    "reconstruct_boundary",
]
