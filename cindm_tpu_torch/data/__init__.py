from .airfoil import AirfoilDatasetConfig, boundary_coords, boundary_mask_offset, sample_boundary_params
from .nbody import NBodyDataset, NBodyDatasetConfig, generate_trajectories

__all__ = ["AirfoilDatasetConfig", "NBodyDataset", "NBodyDatasetConfig", "boundary_coords",
           "boundary_mask_offset", "generate_trajectories", "sample_boundary_params"]
