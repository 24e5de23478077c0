from .airfoil import (
    AirfoilDataset,
    AirfoilDatasetConfig,
    boundary_coords,
    boundary_mask_offset,
    generate_airfoil_sims,
    load_reference_airfoil_dirs,
    sample_boundary_params,
)
from .nbody import NBodyDataset, NBodyDatasetConfig, generate_trajectories

__all__ = ["AirfoilDataset", "AirfoilDatasetConfig", "NBodyDataset", "NBodyDatasetConfig",
           "boundary_coords", "boundary_mask_offset", "generate_airfoil_sims",
           "generate_trajectories", "load_reference_airfoil_dirs", "sample_boundary_params"]
