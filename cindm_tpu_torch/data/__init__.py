from .nbody import NBodyDataset, NBodyDatasetConfig, generate_trajectories

__all__ = ["NBodyDataset", "NBodyDatasetConfig", "generate_trajectories"]
