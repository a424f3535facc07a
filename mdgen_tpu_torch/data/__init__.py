"""Data: split CSVs, trajectory windows, batching, synthetic trajectories."""
from .dataset import MDGenDataset, read_split  # noqa: F401
from .loader import Loader  # noqa: F401
from .synthetic import (  # noqa: F401
    synthetic_rotamer_trajectory,
    synthetic_trajectory,
    write_synthetic_dataset,
)
