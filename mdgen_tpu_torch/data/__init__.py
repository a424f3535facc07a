"""Data: split CSVs, trajectory windows, batching, synthetic trajectories."""
from .dataset import MDGenDataset, read_split  # noqa: F401
from .loader import Loader  # noqa: F401
from .synthetic import synthetic_trajectory  # noqa: F401
