"""Runtime: inference, training, optimizer and checkpoints."""
from .wrapper import (  # noqa: F401
    MDGenRuntime,
    TrainRuntime,
    TrainState,
    batch_to_device,
    tokenize_atom14,
)
