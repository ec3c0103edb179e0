"""The training loop (port of ``repro/train``)."""
from repro_torch.train.loop import TrainLoop, TrainLoopConfig

__all__ = ["TrainLoop", "TrainLoopConfig"]
