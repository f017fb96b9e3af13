"""Scale-out: the multi-stream mixing wall, on one device or split over the
ranks of a ``torch.distributed`` process group."""

from .wall import MixingWall

__all__ = ["MixingWall"]
