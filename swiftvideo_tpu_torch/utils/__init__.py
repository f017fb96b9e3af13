from . import matrix

__all__ = ["matrix"]
