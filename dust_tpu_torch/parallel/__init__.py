from .sweep import MegakernelGroupSweep

__all__ = ["MegakernelGroupSweep"]
