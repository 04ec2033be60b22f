from .utf import MerweScaledUTF

__all__ = ["MerweScaledUTF"]
