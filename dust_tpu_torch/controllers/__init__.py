from .disco import DiscoState, MultiDisco

__all__ = ["DiscoState", "MultiDisco"]
