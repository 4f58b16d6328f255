from .profiling import trace, time_steps

__all__ = ["trace", "time_steps"]
