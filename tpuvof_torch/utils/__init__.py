from .profiling import span, trace

__all__ = ["span", "trace"]
