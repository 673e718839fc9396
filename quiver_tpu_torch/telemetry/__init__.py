from .registry import DEFAULT_TIME_BUCKETS, Counter, Histogram

__all__ = ["Counter", "Histogram", "DEFAULT_TIME_BUCKETS"]
