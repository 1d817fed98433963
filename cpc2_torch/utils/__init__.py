"""Host-side helpers of the trainer."""

from .prefetch import PrefetchIterator, prefetch

__all__ = ["PrefetchIterator", "prefetch"]
