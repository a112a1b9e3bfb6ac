"""Input windows (port of ``Window`` from ``paddle_tpu/io/__init__.py``;
the prefetchers are ROADMAP.md A8)."""

from __future__ import annotations


class Window(tuple):
    """A window of ``k`` training batches stacked along a new leading
    axis, for ``jit.CompiledTrainStep(..., fused_steps=k)``.

    A ``Window`` is the tuple of stacked step arguments (``step(*w)``
    unpacks them) and carries the window length as ``.k``, so a partial
    tail window (a loader whose length is no multiple of k) describes
    itself: the step runs it as single steps instead of dropping or
    padding batches."""

    def __new__(cls, args, k):
        self = tuple.__new__(cls, tuple(args))
        self.k = int(k)
        return self


__all__ = ["Window"]
