"""``paddle.distributed`` of the port: so far only ``fleet.recompute``
(the rest is ROADMAP.md A7)."""

from . import fleet

__all__ = ["fleet"]
