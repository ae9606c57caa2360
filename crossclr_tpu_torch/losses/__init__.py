"""Loss math."""

from .functional import l2_normalize

__all__ = ["l2_normalize"]
