"""Training and evaluation losses."""
from .labeled import get_labeled_loss
from .supervised import get_loss

__all__ = ["get_labeled_loss", "get_loss"]
