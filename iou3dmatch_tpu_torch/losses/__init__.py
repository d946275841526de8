"""Training and evaluation losses."""
from .groupfree import get_groupfree_eval_loss, get_groupfree_loss
from .labeled import get_labeled_loss
from .supervised import get_loss
from .unlabeled import get_unlabeled_loss

__all__ = ["get_groupfree_eval_loss", "get_groupfree_loss", "get_labeled_loss", "get_loss",
           "get_unlabeled_loss"]
