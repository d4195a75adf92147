"""Model handlers over stacked per-node state."""

from . import losses
from .base import ModelState, PeerModel
from .sgd import SGDHandler

__all__ = ["ModelState", "PeerModel", "SGDHandler", "losses"]
