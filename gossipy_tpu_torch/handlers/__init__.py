"""Model handlers over stacked per-node state."""

from . import losses
from .base import BaseHandler, ModelState, PeerModel
from .sgd import SGDHandler

__all__ = ["BaseHandler", "ModelState", "PeerModel", "SGDHandler", "losses"]
