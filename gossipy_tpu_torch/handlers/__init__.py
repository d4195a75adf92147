"""Model handlers over stacked per-node state."""

from . import losses
from .base import BaseHandler, ModelState, PeerModel
from .kmeans import KMeansHandler, exact_match, greedy_match
from .linear import AdaLineHandler, PegasosHandler
from .mf import MFHandler
from .sgd import LimitedMergeSGDHandler, SGDHandler

__all__ = ["AdaLineHandler", "BaseHandler", "KMeansHandler",
           "LimitedMergeSGDHandler", "MFHandler", "ModelState", "PeerModel",
           "PegasosHandler", "SGDHandler", "exact_match", "greedy_match",
           "losses"]
