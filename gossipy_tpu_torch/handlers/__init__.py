"""Model handlers over stacked per-node state."""

from . import losses
from .base import BaseHandler, ModelState, PeerModel
from .kmeans import KMeansHandler, exact_match, greedy_match
from .linear import AdaLineHandler, PegasosHandler
from .mf import MFHandler
from .sgd import LimitedMergeSGDHandler, PartitionedSGDHandler, \
    SamplingSGDHandler, SGDHandler, WeightedSGDHandler

__all__ = ["AdaLineHandler", "BaseHandler", "KMeansHandler",
           "LimitedMergeSGDHandler", "MFHandler", "ModelState",
           "PartitionedSGDHandler", "PeerModel", "PegasosHandler",
           "SGDHandler", "SamplingSGDHandler", "WeightedSGDHandler",
           "exact_match", "greedy_match", "losses"]
