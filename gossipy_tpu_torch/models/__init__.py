"""Models over stacked per-node parameters (see :mod:`.nn`)."""

from .nn import CIFAR10Net, LogisticRegression, ParamLayout

__all__ = ["CIFAR10Net", "LogisticRegression", "ParamLayout"]
