"""Models over stacked per-node parameters (see :mod:`.nn`)."""

from .nn import (MLP, AdaLine, CIFAR10Net, LinearRegression,
                 LogisticRegression, ParamLayout, Perceptron,
                 param_count)

__all__ = ["AdaLine", "CIFAR10Net", "LinearRegression", "LogisticRegression", "MLP",
           "ParamLayout", "Perceptron", "param_count"]
