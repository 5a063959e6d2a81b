"""Optimizers (subset of ``mxnet_tpu/optimizer``)."""
from .optimizer import (Optimizer, SGD, Adam, Updater, create,  # noqa: F401
                        get_updater, register)

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "create", "get_updater",
           "register"]
