"""Gluon, the imperative layer API, on PyTorch modules."""
from .block import Block, HybridBlock  # noqa: F401
from .parameter import (  # noqa: F401
    DeferredInitializationError, Parameter, ParameterDict)
from .trainer import Trainer  # noqa: F401
from . import nn, contrib, loss, model_zoo, rnn, utils, data  # noqa: F401
