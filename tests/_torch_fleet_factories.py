"""Predictor factories of the port's fleet tests. No test lives here, and
nothing here imports jax or mxnet_tpu: a process replica's spawned child
unpickles these functions by module name."""
import numpy as np

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import serving

IN_UNITS = 3


def dense_params(seed=7):
    """The Dense(4)'s weights, as numpy, from a seed."""
    rng = np.random.RandomState(seed)
    return {"weight": (rng.randn(4, IN_UNITS) * 0.5).astype(np.float32),
            "bias": (rng.randn(4) * 0.1).astype(np.float32)}


def dense_predictor(seed=7, prefix="fleet_t_"):
    """A 1-bucket Predictor of a Dense(4) over 3 inputs on the CPU."""
    net = mt.gluon.nn.Dense(4, in_units=IN_UNITS, prefix=prefix)
    net.initialize(ctx=mt.cpu())
    w = dense_params(seed)
    net.load_numpy_params({prefix + k: v for k, v in w.items()})
    return serving.Predictor.from_block(
        net, input_shapes={"data": (IN_UNITS,)}, batch_sizes=(4,),
        warmup=False, ctx=mt.cpu())
