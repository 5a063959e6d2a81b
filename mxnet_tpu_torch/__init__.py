"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``.

The port mirrors ``mxnet_tpu``'s module paths and public names, slice by
slice (ROADMAP.md). Plain tensor code is PyTorch; every kernel that
``mxnet_tpu`` wrote in Pallas for the TPU is a kernel written by hand for
the H100 (``csrc/``), built with ``nvcc`` at first use. Entry points run
on ``gpu(0)`` unless given ``ctx=cpu()``.

    import mxnet_tpu_torch as mx
    net = mx.gluon.model_zoo.transformer.transformer_lm(impl="flash")
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0),
                   generator=torch.Generator().manual_seed(0))
    trainer = mx.gluon.Trainer(net.collect_params(), "adam")
    with mx.autograd.record():
        loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y).mean()
    loss.backward()
    trainer.step(1)

ResNet-50 v1 trained as ``mxnet_tpu``'s ImageNet recipe trains it
(``examples/image_classification/train_imagenet.py``): fp32 master
weights, bf16 forward and backward, on a one-card mesh.

    net = mx.gluon.model_zoo.vision.resnet50_v1(layout="NHWC", stem="s2d")
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2),
                   generator=torch.Generator().manual_seed(0))
    trainer = mx.parallel.ShardedTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
        dtype="bfloat16")
    loss = trainer.step(x, y)          # a 0-d tensor on the card
    trainer.sync_to_net()

INT8 serving of an exported graph (``mxnet_tpu``'s Predictor flow): fold
BatchNorm, calibrate, quantize, and serve each bucket as one CUDA graph.

    sym_file, params_file = net.export("resnet18")
    pred = mx.serving.Predictor(sym_file, params_file,
                                input_shapes={"data": (3, 224, 224)},
                                batch_sizes=(1, 32, 128), quantize="int8",
                                calib_data=mx.io.NDArrayIter(x, batch_size=16),
                                calib_mode="naive")
    logits = pred.predict(images)[0]

The imperative and symbolic front end (MXNet's ``mx.nd`` / ``mx.sym`` /
Module), on the card unless told ``ctx=mx.cpu()``; MXNet's default
context is the CPU, the port's is ``gpu(0)``:

    x = mx.nd.ones((2, 3))                      # on gpu(0)
    w = mx.nd.random.normal(shape=(4, 3))
    w.attach_grad()
    with mx.autograd.record():
        y = mx.nd.FullyConnected(x, w, num_hidden=4, no_bias=True)
    y.backward()                                # w.grad: an NDArray
    mod = mx.mod.Module(softmax_output_symbol)  # Module(context=gpu(0))
    mod.fit(mx.io.NDArrayIter(X, y, 128), num_epoch=5,
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9})
"""
from __future__ import annotations

from .base import MXNetError  # noqa: F401
from .context import Context, cpu, current_context, gpu, tpu  # noqa: F401
from . import initializer  # noqa: F401
from . import initializer as init  # noqa: F401
from . import autograd, optimizer, ops, gluon, serving  # noqa: F401
from . import lr_scheduler, metric, parallel, capture  # noqa: F401
from . import symbol, executor, io, contrib, ndarray, amp  # noqa: F401
from . import random, kvstore, model, module, callback, image  # noqa: F401
from .attribute import AttrScope  # noqa: F401
from . import symbol as sym  # noqa: F401
from . import ndarray as nd  # noqa: F401
from . import kvstore as kv  # noqa: F401
from . import module as mod  # noqa: F401

__all__ = ["MXNetError", "Context", "cpu", "gpu", "tpu", "current_context",
           "initializer", "init", "autograd", "optimizer", "ops", "gluon",
           "serving", "lr_scheduler", "metric", "parallel", "capture",
           "symbol", "sym", "executor", "io", "contrib", "ndarray", "nd",
           "amp", "random", "kvstore", "kv", "model", "module", "mod",
           "callback", "image", "AttrScope"]
