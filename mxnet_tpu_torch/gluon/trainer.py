"""Gluon Trainer: applies an Optimizer to a set of Parameters (subset of
``mxnet_tpu/gluon/trainer.py``; parity: python/mxnet/gluon/trainer.py).

In one process ``kvstore`` 'device' (the default), 'local', 'tpu' /
'nccl', a one-process KVStore or None have nothing to reduce, so
:meth:`Trainer.step` is :meth:`Trainer.update` with
``rescale_grad = scale / batch_size``. A distributed store ('dist_sync',
'dist_device_sync', 'dist', or a :class:`~mxnet_tpu_torch.kvstore.dist.
KVStoreDist`) is made at the first step (``mxnet_tpu/gluon/trainer.py:
72-89``): every trainable parameter is ``init``-ed on it and pulled back,
so every worker starts from rank 0's weights (MXNet's ``_init_params``);
each step then pushes and pulls every gradient (the sum over the
workers) before the update, whose ``rescale_grad`` stays ``scale /
batch_size`` of one worker's batch, as ``mxnet_tpu``'s does. With
``update_on_kvstore=True`` the store runs the optimizer and the step
pulls the weights. 'dist_async' raises. ``ignore_stale_grad`` is accepted
and, as in ``mxnet_tpu``, changes nothing: every parameter whose
``grad_req`` is not "null" is updated from its gradient buffer (zeros if
no backward wrote it). Gradient compression raises, naming its ROADMAP
item. As in ``mxnet_tpu/gluon/trainer.py:103-206``, the step runs under
the step watchdog (``MXNET_TPU_TORCH_WATCHDOG_STEP_TIMEOUT``; a stall with
a rollback-policy sentinel attached resumes from the last checkpoint), the
``hang_step`` / ``nan_grad`` / ``nonfinite_grad`` fault hooks, an attached
``HealthSentinel``'s check before the update, and trace spans
(``train.step``, ``step.allreduce``, ``step.sentinel``, ``step.update``).
The optimizer's states and update counts save and load as
``mxnet_tpu``'s bytes (:meth:`Trainer.save_states`,
:meth:`Trainer.load_states`); a checkpoint also carries the AMP loss
scaler's state.

The update sweep (``mxnet_tpu/gluon/trainer.py:202-244``) is one
multi-tensor op over every trainable parameter (``ops/optimizer_ops.py``),
as ``parallel.ShardedTrainer``'s is. ``aggregate_num`` is accepted for
parity and changes nothing: every grouping gives the same bits. Its
scalars are computed first, on the host (:meth:`Trainer._scalars`), and
the sweep takes them as Python floats or, in a captured step
(:func:`mxnet_tpu_torch.capture.capture`), as device slots holding them.
"""
from __future__ import annotations

import os

from .. import optimizer as opt
from ..base import MXNetError
from ..observability import trace as _obs_trace
from ..resilience import faults as _faults
from ..resilience import watchdog as _watchdog
from ..resilience.checkpoint import atomic_write_bytes
from .parameter import Parameter

__all__ = ["Trainer"]


def _param_list(params):
    """``params`` -> [Parameter]: a ``collect_params()`` result (tensors,
    with their Parameters in ``param_objects``), a dict of Parameters, or
    a list of them."""
    if hasattr(params, "param_objects"):
        params = params.param_objects
    if hasattr(params, "values"):
        params = list(params.values())
    if not isinstance(params, (list, tuple)) or not all(
            isinstance(p, Parameter) for p in params):
        raise ValueError("First argument must be a list or dict of "
                         "Parameters, or Block.collect_params(), got "
                         f"{type(params).__name__}.")
    return list(params)


class Trainer:
    """Applies ``optimizer`` (a name for :func:`optimizer.create`, or an
    Optimizer) to ``params`` (``mxnet_tpu/gluon/trainer.py:27``)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        self._params = _param_list(params)
        # a distributed store (by name or object) sums the gradients over
        # the workers; every other store kvstore.create takes has nothing
        # to reduce in one process (gluon/trainer.py:56-60)
        from ..kvstore import kvstore as _kvs
        from ..kvstore.dist import KVStoreDist

        self._kvstore = None      # the distributed store, once made
        self._dist = kvstore if isinstance(kvstore, KVStoreDist) else (
            kvstore if isinstance(kvstore, str)
            and _kvs.check_name(kvstore) == "dist" else None)
        self._update_on_kvstore = bool(update_on_kvstore) and \
            self._dist is not None
        if compression_params is not None:
            _kvs.KVStore("local").set_gradient_compression(
                compression_params)
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None if optimizer "
                                 "is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updater = opt.get_updater(self._optimizer)
        self._sentinel = None     # resilience.HealthSentinel.attach

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _init_kvstore(self):
        """Make the distributed store; every trainable parameter takes
        rank 0's value (``mxnet_tpu/gluon/trainer.py:72-89``)."""
        from ..kvstore import kvstore as _kvs
        from ..ndarray.ndarray import NDArray

        kv = _kvs.create(self._dist) if isinstance(self._dist, str) \
            else self._dist
        if self._update_on_kvstore:
            kv.set_optimizer(self._optimizer)
        for i in self._active():
            w = NDArray(self._params[i].data())
            kv.init(i, w)
            kv.pull(i, w)
        self._kvstore = kv

    def allreduce_grads(self):
        """Sum every trainable parameter's gradient over the workers, in
        place (``mxnet_tpu/gluon/trainer.py:148-163``)."""
        from ..ndarray.ndarray import NDArray

        if self._dist is None:
            return
        if self._kvstore is None:
            self._init_kvstore()
        keys = list(self._active())
        grads = [NDArray(self._params[i].grad()) for i in keys]
        self._kvstore.push(keys, grads)     # one push: one liveness check
        if not self._update_on_kvstore:
            self._kvstore.pull(keys, grads)

    def step(self, batch_size, ignore_stale_grad=False):
        """One update of every trainable parameter, with gradients summed
        over the workers of a distributed store and scaled by ``1 /
        batch_size`` (``mxnet_tpu/gluon/trainer.py:103``), under the step
        watchdog, with an attached sentinel consulted between the
        all-reduce and the update."""
        if not self._update_on_kvstore:
            self._guarded(batch_size, allreduce=True)
            return
        from ..ndarray.ndarray import NDArray

        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()       # the store's updater runs at the push
        for i in self._active():
            self._kvstore.pull(i, NDArray(self._params[i].data()))

    def update(self, batch_size, ignore_stale_grad=False):
        """Apply the optimizer to every parameter whose ``grad_req`` is not
        "null" (``mxnet_tpu/gluon/trainer.py:161``)."""
        if self._update_on_kvstore:
            raise MXNetError("update() when parameters are updated on the "
                             "kvstore is not supported; pass "
                             "update_on_kvstore=False")
        self._guarded(batch_size, allreduce=False)

    def _guarded(self, batch_size, allreduce):
        self._optimizer.rescale_grad = self._scale / batch_size
        try:
            with _watchdog.guard(
                    "step", detail="gluon.Trainer.step" if allreduce
                    else "gluon.Trainer.update",
                    step=getattr(self._sentinel, "_step", None)):
                self._update_phases(allreduce)
        except _watchdog.PeerLostError:
            raise  # a dead peer does not come back at the next step
        except _watchdog.StallError as e:
            if not self._stall_rollback(e):
                raise

    def _stall_rollback(self, err):
        """A stalled step resumes from the last good checkpoint when a
        rollback-policy sentinel with a manager is attached: parameters,
        optimizer states, generators and loss scaler restored, the crash
        report amended, the step skipped. True when recovered."""
        s = self._sentinel
        if s is None or s.policy != "rollback" or s.manager is None:
            return False
        manifest = s.manager.restore_latest(net=s._net, trainer=self)
        if manifest is None:
            return False
        _watchdog.note_rollback(err, manifest)
        import warnings

        warnings.warn(
            f"training step stalled ({err}); rolled back to checkpoint "
            f"step {manifest.get('step')} and skipped the step")
        return True

    def _update_phases(self, allreduce):
        """The guarded step body, each phase under a trace span."""
        with _obs_trace.span("train.step",
                             entry="step" if allreduce else "update",
                             step=getattr(self._sentinel, "_step", None)):
            _faults.maybe_hang("hang_step")
            if allreduce:
                with _obs_trace.span("step.allreduce"):
                    self.allreduce_grads()
            _faults.maybe_nan_grads(self._params)
            _faults.maybe_nonfinite_grad(self._params)
            if self._sentinel is not None:
                with _obs_trace.span("step.sentinel"):
                    healthy = self._sentinel.before_update(self)
                if not healthy:
                    return  # skipped or rolled back per the policy
            with _obs_trace.span("step.update"):
                self._update(self._scalars())

    def _active(self):
        return [i for i, p in enumerate(self._params)
                if p.grad_req != "null"]

    def _scalars(self):
        """This step's scalars as Python floats: ``rescale_grad``, then the
        optimizer's ``n_scalars`` scalars (``lr``, ``wd``, ...) of each
        trainable parameter in sweep order. Each parameter's update count
        advances, as its eager update does."""
        optim = self._optimizer
        out = [optim.rescale_grad]
        for i in self._active():
            out += optim._scalars(i)
        return out

    def _update(self, scal):
        """The update sweep with the scalars ``scal`` of :meth:`_scalars`:
        those floats, or device slots holding them."""
        active = self._active()
        k = self._optimizer.n_scalars
        if len(scal) != 1 + k * len(active):
            raise ValueError(f"{len(scal)} scalars for {len(active)} "
                             "trainable parameters")
        weights = [self._params[i].data() for i in active]
        grads = [self._params[i].grad() for i in active]
        states = [self._updater.state(i, w) for i, w in zip(active, weights)]
        per = [tuple(scal[1 + k * j:1 + k * (j + 1)])
               for j in range(len(active))]
        self._optimizer.update_group(weights, grads, states, per, scal[0])

    def get_states_bytes(self):
        """The optimizer's states and update counts as ``mxnet_tpu``'s
        bytes (``mxnet_tpu/gluon/trainer.py:246-253``)."""
        return self._updater.get_states()

    def set_states_bytes(self, states):
        """Read :meth:`get_states_bytes`' bytes, or ``mxnet_tpu``'s
        (``mxnet_tpu/gluon/trainer.py:255-264``); each state moves to its
        parameter's device at its first update."""
        self._updater.set_states(states)
        self._optimizer.param_dict = dict(enumerate(self._params))

    def save_states(self, fname):
        """Write the trainer's states to ``fname`` atomically: a temporary
        file beside it, fsync, rename (``mxnet_tpu/gluon/trainer.py:
        266-272``), so a crash never leaves a truncated file."""
        atomic_write_bytes(fname, self.get_states_bytes())

    def load_states(self, fname):
        """Read the states :meth:`save_states` (or ``mxnet_tpu``) wrote."""
        with open(fname, "rb") as f:
            self.set_states_bytes(f.read())

