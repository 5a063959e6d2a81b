"""``ShardedTrainer`` on one device (the one-device subset of
``mxnet_tpu/parallel/trainer.py``).

``mxnet_tpu`` compiles forward, backward and the optimizer update into one
jitted program over a mesh (``mxnet_tpu/parallel/trainer.py:292-355``).
The port captures the same step as one CUDA graph per signature (batch
shapes and dtypes, ``microbatches``) through
:class:`mxnet_tpu_torch.capture.CapturedExec`: the net's forward through
:func:`functional_call` on the trainer's own tensors,
``torch.autograd.grad`` for the gradients, and the functional update of
:func:`make_update_fn` in place, with ``lr``, ``wd`` and ``rescale_grad``
read from device slots that the host refreshes every step (Adam's bias
correction and :meth:`ShardedTrainer.set_learning_rate` included). The
batch is copied into the graph's static inputs outside it, the running
statistics are written back into the trainer's own aux tensors inside it,
and the loss comes back as a copy. On a CPU mesh the same program runs
directly; ``MXNET_TPU_TORCH_CAPTURE=0`` runs it eagerly. The dtype policy
is
``mxnet_tpu``'s (``_make_compute_loss``, ``trainer.py:234-290``):

- master parameters and optimizer state stay in the net's dtype (fp32);
- with ``dtype`` set, floating parameters are cast to it inside the graph,
  so their gradients land in the master dtype; a floating input is cast
  to it too, and the output is cast to f32 before the loss;
- aux (BatchNorm's running statistics) stays uncast, and ``new_aux`` is
  cast back to each aux tensor's dtype;
- the loss is ``loss_fn(out, y).mean()``.

The step returns the loss as a 0-d tensor on the device: there is no host
synchronisation per step. The net's own tensors stay as they were until
:meth:`ShardedTrainer.sync_to_net`.

Not ported, and raising where asked for: meshes over more than one device,
``param_rules``, ``remat``, a ``checkpoint_manager`` (ROADMAP Queue 1
item 6), the pad mask ``length=``, and the step watchdog, fault
injection, integrity fingerprints, elastic OOM retry, pod and multi-host
recovery and optimizer-state save/load (Queue 1 item 12).
"""
from __future__ import annotations

import torch

from .. import autograd, capture
from ..base import torch_dtype
from .functional import functional_call, param_arrays, aux_arrays
from .mesh import create_mesh
from .optim import make_update_fn

__all__ = ["ShardedTrainer", "make_update_fn"]


def _queued(what, item):
    return NotImplementedError(
        f"ShardedTrainer: {what} is not ported to the PyTorch port yet "
        f"(ROADMAP Queue 1 item {item})")


class ShardedTrainer:
    """One training step of ``net`` on a one-device mesh.

    Parameters
    ----------
    net : initialized gluon Block
    loss_fn : gluon Loss, or callable(pred, label) -> per-sample losses
    optimizer, optimizer_params : a name of :func:`make_update_fn`'s
        registry and its hyper-parameters (``learning_rate``, ``wd``, ...);
        ``wd`` applies to every parameter
    mesh : a :class:`Mesh` of one device (default ``create_mesh()``:
        ``gpu(0)``)
    batch_axis_name : accepted for ``mxnet_tpu``'s signature; one device
        does not split the batch
    dtype : compute dtype (None: the net's own; ``"bfloat16"`` or
        ``"float16"``: fp32 masters, 16-bit forward and backward)
    param_rules, remat, checkpoint_manager : not ported; anything but
        their defaults raises ``NotImplementedError``
    """

    def __init__(self, net, loss_fn, optimizer="sgd", optimizer_params=None,
                 mesh=None, param_rules=(), batch_axis_name="dp",
                 dtype=None, remat=None, checkpoint_manager=None):
        if param_rules:
            raise _queued("param_rules (tensor-parallel shardings)", 6)
        if remat:
            raise _queued("remat (activation recomputation)", 6)
        if checkpoint_manager is not None:
            raise _queued("checkpoint_manager (elastic mesh-shrink resume)",
                          6)
        mesh = mesh if mesh is not None else create_mesh()
        if mesh.size != 1:
            raise _queued(f"a mesh of {mesh.size} devices", 6)
        self.mesh = mesh
        self.device = mesh.devices.flat[0]
        self.net = net
        self.loss_fn = loss_fn
        self._compute_dtype = None if dtype is None else torch_dtype(dtype)
        self._fwd = functional_call(net, train=True)
        # the trainer's own copies: the net keeps its tensors until
        # sync_to_net (mxnet_tpu/parallel/trainer.py:_place copies too)
        self.params = {k: v.detach().to(self.device, copy=True)
                       for k, v in param_arrays(net).items()}
        self.aux = {k: v.detach().to(self.device, copy=True)
                    for k, v in aux_arrays(net).items()}
        self._optimizer = optimizer
        self._optimizer_params = dict(optimizer_params or {})
        init, self._update = make_update_fn(optimizer,
                                            dict(self._optimizer_params))
        self.opt_state = init(self.params)
        self._slots = capture.SlotTable(self.device)
        self._step_vals = None
        self._exec = capture.CapturedExec(
            self._captured_program, label="sharded_step",
            device=self.device, state=self._state_tensors,
            eager=self._eager_program, warmup_guard=self._warmup_guard)

    # ----------------------------------------------------------- capture
    def _capture_fingerprint(self, x=None, y=None, microbatches=None):
        """The step program's structural key (``mxnet_tpu/parallel/
        trainer.py:292``); with a batch, its shapes, dtypes and
        ``microbatches`` too, which the captured entries are keyed by."""
        parts = {"net": capture.net_sig(self.net),
                 "loss": capture.code_sig(self.loss_fn),
                 "optimizer": self._optimizer,
                 "dtype": str(self._compute_dtype),
                 "params": [(k, tuple(v.shape), str(v.dtype))
                            for k, v in self.params.items()]}
        if x is not None:
            parts["batch"] = [(tuple(a.shape), str(a.dtype)) for a in (x, y)]
            parts["microbatches"] = microbatches
        return capture.fingerprint(parts)

    def _state_tensors(self):
        """Masters, aux and optimizer states: the tensors the captured
        program updates in place, whose addresses key its entries."""
        out = list(self.params.values()) + list(self.aux.values())
        for v in self.opt_state["state"].values():
            out += [v] if isinstance(v, torch.Tensor) else list(v)
        return out

    def _warmup_guard(self):
        return capture._restored(self._state_tensors())

    def _captured_program(self, x, y, n):
        return self._program(x, y, n, None if self._step_vals is None
                             else self._slots.views)

    def _eager_program(self, x, y, n):
        return self._program(x, y, n, self._step_vals)

    def _write_aux(self, new_aux):
        with torch.no_grad():
            for k, v in new_aux.items():
                self.aux[k].copy_(v)

    def _program(self, x, y, n, scal):
        """The whole step on the batch: loss (mean of the microbatch
        losses), gradients, aux written back, the update in place with the
        scalars ``scal`` (None: the update computes them itself)."""
        if n == 1:
            loss, grads, new_aux = self._loss_and_grads(x, y)
            self._write_aux(new_aux)
        else:
            mb = int(x.shape[0]) // n
            loss, grads = None, None
            for i in range(n):
                sl = slice(i * mb, (i + 1) * mb)
                loss_i, g_i, new_aux = self._loss_and_grads(x[sl], y[sl])
                self._write_aux(new_aux)
                if grads is None:
                    loss, grads = loss_i, g_i
                else:
                    loss = loss + loss_i
                    for k, g in g_i.items():
                        grads[k].add_(g)
            inv = 1.0 / n
            for g in grads.values():
                g.mul_(inv)
            loss = loss / n
        if scal is not None:
            self.opt_state["scalars"] = scal
        try:
            self._update(self.params, grads, self.opt_state)
        finally:
            self.opt_state.pop("scalars", None)
        return loss

    # ------------------------------------------------------------ the step
    def _loss_and_grads(self, x, y):
        """(loss 0-d f32, {name: grad} in the master dtypes, new_aux) at
        the current parameters."""
        cdtype = self._compute_dtype
        names = list(self.params)
        leaves = [self.params[k].detach().requires_grad_(
            self.params[k].is_floating_point()) for k in names]
        with autograd.record():
            cp = dict(zip(names, leaves))
            if cdtype is not None:
                cp = {k: v.to(cdtype) if v.is_floating_point() else v
                      for k, v in cp.items()}
                if x.is_floating_point():
                    x = x.to(cdtype)
            out, new_aux = self._fwd(cp, self.aux, x)
            if cdtype is not None:
                out = out.float()
                new_aux = {k: v.to(self.aux[k].dtype)
                           if self.aux[k].is_floating_point() else v
                           for k, v in new_aux.items()}
            loss = self.loss_fn(out, y).mean()
        diff = [leaf for leaf in leaves if leaf.requires_grad]
        got = iter(torch.autograd.grad(loss, diff, allow_unused=True))
        grads = {}
        for k, leaf in zip(names, leaves):
            g = next(got) if leaf.requires_grad else None
            grads[k] = torch.zeros_like(leaf) if g is None else g
        return loss.detach(), grads, new_aux

    def _place(self, a):
        """A batch operand as a tensor on the trainer's device; one that is
        there already is used as it is (no copy)."""
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(a)
        return a if a.device == self.device else a.to(self.device)

    def step(self, x, y, microbatches=None, length=None):
        """One training step on the batch ``(x, y)`` (numpy arrays or
        tensors); returns the loss as a 0-d tensor on the device.

        ``microbatches=n`` takes the gradients of n equal slices of the
        batch at the same parameters, sums them, scales the sum by 1/n and
        applies it in one update; the running statistics chain through the
        slices, and the loss is the mean of the slice losses
        (``mxnet_tpu/parallel/trainer.py:1029-1077``). An ``n`` that does
        not split the batch raises. ``length=`` (the pad mask) is not
        ported and raises.
        """
        if length is not None:
            raise _queued("length= (the pad-masked step)", 12)
        x, y = self._place(x), self._place(y)
        rows = int(x.shape[0])
        if microbatches is None:
            n = 1
        else:
            n = int(microbatches)
            if n < 1 or rows % n:
                raise ValueError(
                    f"microbatches={n} does not divide the {rows}-row batch "
                    "into whole microbatches; accumulation must never "
                    "silently drop tail rows")
        t = self.opt_state["t"] + 1
        scalars = getattr(self._update, "scalars", None)
        if scalars is None and self.device.type == "cuda" \
                and capture.enabled():
            raise capture.CaptureError(
                "ShardedTrainer: an update function without .scalars bakes "
                "its rate into the graph; give it scalars(t) or run with "
                "MXNET_TPU_TORCH_CAPTURE=0")
        self._step_vals = None if scalars is None else scalars(t)
        if self._step_vals is not None:
            self._slots.write(self._step_vals)
        loss = self._exec(x, y, key=(n,))
        self.opt_state["t"] = t
        return loss

    # ---------------------------------------------------------- the rate
    def set_learning_rate(self, lr):
        """Change the learning rate (``mxnet_tpu/parallel/trainer.py:
        510-521``). The update is rebuilt with it; a captured step reads
        the rate from its slot, so nothing is captured again."""
        self._optimizer_params["learning_rate"] = float(lr)
        _, self._update = make_update_fn(self._optimizer,
                                         dict(self._optimizer_params))

    @property
    def learning_rate(self):
        return self._optimizer_params.get("learning_rate")

    # ------------------------------------------------------------ the net
    def sync_to_net(self):
        """Write the trainer's parameters and aux state into the net's
        tensors, in the net's dtypes (``mxnet_tpu/parallel/trainer.py:
        1159-1190``)."""
        for name, p in self.net._param_objects().items():
            if name in self.params:
                p.set_data(self.params[name])
            elif name in self.aux:
                p.set_data(self.aux[name])
