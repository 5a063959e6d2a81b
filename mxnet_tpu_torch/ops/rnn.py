"""The fused RNN op: vanilla (relu / tanh), LSTM and GRU, multi-layer,
bidirectional (port of ``mxnet_tpu/ops/rnn.py``; parity:
src/operator/rnn.cc, rnn_impl.h).

Parameters arrive as MXNet's one flat vector: every layer's and
direction's ``i2h`` then ``h2h`` weight, then every ``i2h`` and ``h2h``
bias (``mxnet_tpu/ops/rnn.py:20-41``). The weights are views of that
vector, so a backward writes its gradient into the one flat tensor. Gate
orders are cuDNN's: LSTM (i, f, g, o), GRU (r, z, n).

Each (layer, direction) hoists its input projection out of the
recurrence as one product over T·N rows (with both biases folded in where
the gates allow), then runs the recurrence as a Python loop of one
``addmm`` and the gate arithmetic a step, in plain PyTorch: this is
``mxnet_tpu``'s own recurrence, not ``torch.nn.LSTM`` or cuDNN's RNN.

Where ``mxnet_tpu`` departs from MXNet 1.6 the port follows MXNet
(ROADMAP Queue 3, "Reference defects"): ``p`` drops out the output of
every layer but the last, in training, from the device's ``mx.random``
generator (``mxnet_tpu`` never applies it); ``lstm_state_clip_min`` /
``_max`` clip the cell state at every step (``mxnet_tpu`` clips only the
final one); ``projection_size`` and ``use_sequence_length`` raise.
"""
from __future__ import annotations

import torch

from ..amp.amp import cast_op
from ..base import MXNetError
from .registry import register

__all__ = ["rnn", "rnn_param_size", "GATES"]

GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_param_size(input_size, state_size, num_layers, bidirectional,
                   mode):
    """The length of the flat parameter vector."""
    g, H, D = GATES[mode], state_size, 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else H * D
        size += D * (g * H * in_sz + g * H * H)
    return size + num_layers * D * 2 * g * H


def _unpack(params, input_size, H, L, D, mode):
    """[layer][direction] -> [w_i2h, w_h2h, b_i2h, b_h2h], views of
    ``params`` (``mxnet_tpu/ops/rnn.py:20-41``)."""
    g = GATES[mode]
    off = 0

    def take(*shape):
        nonlocal off
        n = 1
        for s in shape:
            n *= s
        v = params[off:off + n].view(*shape)
        off += n
        return v

    ws = [[[take(g * H, input_size if layer == 0 else H * D),
            take(g * H, H), None, None] for _ in range(D)]
          for layer in range(L)]
    for layer in range(L):
        for d in range(D):
            ws[layer][d][2] = take(g * H)
            ws[layer][d][3] = take(g * H)
    return ws


def _state_clip(lo, hi, nan):
    """The cell-state clip of MXNet's ``lstm_state_clip_*``, or None. With
    ``nan`` a NaN is clipped too (to ``lo``), as cuDNN's
    ``CUDNN_NOT_PROPAGATE_NAN`` does."""
    if lo is None and hi is None:
        return None
    lo = float("-inf") if lo is None else float(lo)
    hi = float("inf") if hi is None else float(hi)
    if nan:
        return lambda c: torch.fmin(torch.fmax(c, c.new_tensor(lo)),
                                    c.new_tensor(hi))
    return lambda c: c.clamp(lo, hi)


def _direction(x, h, c, w_i2h, w_h2h, b_i2h, b_h2h, mode, reverse, clip):
    """One (layer, direction) over x (T, N, in): (out (T, N, H), hT, cT)."""
    T, N, _ = x.shape
    H = h.shape[-1]
    xs = torch.flip(x, (0,)) if reverse else x
    bias = b_i2h if mode == "gru" else b_i2h + b_h2h
    gi = torch.addmm(bias, xs.reshape(T * N, -1), w_i2h.t()).view(T, N, -1)
    w = w_h2h.t()
    outs = []
    for t in range(T):
        if mode == "lstm":
            # chunk, not slices: its backward is one cat of the 4 gates
            i, f, g, o = torch.addmm(gi[t], h, w).chunk(4, 1)
            c = torch.addcmul(torch.sigmoid(f) * c, torch.sigmoid(i),
                              torch.tanh(g))
            if clip is not None:
                c = clip(c)
            h = torch.sigmoid(o) * torch.tanh(c)
        elif mode == "gru":
            gi_rz, gi_n = gi[t].split((2 * H, H), 1)
            gh_rz, gh_n = torch.addmm(b_h2h, h, w).split((2 * H, H), 1)
            r, z = torch.sigmoid(gi_rz + gh_rz).chunk(2, 1)
            h = torch.lerp(torch.tanh(torch.addcmul(gi_n, r, gh_n)), h, z)
        else:
            pre = torch.addmm(gi[t], h, w)
            h = torch.relu(pre) if mode == "rnn_relu" else torch.tanh(pre)
        outs.append(h)
    out = torch.stack(outs)
    if reverse:
        out = torch.flip(out, (0,))
    return out, h, c


def rnn(data, parameters, state, state_cell=None, state_size=None,
        num_layers=1, bidirectional=False, mode="lstm", p=0.0,
        lstm_state_clip_min=None, lstm_state_clip_max=None,
        lstm_state_clip_nan=False, train=True, generator=None):
    """The recurrence over ``data`` (T, N, I) from ``state`` (and, for
    LSTM, ``state_cell``), each (L·D, N, H): (out (T, N, D·H), hF, cF),
    cF None unless LSTM."""
    if mode not in GATES:
        raise MXNetError(f"RNN: unknown mode {mode!r} "
                         f"({', '.join(GATES)})")
    T, N, input_size = data.shape
    H, L = int(state_size), int(num_layers)
    D = 2 if bidirectional else 1
    want = rnn_param_size(input_size, H, L, bidirectional, mode)
    if parameters.numel() != want:
        raise MXNetError(f"RNN: {parameters.numel()} parameters given, "
                         f"{want} expected for input {input_size}, "
                         f"{L} layers of {H} units, {D} directions, {mode}")
    lstm = mode == "lstm"
    if lstm and state_cell is None:
        raise MXNetError("RNN: mode 'lstm' needs state_cell")
    ws = _unpack(parameters, input_size, H, L, D, mode)
    clip = _state_clip(lstm_state_clip_min, lstm_state_clip_max,
                       lstm_state_clip_nan) if lstm else None
    x, h_finals, c_finals = data, [], []
    for layer in range(L):
        outs = []
        for d in range(D):
            i = layer * D + d
            out, hT, cT = _direction(
                x, state[i], state_cell[i] if lstm else None, *ws[layer][d],
                mode, d == 1, clip)
            outs.append(out)
            h_finals.append(hT)
            c_finals.append(cT)
        x = torch.cat(outs, dim=-1) if D == 2 else outs[0]
        if p > 0 and train and layer < L - 1:
            keep = 1.0 - p
            u = torch.rand(x.shape, generator=generator, device=x.device)
            x = x * ((u < keep).to(x.dtype) / keep)
    return (x, torch.stack(h_finals),
            torch.stack(c_finals) if lstm else None)


def _rnn_nout(params):
    if not params.get("state_outputs", False):
        return 1
    return 3 if params.get("mode", "lstm") == "lstm" else 2


@register("RNN", num_outputs=_rnn_nout)
@cast_op("RNN")
def _rnn(data, parameters, state, state_cell=None, state_size=None,
         num_layers=1, bidirectional=False, mode="lstm", p=0.0,
         state_outputs=False, projection_size=None,
         lstm_state_clip_min=None, lstm_state_clip_max=None,
         lstm_state_clip_nan=False, use_sequence_length=False,
         _train=True, generator=None):
    """``mxnet_tpu/ops/rnn.py:146``'s op: the output, and with
    ``state_outputs`` the final states."""
    if projection_size:
        raise MXNetError("RNN: projection_size (LSTMP) is not ported yet "
                         "(ROADMAP Queue 1 item 11)")
    if use_sequence_length:
        raise MXNetError("RNN: use_sequence_length is not ported yet "
                         "(ROADMAP Queue 1 item 11)")
    out, hF, cF = rnn(data, parameters, state, state_cell, state_size,
                      num_layers, bidirectional, mode, p,
                      lstm_state_clip_min, lstm_state_clip_max,
                      lstm_state_clip_nan, _train, generator)
    if not state_outputs:
        return out
    return (out, hF, cF) if mode == "lstm" else (out, hF)
