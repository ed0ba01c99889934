"""Recurrent layers (port of paddle_tpu/nn/layer/rnn.py): ``SimpleRNN``,
``LSTM`` and ``GRU`` over ``RNNBase`` (several layers, one or both
directions, batch- or time-major), the cells ``LSTMCell``, ``GRUCell`` and
``SimpleRNNCell``, and the cell drivers ``RNN`` and ``BiRNN``.

The JAX package's time loop is ``lax.scan``; the port's is a Python loop
of torch ops, one step at a time, after one GEMM for the input product of
the whole sequence (a graphed ``jit.TrainStep`` captures the unrolled
loop).  cuDNN's RNN is not used.  The gates are i, f, g, o (LSTM) and r,
z, n (GRU), and the parameters ``weight_ih_l{k}[_reverse]``,
``weight_hh_l{k}[_reverse]``, ``bias_ih_l{k}[_reverse]`` and
``bias_hh_l{k}[_reverse]`` ([gates * hidden, in] and [gates * hidden]),
as in the JAX package and in torch.  ``RNNBase`` keeps ``dropout`` and
takes ``sequence_length`` but uses neither, as the JAX package does;
``RNN`` and ``BiRNN`` mask by ``sequence_length``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ... import amp

_GATES = {"LSTM": 4, "GRU": 3, "RNN": 1}


def _lstm_cell(x, h, c, w_ih, w_hh, b_ih, b_hh):
    """JAX ``_lstm_cell``: (h', c') of one step."""
    gates = x @ w_ih.t() + h @ w_hh.t() + b_ih + b_hh
    return _lstm_gates(gates, c)


def _lstm_gates(gates, c):
    i, f, g, o = gates.chunk(4, -1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.tanh(c2) * torch.sigmoid(o), c2


def _gru_cell(x, h, w_ih, w_hh, b_ih, b_hh):
    """JAX ``_gru_cell``: h' of one step."""
    return _gru_gates(x @ w_ih.t() + b_ih, h @ w_hh.t() + b_hh, h)


def _gru_gates(gi, gh, h):
    ir, iz, inn = gi.chunk(3, -1)
    hr, hz, hn = gh.chunk(3, -1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(inn + r * hn)
    return (1 - z) * n + z * h


def _act(pre, activation):
    return torch.tanh(pre) if activation == "tanh" else torch.relu(pre)


def _rnn_cell(x, h, w_ih, w_hh, b_ih, b_hh, activation):
    """JAX ``_rnn_cell``: h' of one step."""
    return _act(x @ w_ih.t() + h @ w_hh.t() + b_ih + b_hh, activation)


def _scan(mode, activation, seq, h, c, w_ih, w_hh, b_ih, b_hh):
    """One direction of one layer over ``seq`` [T, B, in] from (h, c):
    the outputs [T, B, hidden] and the final (h, c).  The input product
    of every step is one GEMM; a step is one ``addmm`` and the gates."""
    steps = seq.shape[0]
    w_hh_t = w_hh.t()
    if mode == "GRU":
        xw = torch.matmul(seq, w_ih.t()) + b_ih
    else:
        xw = torch.matmul(seq, w_ih.t()) + (b_ih + b_hh)
    outs = []
    for t in range(steps):
        if mode == "LSTM":
            h, c = _lstm_gates(torch.addmm(xw[t], h, w_hh_t), c)
        elif mode == "GRU":
            h = _gru_gates(xw[t], torch.addmm(b_hh, h, w_hh_t), h)
        else:
            h = _act(torch.addmm(xw[t], h, w_hh_t), activation)
        outs.append(h)
    return torch.stack(outs), h, c


class RNNBase(nn.Module):
    """The multi-layer, one- or two-direction driver of ``LSTM``, ``GRU``
    and ``SimpleRNN`` (``mode`` "LSTM", "GRU" or "RNN").  Every parameter
    is drawn from U(-1/sqrt(hidden), 1/sqrt(hidden)), as in the JAX
    package.  Layer k > 0 reads the outputs of layer k - 1, both
    directions concatenated; the reverse direction runs over the flipped
    sequence.  Returns ``(outputs, final_states)``: outputs [B, T,
    directions * hidden] (time-major [T, B, ...]), final states
    [layers * directions, B, hidden], a pair (h, c) for the LSTM."""

    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", device=None, dtype=None):
        super().__init__()
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.activation = activation
        self.bidirect = 2 if direction in ("bidirect", "bidirectional") else 1
        gates = _GATES[mode] * hidden_size
        kw = dict(device=device, dtype=dtype)
        self._param_names = []
        for layer in range(num_layers):
            for d in range(self.bidirect):
                in_size = input_size if layer == 0 \
                    else hidden_size * self.bidirect
                suffix = "_reverse" if d == 1 else ""
                names = [f"weight_ih_l{layer}{suffix}",
                         f"weight_hh_l{layer}{suffix}",
                         f"bias_ih_l{layer}{suffix}",
                         f"bias_hh_l{layer}{suffix}"]
                shapes = [(gates, in_size), (gates, hidden_size), (gates,),
                          (gates,)]
                for n, s in zip(names, shapes):
                    self.register_parameter(
                        n, nn.Parameter(torch.empty(s, **kw)))
                self._param_names.append(names)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        std = 1.0 / math.sqrt(self.hidden_size)
        for names in self._param_names:
            for n in names:
                getattr(self, n).uniform_(-std, std, generator=generator)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        is_lstm = self.mode == "LSTM"
        batch = inputs.shape[1] if self.time_major else inputs.shape[0]
        n_states = self.num_layers * self.bidirect
        zeros = inputs.new_zeros((n_states, batch, self.hidden_size))
        if initial_states is None:
            init_h, init_c = zeros, zeros
        elif is_lstm:
            init_h, init_c = initial_states
        else:
            init_h, init_c = initial_states, zeros
        params = [getattr(self, n) for names in self._param_names
                  for n in names]
        # the JAX op ``rnn_{mode}`` takes the inputs, the parameters and
        # the initial states: under amp each is cast by that name
        x, init_h, init_c, *params = amp._cast_args(
            f"rnn_{self.mode}", inputs, init_h, init_c, *params)
        layer_in = x if self.time_major else x.transpose(0, 1)
        h_finals, c_finals = [], []
        for layer in range(self.num_layers):
            outs = []
            for d in range(self.bidirect):
                gi = layer * self.bidirect + d
                seq = layer_in.flip(0) if d == 1 else layer_in
                ys, h, c = _scan(self.mode, self.activation, seq,
                                 init_h[gi], init_c[gi],
                                 *params[gi * 4:gi * 4 + 4])
                outs.append(ys.flip(0) if d == 1 else ys)
                h_finals.append(h)
                c_finals.append(c)
            layer_in = torch.cat(outs, -1) if self.bidirect == 2 else outs[0]
        out = layer_in if self.time_major else layer_in.transpose(0, 1)
        if is_lstm:
            return out, (torch.stack(h_finals), torch.stack(c_finals))
        return out, torch.stack(h_finals)

    def extra_repr(self) -> str:
        return (f"{self.input_size}, {self.hidden_size}, "
                f"num_layers={self.num_layers}, "
                f"directions={self.bidirect}")


class SimpleRNN(RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", device=None, dtype=None):
        super().__init__("RNN", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, activation,
                         device, dtype)


class LSTM(RNNBase):
    """The reference's ``LSTM``."""

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 device=None, dtype=None):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, device=device,
                         dtype=dtype)


class GRU(RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 device=None, dtype=None):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, device=device,
                         dtype=dtype)


class RNNCellBase(nn.Module):
    """A cell for ``RNN`` / ``BiRNN``: weights [gates * hidden, in] and
    [gates * hidden, hidden] from U(-1/sqrt(hidden), 1/sqrt(hidden)),
    biases zero (the JAX package's cells)."""

    def __init__(self, gates, input_size, hidden_size, device=None,
                 dtype=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        kw = dict(device=device, dtype=dtype)
        g = gates * hidden_size
        self.weight_ih = nn.Parameter(torch.empty(g, input_size, **kw))
        self.weight_hh = nn.Parameter(torch.empty(g, hidden_size, **kw))
        self.bias_ih = nn.Parameter(torch.zeros(g, **kw))
        self.bias_hh = nn.Parameter(torch.zeros(g, **kw))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        std = 1.0 / math.sqrt(self.hidden_size)
        self.weight_ih.uniform_(-std, std, generator=generator)
        self.weight_hh.uniform_(-std, std, generator=generator)
        self.bias_ih.zero_()
        self.bias_hh.zero_()

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        batch = batch_ref.shape[batch_dim_idx]
        shape = (self.hidden_size,) if shape is None else tuple(shape)
        return torch.full((batch,) + shape, init_value,
                          dtype=dtype or torch.float32,
                          device=batch_ref.device)

    def _zeros(self, inputs):
        return torch.zeros(inputs.shape[0], self.hidden_size,
                           device=inputs.device)

    def _weights(self):
        return (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh)


class LSTMCell(RNNCellBase):
    """One LSTM step: returns ``(h, (h, c))``."""

    def __init__(self, input_size, hidden_size, device=None, dtype=None):
        super().__init__(4, input_size, hidden_size, device, dtype)

    def forward(self, inputs, states=None):
        h, c = (self._zeros(inputs),) * 2 if states is None else states
        args = amp._cast_args("lstm_cell", inputs, h, c, *self._weights())
        out = _lstm_cell(*args)
        return out[0], out


class GRUCell(RNNCellBase):
    """One GRU step: returns ``(h, h)``."""

    def __init__(self, input_size, hidden_size, device=None, dtype=None):
        super().__init__(3, input_size, hidden_size, device, dtype)

    def forward(self, inputs, states=None):
        h = self._zeros(inputs) if states is None else states
        out = _gru_cell(*amp._cast_args("gru_cell", inputs, h,
                                        *self._weights()))
        return out, out


class SimpleRNNCell(RNNCellBase):
    """One step of tanh (or relu) RNN: returns ``(h, h)``."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 device=None, dtype=None):
        super().__init__(1, input_size, hidden_size, device, dtype)
        self.activation = activation

    def forward(self, inputs, states=None):
        h = self._zeros(inputs) if states is None else states
        out = _rnn_cell(*amp._cast_args("rnn_cell", inputs, h,
                                        *self._weights()), self.activation)
        return out, out


def _mask_states(new, old, mask):
    if isinstance(new, (tuple, list)):
        return type(new)(_mask_states(n, o, mask) for n, o in zip(new, old))
    return new * mask + old * (1 - mask)


def _zeros_like_states(s):
    if isinstance(s, (tuple, list)):
        return type(s)(_zeros_like_states(x) for x in s)
    return s * 0.0


class RNN(nn.Module):
    """Runs ``cell`` over the time axis (reversed with ``is_reverse``).
    With ``sequence_length`` [B], a row's outputs past its length are
    zero and its states stay as they were (the zero state where the
    cell had none yet)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        time_axis = 0 if self.time_major else 1
        steps = inputs.shape[time_axis]
        order = range(steps - 1, -1, -1) if self.is_reverse \
            else range(steps)
        states = initial_states
        outs = [None] * steps
        for t in order:
            x_t = inputs[t] if self.time_major else inputs[:, t]
            out, new_states = self.cell(x_t, states, **kwargs)
            if sequence_length is not None:
                keep = (sequence_length > t).to(out.dtype)
                mask = keep.reshape([-1] + [1] * (out.dim() - 1))
                out = out * mask
                prev = states if states is not None else \
                    _zeros_like_states(new_states)
                new_states = _mask_states(new_states, prev, mask)
            states = new_states
            outs[t] = out
        return torch.stack(outs, time_axis), states


class BiRNN(nn.Module):
    """A forward and a backward ``RNN``, outputs concatenated on the
    feature axis; the states come back as (forward, backward)."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw = cell_fw
        self.cell_bw = cell_bw
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        states_fw, states_bw = (None, None) if initial_states is None \
            else initial_states
        out_fw, st_fw = self.rnn_fw(inputs, states_fw, sequence_length,
                                    **kwargs)
        out_bw, st_bw = self.rnn_bw(inputs, states_bw, sequence_length,
                                    **kwargs)
        return torch.cat([out_fw, out_bw], -1), (st_fw, st_bw)
