"""Convolutional LSTM over sequences of images.

Counterpart of gpnf_tpu/ops/convrnn.py in its stacked, unidirectional
2-d LSTM mode. Gate order i, f, g, o; "same" padding d*(k-1) split
floor/ceil. The input-to-gate convolution of a layer runs once over the
whole sequence (batch and time merged); the recurrence is a loop over
time, layer after layer. The JAX package's diagonal wavefront is a TPU
schedule of the same computation. GRU, plain RNN, peephole LSTM and the
1-d/3-d variants are not ported yet.

Layout: sequences are (B, T, C, H, W).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from .basic import sigmoid
from .conv import conv2d, uniform_


class LSTMLayer(nn.Module):
    """One ConvLSTM layer's weights: w_ih, w_hh (4*out, in|out, k, k), b_ih, b_hh."""

    def __init__(self, in_ch: int, out_ch: int, k: int, *, generator=None):
        super().__init__()
        stdv = 1.0 / math.sqrt(out_ch)
        g = 4 * out_ch
        self.w_ih = nn.Parameter(uniform_((g, in_ch, k, k), stdv, generator))
        self.w_hh = nn.Parameter(uniform_((g, out_ch, k, k), stdv, generator))
        self.b_ih = nn.Parameter(uniform_((g,), stdv, generator))
        self.b_hh = nn.Parameter(uniform_((g,), stdv, generator))


class ConvLSTM(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, *,
                 num_layers: int = 1, dilation: int = 1, generator=None):
        super().__init__()
        self.out_ch = out_channels
        self.dilation = dilation
        self.layers = nn.ModuleList(
            LSTMLayer(in_channels if i == 0 else out_channels, out_channels,
                      kernel_size, generator=generator)
            for i in range(num_layers))

    def input_gates(self, layer: LSTMLayer, x):
        """conv(x_t, w_ih) + b_ih for a (B, C, H, W) step or (B, T, C, H, W)."""
        if x.dim() == 4:
            return conv2d(x, layer.w_ih, layer.b_ih, dilation=self.dilation)
        b, t = x.shape[:2]
        g = conv2d(x.reshape(b * t, *x.shape[2:]), layer.w_ih, layer.b_ih,
                   dilation=self.dilation)
        return g.reshape(b, t, *g.shape[1:])

    def cell(self, layer: LSTMLayer, igate, state):
        """One step from precomputed input gates; returns (h, (h, c))."""
        h, c = state
        gates = igate + conv2d(h, layer.w_hh, layer.b_hh, dilation=self.dilation)
        i, f, g, o = torch.chunk(gates, 4, dim=1)
        c_new = sigmoid(f) * c + sigmoid(i) * torch.tanh(g)
        h_new = sigmoid(o) * torch.tanh(c_new)
        return h_new, (h_new, c_new)

    def zero_states(self, batch, spatial, device, dtype=torch.float32):
        shape = (batch, self.out_ch, *spatial)
        return [(torch.zeros(shape, device=device, dtype=dtype),
                 torch.zeros(shape, device=device, dtype=dtype))
                for _ in self.layers]

    def forward(self, x_seq):
        """(B, T, C, H, W) from zero state -> (B, T, out_ch, H, W), [(h, c)]."""
        b, t = x_seq.shape[:2]
        states = self.zero_states(b, x_seq.shape[3:], x_seq.device, x_seq.dtype)
        inp = x_seq
        for idx, layer in enumerate(self.layers):
            igates = self.input_gates(layer, inp)
            state, outs = states[idx], []
            for step in range(t):
                out, state = self.cell(layer, igates[:, step], state)
                outs.append(out)
            states[idx] = state
            inp = torch.stack(outs, dim=1)
        return inp, states
