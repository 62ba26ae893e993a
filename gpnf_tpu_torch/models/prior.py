"""ConvLSTM channel-autoregressive prior (mAR-SCF).

Counterpart of gpnf_tpu/models/prior.py. The channels of a level's latent
are the autoregressive sequence: the teacher-forced likelihood is one pass
of the ConvLSTM over the channel axis, and ancestral sampling is a loop
over channels that carries the LSTM state and the previous channel. In
training, `dp_rate` > 0 zeroes whole channels of the teacher-forced input
(one keep per (sample, channel), not rescaled), as the JAX package does.
With `compute_dtype=torch.bfloat16` the likelihood's encoder (its convs,
the LSTM and its states) runs in bf16 on the bf16-cast input and weights,
the output cast back to float32 for the Gaussian terms; sampling stays
float32 with the float32 weights (the JAX prior's `sample(dtype=float32)`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from ..ops.conv import conv2d, uniform_
from ..ops.convrnn import ConvLSTM

LOG2PI = math.log(2.0 * math.pi)

# per-level ConvLSTM kernel sizes and dilations
KERNEL_SIZES = [5, 5, 3, 3, 3, 3, 3]
DILATIONS = [2, 1, 1, 1, 1, 1, 1]


class ConvSeqEncoder(nn.Module):
    """conv-embed -> ConvLSTM stack -> conv-out, convs applied per time step."""

    def __init__(self, input_ch: int, out_ch: int, embed_ch: int,
                 kernel_size: int = 5, dilation: int = 1, num_layers: int = 1,
                 *, generator=None):
        super().__init__()
        k = kernel_size
        self.embed_w = nn.Parameter(uniform_(
            (embed_ch, input_ch, k, k), 1.0 / math.sqrt(input_ch * k * k),
            generator))
        self.embed_b = nn.Parameter(torch.zeros(embed_ch))
        self.out_w = nn.Parameter(uniform_(
            (out_ch, embed_ch, 3, 3), 1.0 / math.sqrt(embed_ch * 9), generator))
        self.out_b = nn.Parameter(torch.zeros(out_ch))
        self.lstm = ConvLSTM(embed_ch, embed_ch, kernel_size,
                             num_layers=num_layers, dilation=dilation,
                             generator=generator)

    @staticmethod
    def _td(x_seq, w, b):
        """Time-distributed conv: (B, T, C, H, W) through one conv."""
        bsz, t = x_seq.shape[:2]
        y = conv2d(x_seq.reshape(bsz * t, *x_seq.shape[2:]), w, b)
        return y.reshape(bsz, t, *y.shape[1:])

    def forward(self, x_seq):
        x = self._td(x_seq, self.embed_w, self.embed_b)
        outs, _ = self.lstm(x)
        return self._td(outs, self.out_w, self.out_b)

    def step(self, x_t, states):
        """One autoregressive step: x_t (B, C, H, W), per-layer (h, c) states."""
        inp = conv2d(x_t, self.embed_w, self.embed_b)
        new_states = []
        for layer, state in zip(self.lstm.layers, states):
            inp, state = self.lstm.cell(layer, self.lstm.input_gates(layer, inp),
                                        state)
            new_states.append(state)
        return conv2d(inp, self.out_w, self.out_b), new_states


class CondEmbed(nn.Module):
    """z1 conditioning: conv5x5(nc -> 32) -> relu -> conv5x5(32 -> 4)."""

    def __init__(self, nc: int, *, generator=None):
        super().__init__()
        self.w1 = nn.Parameter(uniform_((32, nc, 5, 5), 1.0 / math.sqrt(nc * 25),
                                        generator))
        self.b1 = nn.Parameter(torch.zeros(32))
        self.w2 = nn.Parameter(uniform_((4, 32, 5, 5), 1.0 / math.sqrt(32 * 25),
                                        generator))
        self.b2 = nn.Parameter(torch.zeros(4))

    def forward(self, z1):
        return conv2d(torch.relu(conv2d(z1, self.w1, self.b1)), self.w2, self.b2)


class ChannelPriorUniScale(nn.Module):
    """p(z_c | z_<c, z1) for one level; the channels are the AR sequence."""

    def __init__(self, nc_base: int, height: int, width: int, level: int,
                 tot_levels: int, hidden_size: int = 32, num_layers: int = 1,
                 dp_rate: float = 0.0, compute_dtype=None, *, generator=None):
        super().__init__()
        self.dp_rate = dp_rate
        self.compute_dtype = compute_dtype
        self.height = height // (2 ** level)
        self.width = width // (2 ** level)
        self.is_final = level == tot_levels
        self.nc = nc_base * 2 ** (level + 1 if self.is_final else level)
        input_ch = 1 if self.is_final else 5  # z channel (+4 cond channels)
        self.encoder = ConvSeqEncoder(
            input_ch, 2, hidden_size, kernel_size=KERNEL_SIZES[level - 1],
            dilation=DILATIONS[level - 1], num_layers=num_layers,
            generator=generator)
        self.cond = None if self.is_final else CondEmbed(self.nc,
                                                         generator=generator)

    @staticmethod
    def _likelihood(mean, logs, z):
        return -0.5 * (logs * 2.0 + ((z - mean) ** 2) * torch.exp(-2.0 * logs)
                       + LOG2PI)

    def log_likelihood(self, z, generator=None):
        """z = (z1, z2) for intermediate levels, z for the final one -> (B,)."""
        z1, z2 = z if isinstance(z, tuple) else (None, z)
        b, t = z2.shape[:2]
        z2_seq = z2[:, :, None]  # (B, T, 1, H, W)
        z2_in = z2_seq
        if self.training and self.dp_rate > 0.0:
            keep = torch.rand((b, t, 1, 1, 1), generator=generator,
                              device=z2.device) >= self.dp_rate
            z2_in = torch.where(keep, z2_seq, 0.0)
        zeros = torch.zeros((b, 1, 1, self.height, self.width), dtype=z2.dtype,
                            device=z2.device)
        lstm_input = torch.cat([zeros, z2_in[:, :-1]], dim=1)
        if z1 is not None:
            cond = self.cond(z1)[:, None].expand(b, t, 4, self.height,
                                                 self.width)
            lstm_input = torch.cat([lstm_input, cond], dim=2)
        if self.compute_dtype is None:
            out = self.encoder(lstm_input)
        else:
            out = self.encoder(lstm_input.to(self.compute_dtype)).float()
        ll = self._likelihood(out[:, :, 0:1], out[:, :, 1:2], z2_seq)
        return torch.sum(ll.reshape(b, -1), dim=-1)

    def sample(self, z1=None, batch: Optional[int] = None, eps_std: float = 1.0,
               generator=None, device=None):
        """Ancestral sampling over channels -> (B, nc, H, W)."""
        cond = None
        if z1 is not None:
            batch, device = z1.shape[0], z1.device
            cond = self.cond(z1)
        dtype = self.encoder.embed_w.dtype
        eps = torch.randn((self.nc, batch, 1, self.height, self.width),
                          generator=generator, device=device) * eps_std
        z_t = torch.zeros((batch, 1, self.height, self.width), device=device,
                          dtype=dtype)
        states = self.encoder.lstm.zero_states(batch, (self.height, self.width),
                                               device, dtype)
        zs = []
        for eps_t in eps:
            x_t = z_t if cond is None else torch.cat([z_t, cond], dim=1)
            out, states = self.encoder.step(x_t, states)
            z_t = out[:, 0:1] + torch.exp(out[:, 1:2]) * eps_t
            zs.append(z_t[:, 0])
        return torch.stack(zs, dim=1)


class ChannelPriorMultiScale(nn.Module):
    """One ChannelPriorUniScale per level, levels 1..L."""

    def __init__(self, nc_base: int, height: int, width: int, levels: int,
                 hidden_size: int = 32, num_layers: int = 2,
                 dp_rate: float = 0.0, compute_dtype=None, *, generator=None):
        super().__init__()
        self.levels = nn.ModuleList(
            ChannelPriorUniScale(nc_base, height, width, level, levels,
                                 hidden_size=hidden_size, num_layers=num_layers,
                                 dp_rate=dp_rate, compute_dtype=compute_dtype,
                                 generator=generator)
            for level in range(1, levels + 1))

    def log_likelihood(self, z, level, generator=None):
        return self.levels[level - 1].log_likelihood(z, generator)

    def sample(self, level, z1=None, batch=None, eps_std=1.0, generator=None,
               device=None):
        return self.levels[level - 1].sample(z1=z1, batch=batch,
                                             eps_std=eps_std,
                                             generator=generator, device=device)
