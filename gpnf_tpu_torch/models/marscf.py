"""mAR-SCF: multi-scale autoregressive normalizing flow for images.

Counterpart of gpnf_tpu/models/marscf.py. A flow step is actnorm -> invconv
(PLU) -> [attention -> attention (permuted)] -> coupling [-> tuple flip];
a level is squeeze -> K steps -> channel split, the split-off half scored
by the prior. The coupling is MixLogCDF (with a tuple flip after it) or
affine (`coupling`), the attentions are optional (`use_attention`), and the
prior is the ConvLSTM channel-AR prior or a learned Gaussian per split with
a standard normal on the last level (`prior`), with the JAX package's names
and defaults. The K steps of a level are a plain loop (the JAX package
scans a stacked copy; `convert.py` unstacks it and stacks it back). The
whole model also runs in float64 (`model.double()`).

Training mode is PyTorch's: `model.train()` turns on the couplings'
dropout (`drop_prob`, 0.2 as in the JAX package) and the prior's
(`prior_dp_rate`, 0), `model.eval()` turns them off; the JAX package
passes `train=True` instead. `ddi` always runs without dropout.

`fused_gated_conv` (off by default, as in the JAX package) runs every
coupling block's GatedConv and residual as one `fused_gated_conv` kernel.
It has the same parameters, and in eval mode or at dropout 0 the same
numbers up to rounding; its Dropout2d mask comes from Philox. The JAX
package's compile and memory options (scan_steps, scan_unroll, remat*,
precompute_wn, prior_scan_unroll) change no numbers and have no
counterpart here.

`compute_dtype` ("float32", the default, or "bfloat16", `bench.py`'s) is
the JAX package's: in bfloat16 the MixLogCDF coupling nets run in bf16
(ops/mixlogcdf.py says where they round) and so does the ConvLSTM prior's
log-likelihood, while the flow's actnorms, invertible convolutions and
attentions, the mixture head and its kernels, every log-det and the prior's
sampling stay float32. Parameters are float32 under either dtype. The bf16
path serves (eval bits/dim, sampling) and trains on the card: the
attention's forward and backward run bf16 kernels at every head width, and
parameters, the Adamax state, the loss and every log-det stay float32.
With `fused_gated_conv` in bfloat16 the fused GatedConv runs its bf16
kernels (`bench.py`'s BENCH_FUSED_GCONV=1 step).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn

from ..ops.actnorm import ActNorm
from ..ops.attention import InvertibleAttention
from ..ops.basic import GaussianDiag, Squeeze, TupleFlip, split_channels
from ..ops.coupling import AffineCoupling, Split2dGaussian
from ..ops.invconv import InvConv1x1
from ..ops.mixlogcdf import MixLogCDFCoupling
from ..utils.device import resolve_device
from .prior import ChannelPriorMultiScale


@dataclass(frozen=True)
class MarScfConfig:
    image_shape: Tuple[int, int, int] = (32, 32, 3)  # H, W, C
    L: int = 3
    K: int = 4
    hidden_channels: int = 96
    coupling: str = "mixlogcdf"  # "mixlogcdf" | "affine"
    use_attention: bool = True
    attn_heads: int = 3
    num_blocks: int = 10
    num_components: int = 32
    drop_prob: float = 0.2
    prior: str = "convlstm"  # "convlstm" | "gaussian"
    prior_hidden: int = 32
    prior_layers: int = 3
    prior_dp_rate: float = 0.0
    actnorm_scale: float = 1.0
    fused_gated_conv: bool = False
    compute_dtype: str = "float32"  # "float32" | "bfloat16"

    def __post_init__(self):
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {self.compute_dtype!r} is not "
                             f"one of {tuple(COMPUTE_DTYPES)}")

    @property
    def torch_compute_dtype(self):
        """The coupling nets' and the prior likelihood's dtype: None (the
        model's own, float32 or float64) or torch.bfloat16."""
        return COMPUTE_DTYPES[self.compute_dtype]


COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


class FlowStep(nn.Module):
    def __init__(self, cfg: MarScfConfig, channels: int, *, generator=None):
        super().__init__()
        self.actnorm = ActNorm(channels, scale=cfg.actnorm_scale)
        self.invconv = InvConv1x1(channels, generator=generator)
        self.use_attention = cfg.use_attention
        if cfg.use_attention:
            self.attn1 = InvertibleAttention(
                channels, num_heads=cfg.attn_heads, generator=generator)
            self.attn2 = InvertibleAttention(
                channels, num_heads=cfg.attn_heads, generator=generator)
        if cfg.coupling == "mixlogcdf":
            self.coupling = MixLogCDFCoupling(
                channels, cfg.hidden_channels, num_blocks=cfg.num_blocks,
                num_components=cfg.num_components, drop_prob=cfg.drop_prob,
                generator=generator, fused_gconv=cfg.fused_gated_conv,
                compute_dtype=cfg.torch_compute_dtype)
            self.tuple_flip = TupleFlip()
        elif cfg.coupling == "affine":
            self.coupling = AffineCoupling(channels, channels,
                                           cfg.hidden_channels,
                                           generator=generator)
            self.tuple_flip = None
        else:
            raise ValueError(f"unknown coupling {cfg.coupling!r}")

    def _after_actnorm(self, x, logdet, generator=None, ddi=False):
        x, logdet = self.invconv(x, logdet)
        if self.use_attention:
            x, logdet = self.attn1(x, logdet)
            x, logdet = self.attn2(x, logdet, permute=True)
        if ddi and isinstance(self.coupling, AffineCoupling):
            x, logdet = self.coupling.ddi(x, logdet)
        else:
            x, logdet = self.coupling(x, logdet, generator)
        if self.tuple_flip is not None:
            x, logdet = self.tuple_flip.forward(x, logdet)
        return x, logdet

    def forward(self, x, logdet, generator=None):
        return self._after_actnorm(*self.actnorm(x, logdet), generator)

    def inverse(self, y, logdet):
        if self.tuple_flip is not None:
            y, logdet = self.tuple_flip.inverse(y, logdet)
        y, logdet = self.coupling.inverse(y, logdet)
        if self.use_attention:
            y, logdet = self.attn2.inverse(y, logdet, permute=True)
            y, logdet = self.attn1.inverse(y, logdet)
        y, logdet = self.invconv.inverse(y, logdet)
        return self.actnorm.inverse(y, logdet)

    def ddi(self, x, logdet):
        """forward() with the actnorms (the step's, and the affine
        coupling's fused ones) initialised from `x` first."""
        return self._after_actnorm(*self.actnorm.ddi(x, logdet), ddi=True)


class Level(nn.Module):
    def __init__(self, cfg: MarScfConfig, channels: int, *, generator=None):
        super().__init__()
        self.steps = nn.ModuleList(FlowStep(cfg, channels, generator=generator)
                                   for _ in range(cfg.K))

    def forward(self, z, logdet, generator=None):
        for step in self.steps:
            z, logdet = step(z, logdet, generator)
        return z, logdet

    def inverse(self, z, logdet):
        for step in reversed(self.steps):
            z, logdet = step.inverse(z, logdet)
        return z, logdet


class MarScfFlow(nn.Module):
    """Image density model in bits/dim; forward = encode, inverse = sample.

    Parameters are drawn on the CPU from `generator` (a CPU torch.Generator,
    or seed 0) and then moved to `device`, so the same seed gives the same
    weights on every device. `device` defaults to CUDA and raises on a host
    without a card; pass device="cpu" to run the plain PyTorch versions of
    the kernels."""

    def __init__(self, cfg: MarScfConfig, *, device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        h, w, c = cfg.image_shape
        if c not in (1, 3):
            raise ValueError(f"image channels must be 1 or 3, got {c}")
        self.squeeze = Squeeze(2)
        levels, self.level_shapes = [], []
        for i in range(cfg.L):
            c, h, w = c * 4, h // 2, w // 2
            levels.append(Level(cfg, c, generator=generator))
            self.level_shapes.append((c, h, w))
            if i < cfg.L - 1:
                c = c // 2
        self.levels = nn.ModuleList(levels)
        self.final_shape = (c, h, w)
        hh, ww, cc = cfg.image_shape
        if cfg.prior == "convlstm":
            self.prior = ChannelPriorMultiScale(
                cc, hh, ww, cfg.L, hidden_size=cfg.prior_hidden,
                num_layers=cfg.prior_layers, dp_rate=cfg.prior_dp_rate,
                compute_dtype=cfg.torch_compute_dtype, generator=generator)
            self.splits = None
        elif cfg.prior == "gaussian":
            self.prior = None
            self.splits = nn.ModuleList(
                Split2dGaussian(self.level_shapes[i][0])
                for i in range(cfg.L - 1))
        else:
            raise ValueError(f"unknown prior {cfg.prior!r}")
        self.num_dims = hh * ww * cc
        self.to(device)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    # -- density -------------------------------------------------------------
    def encode(self, z, logdet, generator=None):
        """Runs the flow and adds the prior log-probs -> (final z, objective).
        In training mode `generator` draws the dropout."""
        for i, level in enumerate(self.levels):
            z, logdet = level(*self.squeeze.forward(z, logdet), generator)
            if i < self.cfg.L - 1:
                if self.prior is None:
                    z, logdet = self.splits[i](z, logdet)
                    continue
                z1, z2 = split_channels(z)
                logdet = logdet + self.prior.log_likelihood((z1, z2), i + 1,
                                                            generator)
                z = z1
        if self.prior is None:
            return z, logdet + GaussianDiag.logp(None, None, z)
        return z, logdet + self.prior.log_likelihood(z, self.cfg.L, generator)

    def dequantize(self, x, generator=None, noise=None):
        """x + U[0, 1)/256; `noise` (x's shape) replaces the draw."""
        if noise is None:
            noise = torch.rand(x.shape, generator=generator, dtype=x.dtype,
                               device=x.device)
        return x + noise * (1.0 / 256.0)

    def forward(self, x, *, generator=None, noise=None):
        """x in [-0.5, 0.5] -> (z, nll in bits/dim per image). `generator`
        draws the dequantisation noise and, in training mode, the dropout."""
        z = self.dequantize(x, generator, noise)
        logdet = torch.full((x.shape[0],), -math.log(256.0) * self.num_dims,
                            dtype=x.dtype, device=x.device)
        z, objective = self.encode(z, logdet, generator)
        return z, -objective / (math.log(2.0) * self.num_dims)

    # -- sampling ------------------------------------------------------------
    def sample(self, batch: int, eps_std: float = 1.0, generator=None):
        cfg, device = self.cfg, self.device
        if self.prior is None:
            z = GaussianDiag.sample_eps(
                (batch, *self.final_shape), eps_std, generator,
                dtype=next(self.parameters()).dtype, device=device)
        else:
            z = self.prior.sample(cfg.L, batch=batch, eps_std=eps_std,
                                  generator=generator, device=device)
        zero = torch.zeros((batch,), device=device, dtype=z.dtype)
        for i in reversed(range(cfg.L)):
            if i < cfg.L - 1:
                if self.prior is None:
                    z, _ = self.splits[i].inverse(z, zero, eps_std, generator)
                else:
                    z2 = self.prior.sample(i + 1, z1=z, eps_std=eps_std,
                                           generator=generator)
                    z = torch.cat([z, z2], dim=1)
            z, _ = self.levels[i].inverse(z, zero)
            z, _ = self.squeeze.inverse(z, zero)
        return z

    # -- data-dependent init -------------------------------------------------
    @torch.no_grad()
    def ddi(self, x, *, generator=None, noise=None):
        """Initialise every actnorm, in place, from a prototype batch (in eval
        mode, as the JAX package's ddi runs without dropout)."""
        was_training = self.training
        self.eval()
        try:
            z = self.dequantize(x, generator, noise)
            logdet = torch.zeros((x.shape[0],), dtype=x.dtype, device=x.device)
            for i, level in enumerate(self.levels):
                z, logdet = self.squeeze.forward(z, logdet)
                for step in level.steps:
                    z, logdet = step.ddi(z, logdet)
                if i < self.cfg.L - 1:
                    z, _ = split_channels(z)
        finally:
            self.train(was_training)
