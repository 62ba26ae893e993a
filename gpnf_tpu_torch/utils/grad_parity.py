"""Per-tensor parity of a bf16 training step's gradients against a
reference bf16 step on the same weights, images and noise.

A bf16 gradient is the float32 one plus rounding noise, and two valid bf16
backwards (the same rounding points, float32 sums in other orders) differ
by noise of the same size: one sum whose last bit differs flips a bf16
rounding, and the flips run on through every layer below it. So a tensor is
held to its own noise, measured on the reference device: the larger of its
reference bf16 step's distance from the float32 step and its distance from
further bf16 steps on weights moved by a few float32 ulps (as valid a bf16
run as the first; the float32 gradient moves by far less). Each tensor's
bar is the larger of `floor` of its own largest float32 gradient and `k`
times that noise.

A tensor of few elements has no stable noise of its own: the noise of one
element is a single draw, which can land near zero by chance, and then a
second valid bf16 run sits many times that draw away from the first
(PERF.md has the flagship's readings). A tensor with fewer
than POOL_MIN elements is therefore held to the noise pooled over its
namesakes: every tensor of the same name with the indices left out
(levels.*.steps.*.attn2.offset3) that also has fewer than POOL_MIN
elements.
"""
from __future__ import annotations

import re

import torch

POOL_MIN = 12
# On the flagship the card's bf16 step and a CPU run on moved weights
# both sit within about a third of this bar on their worst tensor
# (PERF.md): K = 3 keeps a margin over the tails of a max over few
# elements
K = 3.0
FLOOR = 1e-3


def pool_name(name: str) -> str:
    """The name with its indices left out: levels.2.steps.0.attn2.offset3
    -> levels.*.steps.*.attn2.offset3."""
    return re.sub(r"(?<![^.])\d+(?![^.])", "*", name)


def perturbed(module: torch.nn.Module, seed: int,
              rel: float = 2.0 ** -22) -> dict:
    """`module`'s state dict with each parameter times 1 +- rel (a random
    sign each, from `seed`) and its buffers as they are."""
    gen = torch.Generator().manual_seed(seed)
    out = {k: v.detach().clone() for k, v in module.state_dict().items()}
    for name, p in module.named_parameters():
        v = p.detach().cpu()
        sign = torch.randint(0, 2, v.shape, generator=gen).to(v) * 2 - 1
        out[name] = (v * (1 + rel * sign)).to(p.device)
    return out


def _maxabs(a, b) -> float:
    return float((a - b).abs().max())


def bf16_grad_parity(got: dict, ref16: dict, ref32: dict, others=(),
                     k: float = K, floor: float = FLOOR) -> list:
    """One row per tensor, worst first: (diff / bar, name, diff, noise,
    max |ref32|, elements), where diff = max |got - ref16| and noise is the
    tensor's (or its pool's) largest of max |ref16 - ref32| and
    max |other - ref16| over `others` (further reference bf16 gradients on
    perturbed weights). The tensor passes where the ratio is at most 1."""
    own = {n: max([_maxabs(ref16[n], ref32[n])]
                  + [_maxabs(o[n], ref16[n]) for o in others])
           for n in ref32}
    pools = {}
    for n, g in ref32.items():
        if g.numel() < POOL_MIN:
            key = pool_name(n)
            pools[key] = max(pools.get(key, 0.0), own[n])
    rows = []
    for n, g in ref32.items():
        noise = pools[pool_name(n)] if g.numel() < POOL_MIN else own[n]
        diff = _maxabs(got[n], ref16[n])
        top = float(g.abs().max())
        bar = max(floor * top, k * noise)
        rows.append((diff / bar if bar else float(diff > 0) * float("inf"),
                     n, diff, noise, top, g.numel()))
    return sorted(rows, reverse=True)
