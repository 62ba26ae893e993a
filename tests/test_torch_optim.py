"""The port's optimizer (torch.optim.Adamax + the lagged warmup + the skip of
non-finite updates) in lockstep with the JAX package's
`optax.apply_if_finite(reference_adamax(reference_warmup(...)))`, the
optimizer gpnf_tpu/training/loop.py trains with."""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gpnf_tpu.training.optim import reference_adamax, reference_warmup
from gpnf_tpu_torch.training.optim import AdamaxWarmup, warmup_factor
from torch_parity import close, rng

SHAPES = [(7,), (4, 5), (3, 3, 2, 2)]


def _lockstep(grads_per_step, max_errors, lr=1e-2, warm_up=8, batch_size=2):
    r = rng(0)
    init = [r.standard_normal(s).astype(np.float32) for s in SHAPES]
    tparams = [torch.nn.Parameter(torch.tensor(v.copy())) for v in init]
    opt = AdamaxWarmup(tparams, lr=lr, warm_up=warm_up, batch_size=batch_size,
                       max_consecutive_errors=max_errors)
    jopt = optax.apply_if_finite(
        reference_adamax(reference_warmup(lr, warm_up, batch_size)),
        max_consecutive_errors=max_errors)
    jparams = [jnp.asarray(v) for v in init]
    state = jopt.init(jparams)
    applied = []
    for i, grads in enumerate(grads_per_step):
        opt.zero_grad()
        for p, g in zip(tparams, grads):
            p.grad = torch.tensor(g.copy())
        applied.append(opt.step())
        updates, state = jopt.update([jnp.asarray(g) for g in grads], state,
                                     jparams)
        jparams = optax.apply_updates(jparams, updates)
        for tp, jp in zip(tparams, jparams):
            np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {i}")
    return opt, state, applied


def _grads(steps, nan_at=()):
    r = rng(1)
    out = []
    for i in range(steps):
        grads = [r.standard_normal(s).astype(np.float32) * (1.0 + i)
                 for s in SHAPES]
        grads[0] = grads[0] * 1e-9  # the eps-inside-the-max branch
        if i in nan_at:
            grads[1][2, 3] = np.nan
        out.append(grads)
    return out


def test_ten_steps_with_a_nan_gradient_match_jax():
    opt, state, applied = _lockstep(_grads(10, nan_at=(4,)), 100)
    assert applied == [i != 4 for i in range(10)]
    assert opt.total_notfinite == int(state.total_notfinite) == 1
    # the skipped update advanced neither the moments nor the schedule
    assert int(state.inner_state.count) == 9
    assert opt.scheduler.last_epoch == 9


def test_update_applied_after_too_many_nonfinite_in_a_row():
    opt, state, applied = _lockstep(_grads(6, nan_at=(1, 2, 3)), 2)
    assert applied == [True, False, False, True, True, True]
    assert opt.notfinite_count == int(state.notfinite_count) == 0


@pytest.mark.parametrize("batch_size,warm_up", [(2, 8), (64, 64)])
def test_warmup_lags_one_update(batch_size, warm_up):
    factor = warmup_factor(warm_up, batch_size)
    sched = reference_warmup(1.0, warm_up, batch_size)
    got = [factor(n) for n in range(12)]
    want = [float(sched(jnp.asarray(n, jnp.int32))) for n in range(12)]
    close(np.array(got), np.array(want), 0, 1e-7)
    assert got[0] == got[1] == 0.0
