"""GP regression CLI: exact GP on tabular data, or on mAR-SCF flow features.

Counterpart of the JAX package's `train_gp.py`, with the same flags, minus
--no_pallas (the kernels always run on the card; the CPU runs their plain
versions) and plus --device (default cuda; a host without a card raises
unless --device cpu is given). TF32 is switched off.

  default   tabular synthetic regression (`make_regression`), an ARD GP's
            hyperparameters by type-II maximum likelihood.
  --flow    images -> flow encode -> exact GP on the flattened latents.
            Fits three models and prints their NLML and held-out RMSE:
              raw     GP on flattened pixels (the baseline),
              frozen  GP on the features of a fixed flow,
              joint   `FlowGP.fit`: gradients through the flow and the GP.
            The flow (affine couplings, Gaussian split priors, no attention
            by default) is ddi-initialised on x_train[:256];
            --flow_pretrain_steps trains its density full-batch on
            x_train[:512] first (Adamax, no warmup); --flow_checkpoint
            restores a checkpoint of either package instead.

    python -m gpnf_tpu_torch.train_gp --flow --n_train 1024 --n_test 256 \\
        --steps 150 --image_size 16 --flow_C 32 --flow_pretrain_steps 100
"""
from __future__ import annotations

import argparse
import copy
import time

import numpy as np
import torch


def make_regression(n, d, noise, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3, 3, (n, d)).astype(np.float32)
    f = (np.sin(x[:, 0]) + 0.5 * np.cos(2 * x[:, min(1, d - 1)])
         + 0.3 * x[:, 0] ** 2 / 3)
    y = (f + rng.normal(0, noise, n)).astype(np.float32)
    return x, y


def make_image_regression(n, size, noise, seed):
    """Oriented sinusoidal gratings (n, 3, size, size) in [-0.5, 0.5]; the
    target is the spatial frequency (+ noise)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    freq = rng.uniform(1.0, 4.0, n).astype(np.float32)
    theta = rng.uniform(0, np.pi, n).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, (n, 3)).astype(np.float32)
    grid = (np.cos(theta)[:, None, None] * xx[None]
            + np.sin(theta)[:, None, None] * yy[None])
    img = 0.5 * np.sin(2 * np.pi * freq[:, None, None, None] * grid[:, None]
                       + phase[:, :, None, None])
    img += rng.normal(0, 0.02, img.shape).astype(np.float32)
    img = np.clip(img, -0.5, 0.5).astype(np.float32)
    y = (freq + rng.normal(0, noise, n)).astype(np.float32)
    return img, y


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n_train", type=int, default=512)
    p.add_argument("--n_test", type=int, default=128)
    p.add_argument("--dim", type=int, default=4)
    p.add_argument("--kernel", default="rbf",
                   choices=["rbf", "matern12", "matern32", "matern52"])
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--noise", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--flow", action="store_true",
                   help="GP on mAR-SCF flow features (raw/frozen/joint)")
    p.add_argument("--image_size", type=int, default=16)
    p.add_argument("--flow_K", type=int, default=2)
    p.add_argument("--flow_C", type=int, default=32)
    p.add_argument("--flow_L", type=int, default=2)
    p.add_argument("--flow_coupling", default="affine",
                   choices=["affine", "mixlogcdf"])
    p.add_argument("--flow_attention", action="store_true")
    p.add_argument("--flow_lr", type=float, default=None,
                   help="joint-fit lr of the flow (default: --lr x 0.1)")
    p.add_argument("--flow_checkpoint", default=None,
                   help="checkpoint directory (best.npz restored)")
    p.add_argument("--flow_pretrain_steps", type=int, default=0)
    p.add_argument("--flow_pretrain_lr", type=float, default=1e-3)
    return p.parse_args(argv)


def _rmse(mean, y):
    return float(np.sqrt(np.mean((mean.detach().cpu().numpy() - y) ** 2)))


def _fmt_traj(losses, k=5):
    idx = np.unique(np.linspace(0, len(losses) - 1, k).astype(int))
    return " -> ".join(f"{losses[i]:.4f}" for i in idx)


def run_tabular(args, device) -> dict:
    from .models.gp import GPConfig, GPRegression

    x, y = make_regression(args.n_train + args.n_test, args.dim, args.noise,
                           args.seed)
    x_tr = torch.from_numpy(x[:args.n_train]).to(device)
    y_tr = torch.from_numpy(y[:args.n_train]).to(device)
    x_te, y_te = torch.from_numpy(x[args.n_train:]).to(device), y[args.n_train:]
    gp = GPRegression(GPConfig(kernel=args.kernel, ard=True), args.dim,
                      device=device)
    with torch.no_grad():
        nlml0 = float(gp.neg_log_marginal_likelihood(x_tr, y_tr))
    t0 = time.perf_counter()
    losses = gp.fit(x_tr, y_tr, steps=args.steps, lr=args.lr)
    fit_s = time.perf_counter() - t0
    with torch.no_grad():
        mean, var = gp.posterior(x_tr, y_tr, x_te)
    mean_np, var_np = mean.cpu().numpy(), var.cpu().numpy()
    rmse = float(np.sqrt(np.mean((mean_np - y_te) ** 2)))
    inside = float(np.mean(np.abs(mean_np - y_te) <= 2 * np.sqrt(var_np)))
    print(f"kernel={args.kernel} N={args.n_train} D={args.dim} device={device}")
    print(f"NLML: {nlml0:.4f} -> {losses[-1]:.4f} | test RMSE {rmse:.4f} "
          f"| 2-sigma coverage {inside:.2%}")
    print(f"lengthscales {np.exp(gp.log_lengthscale.detach().cpu().numpy()).round(3)}"
          f" noise {float(torch.exp(gp.log_noise.detach())):.4f}")
    return {"nlml_start": nlml0, "nlml_end": float(losses[-1]),
            "losses": losses.tolist(), "rmse": rmse, "coverage": inside,
            "fit_s": fit_s, "min_var": float(var_np.min())}


def density_pretrain(flow, x, steps, lr, generator):
    """Full-batch density (bits/dim) training of the flow with Adamax (no
    warmup), in place; the bits/dim before each update, read once."""
    opt = torch.optim.Adamax(flow.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8)
    flow.train()
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = torch.mean(flow(x, generator=generator)[1])
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    flow.eval()
    return torch.stack(losses).cpu().numpy()


def build_flow(args, device):
    """The flow of --flow mode, random weights from --seed, in eval mode."""
    from .models.marscf import MarScfConfig, MarScfFlow

    s = args.image_size
    cfg = MarScfConfig(image_shape=(s, s, 3), L=args.flow_L, K=args.flow_K,
                       hidden_channels=args.flow_C,
                       coupling=args.flow_coupling,
                       use_attention=args.flow_attention, num_blocks=2,
                       drop_prob=0.0, prior="gaussian")
    return MarScfFlow(cfg, device=device, generator=torch.Generator(
        ).manual_seed(args.seed)).eval()


def run_flow(args, device) -> dict:
    from .models.gp import FlowGP, GPConfig, GPRegression, flow_feature_fn
    from .ops import kernels

    s = args.image_size
    imgs, y = make_image_regression(args.n_train + args.n_test, s, args.noise,
                                    args.seed)
    x_tr = torch.from_numpy(imgs[:args.n_train]).to(device)
    y_tr = torch.from_numpy(y[:args.n_train]).to(device)
    x_te, y_te = torch.from_numpy(imgs[args.n_train:]).to(device), y[args.n_train:]
    gen = torch.Generator(device=device)

    flow = build_flow(args, device)
    out = {}
    if args.flow_checkpoint:
        from .training.checkpoints import CheckpointManager
        CheckpointManager(args.flow_checkpoint).restore(flow, best=True)
        print(f"flow: restored checkpoint from {args.flow_checkpoint}")
    else:
        flow.ddi(x_tr[:256], generator=gen.manual_seed(1))
        if args.flow_pretrain_steps:
            t0 = time.perf_counter()
            dlosses = density_pretrain(
                flow, x_tr[:min(args.n_train, 512)], args.flow_pretrain_steps,
                args.flow_pretrain_lr, gen.manual_seed(args.seed))
            out["pretrain_losses"] = dlosses.tolist()
            print(f"flow: density pretrain {args.flow_pretrain_steps} steps, "
                  f"bits/dim {_fmt_traj(dlosses)} "
                  f"({time.perf_counter() - t0:.1f}s)")

    with torch.no_grad():
        z_tr = flow_feature_fn(flow)(x_tr)
    d_feat, d_raw = z_tr.shape[-1], int(np.prod(x_tr.shape[1:]))
    print(f"device={device} n_train={args.n_train} image={s}x{s}x3 "
          f"raw_dim={d_raw} flow_dim={d_feat} flow=({args.flow_coupling} "
          f"K={args.flow_K} C={args.flow_C} L={args.flow_L} "
          f"attn={args.flow_attention})")
    out.update(flow_dim=d_feat, raw_dim=d_raw)

    def record(mode, nlml0, losses, mean, var, fit_s, t0, **extra):
        # _rmse reads the mean back: total_s ends after the device's work
        out[mode] = dict(nlml_start=nlml0, nlml_end=float(losses[-1]),
                         losses=losses.tolist(), rmse=_rmse(mean, y_te),
                         fit_s=fit_s, total_s=time.perf_counter() - t0,
                         min_var=float(var.min()), **extra)

    # -- raw-pixel baseline ------------------------------------------------------
    x_tr_flat, x_te_flat = x_tr.reshape(args.n_train, -1), x_te.reshape(
        x_te.shape[0], -1)
    raw_gp = GPRegression(GPConfig(kernel=args.kernel, ard=False), d_raw,
                          device=device).init_from_data(x_tr_flat, y_tr)
    t0 = time.perf_counter()
    with torch.no_grad():
        nlml0 = float(raw_gp.neg_log_marginal_likelihood(x_tr_flat, y_tr))
    t1 = time.perf_counter()
    losses = raw_gp.fit(x_tr_flat, y_tr, steps=args.steps, lr=args.lr)
    fit_s = time.perf_counter() - t1
    with torch.no_grad():
        mean, var = raw_gp.posterior(x_tr_flat, y_tr, x_te_flat)
    record("raw", nlml0, losses, mean, var, fit_s, t0)

    # -- flow features, frozen and joint --------------------------------------------
    gp0 = GPRegression(GPConfig(kernel=args.kernel, ard=False), d_feat,
                       device=device).init_from_data(z_tr, y_tr)
    flow_lr = args.flow_lr if args.flow_lr is not None else args.lr * 0.1
    for mode, train_flow in (("frozen", False), ("joint", True)):
        fgp = FlowGP(copy.deepcopy(flow) if train_flow else flow,
                     copy.deepcopy(gp0))
        t0 = time.perf_counter()
        before = kernels.launch_counts()
        losses = fgp.fit(x_tr, y_tr, steps=args.steps, lr=args.lr,
                         flow_lr=flow_lr, train_flow=train_flow)
        fit_s = time.perf_counter() - t0
        after = kernels.launch_counts()
        with torch.no_grad():
            mean, var = fgp.posterior(x_tr, y_tr, x_te)
        record(mode, float(losses[0]), losses, mean, var, fit_s, t0,
               launches_per_step={k: (after[k] - before[k]) / args.steps
                                  for k in after})
        out[mode]["model"] = fgp
        print(f"{mode:>6}: NLML {_fmt_traj(losses)}")

    print(f"{'model':>6} | {'NLML start':>10} | {'NLML end':>9} | "
          f"{'test RMSE':>9} | {'fit s':>6}")
    for mode in ("raw", "frozen", "joint"):
        r = out[mode]
        print(f"{mode:>6} | {r['nlml_start']:10.4f} | {r['nlml_end']:9.4f} | "
              f"{r['rmse']:9.4f} | {r['total_s']:6.1f}")
    return out


def main(argv=None) -> dict:
    from .utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return run_flow(args, device) if args.flow else run_tabular(args, device)


if __name__ == "__main__":
    main()
