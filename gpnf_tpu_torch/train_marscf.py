"""Train mAR-SCF (ConvLSTM prior) with the PyTorch port.

The counterpart of `train_marscf.py` without `--from_checkpoint` (that is
`python -m gpnf_tpu_torch.eval_marscf`), with the flags that apply to the
port plus --device (default cuda; a host without a card raises unless
--device cpu is given). The coupling is MixLogCDF (the port's default) or
affine, the invertible attentions are on unless --no_attention. Adamax at
lr 1e-4 with the lagged warmup counted in samples, dropout 0.2 in the
MixLogCDF couplings, TF32 off; the best test NLL's parameters go to
<checkpoint_dir>/marscf_<ds>_<coupling>_<K>_<C>/ in the JAX package's npz
layout, so either package restores them. --compute_dtype float32 (the
default, the JAX CLI's) trains in float32 throughout; bfloat16 (`bench.py`'s
train step) runs the MixLogCDF coupling nets and the prior's likelihood in
bf16, forward and backward, each product summed in float32 and rounded
once, as the JAX package does: parameters, Adamax state, the loss and every
log-det stay float32, and so do the checkpoints.

    python -m gpnf_tpu_torch.train_marscf --dataset_name cifar10 \\
        --batch_size 64 --L 3 --K 4 --C 96 --device cuda
    python -m gpnf_tpu_torch.train_marscf --dataset_name imagenet_64 \\
        --batch_size 64 --L 3 --K 4 --C 96 --device cuda
    python -m gpnf_tpu_torch.train_marscf --dataset_name cifar10 \\
        --batch_size 64 --L 3 --K 4 --C 96 --device cuda \\
        --compute_dtype bfloat16
"""
from __future__ import annotations

import argparse

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset_name", default="cifar10",
                   choices=["cifar10", "imagenet_32", "imagenet_64",
                            "synthetic"])
    p.add_argument("--data_root", default=None)
    p.add_argument("--coupling", default="mixlogcdf",
                   choices=["mixlogcdf", "affine"])
    p.add_argument("--batch_size", default=128, type=int)
    p.add_argument("--warm_up", default=10000, type=int,
                   help="warmup in samples")
    p.add_argument("--L", default=3, type=int)
    p.add_argument("--K", default=32, type=int)
    p.add_argument("--C", default=512, type=int)
    p.add_argument("--no_attention", action="store_true")
    p.add_argument("--max_steps", default=None, type=int)
    p.add_argument("--epochs", default=100000, type=int)
    p.add_argument("--eval_every_steps", default=None, type=int,
                   help="eval/ckpt every N steps instead of per epoch")
    p.add_argument("--checkpoint_dir", default="./checkpoints")
    p.add_argument("--log_path", default=None,
                   help="append the log and eval records here as JSON lines")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default="cuda")
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="coupling-net and prior-likelihood dtype (the "
                        "log-dets stay float32)")
    return p.parse_args(argv)


def model_config(args, image_shape=(32, 32, 3), compute_dtype="float32"):
    """The MarScfConfig of the parsed flags, for both CLIs (the train loop
    sets the image shape from the dataset; eval_marscf passes its
    --compute_dtype)."""
    from .models.marscf import MarScfConfig

    return MarScfConfig(image_shape=image_shape, L=args.L, K=args.K,
                        hidden_channels=args.C, coupling=args.coupling,
                        use_attention=not args.no_attention,
                        compute_dtype=compute_dtype)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from .training.loop import TrainConfig, train
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(f"device: {device} "
          f"({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'})"
          f", tf32 off, compute dtype {args.compute_dtype}")
    model_cfg = model_config(args, compute_dtype=args.compute_dtype)
    train_cfg = TrainConfig(
        dataset=args.dataset_name, data_root=args.data_root,
        batch_size=args.batch_size, warm_up=args.warm_up, epochs=args.epochs,
        eval_every_steps=args.eval_every_steps, max_steps=args.max_steps,
        checkpoint_dir=args.checkpoint_dir, log_path=args.log_path,
        seed=args.seed, device=args.device)
    _, best = train(model_cfg, train_cfg)
    print(f"best test NLL (bits/dim): {best:.4f}")
    return {"best_test_nll": best}


if __name__ == "__main__":
    main()
