"""Serve an mAR-SCF checkpoint written by the JAX package: test bits/dim
over the test loader, then an ancestral-sample grid as a PNG.

The counterpart of `train_marscf.py --from_checkpoint`, with the same flags
plus --device (default cuda; a host without a card raises unless
--device cpu is given). Reads <checkpoint_dir>/marscf_<ds>_<coupling>_<K>_<C>/
best.npz and writes samples/torch_<same id>.png. TF32 is switched off, and
so are bf16 products' reduced-precision sums: --compute_dtype float32 (the
default, the JAX CLI's) serves in float32 throughout; bfloat16 runs the
MixLogCDF coupling nets and the prior's likelihood in bf16, each product
summed in float32 and rounded once, as the JAX package does (the mixture
head and every log-det stay float32; the checkpoint is float32 either way).

    python -m gpnf_tpu_torch.eval_marscf --dataset_name synthetic \
        --coupling mixlogcdf --L 3 --K 4 --C 96 --device cuda \
        --compute_dtype bfloat16
"""
from __future__ import annotations

import argparse
import os

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
    p.add_argument("--L", default=3, type=int)
    p.add_argument("--K", default=32, type=int)
    p.add_argument("--C", default=512, type=int)
    p.add_argument("--no_attention", action="store_true")
    p.add_argument("--checkpoint_dir", default="./checkpoints")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default="cuda")
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="coupling-net and prior-likelihood dtype (the "
                        "log-dets stay float32)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from .data.datasets import get_dataset
    from .models.marscf import MarScfFlow
    from .train_marscf import model_config
    from .training.checkpoints import CheckpointManager
    from .training.loop import evaluate, save_sample_grid
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(f"device: {device} "
          f"({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'})"
          f", tf32 off, compute dtype {args.compute_dtype}")

    _, test_loader, image_shape = get_dataset(args.dataset_name,
                                              args.batch_size, args.data_root)
    model = MarScfFlow(model_config(args, image_shape, args.compute_dtype),
                       device=device).eval()
    setting_id = f"marscf_{args.dataset_name}_{args.coupling}_{args.K}_{args.C}"
    CheckpointManager(os.path.join(args.checkpoint_dir, setting_id)).restore(
        model, best=True)
    print("Checkpoint loaded!")

    gen = lambda k: torch.Generator(device=device).manual_seed(args.seed + k)
    nll = evaluate(model, test_loader, generator=gen(1))
    print(f"Test NLL (bits/dim): {nll:.3f}")
    path, nan_count = save_sample_grid(
        model, f"./samples/torch_{setting_id}.png", n=args.batch_size,
        generator=gen(2))
    print(f"samples -> {path} ({nan_count} NaN before the clamp)")
    return {"nll": nll, "samples": path, "nan_count": nan_count}


if __name__ == "__main__":
    main()
