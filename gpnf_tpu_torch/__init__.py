"""gpnf_tpu_torch: the PyTorch/CUDA port of gpnf_tpu for NVIDIA Hopper.

It stands beside the JAX package, which stays the reference, and imports
nothing of it. Plain tensor code is PyTorch; every Pallas kernel on a
ported path is a hand-written CUDA kernel (ops/kernels, csrc/). Entry
points run on the card unless the caller asks for the CPU.
"""
