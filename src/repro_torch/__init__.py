"""Blaze in PyTorch and CUDA: the port of ``repro`` to an NVIDIA H100.

``repro_torch.core`` holds the MapReduce engine, containers and session;
``repro_torch.kernels`` the hand-written CUDA kernels with their plain PyTorch
versions; ``repro_torch.convert`` carries containers across from the JAX
package as numpy arrays.
"""
