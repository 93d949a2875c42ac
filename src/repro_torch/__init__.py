"""Blaze in PyTorch and CUDA: the port of ``repro`` to an NVIDIA H100.

``repro_torch.core`` holds the MapReduce engine, containers and session;
``repro_torch.kernels`` the hand-written CUDA kernels with their plain PyTorch
versions; ``repro_torch.configs`` the model configurations the port runs,
``repro_torch.models`` the LM stack over them (layers, attention with a KV
cache, the dense model) and ``repro_torch.launch`` its entry points
(``serve_lm``); ``repro_torch.convert`` carries containers and LM parameters
across from the JAX package as numpy arrays.
"""
