"""Hand-written Hopper kernels (``csrc/``), their wrappers and plain versions."""
