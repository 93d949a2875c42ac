"""Checkpoints of the port: atomic commit, keep-N, async save, restore onto a
tree of tensors; ``BlockStore``, the spill target of out-of-core blocks."""
