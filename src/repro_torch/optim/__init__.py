"""Optimisers of the port (``repro/optim``)."""
