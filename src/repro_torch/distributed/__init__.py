"""Collectives with narrowed wire formats (``repro/distributed``)."""
