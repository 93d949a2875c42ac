"""The fault-tolerant training loop of the port (``repro/runtime``)."""
