"""Synthetic datasets (numpy only, so both packages get the same inputs)."""
