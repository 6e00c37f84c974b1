"""Synthetic datasets (numpy only), copied from the reference package."""
