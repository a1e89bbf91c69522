"""Conversion of fitted models from the JAX package."""
