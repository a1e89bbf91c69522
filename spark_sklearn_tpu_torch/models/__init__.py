"""Estimator families and estimator classes."""
