"""Sparse X: the CSR container, its host staging form and its device
operand."""
