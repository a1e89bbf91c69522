"""Keyed model fleets (KeyedEstimator/KeyedModel) and gapply."""
