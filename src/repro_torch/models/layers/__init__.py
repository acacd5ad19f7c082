"""Layers of the port's LM stack."""
