"""Serving steps of the model zoo on one card."""
