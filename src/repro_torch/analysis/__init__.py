"""Roofline analysis of the dry run's counts (``analysis.roofline``)."""
