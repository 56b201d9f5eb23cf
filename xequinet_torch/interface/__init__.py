"""Deployment-facing calculators."""
