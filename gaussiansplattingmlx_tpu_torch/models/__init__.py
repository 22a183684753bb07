"""Gaussian parameter store."""
