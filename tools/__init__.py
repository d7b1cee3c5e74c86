"""Helpers that make large fixtures for chip_smoke.py and the tests."""
