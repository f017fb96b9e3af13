"""Faults the check must catch, one module a driver."""
