"""Deterministic fault injection for the serving sentinel; see
faultinject.py."""
