"""Configs and weight loading."""
