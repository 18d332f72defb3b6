"""Helpers over parameter trees (nested dicts of tensors)."""
