"""Typed config and the dtype policy."""
