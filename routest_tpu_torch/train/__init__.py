"""Serving-artifact IO."""
