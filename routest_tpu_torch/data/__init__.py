"""The 12-feature ETA input encoding, geodesy and the seed locations."""
