"""ETA regressors."""
