"""Artifact IO, the ETA training loop and the GNN / route-transformer
trainers."""
