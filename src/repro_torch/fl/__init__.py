"""Federated learning: batched client step, compression, the trainer."""
from .server import FederatedTrainer, RoundLog

__all__ = ["FederatedTrainer", "RoundLog"]
