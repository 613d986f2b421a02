from .partition import dirichlet_partition, partition_stats
from .pipeline import (ClientData, ClientDataset, client_sample_keys,
                       sample_client_batches, stack_client_datasets)
from .synthetic import make_fmnist_like, make_token_stream

__all__ = ["dirichlet_partition", "partition_stats", "ClientData",
           "ClientDataset", "client_sample_keys", "sample_client_batches",
           "stack_client_datasets", "make_fmnist_like", "make_token_stream"]
