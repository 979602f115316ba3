"""Synthetic data and non-IID federated partitioning (numpy)."""
from repro_torch.data.federated import FederatedPartition, dirichlet_partition
from repro_torch.data.synthetic import (SyntheticCelebA,
                                        synthetic_batch_for_config,
                                        synthetic_lm_batch)

__all__ = ["FederatedPartition", "SyntheticCelebA", "dirichlet_partition",
           "synthetic_batch_for_config", "synthetic_lm_batch"]
