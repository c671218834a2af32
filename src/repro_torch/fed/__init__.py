"""Federated training: the FedVeca simulator and its baselines (port of
``repro/fed``, the synchronous round).

Public surface:
  * ``FedSimConfig`` / ``FederatedSimulator`` — K rounds of the fused
    round + controller step on one device;
  * ``fair_fixed_tau`` — the paper's fixed-tau protocol for the baselines;
  * ``centralized_sgd`` — the pooled-data baseline.

Run ``python -m repro_torch.fed --help`` for the command line.
"""
from repro_torch.fed.simulator import (FederatedSimulator, FedSimConfig, centralized_sgd,
                                       fair_fixed_tau)

__all__ = ["FedSimConfig", "FederatedSimulator", "centralized_sgd", "fair_fixed_tau"]
