"""Tensor ops of the solve: costs, sampling, packing, rollout, CVaR, update."""
