"""Empirical 1-D densities used to model per-terrain traction distributions.

Host-side NumPy, matching the behavioral contract of the reference
(reference: mppi_numba/density.py:8-108): a ``Density`` wraps a sampling
function and derives mean / variance / CVaR / PMF-discretization from saved
samples; ``GaussianMixture`` is a truncated-by-rejection GMM sampler.

These run on the host during world construction and benchmarking; they are
not part of the per-replan hot path.  The port keeps its own copy of the
JAX package's ``density.py`` (numpy only) so that it imports nothing of
that package.
"""

from __future__ import annotations

import numpy as np


class Density:
    """Empirical distribution wrapper built on a ``sample_fn``."""

    def __init__(self, sample_bounds, pmf_bounds, sample_fn, num_samples=1e4):
        self.sample_bounds = sample_bounds  # bound within which to sample
        self.pmf_bounds = pmf_bounds        # bound within which to extract the PMF
        self.sample_fn = sample_fn
        self.num_samples = num_samples

        self.sample_initialized = False
        self.samples = None

    def initialize_samples(self, num_samples):
        self.samples = self.sample(num_samples)
        self.sample_initialized = True

    def _saved_samples(self):
        if not self.sample_initialized:
            self.initialize_samples(self.num_samples)
        return self.samples

    def mean(self, samples=None):
        samples = self._saved_samples() if samples is None else samples
        return np.mean(samples)

    def var(self, samples=None):
        samples = self._saved_samples() if samples is None else samples
        return np.var(samples)

    def cvar(self, alpha, front=True, samples=None):
        """CVaR via percentile of samples.

        ``front=True`` computes the mean of the worst-``alpha`` *low* tail
        (appropriate for traction, where low values are bad).  Returns
        ``(cvar, var_threshold)`` (reference: mppi_numba/density.py:41-56).
        """
        assert alpha > 0 and alpha <= 1.0, "Alpha must be in (0,1]"
        p = alpha * 100.0 if front else (1.0 - alpha) * 100.0
        samples = self._saved_samples() if samples is None else samples

        thres = np.percentile(samples, p)
        mask = samples < thres if front else samples > thres
        if np.sum(mask) == 0:
            # Degenerate distribution (e.g. all samples identical): fall back
            # to the threshold itself rather than asserting like the reference.
            return float(thres), float(thres)
        return np.mean(samples[mask]), thres

    def sample(self, num):
        return self.sample_fn(num)

    def get_pmf(self, num_bins, include_min_max=True):
        """Histogram PMF over ``pmf_bounds`` with optional exact-min/max bins.

        The extra pinned bins let zero traction and nominal (max) traction be
        represented exactly (reference: mppi_numba/density.py:61-80).
        Returns ``(values, pmf)`` with ``pmf`` summing to 1.
        """
        samples = self._saved_samples()
        vrange = self.pmf_bounds
        nums, _ = np.histogram(samples, num_bins, range=vrange, density=True)

        bin_width = (vrange[1] - vrange[0]) / num_bins
        # linspace, not float arange: arange's float stepping can emit
        # num_bins + 1 centers (e.g. bounds (0, 1) with 49 bins) and
        # desynchronize values from the histogram counts.
        values = (np.linspace(vrange[0], vrange[1], num_bins,
                              endpoint=False) + bin_width / 2)

        if include_min_max:
            values = np.insert(values, 0, vrange[0])
            nums = np.insert(nums, 0, 0)
            values = np.append(values, vrange[1])
            nums = np.append(nums, 0)

        return values, nums / np.sum(nums)


class GaussianMixture(Density):
    """Truncated-by-rejection Gaussian-mixture sampler.

    Used to model per-terrain traction ground truth in simulation
    (reference: mppi_numba/density.py:83-108).  Vectorized rejection sampling
    replaces the reference's one-sample-at-a-time loop.
    """

    def __init__(self, sample_bounds, pmf_bounds, weights, means, stds,
                 num_samples=1e3, rng=None):
        assert np.isclose(sum(weights), 1.0)
        assert len(weights) == len(means) == len(stds)
        assert len(sample_bounds) == 2
        assert len(pmf_bounds) == 2
        assert sample_bounds[1] >= sample_bounds[0]
        assert pmf_bounds[1] >= pmf_bounds[0]
        assert pmf_bounds[0] <= sample_bounds[0] and pmf_bounds[1] >= sample_bounds[1]
        self.num_components = len(weights)
        self.weights = np.asarray(weights, dtype=float)
        self.means = np.asarray(means, dtype=float)
        self.stds = np.asarray(stds, dtype=float)
        rng = np.random if rng is None else rng

        def sample_fn(num):
            num = int(num)
            out = np.empty(num, dtype=float)
            filled = 0
            while filled < num:
                want = num - filled
                # Draw a batch with some headroom for rejections.
                n = max(16, int(want * 1.5))
                idx = rng.choice(self.num_components, size=n, p=self.weights)
                draws = rng.normal(loc=self.means[idx], scale=self.stds[idx])
                ok = draws[(draws >= sample_bounds[0]) & (draws <= sample_bounds[1])]
                take = min(len(ok), want)
                out[filled:filled + take] = ok[:take]
                filled += take
            return out

        super().__init__(sample_bounds, pmf_bounds, sample_fn, num_samples)
