"""Terrain layer: semantic terrains and the Traction Distribution Map (TDM).

The TDM owns a padded ``(bins, H, W)`` int8 PMF grid whose bins sum to 100
per cell, and pads the perimeter with a zero-traction ring sized
``ceil(max_speed * dt / res)`` cells so that rollouts never index outside
the map.  It is built from an external PMF grid, a semantic-id grid or an
occupancy costmap, under each planning mode: the full PMF (tdm), a one-hot
at the CVaR traction bin (det_dyn), or nominal traction plus a CVaR risk
speed map (speed_map; the costmap path).  Host work is numpy, as in
``mppi_numba_tpu.terrain``; only the staging of the padded planes moves to
tensors on the TDM's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.kernels.map_sample import sample_traction_window
from .ops.sampling import draw_map_key, quantize_bin_values


def resolve_device(device):
    """The device a planner or TDM stages to: ``"cuda"`` unless the caller
    names another.  Raises when the default is taken on a host without a
    card, rather than carrying on quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


class Terrain:
    """A semantic terrain type holding linear and angular traction densities
    (reference: mppi_numba/terrain.py:24-66)."""

    def __init__(self, name, rgb, lin_density, ang_density, cvar_alpha=0.1,
                 cvar_front=True, num_saved_samples=1e4):
        self.name = name
        self.lin_density = lin_density
        self.ang_density = ang_density
        self.num_saved_samples = num_saved_samples
        self.lin_saved_samples = self.lin_density.sample(num_saved_samples)
        self.ang_saved_samples = self.ang_density.sample(num_saved_samples)

        self.cvar_alpha = cvar_alpha
        self.cvar_front = cvar_front
        self.rgb = rgb

        self.lin_mean = self.lin_density.mean(self.lin_saved_samples)
        self.lin_var = self.lin_density.var(self.lin_saved_samples)
        self.lin_std = np.sqrt(self.lin_var)
        self.lin_cvar, self.lin_cvar_thres = self.lin_density.cvar(
            self.cvar_alpha, samples=self.lin_saved_samples, front=cvar_front)

        self.ang_mean = self.ang_density.mean(self.ang_saved_samples)
        self.ang_var = self.ang_density.var(self.ang_saved_samples)
        self.ang_std = np.sqrt(self.ang_var)
        self.ang_cvar, self.ang_cvar_thres = self.ang_density.cvar(
            self.cvar_alpha, samples=self.ang_saved_samples, front=cvar_front)

    def update_cvar_alpha(self, alpha):
        assert alpha > 0 and alpha <= 1.0
        self.cvar_alpha = alpha
        self.lin_cvar, self.lin_cvar_thres = self.lin_density.cvar(
            self.cvar_alpha, samples=self.lin_saved_samples, front=self.cvar_front)
        self.ang_cvar, self.ang_cvar_thres = self.ang_density.cvar(
            self.cvar_alpha, samples=self.ang_saved_samples, front=self.cvar_front)

    def sample_traction(self, num_samples):
        return (self.lin_density.sample(num_samples),
                self.ang_density.sample(num_samples))

    def __repr__(self):
        return ("Terrain {} has the following properties for linear and "
                "angular tractions.\n".format(self.name) +
                "mean=({:.2f}, {:.2f}), std=({:.2f}, {:.2f}), "
                "cvar({:.2f})=({:.2f}, {:.2f}) (computed from {} saved samples)"
                .format(self.lin_mean, self.ang_mean, self.lin_std,
                        self.ang_std, self.cvar_alpha, self.lin_cvar,
                        self.ang_cvar, self.num_saved_samples))


# ---------------------------------------------------------------------------
# PMF condensation math (host-side, vectorized; oracles in tests/)
# ---------------------------------------------------------------------------

def cvar_bin_for_terrain_pmf(values, pmf, alpha):
    """Bin index whose value first reaches CVaR_alpha of a terrain PMF.

    Semantic-grid det-dynamics condensation (reference:
    mppi_numba/terrain.py:225-259): with alpha == 1 the target is the plain
    expectation; otherwise the conditional mean of the worst-alpha prefix of
    the CDF.  Returns the first bin whose value >= the target.
    """
    values = np.asarray(values, dtype=float)
    pmf = np.asarray(pmf, dtype=float)
    if alpha == 1.0:
        expected = float(np.sum(pmf * values))
    else:
        cum = np.cumsum(pmf)
        L = int(np.argmax(cum >= alpha))
        cs = cum[L]
        expected = float(np.sum((pmf * values)[:L + 1]))
        if cs > 0:
            expected /= cs
    return int(np.argmax(expected <= values))


def cvar_value_for_terrain_pmf(values, pmf, alpha, eps=0.0):
    """CVaR_alpha (worst-alpha conditional mean) of a terrain PMF.

    ``eps`` matches the reference's denominators: 0 on the semantic-grid
    path (reference: mppi_numba/terrain.py:300), 1e-6 on the external-PMF
    path (reference: mppi_numba/terrain.py:443,487).
    """
    values = np.asarray(values, dtype=float)
    pmf = np.asarray(pmf, dtype=float)
    if alpha == 1.0:
        return float(np.sum(pmf * values))
    cum = np.cumsum(pmf)
    L = int(np.argmax(cum >= alpha))
    return float(np.sum((pmf * values)[:L + 1]) / (cum[L] + eps))


def quantize_pmf_int8(pmf):
    """Quantize a float PMF to int8 percentages whose sum is exactly 100.

    Truncating cast per bin, with the LAST bin absorbing the rounding
    residue (reference: mppi_numba/terrain.py:320-324).
    """
    q = (np.asarray(pmf, dtype=float) * 100).astype(np.int8)
    q[-1] = np.int8(100) - np.sum(q[:-1])
    return q


def condense_pmf_grid_det(pmf_grid, bin_values, alpha, eps=1e-6):
    """External-PMF det-dynamics condensation: per-cell one-hot at the bin
    approximating CVaR_alpha of traction (reference:
    mppi_numba/terrain.py:416-448).

    Args:
      pmf_grid: int8 ``(B, R, C)``, bins sum to 100.
      bin_values: float ``(B,)`` ascending bin traction values.
      alpha: det_dynamics_cvar_alpha in (0, 1].

    Returns:
      int8 ``(B, R, C)`` one-hot-per-column (value 100).
    """
    B, R, C = pmf_grid.shape
    bin_values = np.asarray(bin_values, dtype=float)
    pmf_cumsum = 0.01 * pmf_grid.cumsum(axis=0).astype(float)
    weighted_v_cumsum = np.cumsum(
        0.01 * pmf_grid.astype(float) * bin_values.reshape(-1, 1, 1), axis=0)

    if alpha == 1.0:
        targets = weighted_v_cumsum[-1]
    else:
        upto = np.argmax(pmf_cumsum >= alpha, axis=0)
        num = np.take_along_axis(weighted_v_cumsum, upto[None], axis=0)[0]
        den = np.take_along_axis(pmf_cumsum, upto[None], axis=0)[0] + eps
        targets = num / den

    which = np.argmax(targets[None] <= bin_values.reshape(-1, 1, 1), axis=0)
    out = np.zeros((B, R, C), dtype=np.int8)
    np.put_along_axis(out, which[None], np.int8(100), axis=0)
    return out


def risk_map_from_pmf_grid(pmf_grid, bin_values, bin_values_bounds, alpha,
                           eps=1e-6):
    """Per-cell CVaR_alpha of traction encoded int8 0..100 (risk speed map).

    External-PMF speed-map path (reference: mppi_numba/terrain.py:467-490);
    the semantic path computes the same quantity per unique terrain with
    ``eps=0`` via ``cvar_value_for_terrain_pmf``.
    """
    _, R, C = pmf_grid.shape
    bin_values = np.asarray(bin_values, dtype=float)
    pmf_cumsum = 0.01 * pmf_grid.cumsum(axis=0).astype(float)
    weighted_v_cumsum = np.cumsum(
        0.01 * pmf_grid.astype(float) * bin_values.reshape(-1, 1, 1), axis=0)
    traction_range = float(bin_values_bounds[1]) - float(bin_values_bounds[0])

    if alpha == 1.0:
        cvars = weighted_v_cumsum[-1]
    else:
        upto = np.argmax(pmf_cumsum >= alpha, axis=0)
        num = np.take_along_axis(weighted_v_cumsum, upto[None], axis=0)[0]
        den = np.take_along_axis(pmf_cumsum, upto[None], axis=0)[0] + eps
        cvars = num / den

    return (100 * (cvars - float(bin_values_bounds[0])) / traction_range
            ).astype(np.int8).reshape(1, R, C)


class TDM:
    """Traction Distribution Map.

    Typical workflow:
      1. Initialize with a shared ``Config`` (and a device).
      2. ``reset()``
      3. ``set_TDM_from_PMF_grid(...)``, ``set_TDM_from_semantic_grid(...)``
         or ``set_TDM_from_costmap(...)``
      4. Pass to the planner.
      5. Repeat from 2 when the traction map changes.
    """

    def __init__(self, cfg, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.dt = cfg.dt
        self.max_speed_padding = cfg.max_speed_padding
        self.max_map_dim = cfg.max_map_dim
        self.use_tdm = cfg.use_tdm
        self.use_det_dynamics = cfg.use_det_dynamics
        self.use_nom_dynamics_with_speed_map = cfg.use_nom_dynamics_with_speed_map
        self.use_costmap = cfg.use_costmap
        self.det_dyn = cfg.det_dyn
        self.seed = cfg.seed
        self.num_grid_samples = cfg.num_grid_samples
        # Sampled realizations per batch: the det modes collapse to one map.
        self.batch_size = 1 if self.det_dyn else self.num_grid_samples
        # sample_grids' map keys (the planner's solves draw their own).
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(self.seed)
        # Monotone content token, bumped whenever the staged planes change;
        # MPPIPlanner._compact_planes keys its memo on it.
        self._content_version = 0
        self.reset()

    def reset(self):
        self._content_version += 1
        self.semantic_grid = None
        self.semantic_grid_initialized = False
        self.id2name = None
        self.name2terrain = None
        self.id2terrain_fn = None
        self.terrain2pmf = None

        self.pmf_grid = None            # unpadded host int8 (B, R, C)
        self.bin_values = None
        self.bin_values_bounds = None
        self.num_pmf_bins = None
        self.xlimits = None
        self.ylimits = None
        self.padded_xlimits = None
        self.padded_ylimits = None
        self.pad_cells = None
        self.res = None
        self.pmf_grid_initialized = False

        # Tensors on self.device consumed by the solver.
        self.pmf_grid_device = None     # int8 (B, H, W) padded
        self.qbin_values = None         # int8 (B,)
        self.risk_traction_map = None   # host int8 (1, H, W) padded, or None
        self.risk_traction_map_device = None
        self.obstacle_map = None
        self.obstacle_map_device = None
        self.unknown_map = None
        self.unknown_map_device = None
        self.sample_grid_batch = None   # int8 (M, H, W) last sampled batch
        self.cell_dimensions = None

    def _stage(self, array):
        return torch.tensor(np.ascontiguousarray(array), device=self.device)

    # -- construction -----------------------------------------------------

    def set_TDM_from_semantic_grid(self, sg, res, num_pmf_bins, bin_values,
                                   bin_values_bounds, xlimits, ylimits,
                                   id2name, name2terrain, terrain2pmf,
                                   det_dynamics_cvar_alpha=None,
                                   obstacle_map=None, unknown_map=None):
        """Build the PMF grid from a semantic-id grid (simulation benchmarks).

        Per algorithm mode (reference: mppi_numba/terrain.py:183-343):
          * det-dynamics: per-cell one-hot at the CVaR_alpha traction bin;
          * speed-map: one-hot at the LAST bin (nominal traction) plus a
            separate CVaR risk/speed map;
          * tdm: the full quantized PMF.
        """
        if det_dynamics_cvar_alpha is None:
            assert self.use_tdm or self.use_costmap
        else:
            assert 0 < det_dynamics_cvar_alpha <= 1.0

        self.semantic_grid = np.asarray(sg).copy()
        self.id2name = id2name
        self.name2terrain = name2terrain
        self.id2terrain_fn = lambda sid: self.name2terrain[self.id2name[sid]]
        self.terrain2pmf = terrain2pmf
        self.semantic_grid_initialized = True
        self.cell_dimensions = (res, res)
        self.xlimits = xlimits
        self.ylimits = ylimits
        num_rows, num_cols = self.semantic_grid.shape
        self.num_pmf_bins = num_pmf_bins
        self.bin_values = np.asarray(bin_values).astype(np.float32)
        self.bin_values_bounds = np.asarray(bin_values_bounds).astype(np.float32)
        self.res = res

        assert bin_values[0] == 0, "Assume minimum bin value is 0 for now"
        assert bin_values_bounds[0] == 0, "Assume minimum traction is 0 for now"

        self.pmf_grid = np.zeros((num_pmf_bins, num_rows, num_cols), dtype=np.int8)
        unique_ids = np.unique(self.semantic_grid)

        risk_traction_map = None
        if self.use_det_dynamics:
            # One-hot at the CVaR bin, computed once per unique terrain and
            # painted onto its cells (cells of one terrain share the PMF).
            for sid in unique_ids:
                values, pmf = self.terrain2pmf[self.id2terrain_fn(sid)]
                bi = cvar_bin_for_terrain_pmf(values, pmf, det_dynamics_cvar_alpha)
                mask = self.semantic_grid == sid
                self.pmf_grid[bi, mask] = np.int8(100)
            assert (self.pmf_grid.sum(axis=0) == 100).all()

        elif self.use_nom_dynamics_with_speed_map:
            # Nominal dynamics: all mass in the last bin (traction = 1).
            self.pmf_grid[-1, :, :] = np.int8(100)
            traction_range = float(self.bin_values_bounds[1] - self.bin_values_bounds[0])
            risk = np.zeros((num_rows, num_cols), dtype=np.int8)
            for sid in unique_ids:
                values, pmf = self.terrain2pmf[self.id2terrain_fn(sid)]
                cv = cvar_value_for_terrain_pmf(values, pmf,
                                                det_dynamics_cvar_alpha, eps=0.0)
                q = np.int8(100 * (cv - float(self.bin_values_bounds[0])) / traction_range)
                risk[self.semantic_grid == sid] = q
            risk_traction_map = risk.reshape(1, num_rows, num_cols)

        elif self.use_tdm:
            for sid in unique_ids:
                values, pmf = self.terrain2pmf[self.id2terrain_fn(sid)]
                q = quantize_pmf_int8(pmf)
                mask = self.semantic_grid == sid
                self.pmf_grid[:, mask] = q.reshape(-1, 1)
            assert (self.pmf_grid.sum(axis=0) == 100).all()

        else:
            assert False, "TDM cannot be set up"

        self._finalize(risk_traction_map, obstacle_map, unknown_map,
                       num_rows, num_cols, res)

        # Crop the stored semantic map to the padded extent actually kept
        # (reference: mppi_numba/terrain.py:338-341).
        rows_p, cols_p = self.pmf_grid_device.shape[1:]
        self.semantic_grid = self.semantic_grid[
            :rows_p - 2 * self.pad_cells, :cols_p - 2 * self.pad_cells].copy()

    def set_TDM_from_PMF_grid(self, pmf_grid, tdm_dict, obstacle_map=None,
                              unknown_map=None):
        """Initialize from an external int8 PMF grid (the learned-model path).

        ``pmf_grid`` has shape ``(num_bins, height, width)`` with bins
        summing to 100 per cell; ``tdm_dict`` provides res / xlimits /
        ylimits / bin_values / bin_values_bounds / det_dynamics_cvar_alpha.
        Per mode: tdm keeps the PMF; det_dyn condenses each cell to a
        one-hot at the CVaR bin (``condense_pmf_grid_det``); speed_map
        puts all mass in the last bin and stages the CVaR risk speed map
        (``risk_map_from_pmf_grid``).
        """
        alpha = tdm_dict["det_dynamics_cvar_alpha"]
        if not (0 < alpha <= 1.0):
            print("WARNING: TDM cannot be setup since alpha is not in (0,1]")
        assert 0 < alpha <= 1.0
        assert len(pmf_grid.shape) == 3, "PMF grid must have 3 dimensions"
        pmf_grid = np.asarray(pmf_grid)
        self.num_pmf_bins, num_rows, num_cols = pmf_grid.shape
        self.res = res = tdm_dict["res"]
        self.cell_dimensions = (res, res)
        self.xlimits = tdm_dict["xlimits"]
        self.ylimits = tdm_dict["ylimits"]

        self.bin_values = np.asarray(tdm_dict["bin_values"]).astype(np.float32)
        self.bin_values_bounds = np.asarray(tdm_dict["bin_values_bounds"]).astype(np.float32)
        assert self.bin_values[0] == 0, "Assume minimum bin value is 0 for now"
        assert self.bin_values_bounds[0] == 0, "Assume minimum traction is 0 for now"

        if (np.sum(pmf_grid, axis=0) != 100).any():
            print("WARNING: the provided PMF has columns that don't sum up to "
                  "100: {}".format(np.argwhere(np.sum(pmf_grid, axis=0) != 100)))

        risk_traction_map = None
        if self.use_det_dynamics:
            self.pmf_grid = condense_pmf_grid_det(pmf_grid, self.bin_values, alpha)
        elif self.use_nom_dynamics_with_speed_map:
            self.pmf_grid = np.zeros_like(pmf_grid, dtype=np.int8)
            self.pmf_grid[-1] = np.int8(100)
            risk_traction_map = risk_map_from_pmf_grid(
                pmf_grid, self.bin_values, self.bin_values_bounds, alpha)
        else:
            self.pmf_grid = pmf_grid.astype(np.int8)

        if (np.sum(self.pmf_grid, axis=0) != 100).any():
            print("WARNING: some PMF columns do not sum to 100: {}".format(
                np.argwhere(np.sum(self.pmf_grid, axis=0) != 100)))

        self._finalize(risk_traction_map, obstacle_map, unknown_map,
                       num_rows, num_cols, res)

    def set_TDM_from_costmap(self, costmap_dict, obstacle_map=None,
                             unknown_map=None):
        """Initialize from an occupancy costmap (the ROS costmap2d-shaped
        interface).

        Working completion of the reference's abandoned path
        (reference: mppi_numba/terrain.py:698-747 is fully commented out
        and its ``solve()`` asserts False for ``use_costmap``,
        mppi.py:209-211).  Semantics follow that draft: a costmap carries
        no traction information, so dynamics are NOMINAL (2-bin PMF, all
        mass at traction 1); cells equal to ``no_info_value`` (default 255)
        carry no information and become the unknown mask; cells above
        ``costmap_lethal_threshold`` become the obstacle mask; the risk
        speed map is 100 (= full speed) elsewhere.  The planner routes
        costmap mode through the speed-map solve, where decode(100) = 1
        keeps the time cost nominal and the masks carry the penalties —
        the behavior the draft's -1/-2 risk codes were reaching for.

        ``costmap_dict`` keys: costmap (uint8 (rows, cols)), res, xlimits,
        ylimits, costmap_lethal_threshold, optional no_info_value.
        """
        assert self.use_costmap, \
            "set_TDM_from_costmap is invoked when self.use_costmap is not True"
        costmap = np.asarray(costmap_dict["costmap"])
        assert costmap.ndim == 2, "costmap must be 2D (rows, cols)"
        res = costmap_dict["res"]
        self.res = res
        self.cell_dimensions = (res, res)
        self.xlimits = costmap_dict["xlimits"]
        self.ylimits = costmap_dict["ylimits"]
        num_rows, num_cols = costmap.shape

        self.num_pmf_bins = 2
        self.bin_values = np.array([0.0, 1.0], dtype=np.float32)
        self.bin_values_bounds = np.array([0.0, 1.0], dtype=np.float32)
        self.pmf_grid = np.zeros((2, num_rows, num_cols), dtype=np.int8)
        self.pmf_grid[-1] = np.int8(100)

        no_info_value = costmap_dict.get("no_info_value", 255)
        no_info = costmap == no_info_value
        lethal = ((costmap > costmap_dict["costmap_lethal_threshold"])
                  & ~no_info)
        obstacle = lethal.astype(np.int8)
        if obstacle_map is not None:
            obstacle = obstacle | np.asarray(obstacle_map).astype(np.int8)
        unknown = no_info.astype(np.int8)
        if unknown_map is not None:
            unknown = unknown | np.asarray(unknown_map).astype(np.int8)

        risk = np.full((1, num_rows, num_cols), 100, dtype=np.int8)
        self._finalize(risk, obstacle, unknown, num_rows, num_cols, res)

    def _finalize(self, risk_traction_map, obstacle_map, unknown_map,
                  num_rows, num_cols, res):
        """Pad everything, quantize bin values, and stage to the device."""
        padded_pmf, self.padded_xlimits, self.padded_ylimits = self.set_padding(
            self.pmf_grid, self.max_speed_padding, self.dt, res,
            self.xlimits, self.ylimits)
        self.pmf_grid_device = self._stage(padded_pmf)
        qbins_host = quantize_bin_values(self.bin_values,
                                         self.bin_values_bounds)
        self.qbin_values = self._stage(qbins_host)
        # Host copies of the padded planes for MPPIPlanner._compact_planes.
        self.padded_pmf_host = padded_pmf
        self.qbin_values_host = qbins_host

        if risk_traction_map is not None:
            padded_risk, _, _ = self.set_padding_risk_traction(
                risk_traction_map, self.max_speed_padding, self.dt, res,
                self.xlimits, self.ylimits)
            self.risk_traction_map = padded_risk
            self.risk_traction_map_device = self._stage(padded_risk[0])
        else:
            self.risk_traction_map = None
            self.risk_traction_map_device = torch.zeros(
                tuple(self.pmf_grid_device.shape[1:]), dtype=torch.int8,
                device=self.device)

        self.prepare_obstacle_and_unknown_map(obstacle_map, unknown_map,
                                              num_rows, num_cols, res)
        self.pmf_grid_initialized = True
        self._content_version += 1

    def prepare_obstacle_and_unknown_map(self, obstacle_map, unknown_map,
                                         num_rows, num_cols, res):
        if obstacle_map is not None:
            assert obstacle_map.shape == (num_rows, num_cols), \
                "obstacle_map does not have the same XY dim as pmf grid."
            self.obstacle_map = np.asarray(obstacle_map).astype(np.int8)
        else:
            self.obstacle_map = np.zeros((num_rows, num_cols), dtype=np.int8)

        if unknown_map is not None:
            assert unknown_map.shape == (num_rows, num_cols), \
                "unknown_map does not have the same XY dim as pmf grid."
            self.unknown_map = np.asarray(unknown_map).astype(np.int8)
        else:
            self.unknown_map = np.zeros((num_rows, num_cols), dtype=np.int8)

        padded_obstacle = self.set_padding_2d(self.obstacle_map,
                                              self.max_speed_padding, self.dt, res)
        padded_unknown = self.set_padding_2d(self.unknown_map,
                                             self.max_speed_padding, self.dt, res)
        self.obstacle_map_device = self._stage(padded_obstacle)
        self.unknown_map_device = self._stage(padded_unknown)

    # -- padding ------------------------------------------------------------

    def get_padding_info(self, grid_shape, max_speed_padding, dt, res):
        """Padding ring size + how much of the incoming grid fits in
        ``max_map_dim`` (reference: mppi_numba/terrain.py:562-583)."""
        if len(grid_shape) == 3:
            _, rows, cols = grid_shape
        else:
            rows, cols = grid_shape
        pad_cells = int(np.ceil(max_speed_padding * dt / res))

        max_rows = self.max_map_dim[0] - 2 * pad_cells
        max_cols = self.max_map_dim[1] - 2 * pad_cells
        assert max_rows >= 1 and max_cols >= 1, (
            "While padding the TDM, the max allowed rows {} or cols {} are "
            "below 1 given max_map_dim {}".format(max_rows, max_cols, self.max_map_dim))

        valid_rows = min(max_rows, rows)
        valid_cols = min(max_cols, cols)
        if valid_rows < rows or valid_cols < cols:
            print("WARNING: While padding the TDM, original PMF is cropped "
                  "from ({}, {}) to ({}, {}) to fit within max_map_dim.".format(
                      rows, cols, valid_rows, valid_cols))
        return valid_rows, valid_cols, pad_cells

    def _pad_3d(self, grid, max_speed_padding, dt, res, xlimits, ylimits,
                zero_traction_ring):
        """Shared ring-padding core for (layers, H, W) int8 grids."""
        valid_rows, valid_cols, pad_cells = self.get_padding_info(
            grid.shape, max_speed_padding, dt, res)
        self.pad_cells = pad_cells

        padded_xlimits = np.array([xlimits[0] - pad_cells * res,
                                   xlimits[0] + (valid_cols + pad_cells) * res])
        padded_ylimits = np.array([ylimits[0] - pad_cells * res,
                                   ylimits[0] + (valid_rows + pad_cells) * res])

        padded = np.zeros((grid.shape[0], valid_rows + 2 * pad_cells,
                           valid_cols + 2 * pad_cells), dtype=np.int8)
        if zero_traction_ring:
            padded[0] = np.int8(100)  # all probability mass at zero traction
        padded[:, pad_cells:pad_cells + valid_rows,
               pad_cells:pad_cells + valid_cols] = grid[:, :valid_rows, :valid_cols]
        return padded, padded_xlimits, padded_ylimits

    def set_padding(self, pmf_grid, max_speed_padding, dt, res, xlimits, ylimits):
        """Surround the PMF grid with a zero-traction ring that traps any
        rollout leaving the map (reference: mppi_numba/terrain.py:525-543)."""
        return self._pad_3d(pmf_grid, max_speed_padding, dt, res, xlimits,
                            ylimits, zero_traction_ring=True)

    def set_padding_risk_traction(self, grid, max_speed_padding, dt, res,
                                  xlimits, ylimits):
        """Pad the (1, H, W) risk speed map with a zero ring."""
        return self._pad_3d(grid, max_speed_padding, dt, res, xlimits,
                            ylimits, zero_traction_ring=False)

    def set_padding_2d(self, grid, max_speed_padding, dt, res, pad_val=0):
        valid_rows, valid_cols, pad_cells = self.get_padding_info(
            grid.shape, max_speed_padding, dt, res)
        self.pad_cells = pad_cells
        padded = pad_val * np.ones((valid_rows + 2 * pad_cells,
                                    valid_cols + 2 * pad_cells), dtype=np.int8)
        padded[pad_cells:pad_cells + valid_rows,
               pad_cells:pad_cells + valid_cols] = grid[:valid_rows, :valid_cols]
        return padded

    # -- queries ------------------------------------------------------------

    def get_padded_grid_xy_dim(self):
        if self.pmf_grid_initialized:
            return tuple(self.pmf_grid_device.shape[1:])
        print("Padded grid has not been initialized yet.")
        return None

    def int8_grid_to_float32(self, int8grid):
        """Decode 0..100 int8 map values to traction floats (host numpy)."""
        ratio = np.asarray(int8grid).astype(np.float32) / 100.0
        return ratio * (self.bin_values_bounds[1] - self.bin_values_bounds[0]) \
            + self.bin_values_bounds[0]

    # -- sampling -----------------------------------------------------------

    def sample_grids(self, alpha_dyn=1.0):
        """Sample a batch of traction-map realizations from the PMF: int8
        ``(batch_size, H, W)`` on the device, the solve's map draw (the
        ``map_sample`` kernel on a card) under a key drawn from the TDM's
        own generator.  The planner's solves sample their own batch; this
        is for inspection."""
        assert self.pmf_grid_initialized
        key = draw_map_key(self._generator, self.device)
        pmf, q = self.pmf_grid_device, self.qbin_values
        alpha = torch.tensor(alpha_dyn, dtype=torch.float32,
                             device=self.device)
        self.sample_grid_batch = sample_traction_window(
            key, pmf, None, q, None, alpha, self.batch_size)[2]
        return self.sample_grid_batch

    def sample_grids_true_dist(self, rng=None):
        """Draw ONE ground-truth realization from the underlying terrain
        densities (not the PMF) for closed-loop simulation: a
        ``TractionGrid`` with the TDM's geometry.  The densities draw from
        their own random states; ``rng`` is accepted and unused, as in the
        JAX package."""
        assert self.semantic_grid_initialized
        lins = np.zeros_like(self.semantic_grid, dtype=float)
        angs = np.zeros_like(self.semantic_grid, dtype=float)
        for sid in np.unique(self.semantic_grid):
            mask = self.semantic_grid == sid
            n = int(mask.sum())
            lin_s, ang_s = self.id2terrain_fn(sid).sample_traction(n)
            lins[mask] = lin_s
            angs[mask] = ang_s
        return TractionGrid(lins, angs, res=self.res,
                            xlimits=self.xlimits, ylimits=self.ylimits)


class TractionGrid:
    """A deterministic traction grid: the closed-loop simulator's ground
    truth (host numpy)."""

    def __init__(self, lin_traction, ang_traction, res=1.0, use_int8=False,
                 xlimits=None, ylimits=None):
        if use_int8:
            self.lin_traction = (100 * lin_traction).astype(np.int8)
            self.ang_traction = (100 * ang_traction).astype(np.int8)
        else:
            self.lin_traction = lin_traction
            self.ang_traction = ang_traction
        self.res = res
        self.height, self.width = self.lin_traction.shape
        self.xlimits = (0, self.res * self.width) if xlimits is None else xlimits
        self.ylimits = (0, self.res * self.height) if ylimits is None else ylimits

    def get(self, x, y):
        """Traction at (x, y); zero outside the grid."""
        xi = int((x - self.xlimits[0]) // self.res)
        yi = int((y - self.ylimits[0]) // self.res)
        if xi < 0 or xi >= self.width or yi < 0 or yi >= self.height:
            return 0, 0
        return self.lin_traction[yi, xi], self.ang_traction[yi, xi]

    def get_grids(self):
        return self.lin_traction, self.ang_traction


def unknown_mask_from_confidence(normalized_confidence, conf_thres,
                                 unknown_colors_mask=None):
    """Unknown-cell mask from a terrain detector's confidence scores.

    The reference's confidence-score workflow (reference: README.md:115,
    tdm_models/*/tdm_info.pickle fields ``normalized_confidence`` and
    ``unknown_colors_mask``) marks cells whose detector confidence falls
    below ``conf_thres`` — plus cells with no semantic observation at all —
    as "unknown", which the rollout penalizes via ``unknown_penalty``.

    Returns an int8 ``(H, W)`` mask suitable for
    ``TDM.set_TDM_from_PMF_grid(..., unknown_map=...)``.
    """
    mask = np.asarray(normalized_confidence) < conf_thres
    if unknown_colors_mask is not None:
        mask = mask | (np.asarray(unknown_colors_mask) != 0)
    return mask.astype(np.int8)


def sample_realization_from_pmf_grid(lin_pmf_grid, ang_pmf_grid, bin_values,
                                     rng, res=1.0, xlimits=None,
                                     ylimits=None):
    """Draw ONE ground-truth traction realization from int8 PMF grids: the
    external-PMF path's counterpart of ``TDM.sample_grids_true_dist``.

    Per cell a bin is drawn with probability ``pmf[bin] / 100`` from the
    numpy ``RandomState`` ``rng`` (``randint(1, 101)`` per cell, the first
    bin whose cumulative mass covers it), and the traction is
    ``bin_values[bin]``.  Raises for a cell whose PMF does not sum to 100.
    Returns a ``TractionGrid``.
    """
    bin_values = np.asarray(bin_values, dtype=np.float64)

    def draw(pmf_grid):
        pmf = np.asarray(pmf_grid, dtype=np.int64)
        B, H, W = pmf.shape
        cum = np.cumsum(pmf.reshape(B, -1), axis=0)        # (B, H*W)
        bad = np.flatnonzero(cum[-1] != 100)
        if bad.size:
            raise ValueError(
                "sample_realization_from_pmf_grid: {} cells have PMF sums != "
                "100 (first offender: flat cell {} sums to {})".format(
                    bad.size, int(bad[0]), int(cum[-1, bad[0]])))
        u = rng.randint(1, 101, size=cum.shape[1])          # U{1..100}
        idx = np.argmax(u[None, :] <= cum, axis=0)          # first bin covering u
        return bin_values[idx].reshape(H, W)

    return TractionGrid(draw(lin_pmf_grid), draw(ang_pmf_grid), res=res,
                        xlimits=xlimits, ylimits=ylimits)


# The reference's class name, as the JAX package keeps it.
TDM_Numba = TDM
