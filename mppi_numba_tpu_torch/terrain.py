"""Terrain layer: the Traction Distribution Map (TDM).

The TDM owns a padded ``(bins, H, W)`` int8 PMF grid whose bins sum to 100
per cell, and pads the perimeter with a zero-traction ring sized
``ceil(max_speed * dt / res)`` cells so that rollouts never index outside
the map.  Host work is numpy, as in ``mppi_numba_tpu.terrain``; only the
staging of the padded planes moves to tensors on the TDM's device.

This slice builds the stochastic (tdm) TDM from an external PMF grid.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.sampling import quantize_bin_values


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


def quantize_pmf_int8(pmf):
    """Quantize a float PMF to int8 percentages whose sum is exactly 100.

    Truncating cast per bin, with the LAST bin absorbing the rounding
    residue (reference: mppi_numba/terrain.py:320-324).
    """
    q = (np.asarray(pmf, dtype=float) * 100).astype(np.int8)
    q[-1] = np.int8(100) - np.sum(q[:-1])
    return q


class TDM:
    """Traction Distribution Map.

    Typical workflow:
      1. Initialize with a shared ``Config`` (and a device).
      2. ``reset()``
      3. ``set_TDM_from_PMF_grid(...)``
      4. Pass to the planner.
      5. Repeat from 2 when the traction map changes.
    """

    def __init__(self, cfg, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.dt = cfg.dt
        self.max_speed_padding = cfg.max_speed_padding
        self.max_map_dim = cfg.max_map_dim
        self.det_dyn = cfg.det_dyn
        # Monotone content token, bumped whenever the staged planes change;
        # MPPIPlanner._compact_planes keys its memo on it.
        self._content_version = 0
        self.reset()

    def reset(self):
        self._content_version += 1
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

    def set_TDM_from_semantic_grid(self, *args, **kwargs):
        raise NotImplementedError(
            "TDM.set_TDM_from_semantic_grid is a later slice of the port")

    def set_TDM_from_costmap(self, *args, **kwargs):
        raise NotImplementedError(
            "TDM.set_TDM_from_costmap is a later slice of the port")

    def set_TDM_from_PMF_grid(self, pmf_grid, tdm_dict, obstacle_map=None,
                              unknown_map=None):
        """Initialize from an external int8 PMF grid (the learned-model path).

        ``pmf_grid`` has shape ``(num_bins, height, width)`` with bins
        summing to 100 per cell; ``tdm_dict`` provides res / xlimits /
        ylimits / bin_values / bin_values_bounds / det_dynamics_cvar_alpha.
        """
        if self.det_dyn:
            raise NotImplementedError(
                "the det_dyn / speed_map / costmap TDMs are a later slice of "
                "the port; this slice builds the stochastic (use_tdm) TDM")
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

        self.pmf_grid = pmf_grid.astype(np.int8)
        self._finalize(None, obstacle_map, unknown_map, num_rows, num_cols,
                       res)

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

