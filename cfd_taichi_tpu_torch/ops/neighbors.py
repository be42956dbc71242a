"""Uniform cell grid, cell ids and the cell-sorted CSR table.

Counterpart of `cfd_taichi_tpu/ops/neighbors.py:39-144` (reference
ParticleSystem.py:99-110, 369-407, 486-494). The JAX package turns the
table into fixed-capacity candidate lists because XLA needs static shapes;
the port keeps only the CSR table. Every pair pass (ops/stencil.py) walks
the 27-cell stencil of a query over `starts`, so there is no capacity and
nothing can overflow.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cfd_taichi_tpu_torch.ops.smoothing import f32


class GridSpec(NamedTuple):
    """Uniform grid: cells per axis, cell edge (= support radius h) and the
    linearization strides id = cx*sx + cy*sy + cz*sz. The axis with the
    fewest cells gets stride 1 (the "fast" axis): a stencil row along it is
    one contiguous run of the CSR table."""
    dims: tuple[int, int, int]
    cell: float
    strides: tuple[int, int, int]

    @property
    def num_cells(self) -> int:
        return self.dims[0] * self.dims[1] * self.dims[2]

    @property
    def axes_by_stride(self) -> tuple[int, int, int]:
        """(fast, mid, slow) axes, by ascending stride."""
        return tuple(int(a) for a in np.argsort(self.strides))


def grid_for_box(box_min, box_max, support_radius: float) -> GridSpec:
    """Grid dims = ceil(extent / h) + 1 per axis (reference ParticleSystem.py:100-101)."""
    ext = np.asarray(box_max, np.float64) - np.asarray(box_min, np.float64)
    dims = tuple(int(d) + 1 for d in np.ceil(ext / support_radius).astype(np.int64))
    order = list(np.argsort(dims))  # ascending cell count
    strides = [0, 0, 0]
    s = 1
    for ax in order:
        strides[ax] = s
        s *= dims[ax]
    return GridSpec(dims=dims, cell=float(support_radius),
                    strides=tuple(strides))


def cell_coords(pos: torch.Tensor, grid: GridSpec) -> torch.Tensor:
    """(N, 3) f32 positions -> (N, 3) int32 cell coordinates,
    floor(pos * f32(1/h)) clamped into the grid's edge cells."""
    inv = f32(1.0 / grid.cell)
    c = torch.floor(pos * inv).to(torch.int32)
    hi = torch.tensor([d - 1 for d in grid.dims], dtype=torch.int32,
                      device=pos.device)
    return torch.minimum(torch.clamp(c, min=0), hi)


def cell_id(pos: torch.Tensor, grid: GridSpec) -> torch.Tensor:
    """Linearized int32 cell id of each (N, 3) position; out-of-domain
    positions clamp into edge cells."""
    c = cell_coords(pos, grid)
    sx, sy, sz = grid.strides
    return c[:, 0] * sx + c[:, 1] * sy + c[:, 2] * sz


def cell_id_np(pos_rows: np.ndarray, grid: GridSpec) -> np.ndarray:
    """Host-numpy `cell_id` for scene build (identical f32 arithmetic)."""
    gx, gy, gz = grid.dims
    sx, sy, sz = grid.strides
    p = np.asarray(pos_rows, np.float32)
    inv = np.float32(1.0 / grid.cell)
    cx = np.clip(np.floor(p[:, 0] * inv).astype(np.int64), 0, gx - 1)
    cy = np.clip(np.floor(p[:, 1] * inv).astype(np.int64), 0, gy - 1)
    cz = np.clip(np.floor(p[:, 2] * inv).astype(np.int64), 0, gz - 1)
    return cx * sx + cy * sy + cz * sz


def csr_starts(sorted_cid: torch.Tensor, num_cells: int) -> torch.Tensor:
    """CSR offsets (num_cells + 1,) int32 of an ascending cell-id array:
    the particles of cell c are [starts[c], starts[c+1])."""
    cells = torch.arange(num_cells + 1, dtype=sorted_cid.dtype,
                         device=sorted_cid.device)
    return torch.searchsorted(sorted_cid, cells, side="left",
                              out_int32=True)


def stencil_counts(starts: torch.Tensor, grid: GridSpec) -> torch.Tensor:
    """(num_cells,) int32, by linear cell id: the sources of the CSR table
    `starts` that lie in the cell's 27-cell stencil, cells beyond the grid
    holding none. 0 says that a query of the cell has no candidate."""
    fast, mid, slow = grid.axes_by_stride
    occ = (starts[1:] - starts[:-1]).reshape(
        grid.dims[slow], grid.dims[mid], grid.dims[fast])
    box = torch.nn.functional.pad(occ, (1, 1, 1, 1, 1, 1))
    # The 3 x 3 x 3 box as three 3-wide sums, one axis at a time (exact in
    # integers): six adds where 27 shifted views took 26.
    for axis in range(3):
        m = box.shape[axis] - 2
        box = (box.narrow(axis, 0, m) + box.narrow(axis, 1, m)
               + box.narrow(axis, 2, m))
    return box.reshape(-1).to(torch.int32)


class CellTable(NamedTuple):
    """Cell-sorted source set: `order` maps sorted slots to input rows."""
    order: torch.Tensor   # (Ns,) int64
    starts: torch.Tensor  # (num_cells + 1,) int32


def build_cell_table(pos: torch.Tensor, grid: GridSpec) -> CellTable:
    """Stable sort of (N, 3) positions by cell id, plus the CSR offsets."""
    scid, order = torch.sort(cell_id(pos, grid), stable=True)
    return CellTable(order=order, starts=csr_starts(scid, grid.num_cells))


def brute_force_neighbors(pos_q: torch.Tensor, pos_src: torch.Tensor,
                          h: float, exclude_self: bool = False):
    """O(Nq*Ns) oracle for tests (cf. `cfd_taichi_tpu/ops/neighbors.py:493`):
    the (Nq, Ns) bool pair mask r2 <= f32(h)^2 and its row counts."""
    d = pos_q[:, None, :] - pos_src[None, :, :]
    r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    hf = np.float32(h)
    mask = r2 <= float(hf * hf)
    if exclude_self:
        mask &= ~torch.eye(pos_q.shape[0], pos_src.shape[0], dtype=torch.bool,
                           device=pos_q.device)
    return mask, mask.sum(dim=1).to(torch.int32)
