"""Device-mesh construction helpers.

The workload's two parallel axes are:

- ``grid``: the output-grid dimension M of C_cross, kriged fields,
  uncertainty diagonals, and simulated states — the tensor-parallel analog
  (every grid column is independent given the shared obs factorisation);
- ``ens``: ensemble members / months — the data-parallel analog.

On one host's GPUs the collectives ride NVLink, all to all, so the mesh
follows the algorithm alone; the reference has no distributed backend
at all (single NumPy process), so this module is new capability
(SURVEY.md §2.3/§5.8).
"""

import numpy as np
import jax
from jax.sharding import Mesh


def make_mesh(
    n_grid: int | None = None,
    n_ens: int | None = None,
    devices=None,
    axis_names: tuple[str, str] = ("grid", "ens"),
) -> Mesh:
    """Build a (grid x ens) mesh over the available devices.

    With no sizes given, all devices go to the grid axis. Sizes must
    multiply to the device count.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n_grid is None and n_ens is None:
        n_grid, n_ens = n, 1
    elif n_grid is None:
        n_grid = n // n_ens
    elif n_ens is None:
        n_ens = n // n_grid
    if n_grid * n_ens != n:
        raise ValueError(
            f"mesh {n_grid}x{n_ens} does not match {n} devices"
        )
    arr = np.asarray(devices).reshape(n_grid, n_ens)
    return Mesh(arr, axis_names)
