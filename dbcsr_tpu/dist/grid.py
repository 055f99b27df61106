"""Process grid: a 2-D jax device mesh.

Analog of ``dbcsr_mp_type`` (``src/core/dbcsr_types.F:108-139``,
methods ``src/mpi/dbcsr_mp_methods.F``): the reference wraps an MPI
cartesian grid with cached row/column subcommunicators; here the grid IS a
``jax.sharding.Mesh`` with axes ('pr', 'pc'), and the "subcommunicators"
are simply collectives over one mesh axis.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from ..core.errors import dbcsr_assert

__all__ = ["ProcessGrid"]

AXIS_ROW = "pr"
AXIS_COL = "pc"
AXIS_LAYER = "layer"


@dataclass(frozen=True)
class ProcessGrid:
    """2-D grid, optionally with a third "layer" axis for 2.5D C-reduction
    (the reference's ``num_layers_3D``, ``src/mm/dbcsr_mm_3d.F``)."""

    mesh: Mesh

    @property
    def nprow(self) -> int:
        return self.mesh.shape[AXIS_ROW]

    @property
    def npcol(self) -> int:
        return self.mesh.shape[AXIS_COL]

    @property
    def nlayer(self) -> int:
        return self.mesh.shape.get(AXIS_LAYER, 1)

    @property
    def size(self) -> int:
        return self.nprow * self.npcol * self.nlayer

    @staticmethod
    def make(
        nprow: int,
        npcol: int,
        nlayer: int = 1,
        devices: Optional[Sequence] = None,
    ) -> "ProcessGrid":
        devs = list(devices) if devices is not None else list(jax.devices())
        need = nprow * npcol * nlayer
        dbcsr_assert(
            need <= len(devs),
            f"grid {nprow}x{npcol}x{nlayer} needs {need} devices, "
            f"have {len(devs)}",
        )
        if nlayer > 1:
            arr = np.array(devs[:need]).reshape(nprow, npcol, nlayer)
            return ProcessGrid(Mesh(arr, (AXIS_ROW, AXIS_COL, AXIS_LAYER)))
        arr = np.array(devs[:need]).reshape(nprow, npcol)
        return ProcessGrid(Mesh(arr, (AXIS_ROW, AXIS_COL)))

    @staticmethod
    def square(devices: Optional[Sequence] = None) -> "ProcessGrid":
        """Largest square grid that fits the available devices."""
        devs = list(devices) if devices is not None else list(jax.devices())
        p = int(np.sqrt(len(devs)))
        return ProcessGrid.make(p, p, devs)

    def transposed(self) -> "ProcessGrid":
        arr = np.swapaxes(np.array(self.mesh.devices), 0, 1)
        return ProcessGrid(Mesh(arr, self.mesh.axis_names))

    def sharding(self, *spec) -> NamedSharding:
        return NamedSharding(self.mesh, PartitionSpec(*spec))
