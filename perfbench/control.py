"""The control of the check: the reference in the program's place, computed
in float32, the precision below the exact integers and float64 features
that the configurations state.

:func:`control_pass` is a ``wrap`` for :func:`perfbench.harness.run_cell`:
the window then times the program as usual, but hands the check, for each
frame, the reference's table computed once with float32 sums (rounded back
to integers) and float32 features, behind the methods of the program's
``FeatureTable`` that the check reads. The check has to find it not correct.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import reference

__all__ = ["ControlTable", "control_pass"]


class ControlTable:
    """A :class:`~perfbench.reference.RefTable`'s fields, and its features
    computed in ``dtype``, under the names the program's table gives them."""

    def __init__(self, t: reference.RefTable, dtype=np.float32):
        self.__dict__.update(vars(t))
        self.n_labels, self.n_pairs = t.ids.size, t.pair_lo.size
        self._f = reference.features(t, dtype)

    def volume(self):
        return self._f["volume"]

    def barycenter(self):
        return self._f["barycenter"]

    def wall_areas(self):
        return self._f["wall_areas"]

    def inertia_axes(self):
        return self._f["eigenvalues"], self._f["eigenvectors"]

    def l1_labels(self):
        return self._f["l1_labels"].tolist()

    def margin_labels(self):
        return self._f["margin_labels"].tolist()


class _Control:
    def __init__(self, program, raw, device, voxelsize, background: int):
        self.program = program
        self.tables = [ControlTable(reference.reference_table(
            r, voxelsize, background, device, acc=torch.float32)) for r in raw]

    def frame(self, k):
        return self.program.frame(k)

    def voxels(self, k):
        return self.program.voxels(k)

    def __call__(self, k):
        self.program(k)
        return self.tables[self.frame(k)]

    def close(self):
        self.program.close()


def control_pass(config: dict):
    """A ``wrap`` that puts the float32 reference in the program's place."""
    def wrap(program, raw, device):
        return _Control(program, raw, device, config["voxelsize"], int(config["background"]))
    return wrap
