"""The pass of a stack already on the device.

Set-up ingests each frame once with the program's
``LabeledStack.from_array`` (host relabel, then the copy to the device) and
keeps the stacks there, as a pipeline that segments on the card would. A
pass is one ``analyze_stack(stack, engine="auto")`` of frame ``k`` mod the
frame count, which returns with its ``FeatureTable`` on the host.
"""

from __future__ import annotations

import numpy as np


class Pass:
    def __init__(self, frames, config: dict, traffic: dict, device, span):
        from tissue_analysis_tpu_torch.core.stack import LabeledStack
        from tissue_analysis_tpu_torch.engine import analyze_stack

        self._analyze = analyze_stack
        voxelsize = tuple(config["voxelsize"])
        self.stacks = []
        for raw in frames:
            with span("ingest"):
                self.stacks.append(LabeledStack.from_array(
                    raw, voxelsize=voxelsize, background=int(config["background"]),
                    device=device))

    def frame(self, k: int) -> int:
        return k % len(self.stacks)

    def voxels(self, k: int) -> int:
        return int(np.prod(self.stacks[self.frame(k)].shape))

    def __call__(self, k: int):
        return self._analyze(self.stacks[self.frame(k)], engine="auto")

    def close(self) -> None:
        self.stacks.clear()


def make(frames, config: dict, traffic: dict, device, span) -> Pass:
    return Pass(frames, config, traffic, device, span)
