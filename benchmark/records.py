"""The requests a window served, as token arrays.

Each request is a (prompt, served) pair of int32 numpy arrays, held in two
lists. Arrays are not tracked by Python's cyclic collector, so the
harness's record of a long window adds no work to the collections that
run inside it."""

from __future__ import annotations

import numpy as np


class Served:
    def __init__(self) -> None:
        self.prompts: list = []
        self.served: list = []

    def add(self, prompt, served) -> None:
        self.prompts.append(np.asarray(prompt, dtype=np.int32))
        self.served.append(np.asarray(served, dtype=np.int32))

    def extend(self, other: "Served") -> None:
        self.prompts += other.prompts
        self.served += other.served

    def __len__(self) -> int:
        return len(self.prompts)

    def __getitem__(self, i: int) -> tuple:
        return self.prompts[i], self.served[i]

    def __iter__(self):
        return zip(self.prompts, self.served)
