"""Block instance record shared by the LCB engine and the output layer.

Mirrors the observable fields of the reference's BlockInstance
(blocksfinder.h:29-51, blocksfinder.cpp:49-107): signed id encodes strand,
coordinates are half-open [start, end) in + strand space.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Block:
    signed_id: int
    chr: int
    start: int
    end: int

    @property
    def block_id(self) -> int:
        return abs(self.signed_id)

    @property
    def sign(self) -> int:
        return 1 if self.signed_id > 0 else -1

    @property
    def length(self) -> int:
        return self.end - self.start

    def sort_key(self):
        # operator< : (|id|, chr, start)  (blocksfinder.cpp:104-107)
        return (self.block_id, self.chr, self.start)
