"""Position ranges and region trackers.

Reference: blt_util/known_pos_range2.hh, RegionTracker.hh. Host-side
bookkeeping (active regions, call regions, nocompress tracks) — cheap
sequential logic kept off-device by design.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True, order=True)
class PosRange:
    """Half-open [begin, end) reference position range."""
    begin: int
    end: int

    def __len__(self) -> int:
        return max(0, self.end - self.begin)

    def intersects(self, other: "PosRange") -> bool:
        return self.begin < other.end and other.begin < self.end

    def contains_pos(self, pos: int) -> bool:
        return self.begin <= pos < self.end

    def union(self, other: "PosRange") -> "PosRange":
        return PosRange(min(self.begin, other.begin), max(self.end, other.end))


class RegionTracker:
    """Merged interval set with O(log n) queries (RegionTracker.hh)."""

    def __init__(self):
        self._ivs: list[tuple[int, int]] = []  # sorted, disjoint

    def add(self, begin: int, end: int) -> None:
        import bisect
        ivs = self._ivs
        i = bisect.bisect_left(ivs, (begin, -1))
        # merge with predecessor if touching
        if i > 0 and ivs[i - 1][1] >= begin:
            i -= 1
            begin = ivs[i][0]
            end = max(end, ivs[i][1])
        j = i
        while j < len(ivs) and ivs[j][0] <= end:
            end = max(end, ivs[j][1])
            j += 1
        ivs[i:j] = [(begin, end)]

    def is_intersect_region(self, pos: int) -> bool:
        import bisect
        i = bisect.bisect_right(self._ivs, (pos, float("inf")))
        return i > 0 and self._ivs[i - 1][1] > pos

    def is_range_intersect(self, begin: int, end: int) -> bool:
        import bisect
        i = bisect.bisect_left(self._ivs, (begin, -1))
        if i > 0 and self._ivs[i - 1][1] > begin:
            return True
        return i < len(self._ivs) and self._ivs[i][0] < end

    def intervals(self):
        return list(self._ivs)

    def clear(self):
        self._ivs.clear()
