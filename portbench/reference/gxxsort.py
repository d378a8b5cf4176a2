"""libstdc++-compatible unstable sort, for the reference's output stage.

SibeliaZ writes its GFF rows after a chain of ``std::sort`` calls whose
comparators look only at a subset of the record fields (the blocks'
copies and ids, then the ids alone).  ``std::sort`` is unstable, so the
order of equal elements, and with it which of a block's overlapping
instances is trimmed first, is the deterministic residue of libstdc++'s
introsort on the input permutation.  This is that algorithm: introsort
with threshold 16, depth limit 2*floor(log2(n)), median-of-3 pivot moved
to front, heapsort fallback, and a final insertion-sort pass, as g++'s
<bits/stl_algo.h> has shipped it for decades.  Elements are sorted in
place; `comp(a, b)` is a strict weak ordering.
"""

from __future__ import annotations

from typing import Callable, List, TypeVar

T = TypeVar("T")

_THRESHOLD = 16


def _lg(n: int) -> int:
    return n.bit_length() - 1


def _insertion_sort(a: List[T], first: int, last: int, comp) -> None:
    if first == last:
        return
    for i in range(first + 1, last):
        if comp(a[i], a[first]):
            val = a[i]
            a[first + 1 : i + 1] = a[first:i]
            a[first] = val
        else:
            # unguarded linear insert
            val = a[i]
            j = i - 1
            while comp(val, a[j]):
                a[j + 1] = a[j]
                j -= 1
            a[j + 1] = val


def _unguarded_insertion_sort(a: List[T], first: int, last: int, comp) -> None:
    for i in range(first, last):
        val = a[i]
        j = i - 1
        while comp(val, a[j]):
            a[j + 1] = a[j]
            j -= 1
        a[j + 1] = val


def _move_median_to_first(a: List[T], result: int, x: int, y: int, z: int, comp) -> None:
    if comp(a[x], a[y]):
        if comp(a[y], a[z]):
            a[result], a[y] = a[y], a[result]
        elif comp(a[x], a[z]):
            a[result], a[z] = a[z], a[result]
        else:
            a[result], a[x] = a[x], a[result]
    elif comp(a[x], a[z]):
        a[result], a[x] = a[x], a[result]
    elif comp(a[y], a[z]):
        a[result], a[z] = a[z], a[result]
    else:
        a[result], a[y] = a[y], a[result]


def _unguarded_partition(a: List[T], first: int, last: int, pivot: int, comp) -> int:
    while True:
        while comp(a[first], a[pivot]):
            first += 1
        last -= 1
        while comp(a[pivot], a[last]):
            last -= 1
        if not first < last:
            return first
        a[first], a[last] = a[last], a[first]
        first += 1


def _partition_pivot(a: List[T], first: int, last: int, comp) -> int:
    mid = first + (last - first) // 2
    _move_median_to_first(a, first, first + 1, mid, last - 1, comp)
    return _unguarded_partition(a, first + 1, last, first, comp)


def _adjust_heap(a: List[T], first: int, hole: int, length: int, value: T, comp) -> None:
    top = hole
    second = hole
    while second < (length - 1) // 2:
        second = 2 * (second + 1)
        if comp(a[first + second], a[first + second - 1]):
            second -= 1
        a[first + hole] = a[first + second]
        hole = second
    if length & 1 == 0 and second == (length - 2) // 2:
        second = 2 * (second + 1)
        a[first + hole] = a[first + second - 1]
        hole = second - 1
    # push_heap
    parent = (hole - 1) // 2
    while hole > top and comp(a[first + parent], value):
        a[first + hole] = a[first + parent]
        hole = parent
        parent = (hole - 1) // 2
    a[first + hole] = value


def _make_heap(a: List[T], first: int, last: int, comp) -> None:
    length = last - first
    if length < 2:
        return
    parent = (length - 2) // 2
    while True:
        value = a[first + parent]
        _adjust_heap(a, first, parent, length, value, comp)
        if parent == 0:
            return
        parent -= 1


def _sort_heap(a: List[T], first: int, last: int, comp) -> None:
    while last - first > 1:
        last -= 1
        value = a[last]
        a[last] = a[first]
        _adjust_heap(a, first, 0, last - first, value, comp)


def _heap_select_sort(a: List[T], first: int, last: int, comp) -> None:
    # std::partial_sort(first, last, last): heap-select then sort the heap.
    _make_heap(a, first, last, comp)
    _sort_heap(a, first, last, comp)


def _introsort_loop(a: List[T], first: int, last: int, depth_limit: int, comp) -> None:
    while last - first > _THRESHOLD:
        if depth_limit == 0:
            _heap_select_sort(a, first, last, comp)
            return
        depth_limit -= 1
        cut = _partition_pivot(a, first, last, comp)
        _introsort_loop(a, cut, last, depth_limit, comp)
        last = cut


def gxx_sort(a: List[T], comp: Callable[[T, T], bool]) -> None:
    """Sort the list in place exactly as g++'s std::sort(comp) would."""
    n = len(a)
    if n == 0:
        return
    _introsort_loop(a, 0, n, _lg(n) * 2, comp)
    # final insertion sort
    if n > _THRESHOLD:
        _insertion_sort(a, 0, _THRESHOLD, comp)
        _unguarded_insertion_sort(a, _THRESHOLD, n, comp)
    else:
        _insertion_sort(a, 0, n, comp)
