"""std::sort-compatible sorting.

The reference's output is sensitive to the tie order of two unstable
``std::sort`` calls (anchor-occurrence sorts: reference
src/solver.cpp:641-663 and src/approximator.cpp:1200-1208 — occurrences
with identical spans carry different colours, and their order decides
colour containment unions). For byte parity we reproduce libstdc++'s
introsort exactly:

  * native path: ``dg_std_sort3`` in dgcore runs the real ``std::sort``
    on a permutation with the same comparator — identical by definition;
  * fallback: a pure-Python emulation of libstdc++'s
    ``__introsort_loop`` / ``__final_insertion_sort`` / heapsort
    (bits/stl_algo.h semantics, threshold 16, depth limit 2·⌊log2 n⌋).

Both paths are cross-checked in tests.
"""

from __future__ import annotations

from typing import Callable, TypeVar

T = TypeVar("T")

_THRESH = 16


def _lg(n: int) -> int:
    return n.bit_length() - 1


def _insertion_sort(a, first, last, less):
    for i in range(first + 1, last):
        if less(a[i], a[first]):
            val = a[i]
            a[first + 1 : i + 1] = a[first:i]
            a[first] = val
        else:
            _unguarded_linear_insert(a, i, less)


def _unguarded_linear_insert(a, last, less):
    val = a[last]
    nxt = last - 1
    while less(val, a[nxt]):
        a[nxt + 1] = a[nxt]
        nxt -= 1
    a[nxt + 1] = val


def _unguarded_insertion_sort(a, first, last, less):
    for i in range(first, last):
        _unguarded_linear_insert(a, i, less)


def _final_insertion_sort(a, first, last, less):
    if last - first > _THRESH:
        _insertion_sort(a, first, first + _THRESH, less)
        _unguarded_insertion_sort(a, first + _THRESH, last, less)
    else:
        _insertion_sort(a, first, last, less)


def _move_median_to_first(a, result, i1, i2, i3, less):
    if less(a[i1], a[i2]):
        if less(a[i2], a[i3]):
            a[result], a[i2] = a[i2], a[result]
        elif less(a[i1], a[i3]):
            a[result], a[i3] = a[i3], a[result]
        else:
            a[result], a[i1] = a[i1], a[result]
    elif less(a[i1], a[i3]):
        a[result], a[i1] = a[i1], a[result]
    elif less(a[i2], a[i3]):
        a[result], a[i3] = a[i3], a[result]
    else:
        a[result], a[i2] = a[i2], a[result]


def _unguarded_partition(a, first, last, pivot, less):
    while True:
        while less(a[first], a[pivot]):
            first += 1
        last -= 1
        while less(a[pivot], a[last]):
            last -= 1
        if not first < last:
            return first
        a[first], a[last] = a[last], a[first]
        first += 1


def _unguarded_partition_pivot(a, first, last, less):
    mid = first + (last - first) // 2
    _move_median_to_first(a, first, first + 1, mid, last - 1, less)
    return _unguarded_partition(a, first + 1, last, first, less)


# -- libstdc++ heap operations (bits/stl_heap.h) --
def _push_heap(a, first, hole, top, value, less):
    parent = (hole - 1) // 2
    while hole > top and less(a[first + parent], value):
        a[first + hole] = a[first + parent]
        hole = parent
        parent = (hole - 1) // 2
    a[first + hole] = value


def _adjust_heap(a, first, hole, length, value, less):
    top = hole
    second = hole
    while second < (length - 1) // 2:
        second = 2 * (second + 1)
        if less(a[first + second], a[first + second - 1]):
            second -= 1
        a[first + hole] = a[first + second]
        hole = second
    if (length & 1) == 0 and second == (length - 2) // 2:
        second = 2 * (second + 1)
        a[first + hole] = a[first + second - 1]
        hole = second - 1
    _push_heap(a, first, hole, top, value, less)


def _make_heap(a, first, last, less):
    length = last - first
    if length < 2:
        return
    parent = (length - 2) // 2
    while True:
        value = a[first + parent]
        _adjust_heap(a, first, parent, length, value, less)
        if parent == 0:
            return
        parent -= 1


def _sort_heap(a, first, last, less):
    while last - first > 1:
        last -= 1
        value = a[last]
        a[last] = a[first]
        _adjust_heap(a, first, 0, last - first, value, less)


def _heap_sort(a, first, last, less):
    _make_heap(a, first, last, less)
    _sort_heap(a, first, last, less)


def _introsort_loop(a, first, last, depth, less):
    while last - first > _THRESH:
        if depth == 0:
            _heap_sort(a, first, last, less)
            return
        depth -= 1
        cut = _unguarded_partition_pivot(a, first, last, less)
        _introsort_loop(a, cut, last, depth, less)
        last = cut


def std_sort(a: list, less: Callable[[T, T], bool]) -> None:
    """In-place libstdc++-compatible std::sort."""
    n = len(a)
    if n < 2:
        return
    _introsort_loop(a, 0, n, 2 * _lg(n), less)
    _final_insertion_sort(a, 0, n, less)


def std_sort_by_keys3(items: list, k1: list[int], k2: list[int], k3: list[int]):
    """Sort `items` like std::sort with lexicographic (k1,k2,k3) comparator.

    Uses the native std::sort permutation oracle when available, else the
    Python emulation. Keys are parallel to `items` (by original index).
    """
    n = len(items)
    if n < 2:
        return items
    try:
        from .. import native

        if native.available():
            import numpy as np

            perm = np.arange(n, dtype=np.int32)
            native.get_lib().dg_std_sort3(
                np.asarray(k1, np.int64), np.asarray(k2, np.int64),
                np.asarray(k3, np.int64), perm, n,
            )
            return [items[p] for p in perm]
    except Exception:
        pass
    idx = list(range(n))
    std_sort(
        idx,
        lambda a, b: (k1[a], k2[a], k3[a]) < (k1[b], k2[b], k3[b]),
    )
    return [items[p] for p in idx]
