"""Radix / factorization math for the FFT planner.

Counterpart of ``pyfft_tpu/utils/radix.py`` (same functions, same
results).  It is a copy rather than an import because importing any
``pyfft_tpu`` module runs ``pyfft_tpu/__init__.py``, which imports jax;
this package never does.

All functions are pure and run at plan time only.
"""

from __future__ import annotations


def is_power_of_two(n: int) -> bool:
    """True iff ``n`` is a positive power of two."""
    return n > 0 and (n & (n - 1)) == 0


def ilog2(n: int) -> int:
    """Exact integer log2; raises for non-powers-of-two."""
    if not is_power_of_two(n):
        raise ValueError(f"{n} is not a positive power of two")
    return n.bit_length() - 1


def balanced_split(n: int) -> tuple[int, int]:
    """Split power-of-two ``n`` into (n1, n2) with n1*n2 == n, n1 >= n2,
    as close to sqrt(n) as possible (the four-step decomposition's split).
    """
    p = ilog2(n)
    p1 = (p + 1) // 2
    return 1 << p1, 1 << (p - p1)


def radix_decompose(n: int, max_radix: int) -> list[int]:
    """Greedy decomposition of power-of-two ``n`` into radices <= max_radix:
    the largest-first list of power-of-two radices whose product is ``n``,
    with a skewed tail rebalanced (e.g. [8, 4, 4] rather than [8, 8, 1]).
    """
    if not is_power_of_two(max_radix):
        raise ValueError("max_radix must be a power of two")
    p = ilog2(n)
    pr = ilog2(max_radix)
    radices = []
    while p > 0:
        r = min(p, pr)
        radices.append(1 << r)
        p -= r
    if len(radices) >= 2 and radices[-1] * 4 <= radices[-2]:
        total = radices[-1] * radices[-2]
        radices[-2], radices[-1] = balanced_split(total)
    return radices


def fourstep_split(n: int, max_base: int) -> tuple[int, int]:
    """Choose (n1, n2) for one four-step level of an n-point transform:
    the second (contiguous) factor as large as ``max_base`` allows."""
    if n <= max_base:
        raise ValueError(f"n={n} fits the base case (max_base={max_base})")
    n2 = max_base
    n1 = n // n2
    return n1, n2
