"""Shared-memory wavefronts of the Gram-resident matvec's triangle reads.

    python tools/tri_banks.py --n 96 112 128 168

``csrc/tri_matvec.cuh`` (the resident kernel's and ``gram_power``'s matvec)
reads, for feature i of a lane and term k, the upper-triangle pair
(min(k, i), max(k, i)) at word ``base_r + c`` with ``base_r = r(n-1) -
r(r-1)/2``. A warp holds 32 features of one lane and reads one word each a
term; shared memory serves a warp's read in as many wavefronts as the most
distinct words any one of its 32 four-byte banks holds. For each n this
prints the wavefronts a warp's triangle read costs, averaged over the
lane's warp-terms, and the most any read costs. The triangle's offset in
shared memory shifts every bank alike, so it does not change the count.
"""
from __future__ import annotations

import argparse
from collections import Counter


def pair_word(n: int, k: int, i: int) -> int:
    r, c = min(k, i), max(k, i)
    return r * (n - 1) - r * (r - 1) // 2 + c


def wavefronts(n: int) -> tuple[float, int]:
    """(mean, max) wavefronts of a warp's triangle read at feature count n."""
    total = reads = worst = 0
    for w0 in range(0, n, 32):
        feats = range(w0, min(w0 + 32, n))
        for k in range(n):
            words = {pair_word(n, k, i) for i in feats}
            cost = max(Counter(a % 32 for a in words).values())
            total += cost
            reads += 1
            worst = max(worst, cost)
    return total / reads, worst


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", default=[96, 112, 128, 168])
    for n in ap.parse_args().n:
        mean, worst = wavefronts(n)
        print(f"n={n}: {mean:.2f} wavefronts a warp's triangle read on average, "
              f"at most {worst}")


if __name__ == "__main__":
    main()
