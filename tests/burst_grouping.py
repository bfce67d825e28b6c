"""The burst kernel's grouping (``csrc/fista_burst.cu``, the Grouping part of
its note) restated in Python, and the table of widths that note prints. The
card tests hold the library's exports to both; the CPU tests hold the table
to the rule."""
import re

from fastoptsolver_tpu_torch.kernels import _build

BLOCK_SMEM = 232448  # the shared memory a Hopper block may use
SM_SMEM = 233472  # a Hopper SM's shared memory
BLOCK_RESERVE = 1024  # the shared memory the card reserves a block
SM_THREADS = 1024  # an SM's 65,536 registers at 64 a thread
BARRIER = 16  # the slab read's mbarrier
MAX_N = 104


def lane_floats(n: int) -> int:
    """Shared floats of one lane: y and the trial point, the Gram, two staged
    sums and five results."""
    vec, q = -(-n // 4) * 4, -(-n * n // 4) * 4
    return 2 * vec + q + 2 * n + 5


def threads(n: int) -> int:
    return -(-n // 32) * 32


def block_group(n: int) -> int:
    """Lanes a CTA by a block's limits alone (the group before pairing)."""
    return min((BLOCK_SMEM - BARRIER) // (4 * lane_floats(n)), 1024 // threads(n))


def sm_ctas(n: int, G: int) -> int:
    """CTAs of G lanes one SM holds by its shared memory and registers."""
    per_cta = 4 * lane_floats(n) * G + BARRIER + BLOCK_RESERVE
    return min(SM_SMEM // per_cta, SM_THREADS // (G * threads(n)))


def group(n: int) -> int:
    """Half a block's lanes where they are even and two such CTAs fit an SM."""
    G = block_group(n)
    return G // 2 if G % 2 == 0 and sm_ctas(n, G) < 2 and sm_ctas(n, G // 2) >= 2 else G


def table() -> dict:
    """The note's table: ``{n: (G0, G, CTAs an SM)}`` for every n it covers."""
    rows = {}
    for line in (_build.CSRC / "fista_burst.cu").read_text().splitlines():
        m = re.match(r"//   (n|G0|G|CTAs an SM) {2,}(.*)$", line)
        if m:
            rows[m.group(1)] = m.group(2).split()
    out = {}
    for j, span in enumerate(rows["n"]):
        lo, hi = (int(v) for v in span.split("-"))
        for n in range(lo, hi + 1):
            out[n] = tuple(int(rows[k][j]) for k in ("G0", "G", "CTAs an SM"))
    return out
