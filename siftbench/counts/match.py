"""The least work of K4 (``csrc/match.cu``): every live descriptor of one
set against every live one of the other, 2 * n1 * n2 * 128 operations,
against the TF32 peak (no float32-faithful product on this card runs under
one TF32 pass, so no split of the product can read over 100%); both sets
read once (512 B a row) and the outputs written once (score, ambiguity,
index: 12 B a row of the first set)."""

from siftbench.counts import peaks

DIM = 128


def work(n1: int, n2: int) -> tuple[float, float]:
    """(operations, bytes) of one match of ``n1`` against ``n2`` points."""
    return 2.0 * n1 * n2 * DIM, float((n1 + n2) * DIM * 4 + n1 * 12)


def bound_s(n1: int, n2: int) -> tuple[float, str]:
    ops, nbytes = work(n1, n2)
    return peaks.bound_s(ops, nbytes, "tf32")
