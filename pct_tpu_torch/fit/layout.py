"""The moment layout of the moments route, shared by the moments kernel
(``ops.moments``), its epilogue (``ops.epilogue``) and ``fit.moments``:
all exponent triples (a, b, c) with a+b+c <= 4, graded-lexicographic;
index 0 is (0,0,0) = Σw (the weighted count)."""

MOMENT_EXPS: tuple = tuple(
    (a, b, c)
    for d in range(5)
    for a in range(d, -1, -1)
    for b in range(d - a, -1, -1)
    for c in (d - a - b,)
)
NUM_MOMENTS = len(MOMENT_EXPS)          # 35
_IDX = {e: i for i, e in enumerate(MOMENT_EXPS)}


def moment_index(a: int, b: int, c: int) -> int:
    return _IDX[(a, b, c)]
