"""CIGAR parsing and derived alignment features.

The evidence layer (SPEC.md §4) never walks CIGARs at classification time:
every predicate input is precomputed here at decode time into flat per-read
features (reference span, soft-clip lengths, query-order offset, aligned
reference blocks). Replaces per-read ``pysam.AlignedSegment`` attribute
access (reference L0, SURVEY.md §1).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

# op codes, BAM encoding order
M, I, D, N, S, H, P, EQ, X = range(9)
OPS = "MIDNSHP=X"
_OP_CODE = {c: i for i, c in enumerate(OPS)}

CONSUMES_QUERY = (True, True, False, False, True, False, False, True, True)
CONSUMES_REF = (True, False, True, True, False, False, False, True, True)
# "aligned" per SPEC.md §4.1: M/=/X only (D/N consume ref but are not aligned)
IS_ALIGNED = (True, False, False, False, False, False, False, True, True)
IS_CLIP = (False, False, False, False, True, True, False, False, False)


def parse_cigar_string(text: str) -> List[Tuple[int, int]]:
    """``"5S90M5S"`` → ``[(S,5),(M,90),(S,5)]`` (op-code, length) pairs."""
    ops: List[Tuple[int, int]] = []
    if text in ("*", ""):
        return ops
    num = 0
    for ch in text:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            ops.append((_OP_CODE[ch], num))
            num = 0
    return ops


def cigar_string(ops: Sequence[Tuple[int, int]]) -> str:
    return "".join("%d%s" % (ln, OPS[op]) for op, ln in ops) or "*"


class CigarFeatures:
    """Flat features of one alignment's CIGAR at reference position ``pos``."""

    __slots__ = (
        "ref_end",
        "ref_aln_len",
        "left_soft",
        "right_soft",
        "left_clip",
        "right_clip",
        "query_len",
        "blocks",
    )

    def __init__(self, pos: int, ops: Sequence[Tuple[int, int]]) -> None:
        ref_aln = 0
        qlen = 0
        cur = pos
        blocks: List[Tuple[int, int]] = []
        blk_start = -1
        for op, ln in ops:
            if CONSUMES_QUERY[op]:
                qlen += ln
            if IS_ALIGNED[op]:
                ref_aln += ln
                if blk_start < 0:
                    blk_start = cur
                cur += ln
            elif CONSUMES_REF[op]:  # D/N end an aligned block
                if blk_start >= 0:
                    blocks.append((blk_start, cur))
                    blk_start = -1
                cur += ln
        if blk_start >= 0:
            blocks.append((blk_start, cur))
        self.ref_end = cur
        self.ref_aln_len = ref_aln
        self.query_len = qlen
        self.blocks = blocks
        # clips: S counts toward soft; S+H toward query-order offset
        self.left_soft = 0
        self.right_soft = 0
        self.left_clip = 0
        self.right_clip = 0
        for op, ln in ops:
            if not IS_CLIP[op]:
                break
            self.left_clip += ln
            if op == S:
                self.left_soft += ln
        for op, ln in reversed(ops):
            if not IS_CLIP[op]:
                break
            self.right_clip += ln
            if op == S:
                self.right_soft += ln

    def lead_clip_query(self, is_reverse: bool) -> int:
        """Clipped bases preceding the aligned segment in original read
        orientation — the query-offset used to order split pieces
        (SPEC.md §4.2)."""
        return self.right_clip if is_reverse else self.left_clip
