"""Streaming VCF ingestion."""

from __future__ import annotations

from typing import IO, Iterator, List, Tuple


def read_vcf_lines(stream: IO[str]) -> Tuple[List[str], Iterator[str]]:
    """Split a VCF stream into (header_lines, body_line_iterator).

    Header lines include the ``#CHROM`` line. Body lines are yielded
    stripped of the trailing newline.
    """
    header: List[str] = []
    first_body: List[str] = []
    for raw in stream:
        line = raw.rstrip("\n")
        if line.startswith("#"):
            header.append(line)
        else:
            if line:
                first_body.append(line)
            break

    def body() -> Iterator[str]:
        yield from first_body
        for raw in stream:
            line = raw.rstrip("\n")
            if line:
                yield line

    return header, body()
