"""Standalone FASTA sterilizer (stdin -> stdout).

Parity with the reference's legacy ``preprocess_moni_fasta.py`` (not called
by the reference pipeline either — index.sh uses seqtk/samtools instead, but
it is part of the reference's public surface): uppercase every record,
optionally reverse (``-r``) and/or complement (``-c``) with the reference's
header suffixes ``_reverse`` / ``_complement`` / ``_reverse_complement``
(preprocess_moni_fasta.py:33-54), output wrapped at 80 columns. No BioPython
dependency (the reference's requirements.txt forgot it; SURVEY §2.3).

Run: ``python -m memo_tpu_torch.io.preprocess [-r] [-c] < in.fa > out.fa``

The port's own copy of :mod:`memo_tpu.io.preprocess`, which stays the reference; the two
read and write the same files.
"""

from __future__ import annotations

import argparse
import sys
import textwrap

_COMP = {"A": "T", "T": "A", "G": "C", "C": "G", "N": "N"}


def complement_seq(seq: str) -> str:
    """Complement of a nucleotide sequence (reference
    preprocess_moni_fasta.py:14-22 — same strict ATGCN alphabet)."""
    return "".join(_COMP[b] for b in seq)


def sterilize(in_stream, out_stream, reverse: bool = False, complement: bool = False) -> None:
    headers: list[str] = []
    seqs: list[str] = []
    cur: list[str] = []
    for line in in_stream:
        line = line.strip()
        if line.startswith(">"):
            if headers:
                seqs.append("".join(cur))
            headers.append(line[1:].split()[0])
            cur = []
        elif line:
            cur.append(line.upper())
    if headers:
        seqs.append("".join(cur))

    for header, seq in zip(headers, seqs):
        if reverse and complement:
            header += "_reverse_complement"
            seq = complement_seq(seq[::-1])
        elif reverse:
            header += "_reverse"
            seq = seq[::-1]
        elif complement:
            header += "_complement"
            seq = complement_seq(seq)
        print(">" + header, file=out_stream)
        print(textwrap.fill(seq, width=80), file=out_stream)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Reads fasta file from stdin. Output sterilized sequence with optional rc."
    )
    ap.add_argument("-c", "--complement", action="store_true", help="complement the sequence")
    ap.add_argument("-r", "--reverse", action="store_true", help="reverse the sequence")
    args = ap.parse_args(argv)
    sterilize(sys.stdin, sys.stdout, reverse=args.reverse, complement=args.complement)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
