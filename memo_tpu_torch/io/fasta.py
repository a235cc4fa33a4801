"""Host-side FASTA layer.

Replaces the reference's external C binaries (reference index.sh:56-65):

- ``seqtk seq -S``  -> :func:`read_fasta` (records parsed to contiguous bytes)
- ``samtools faidx`` -> :func:`write_fai` / :func:`parse_fai` (identical .fai)
- ``samtools faidx -i`` -> :func:`reverse_complement` (IUPAC-complete, case
  preserving, records renamed ``<name>/rc`` like samtools)
- ``sed '/^>/ !s/$/\\$/g'`` -> the ``'$'`` terminator is appended by the index
  builder when concatenating document text (never materialized to disk).

Sequences are numpy ``uint8`` arrays of ASCII bytes, so they can be handed to
the native matching-statistics library or a device without copies.

The port's own copy of :mod:`memo_tpu.io.fasta`, which stays the reference; the two
read and write the same files.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

# IUPAC nucleotide complement, case preserving; bytes not in the table map to
# themselves (matches samtools' behavior of passing unknowns through).
_COMPLEMENT = np.arange(256, dtype=np.uint8)
for a, b in [
    ("A", "T"), ("C", "G"), ("G", "C"), ("T", "A"), ("U", "A"),
    ("R", "Y"), ("Y", "R"), ("S", "S"), ("W", "W"), ("K", "M"), ("M", "K"),
    ("B", "V"), ("V", "B"), ("D", "H"), ("H", "D"), ("N", "N"),
]:
    _COMPLEMENT[ord(a)] = ord(b)
    _COMPLEMENT[ord(a.lower())] = ord(b.lower())

_UPPER = np.arange(256, dtype=np.uint8)
for c in range(ord("a"), ord("z") + 1):
    _UPPER[c] = c - 32


@dataclass
class FastaRecord:
    """One FASTA record: ``name`` is the header up to the first whitespace
    (the same key samtools uses in .fai), ``seq`` is ASCII bytes."""

    name: str
    seq: np.ndarray  # uint8[length]

    def __len__(self) -> int:
        return int(self.seq.shape[0])

    def upper(self) -> "FastaRecord":
        return FastaRecord(self.name, _UPPER[self.seq])


def read_fasta(path: str | os.PathLike) -> list[FastaRecord]:
    """Parse a FASTA file into records (multi-line sequences are joined)."""
    records: list[FastaRecord] = []
    name: str | None = None
    chunks: list[bytes] = []
    with open(path, "rb") as fh:
        for raw in fh:
            line = raw.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    records.append(_make_record(name, chunks))
                name = line[1:].split(None, 1)[0].decode() if len(line) > 1 else ""
                chunks = []
            elif line:
                if name is None:
                    raise ValueError(f"{path}: sequence data before first header")
                chunks.append(line)
    if name is not None:
        records.append(_make_record(name, chunks))
    if not records:
        raise ValueError(f"{path}: no FASTA records found")
    return records


def _make_record(name: str, chunks: list[bytes]) -> FastaRecord:
    return FastaRecord(name, np.frombuffer(b"".join(chunks), dtype=np.uint8).copy())


def iter_fasta(path: str | os.PathLike) -> Iterator[FastaRecord]:
    yield from read_fasta(path)


def reverse_complement(rec: FastaRecord, suffix: str = "/rc") -> FastaRecord:
    """Reverse complement of a record, renamed like ``samtools faidx -i``
    (reference index.sh:64 appends these to each document)."""
    return FastaRecord(rec.name + suffix, _COMPLEMENT[rec.seq][::-1].copy())


def with_reverse_complements(records: Sequence[FastaRecord]) -> list[FastaRecord]:
    """Documents + their reverse complements, originals first — the exact
    record order the reference builds with seqtk+samtools (index.sh:63-64)."""
    return list(records) + [reverse_complement(r) for r in records]


def fai_entries(path: str | os.PathLike) -> list[tuple[str, int, int, int, int]]:
    """Compute samtools-identical .fai rows (name, length, offset, linebases,
    linewidth) from the FASTA file layout."""
    entries: list[tuple[str, int, int, int, int]] = []
    with open(path, "rb") as fh:
        offset = 0
        name = None
        seq_len = 0
        seq_offset = 0
        linebases = 0
        linewidth = 0
        first_line = True
        for raw in fh:
            if raw.startswith(b">"):
                if name is not None:
                    entries.append((name, seq_len, seq_offset, linebases, linewidth))
                header = raw.rstrip(b"\r\n")
                name = header[1:].split(None, 1)[0].decode() if len(header) > 1 else ""
                offset += len(raw)
                seq_offset = offset
                seq_len = 0
                linebases = 0
                linewidth = 0
                first_line = True
            else:
                stripped = raw.rstrip(b"\r\n")
                if stripped:
                    if first_line:
                        linebases = len(stripped)
                        linewidth = len(raw)
                        first_line = False
                    seq_len += len(stripped)
                offset += len(raw)
        if name is not None:
            entries.append((name, seq_len, seq_offset, linebases, linewidth))
    return entries


def write_fai(fasta_path: str | os.PathLike, fai_path: str | os.PathLike | None = None) -> str:
    """Write ``<fasta>.fai`` (same columns as ``samtools faidx``,
    reference index.sh:56)."""
    fai_path = str(fai_path or (str(fasta_path) + ".fai"))
    rows = fai_entries(fasta_path)
    with open(fai_path, "w") as out:
        for name, length, off, lb, lw in rows:
            out.write(f"{name}\t{length}\t{off}\t{lb}\t{lw}\n")
    return fai_path


def parse_fai(fai_path: str | os.PathLike) -> list[tuple[str, int, int]]:
    """.fai -> cumulative (name, global_start, global_end) intervals over the
    concatenation of records — the coordinate map the reference builds at
    dap_to_bed.py:20-28."""
    intervals: list[tuple[str, int, int]] = []
    csum = 0
    with open(fai_path) as fh:
        for line in fh:
            if not line.strip():
                continue
            name, length = line.split("\t")[:2]
            intervals.append((name, csum, csum + int(length)))
            csum += int(length)
    return intervals


def write_fasta(path: str | os.PathLike, records: Sequence[FastaRecord], width: int = 0) -> None:
    """Write records; ``width=0`` writes single-line sequences (the normalized
    form the reference produces with ``seqtk seq -S``, index.sh:63)."""
    with open(path, "wb") as out:
        for rec in records:
            out.write(b">" + rec.name.encode() + b"\n")
            data = rec.seq.tobytes()
            if width <= 0:
                out.write(data + b"\n")
            else:
                for i in range(0, len(data), width):
                    out.write(data[i : i + width] + b"\n")
