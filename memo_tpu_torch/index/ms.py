"""Matching statistics of a pivot genome against each document.

The MONI replacement (reference index.sh:69-76). Semantics: for each pivot
record P and document text T (= the document's records + their reverse
complements, each '$'-terminated, concatenated — exactly the ``.w_rc`` file
the reference builds at index.sh:63-65),

    ms[p] = length of the longest prefix of P[p:] that is a substring of T.

'$' never occurs in the pivot, so matches cannot span document records.

Backends:
- ``native``: C++ generalized suffix automaton over the reversed text
  (memo_tpu_torch/native/libms.cpp), streamed with the reversed pivot.
- ``python``: same algorithm in pure Python (tests / no-toolchain fallback).

The port's own copy of :mod:`memo_tpu.index.ms`, which stays the reference; the two
read and write the same files.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from memo_tpu_torch.io.fasta import FastaRecord, with_reverse_complements

TERMINATOR = b"$"


def document_text(records: Sequence[FastaRecord], add_rc: bool = True) -> bytes:
    """Concatenated '$'-terminated document text (records + reverse
    complements, originals first — reference index.sh:63-65)."""
    recs = with_reverse_complements(records) if add_rc else list(records)
    return b"".join(r.seq.tobytes() + TERMINATOR for r in recs)


class _PySuffixAutomaton:
    """Suffix automaton with dict transitions (pure-Python fallback)."""

    def __init__(self, text: bytes):
        self.len = [0]
        self.link = [-1]
        self.next: list[dict[int, int]] = [{}]
        last = 0
        for b in reversed(text):  # automaton of reversed text
            last = self._extend(b, last)
        self.last = last

    def _extend(self, c: int, last: int) -> int:
        ln, lk, nx = self.len, self.link, self.next
        cur = len(ln)
        ln.append(ln[last] + 1)
        lk.append(-1)
        nx.append({})
        p = last
        while p != -1 and c not in nx[p]:
            nx[p][c] = cur
            p = lk[p]
        if p == -1:
            lk[cur] = 0
        else:
            q = nx[p][c]
            if ln[p] + 1 == ln[q]:
                lk[cur] = q
            else:
                clone = len(ln)
                ln.append(ln[p] + 1)
                lk.append(lk[q])
                nx.append(dict(nx[q]))
                while p != -1 and nx[p].get(c) == q:
                    nx[p][c] = clone
                    p = lk[p]
                lk[q] = clone
                lk[cur] = clone
        return cur

    def matching_statistics(self, pivot: bytes) -> np.ndarray:
        out = np.zeros(len(pivot), np.int32)
        state, l = 0, 0
        ln, lk, nx = self.len, self.link, self.next
        for i in range(len(pivot) - 1, -1, -1):
            c = pivot[i]
            while state != 0 and c not in nx[state]:
                state = lk[state]
                l = ln[state]
            if c in nx[state]:
                state = nx[state][c]
                l += 1
            else:
                state, l = 0, 0
            out[i] = l
        return out


class MatchingStatisticsIndex:
    """Per-document MS index: build once, query any number of pivot records
    (the ``moni build`` / ``moni ms`` split, reference index.sh:69-76)."""

    def __init__(self, text: bytes, backend: str = "auto"):
        self.text = text
        self._native = None
        self._py = None
        if backend in ("auto", "native"):
            from memo_tpu_torch.native.build import load_libms

            lib = load_libms()
            if lib is not None:
                handle = lib.ms_build(text, len(text))
                if handle:
                    self._native = (lib, handle)
                elif backend == "native":
                    raise RuntimeError("libms build failed (alphabet overflow or OOM)")
            elif backend == "native":
                from memo_tpu_torch.native.build import build_error

                raise RuntimeError(f"libms unavailable: {build_error()}")
        if self._native is None:
            if backend == "python" or backend == "auto":
                self._py = _PySuffixAutomaton(text)
            else:
                raise ValueError(f"unknown backend {backend!r}")

    @property
    def backend(self) -> str:
        return "native" if self._native is not None else "python"

    def query(self, pivot: bytes | np.ndarray) -> np.ndarray:
        if isinstance(pivot, np.ndarray):
            pivot = pivot.tobytes()
        if self._native is not None:
            import ctypes

            lib, handle = self._native
            out = np.zeros(len(pivot), np.int32)
            lib.ms_query(
                handle, pivot, len(pivot), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
            )
            return out
        return self._py.matching_statistics(pivot)

    def __del__(self):
        if getattr(self, "_native", None) is not None:
            lib, handle = self._native
            try:
                lib.ms_free(handle)
            except Exception:
                pass
            self._native = None


# --- memory-bounded document MS -------------------------------------------
#
# MS against a multi-record document is the elementwise MAX over its records
# (incl. reverse complements): '$' terminators already prevent matches from
# spanning records, so partitioning the record set into bounded-size groups
# and max-merging per-group MS is semantics-preserving. This is what makes
# chromosome/HPRC-scale documents (reference index.sh handles them via MONI's
# r-index) reachable within a fixed RAM budget. Two engines per group:
#
# - automaton (~64 B/char): fastest for small groups, reusable across pivots.
# - suffix array (ms_sa, ~13 B/char over group+pivot): exact SA-IS + LCP-scan
#   path for big groups/records — a 250 Mbp chromosome (+RC as a separate
#   group) fits in a few GB.

#: Default RAM budget for one MS group build (bytes). Override with
#: MEMO_TPU_MS_BUDGET_BYTES or BuildConfig.ms_budget_bytes / --ms-budget-mb.
DEFAULT_MS_BUDGET_BYTES = 8 << 30

_AUTOMATON_BYTES_PER_CHAR = 64  # ~2 states/char * (2+6) int32 interleaved
_SA_BYTES_PER_CHAR = 9  # SA 4 + string 1 + fused char/type 2 + recursion ~2
_SEPARATOR = b"\x01"  # joins pivot records for the one-pass SA query


def _ms_budget_bytes(budget_bytes: int | None) -> int:
    if budget_bytes is not None:
        return int(budget_bytes)
    import os

    return int(os.environ.get("MEMO_TPU_MS_BUDGET_BYTES", DEFAULT_MS_BUDGET_BYTES))


def partition_units(
    units: Sequence[FastaRecord], group_max_chars: int
) -> list[list[FastaRecord]]:
    """Greedy in-order partition of '$'-terminated units into groups whose
    total text size stays under ``group_max_chars``. A single unit larger
    than the cap gets its own group (the engine will raise if it truly
    cannot fit)."""
    groups: list[list[FastaRecord]] = []
    cur: list[FastaRecord] = []
    cur_chars = 0
    for u in units:
        chars = len(u) + 1
        if cur and cur_chars + chars > group_max_chars:
            groups.append(cur)
            cur, cur_chars = [], 0
        cur.append(u)
        cur_chars += chars
    if cur:
        groups.append(cur)
    return groups


def sa_matching_statistics(
    text: bytes, pivot_records: Sequence[FastaRecord]
) -> list[np.ndarray]:
    """Exact MS of every pivot record against ``text`` in ONE suffix-array
    pass (libms ms_sa): pivot records are joined by 0x01 separators, and each
    record's output is clamped to its remaining length (matches through the
    separators can only overshoot past a record's end, never within it)."""
    import ctypes

    from memo_tpu_torch.native.build import build_error, load_libms

    lib = load_libms()
    if lib is None:
        raise RuntimeError(f"libms unavailable for SA backend: {build_error()}")
    pivot_cat = _SEPARATOR.join(r.seq.tobytes() for r in pivot_records)
    m = len(pivot_cat)
    out = np.zeros(m, np.int32)
    if m and text:
        rc = lib.ms_sa(
            text,
            len(text),
            pivot_cat,
            m,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if rc == -1:
            raise ValueError(
                f"SA group too large for int32 indexing ({len(text) + m} chars); "
                "lower the MS budget so groups shrink"
            )
        if rc == -2:
            raise ValueError(
                "input contains reserved bytes (0x00/0x01, or '$' in the pivot)"
            )
        if rc != 0:
            raise RuntimeError(f"ms_sa failed with code {rc}")
    return _split_record_pieces(out, pivot_records)


def _split_record_pieces(
    row: np.ndarray, records: Sequence[FastaRecord], in_place: bool = False
) -> list[np.ndarray]:
    """Split a concatenated-pivot MS row back into per-record arrays, clamping
    each value to its record's remaining length (matches through the 0x01
    joiners only overshoot past a record's end, never within it).
    ``in_place`` clamps views of ``row`` without copying (caller owns the
    buffer and discards it after folding)."""
    cols: list[np.ndarray] = []
    off = 0
    for r in records:
        piece = row[off : off + len(r)]
        if not in_place:
            piece = piece.copy()
        np.minimum(piece, np.arange(len(r), 0, -1, dtype=np.int32), out=piece)
        cols.append(piece)
        off += len(r) + 1
    return cols


def _rc_start_ms(ms_rc: np.ndarray) -> np.ndarray:
    """Convert start-MS of RC(P) vs text T into start-MS of P vs RC(T).

    Substring-ness commutes with reverse complement: ``x ⊆ RC(T)`` iff
    ``RC(x) ⊆ T`` (the byte complement table is an involution — guarded by
    :func:`_rc_exact` for the one IUPAC exception, U). With m = len(P) and
    ``msR[q]`` = longest prefix of RC(P)[q:] in T, the longest match of P
    ENDING at position e (exclusive) against RC(T) is ``msE[e] = msR[m-e]``.
    The matching-statistics law msR[q+1] >= msR[q]-1 makes
    ``f(e) = e - msE[e]`` nondecreasing, so the start-MS

        out[p] = max{ l : P[p:p+l] ⊆ RC(T) } = max{ e : f(e) <= p } - p

    falls out of one vectorized searchsorted (f(p) <= p guarantees
    out[p] >= 0). This is what lets the SA/GSA paths index the FORWARD text
    only and query P and RC(P) instead — halving text chars, the win
    compounding across documents in colored-GSA groups."""
    m = ms_rc.shape[0]
    from memo_tpu_torch.native.build import load_libms

    lib = load_libms()
    if lib is not None and m:
        # One sequential two-pointer merge in C (libms ms_rc_start): both
        # f's argument and p advance monotonically. The numpy fallbacks
        # (searchsorted, then histogram+cumsum) allocate several m-sized
        # temporaries per color and measurably dominated wide pooled builds.
        import ctypes

        ms_c = np.ascontiguousarray(ms_rc, np.int32)
        out = np.empty(m, np.int32)
        lib.ms_rc_start(
            ms_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            m,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return out
    idx = np.arange(m, dtype=np.int32)  # all values < 2^31: int32 is exact
    f = np.empty(m + 1, np.int32)
    f[0] = 0
    np.subtract(idx + 1, ms_rc[::-1], out=f[1:])  # nondecreasing, in [0, m]
    # max{ e : f(e) <= p } + 1 == #{ e : f(e) <= p } (f nondecreasing), which
    # for every p at once is a counting sort: cumsum of the value histogram.
    e_max = np.cumsum(np.bincount(f, minlength=m + 1)[:m]).astype(np.int32)
    e_max -= 1
    e_max -= idx
    return e_max


def _rc_exact(*byte_arrays) -> bool:
    """True iff the reverse-complement byte table is an involution on every
    byte present — always, except for 'U'/'u' (complement A, whose complement
    is T != U). Inputs containing U fall back to the RC-text layout."""
    for a in byte_arrays:
        arr = np.frombuffer(a, np.uint8) if isinstance(a, (bytes, bytearray)) else a
        if arr.size and (np.any(arr == ord("U")) or np.any(arr == ord("u"))):
            return False
    return True


def sa_matching_statistics_fwd(
    fwd_text: bytes, pivot_records: Sequence[FastaRecord]
) -> list[np.ndarray]:
    """Exact MS of every pivot record against ``fwd_text`` AND its per-unit
    reverse complements, from ONE suffix array over the FORWARD text only:
    the pivot is queried twice (P and RC(P)) and the RC half is converted
    with :func:`_rc_start_ms`. Equivalent to :func:`sa_matching_statistics`
    over text+RC at half the text chars. Caller must ensure
    ``_rc_exact(fwd_text, *pivots)`` (no 'U' bytes)."""
    from memo_tpu_torch.io.fasta import reverse_complement

    both = list(pivot_records) + [reverse_complement(r) for r in pivot_records]
    cols = sa_matching_statistics(fwd_text, both)
    n = len(pivot_records)
    return [np.maximum(cols[i], _rc_start_ms(cols[n + i])) for i in range(n)]


def gsa_matching_statistics(
    units: Sequence[FastaRecord],
    colors: Sequence[int],
    n_colors: int,
    pivot_records: Sequence[FastaRecord],
    scan_threads: int = 1,
) -> list[list[np.ndarray]]:
    """Exact MS of every pivot record against EVERY color in ONE
    generalized-suffix-array pass (libms ms_gsa): the pivot is sorted once
    per group instead of once per document. ``colors[u]`` tags unit u with
    its document. ``scan_threads`` parallelizes the per-color scan pairs in
    the C side (they are independent). Returns ``[n_colors][n_pivot_records]``
    int32 arrays."""
    import ctypes

    from memo_tpu_torch.native.build import build_error, load_libms

    lib = load_libms()
    if lib is None:
        raise RuntimeError(f"libms unavailable for GSA backend: {build_error()}")
    text = document_text(units, add_rc=False)
    ends = np.cumsum([len(u) + 1 for u in units]).astype(np.int64)
    cols = np.asarray(list(colors), np.int32)
    pivot_cat = _SEPARATOR.join(r.seq.tobytes() for r in pivot_records)
    m = len(pivot_cat)
    out = np.zeros((n_colors, m), np.int32)
    if m and text:
        rc = lib.ms_gsa_mt(
            text,
            len(text),
            ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(units),
            cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n_colors,
            pivot_cat,
            m,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            max(int(scan_threads), 1),
        )
        if rc == -1:
            raise ValueError(
                f"GSA group too large for int32 indexing ({len(text) + m} chars); "
                "lower the MS budget so groups shrink"
            )
        if rc == -2:
            raise ValueError(
                "input contains reserved bytes (0x00/0x01, or '$' in the pivot)"
            )
        if rc == -3:
            raise ValueError("bad unit colors (need 0 <= color < n_colors <= 250)")
        if rc != 0:
            raise RuntimeError(f"ms_gsa failed with code {rc}")
    return [_split_record_pieces(out[c], pivot_records) for c in range(n_colors)]


class GsaGroup:
    """Streaming handle over one colored-GSA group (libms gsa_build /
    gsa_scan / gsa_free): the suffix array and per-row color table are built
    ONCE, then :meth:`scan` computes matching statistics for any color range
    into a bounded buffer — a monolithic ``[n_colors, m]`` result is
    gigabytes at HPRC widths, so :func:`pangenome_ms` folds blocks into its
    per-document accumulators as they stream out."""

    def __init__(
        self,
        units: Sequence[FastaRecord],
        colors: Sequence[int],
        n_colors: int,
        pivot_records: Sequence[FastaRecord],
    ):
        import ctypes

        from memo_tpu_torch.native.build import build_error, load_libms

        lib = load_libms()
        if lib is None:
            raise RuntimeError(f"libms unavailable for GSA backend: {build_error()}")
        self._lib = lib
        self.n_colors = int(n_colors)
        text = document_text(units, add_rc=False)
        pivot_cat = _SEPARATOR.join(r.seq.tobytes() for r in pivot_records)
        self.m = len(pivot_cat)
        self._handle = None
        if not (self.m and text):
            return
        ends = np.cumsum([len(u) + 1 for u in units]).astype(np.int64)
        cols = np.asarray(list(colors), np.int32)
        handle = ctypes.c_void_p()
        rc = lib.gsa_build(
            text,
            len(text),
            ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(units),
            cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self.n_colors,
            pivot_cat,
            self.m,
            ctypes.byref(handle),
        )
        if rc == -1:
            raise ValueError(
                f"GSA group too large for int32 indexing ({len(text) + self.m} "
                "chars); lower the MS budget so groups shrink"
            )
        if rc == -2:
            raise ValueError(
                "input contains reserved bytes (0x00/0x01, or '$' in the pivot)"
            )
        if rc == -3:
            raise ValueError("bad unit colors (need 0 <= color < n_colors <= 250)")
        if rc != 0:
            raise RuntimeError(f"gsa_build failed with code {rc}")
        self._handle = handle

    def scan(self, c0: int, c1: int, n_threads: int = 1) -> np.ndarray:
        """int32[c1-c0, m] matching statistics for colors [c0, c1)."""
        import ctypes

        out = np.zeros((c1 - c0, self.m), np.int32)
        if self._handle is not None:
            rc = self._lib.gsa_scan(
                self._handle,
                c0,
                c1,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                max(int(n_threads), 1),
            )
            if rc != 0:
                raise RuntimeError(f"gsa_scan failed with code {rc}")
        return out

    def close(self) -> None:
        if getattr(self, "_handle", None) is not None:
            self._lib.gsa_free(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


#: GSA path peak bytes/char: persistent handle (string 1 + SA 4 + LCP 4 +
#: per-row color 1) plus build-time rank 4 and SA-IS internals (fused
#: char/type 2 + recursion), overlapping peaks ~15.
_GSA_BYTES_PER_CHAR = 15

#: Group-size floor (chars) — see sizing comment in pangenome_ms.
_GSA_GROUP_SWEET_CHARS = 24 << 20


def gsa_group_cap(budget: int, query_chars: int) -> int:
    """Pooled-GSA group-size cap in chars for a query (pivot+RC) of
    ``query_chars``: RAM budget and int32 bounds, then the measured sweet
    spot ``max(4 x query, _GSA_GROUP_SWEET_CHARS)`` unless
    MEMO_TPU_GSA_GROUP_CHARS overrides. ONE definition shared by
    :func:`pangenome_ms` and the builder's pooled/per-doc cost model — the
    r4 advisor found the builder's copy drifted to ``2 x query``, doubling
    its group-count estimate and biasing the auto-pool decision."""
    import os

    group_max = max(
        min(budget // _GSA_BYTES_PER_CHAR - query_chars, (1 << 31) - 16 - query_chars),
        1 << 20,
    )
    env_cap = os.environ.get("MEMO_TPU_GSA_GROUP_CHARS")
    if env_cap:
        return min(group_max, max(int(env_cap), 1 << 20))
    return min(group_max, max(4 * query_chars, _GSA_GROUP_SWEET_CHARS))


def pangenome_ms(
    pivot_records: Sequence[FastaRecord],
    documents: Sequence[Sequence[FastaRecord]],
    budget_bytes: int | None = None,
    jobs: int = 1,
    fwd_only: bool | None = None,
) -> list[list[np.ndarray]]:
    """MS of every pivot record against every document, via RAM-budgeted
    colored generalized-SA groups: all documents' units ('$'-terminated
    records, color = document index) are partitioned in order into groups,
    each group is ONE suffix array shared by every document inside it, and
    per-document results max-merge across groups (exact — matches never span
    '$' units; property-tested against the per-document SA path). Two
    savings multiply vs per-document suffix arrays:

    - the pivot is sorted once per GROUP instead of once per document;
    - ``fwd_only`` (default: auto, on unless any input contains 'U' — see
      :func:`_rc_exact`) indexes only the FORWARD document text and instead
      queries both P and RC(P), converting the RC half with
      :func:`_rc_start_ms` — halving the document chars again.

    Together: ~(2C·D + C·P) SA-IS chars drop to ~(C·D + 2P) per budget
    window — ~2.9x fewer at HPRC-like widths (C≈90, D≈P). Per-color scan
    pairs run on ``jobs`` threads when the partition yields one group.
    Returns ``[n_documents][n_pivot_records]``.

    Source units are materialized in RAM; the budget governs per-group SA
    memory (``jobs`` parallel groups multiply it).
    """
    budget = _ms_budget_bytes(budget_bytes)
    if fwd_only is None:
        fwd_only = _rc_exact(
            *(r.seq for r in pivot_records),
            *(r.seq for doc in documents for r in doc),
        )
    from memo_tpu_torch.io.fasta import reverse_complement

    query_records = list(pivot_records)
    if fwd_only:
        query_records += [reverse_complement(r) for r in pivot_records]
    pivot_chars = sum(len(r) + 1 for r in query_records)
    # Group sizing: bounded by the RAM budget and int32 indexing, and capped
    # at ~4x the query size floored at _GSA_GROUP_SWEET_CHARS (on-host
    # sweeps, tools/bench_pooled_ab.py): SA-IS and Kasai are random-access
    # bound and their per-char cost grows measurably past ~10^8 chars
    # (TLB/cache reach), while below ~4x the query the per-group pivot
    # re-sort (2P chars) stops amortizing — at C=90/5 Mbp the 40M cap
    # measured 6.3 Mbp/s vs 4.4 at 96M and 3.4 at 150M.
    # MEMO_TPU_GSA_GROUP_CHARS overrides for sweeps.
    group_max = gsa_group_cap(budget, pivot_chars)

    tagged: list[tuple[FastaRecord, int]] = []
    for j, doc in enumerate(documents):
        units = list(doc) if fwd_only else with_reverse_complements(doc)
        for u in units:
            tagged.append((u, j))
    total_chars = sum(len(u) + 1 for u, _ in tagged)
    if jobs > 1:
        spread = max((total_chars + jobs - 1) // jobs, pivot_chars, 1 << 20)
        group_max = min(group_max, spread)

    # Greedy in-order unit partition (records of one document may split
    # across groups; max-merge keeps that exact), capped at 250 distinct
    # documents per group (the C side's color-byte limit).
    groups: list[list[tuple[FastaRecord, int]]] = []
    cur: list[tuple[FastaRecord, int]] = []
    cur_chars = 0
    cur_colors: set[int] = set()  # incremental — the partition stays O(units)
    for u, j in tagged:
        chars = len(u) + 1
        if cur and (
            cur_chars + chars > group_max
            or (j not in cur_colors and len(cur_colors) >= 250)
        ):
            groups.append(cur)
            cur, cur_chars, cur_colors = [], 0, set()
        cur.append((u, j))
        cur_chars += chars
        cur_colors.add(j)
    if cur:
        groups.append(cur)

    out = [[np.zeros(len(r), np.int32) for r in pivot_records] for _ in documents]
    n_piv = len(pivot_records)
    scan_threads = jobs if len(groups) == 1 else 1
    import threading

    merge_lock = threading.Lock()  # doc rows can span groups (max-merge)
    # Colors per scan call, capped by scratch memory: each call costs two
    # (m+1) x block int32 scratch planes in the C side plus the [block, m]
    # result — 12*m bytes per color. 16 (= libms kBlk) whenever it fits;
    # chromosome-scale pivots (m ~ 257M at 128 Mbp) drop to small blocks so
    # the planes stay in the MEMO_TPU_GSA_SCRATCH_BYTES budget (default 8G).
    import os as _os

    _scratch = int(_os.environ.get("MEMO_TPU_GSA_SCRATCH_BYTES", 8 << 30))
    _conc = min(max(jobs, 1), len(groups)) or 1  # concurrent groups w/ planes
    # Each of the C side's scan threads allocates its own scratch planes, so
    # the divisor counts groups x threads (ADVICE r4: jobs>1 with one group
    # used to overshoot the budget ~2x).
    GSA_BLOCK = max(
        1, min(16, _scratch // max(12 * pivot_chars * _conc * scan_threads, 1))
    )

    def run_group(group: list[tuple[FastaRecord, int]]):
        docs_here = sorted({j for _, j in group})
        remap = {j: c for c, j in enumerate(docs_here)}
        units = [u for u, _ in group]
        colors = [remap[j] for _, j in group]
        grp = GsaGroup(units, colors, len(docs_here), query_records)
        try:
            # Stream color blocks out of the shared suffix array and fold
            # each one into the per-document accumulators immediately —
            # bounded memory instead of a [n_colors, m] monolith.
            for c0 in range(0, len(docs_here), GSA_BLOCK):
                c1 = min(c0 + GSA_BLOCK, len(docs_here))
                blk = grp.scan(c0, c1, n_threads=scan_threads)
                for bi, c in enumerate(range(c0, c1)):
                    pieces = _split_record_pieces(blk[bi], query_records, in_place=True)
                    if fwd_only:
                        # Fold the RC(P) half back onto P (see _rc_start_ms).
                        cols_c = [
                            np.maximum(pieces[i], _rc_start_ms(pieces[n_piv + i]))
                            for i in range(n_piv)
                        ]
                    else:
                        cols_c = pieces
                    with merge_lock:
                        for acc, col in zip(out[docs_here[c]], cols_c):
                            np.maximum(acc, col, out=acc)
        finally:
            grp.close()

    if jobs > 1 and len(groups) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=jobs) as pool:
            list(pool.map(run_group, groups))
    else:
        for group in groups:
            run_group(group)
    return out


def document_ms(
    pivot_records: Sequence[FastaRecord],
    doc_records: Sequence[FastaRecord],
    backend: str = "auto",
    budget_bytes: int | None = None,
    jobs: int = 1,
) -> list[np.ndarray]:
    """MS of every pivot record against one document (records + RCs), within
    a fixed RAM budget. Returns one int32 array per pivot record.

    backend: "auto" (automaton when the whole document fits the budget, else
    partitioned SA groups), "native"/"python" (automaton, partitioned to the
    budget), or "sa" (suffix-array path, partitioned to the budget).

    jobs > 1 builds groups in parallel threads (libms releases the GIL);
    peak memory is ~jobs * budget — the caller owns that trade.
    """
    budget = _ms_budget_bytes(budget_bytes)
    units = with_reverse_complements(doc_records)
    total_chars = sum(len(u) + 1 for u in units)
    pivot_chars = sum(len(r) + 1 for r in pivot_records)
    automaton_max = max(budget // _AUTOMATON_BYTES_PER_CHAR, 1 << 20)
    sa_max = max(
        min(budget // _SA_BYTES_PER_CHAR - pivot_chars, (1 << 31) - 16 - pivot_chars),
        1 << 20,
    )

    from memo_tpu_torch.native.build import load_libms

    native_ok = load_libms() is not None

    if backend == "auto":
        if native_ok:
            # The SA-IS path is ~2x the automaton's end-to-end build+query
            # throughput at every measured size (and ~7x lighter per char),
            # so it is the default whenever the C++ toolchain is present.
            engine, group_max = "sa", sa_max
        else:
            engine, group_max = "automaton", automaton_max  # python fallback
    elif backend in ("native", "python"):
        engine, group_max = "automaton", automaton_max
    elif backend == "sa":
        engine, group_max = "sa", sa_max
    else:
        raise ValueError(f"unknown MS backend {backend!r}")

    def group_cols(group: list[FastaRecord]) -> list[np.ndarray]:
        group_chars = sum(len(u) + 1 for u in group)
        if engine == "sa" and group_chars > sa_max:
            raise ValueError(
                f"record of {group_chars} chars exceeds the MS budget "
                f"({budget} bytes allows {sa_max}); raise --ms-budget-mb"
            )
        text = document_text(group, add_rc=False)  # RCs are already units
        if engine == "sa":
            return sa_matching_statistics(text, pivot_records)
        auto_backend = backend if backend in ("native", "python") else "auto"
        idx = MatchingStatisticsIndex(text, backend=auto_backend)
        try:
            return [idx.query(piv.seq) for piv in pivot_records]
        finally:
            del idx

    # NOTE on the forward-only layout (sa_matching_statistics_fwd): indexing
    # only the forward units and querying P + RC(P) sorts fewer TOTAL chars
    # (2D + G*P -> D + G'*2P), but A/B runs on this host show SA-IS per-char
    # cost grows superlinearly with input size (cache/TLB) — one 48M-char SA
    # costs ~2x/char what two 32M-char SAs do, erasing the saving (13.1 s vs
    # 8.3 s on a 16 Mbp doc). The classic RC-text split also IS the
    # intra-document parallelism. It therefore stays the per-doc default;
    # the fwd layout serves the colored-GSA pooled path (pangenome_ms).

    if jobs > 1:
        # Spread units over ~jobs groups even when everything fits one group:
        # per-group work is (group_chars + pivot_chars), so J parallel groups
        # beat one serial group whenever group_chars stays >= pivot_chars
        # (the re-queried pivot caps the overhead at ~2x work for ~Jx wall).
        # Groups can't split below a single unit (exactness: matches never
        # span '$'-terminated units, so only whole-unit partitions are exact).
        spread = max((total_chars + jobs - 1) // jobs, pivot_chars, 1 << 20)
        group_max = min(group_max, spread)
    groups = partition_units(units, group_max)
    out = [np.zeros(len(r), np.int32) for r in pivot_records]
    if jobs > 1 and len(groups) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=jobs) as pool:
            for cols in pool.map(group_cols, groups):
                for acc, col in zip(out, cols):
                    np.maximum(acc, col, out=acc)
    else:
        for group in groups:
            for acc, col in zip(out, group_cols(group)):
                np.maximum(acc, col, out=acc)
    return out


def matching_statistics(
    pivot_records: Sequence[FastaRecord],
    documents: Sequence[Sequence[FastaRecord]],
    backend: str = "auto",
    uppercase: bool = True,
    budget_bytes: int | None = None,
) -> list[np.ndarray]:
    """Full DAP: per pivot record r, an int32 array ``[len(r), n_documents]``
    of matching statistics (column j = document j, the reference's dap.txt
    column order, index.sh:83)."""
    pivots = [r.upper() if uppercase else r for r in pivot_records]
    out = [np.zeros((len(r), len(documents)), np.int32) for r in pivots]
    for j, doc in enumerate(documents):
        doc_recs = [r.upper() if uppercase else r for r in doc]
        cols = document_ms(pivots, doc_recs, backend=backend, budget_bytes=budget_bytes)
        for i, col in enumerate(cols):
            out[i][:, j] = col
    return out


def naive_matching_statistics(pivot: bytes, text_records: Sequence[bytes]) -> np.ndarray:
    """O(n*m) oracle used by tests: longest prefix of pivot[p:] occurring in
    any single record (matches cannot span records)."""
    m = len(pivot)
    out = np.zeros(m, np.int32)
    for p in range(m):
        best = 0
        hi = m - p
        for rec in text_records:
            # binary search the longest l such that pivot[p:p+l] in rec
            lo_l, hi_l = best, hi
            while lo_l < hi_l:
                mid = (lo_l + hi_l + 1) // 2
                if pivot[p : p + mid] in rec:
                    lo_l = mid
                else:
                    hi_l = mid - 1
            best = lo_l
        out[p] = best
    return out
