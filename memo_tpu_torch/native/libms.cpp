// libms — matching statistics engine for memo_tpu_torch.
//
// Replaces the external MONI dependency of the reference pipeline
// (reference index.sh:69-76: `moni build` + `moni ms`): for each document
// (genome + reverse complements, '$'-terminated records) we need, at every
// pivot position p, the length of the longest prefix of pivot[p:] occurring
// anywhere in the document text.
//
// Design: a generalized suffix automaton built over the REVERSED document
// text. Matching statistics computed by streaming a string through a suffix
// automaton are "longest match ENDING at i"; substring-ness is invariant
// under reversal, so streaming the reversed pivot through the automaton of
// the reversed text and flipping the result yields "longest match STARTING
// at p" — exactly MONI's .lengths semantics. Record terminators ('$', absent
// from the pivot alphabet) prevent matches from spanning records, matching
// the reference's per-record '$' append (index.sh:65).
//
// Complexity: O(|text| * alpha) build, O(|pivot|) amortized per query.
// Memory: ~2 states/char * (8 + 4*alpha) bytes, alpha = the text's exact
// alphabet size (6 for ACGTN$ genomes). This trades memory for
// speed vs MONI's r-index; suitable up to ~hundreds of Mbp of document text
// per build on a large-RAM host. Builds are per-document and embarrassingly
// parallel across documents.
//
// C ABI only (consumed via ctypes from memo_tpu_torch.index.ms) — no pybind11.

#include <algorithm>
#include <cstdint>
#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#endif
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <new>
#include <thread>
#include <vector>
#ifdef __linux__
#include <sys/mman.h>
#endif

namespace {

// Ask the kernel for 2 MB pages on a large allocation (Linux THP is
// usually "madvise"-mode). The suffix-array passes are random accesses over
// hundreds of MB; on 4 KB pages they are TLB-walk bound — SA-IS measured
// 12.1 -> 7.4 Mchar/s going 15M -> 210M chars purely from working-set
// growth. The hint must land BEFORE first touch to take effect eagerly.
inline bool huge_enabled() {
#ifdef __linux__
  // Default ON (~15% on 100M+-char builds, measured best-of-2 at 105M:
  // 7.7 -> 8.8 Mchar/s); MEMO_TPU_HUGEPAGES=0 opts out.
  static const bool on = [] {
    const char* e = getenv("MEMO_TPU_HUGEPAGES");
    return !(e && e[0] == '0');
  }();
  return on;
#else
  return false;
#endif
}

inline void hint_huge(void* p, size_t bytes) {
#ifdef __linux__
  if (!huge_enabled()) return;
  uintptr_t a = (reinterpret_cast<uintptr_t>(p) + 4095) & ~uintptr_t(4095);
  uintptr_t end = reinterpret_cast<uintptr_t>(p) + bytes;
  if (end > a + (2u << 20))
    madvise(reinterpret_cast<void*>(a), end - a, MADV_HUGEPAGE);
#endif
}

// Minimal owning buffer: 64 B aligned, huge-page hinted, NOT initialized —
// std::vector would zero a multi-hundred-MB buffer (a full write pass) and
// touch every 4 KB page before any huge-page hint could apply.
template <typename T>
struct HugeBuf {
  T* p = nullptr;
  size_t n = 0;
  HugeBuf() = default;
  explicit HugeBuf(size_t count) { alloc(count); }
  HugeBuf(const HugeBuf&) = delete;
  HugeBuf& operator=(const HugeBuf&) = delete;
  void alloc(size_t count, bool huge = true) {
    release();
    n = count;
    p = static_cast<T*>(
        ::operator new(count * sizeof(T), std::align_val_t(64)));
    if (huge) hint_huge(p, count * sizeof(T));
  }
  void release() {
    if (p) ::operator delete(p, std::align_val_t(64));
    p = nullptr;
    n = 0;
  }
  ~HugeBuf() { release(); }
  T* data() { return p; }
  const T* data() const { return p; }
  T& operator[](size_t i) { return p[i]; }
  const T& operator[](size_t i) const { return p[i]; }
  size_t size() const { return n; }
};

// One state = (2 + acap) contiguous int32s: [len, link, next[0..acap)].
// The build's suffix-link walks and the query's failure-link walks touch
// len+link+transitions of one state per step; interleaving puts all of them
// in one cache line for DNA alphabets (stride 7 * 4B = 28B), ~2-3x faster
// than parallel len[]/link[]/next[] arrays on large (cache-cold) automata.
struct Automaton {
  // Huge-page arena sized ONCE: a suffix automaton over n chars has
  // < 2n + 4 states (clones included), so there is never a grow path. The
  // build is pure pointer chasing (suffix-link walks) over this arena —
  // the same TLB argument that huge-pages the SA buffers applies, and the
  // old std::vector version additionally paid a resize call per state
  // (r5: ms_build 2 Mbp doc measured ~1.4x faster uncontended with the
  // prefilled arena).
  HugeBuf<int32_t> st;
  int stride;  // 2 + acap
  int16_t code[256];
  int acap;  // transition count per state = exact alphabet size of this text
  int alpha = 0;
  int32_t last = 0;
  int32_t count = 0;
  bool overflow = false;  // alphabet-cap or state-id overflow
  int32_t max_states = INT32_MAX - 2;  // state ids are int32; guard the wrap

  Automaton(int alphabet_cap, int64_t capacity_states)
      : stride(2 + alphabet_cap), acap(alphabet_cap) {
    if (capacity_states > INT32_MAX - 2) capacity_states = INT32_MAX - 2;
    max_states = static_cast<int32_t>(capacity_states);
    st.alloc(static_cast<size_t>(capacity_states) * stride, /*huge=*/false);
    for (int i = 0; i < 256; ++i) code[i] = -1;
    new_state();  // init state 0
    S(0)[0] = 0;
    S(0)[1] = -1;
  }

  int32_t n_states() const { return count; }

  int32_t* S(int32_t s) { return st.data() + static_cast<size_t>(s) * stride; }
  const int32_t* S(int32_t s) const { return st.data() + static_cast<size_t>(s) * stride; }

  int32_t new_state() {
    if (count >= max_states) {  // arena/test cap or int32 id wrap; caller
      overflow = true;          // must partition the document (index/ms.py)
      return 0;
    }
    // States initialize lazily (one 28-56 B memset) so pages fault in build
    // order — an eager whole-arena prefill measured 2x run-to-run variance
    // from THP compaction stalls on this host.
    std::memset(S(count), 0xff, stride * sizeof(int32_t));
    return count++;
  }

  int32_t len_of(int32_t s) const { return S(s)[0]; }
  int32_t link_of(int32_t s) const { return S(s)[1]; }
  int32_t tr(int32_t s, int c) const { return S(s)[2 + c]; }
  void set_tr(int32_t s, int c, int32_t v) { S(s)[2 + c] = v; }

  int code_of(uint8_t b, bool create) {
    int c = code[b];
    if (c < 0 && create) {
      if (alpha >= acap) {
        overflow = true;
        return -1;
      }
      c = alpha++;
      code[b] = static_cast<int16_t>(c);
    }
    return c;
  }

  void extend(uint8_t b) {
    int c = code_of(b, /*create=*/true);
    if (c < 0) return;  // overflow flagged; caller checks
    int32_t cur = new_state();
    if (overflow) return;
    S(cur)[0] = len_of(last) + 1;
    int32_t p = last;
    while (p != -1 && tr(p, c) == -1) {
      set_tr(p, c, cur);
      p = link_of(p);
    }
    if (p == -1) {
      S(cur)[1] = 0;
    } else {
      int32_t q = tr(p, c);
      if (len_of(p) + 1 == len_of(q)) {
        S(cur)[1] = q;
      } else {
        int32_t clone = new_state();
        if (overflow) return;
        std::memcpy(S(clone), S(q), stride * sizeof(int32_t));
        S(clone)[0] = len_of(p) + 1;
        while (p != -1 && tr(p, c) == q) {
          set_tr(p, c, clone);
          p = link_of(p);
        }
        S(q)[1] = clone;
        S(cur)[1] = clone;
      }
    }
    last = cur;
  }
};

// ---------------------------------------------------------------------------
// SA-IS suffix array construction (Nong/Zhang/Chan induced sorting) and
// LCP-scan matching statistics.
//
// The automaton above needs ~64 B per text char; a chromosome-scale record
// (250 Mbp + RC) would need ~32 GB. This path computes the same MS exactly
// via one suffix array over text ++ 0x01 ++ pivot ++ 0x00 at ~13 B/char
// (SA 4 + rank 4 + LCP 4 + string 1), so whole-chromosome documents fit a
// modest RAM budget. ms[p] = max over text suffixes t of lcp(pivot[p:], t),
// which is the min-LCP to the nearest text suffix above/below the pivot
// suffix in SA order — two linear scans. Separator bytes (0x01/0x00) occur
// nowhere in genomic input (caller-guarded), so matches cannot cross record
// terminators; any overshoot through the single text/pivot separator is
// clipped by the caller's per-record length clamp (index/ms.py).
// ---------------------------------------------------------------------------

template <typename CharT>
static void sais_impl(const CharT* s, int32_t* SA, int32_t n, int32_t K) {
  // n includes a trailing sentinel s[n-1] that is the unique minimum.
  if (n == 1) {
    SA[0] = 0;
    return;
  }
  HugeBuf<uint8_t> t(n);  // 1 = S-type (fully written below)
  t[n - 1] = 1;
  for (int32_t i = n - 2; i >= 0; --i)
    t[i] = (s[i] < s[i + 1] || (s[i] == s[i + 1] && t[i + 1])) ? 1 : 0;
  auto is_lms = [&](int32_t i) { return i > 0 && t[i] && !t[i - 1]; };

  // Fused (char, type) array: the induce passes make ONE dependent random
  // load per step instead of two (s[j] and t[j]) — worth ~20% end to end.
  // uint16 covers uint8 texts; uint32 covers recursion names (< 2^30).
  // Bucket counts are computed once per level, not re-scanned per pass.
  using CT = std::conditional_t<sizeof(CharT) == 1, uint16_t, uint32_t>;
  HugeBuf<CT> ct(n);
  for (int32_t i = 0; i < n; ++i)
    ct[i] = (static_cast<CT>(s[i]) << 1) | t[i];
  std::vector<int32_t> cnt(K, 0), bkt(K);
  for (int32_t i = 0; i < n; ++i) cnt[s[i]]++;
  auto get_buckets = [&](bool end) {
    int32_t sum = 0;
    for (int32_t c = 0; c < K; ++c) {
      sum += cnt[c];
      bkt[c] = end ? sum : sum - cnt[c];
    }
  };
  // The induced-sort passes are bound on dependent random loads
  // (SA[i] -> ct[j]); prefetching a few iterations ahead hides most of
  // the miss latency on large (cache-cold) texts. (A second prefetch stage
  // for the bucket-store side was measured ~13% SLOWER — the extra ct loads
  // cost more than the store prefetch saves on this core.)
  constexpr int32_t PF = 32;
  auto induce = [&]() {
    get_buckets(false);  // induce L-types left to right
    for (int32_t i = 0; i < n; ++i) {
      if (i + PF < n && SA[i + PF] > 0) __builtin_prefetch(&ct[SA[i + PF] - 1]);
      int32_t j = SA[i] - 1;
      if (SA[i] > 0) {
        CT c = ct[j];
        if (!(c & 1)) SA[bkt[c >> 1]++] = j;
      }
    }
    get_buckets(true);  // induce S-types right to left
    for (int32_t i = n - 1; i >= 0; --i) {
      if (i - PF >= 0 && SA[i - PF] > 0) __builtin_prefetch(&ct[SA[i - PF] - 1]);
      int32_t j = SA[i] - 1;
      if (SA[i] > 0) {
        CT c = ct[j];
        if (c & 1) SA[--bkt[c >> 1]] = j;
      }
    }
  };

  // Stage 1: bucket-sort LMS positions, induce a full (LMS-substring) order.
  std::fill(SA, SA + n, -1);
  get_buckets(true);
  for (int32_t i = 1; i < n; ++i)
    if (is_lms(i)) SA[--bkt[s[i]]] = i;
  induce();

  // Stage 2: compact the now-sorted LMS positions and name their substrings.
  int32_t n1 = 0;
  for (int32_t i = 0; i < n; ++i)
    if (is_lms(SA[i])) SA[n1++] = SA[i];
  std::fill(SA + n1, SA + n, -1);
  int32_t name = 0, prev = -1;
  for (int32_t i = 0; i < n1; ++i) {
    int32_t pos = SA[i];
    bool diff = false;
    if (prev < 0) {
      diff = true;
    } else {
      // Compare via the fused (char, type) array: one load per side per
      // step instead of s[]+t[], with LMS-ness derived from the previous
      // step's fused values (is_lms(i) == S-type(i) && L-type(i-1)).
      CT a = ct[pos], b = ct[prev];
      if (a != b) {
        diff = true;
      } else {
        for (int32_t d = 1;; ++d) {
          CT a2 = ct[pos + d], b2 = ct[prev + d];
          bool lp = (a2 & 1) && !(a & 1);
          bool lq = (b2 & 1) && !(b & 1);
          if (lp && lq) break;  // both substrings ended together: equal
          if (lp != lq || a2 != b2) {
            diff = true;
            break;
          }
          a = a2;
          b = b2;
        }
      }
    }
    if (diff) {
      ++name;
      prev = pos;
    }
    SA[n1 + pos / 2] = name - 1;  // LMS positions are >= 2 apart: pos/2 unique
  }
  int32_t* s1 = SA + n - n1;
  for (int32_t i = n - 1, j = n - 1; i >= n1; --i)
    if (SA[i] >= 0) SA[j--] = SA[i];

  // Stage 3: order the LMS suffixes (recurse iff names repeat), re-induce.
  if (name < n1) {
    sais_impl<int32_t>(s1, SA, n1, name);
  } else {
    for (int32_t i = 0; i < n1; ++i) SA[s1[i]] = i;
  }
  for (int32_t i = 1, j = 0; i < n; ++i)
    if (is_lms(i)) s1[j++] = i;  // LMS positions in text order
  for (int32_t i = 0; i < n1; ++i) SA[i] = s1[SA[i]];
  std::fill(SA + n1, SA + n, -1);
  get_buckets(true);
  for (int32_t i = n1 - 1; i >= 0; --i) {
    int32_t j = SA[i];
    SA[i] = -1;
    SA[--bkt[s[j]]] = j;
  }
  induce();
}

}  // namespace

extern "C" {

// Suffix array of s[0..n) (no sentinel required; one is appended internally).
// Test/debug surface for the SA-IS core. Returns 0, or -1 if n is too large.
int32_t sais_u8(const uint8_t* s, int64_t n, int32_t* sa_out) {
  if (n + 1 > INT32_MAX - 1) return -1;
  HugeBuf<uint8_t> buf(static_cast<size_t>(n) + 1);
  std::memcpy(buf.data(), s, static_cast<size_t>(n));
  buf[n] = 0;  // unique minimum sentinel (caller guarantees no 0x00 in s)
  HugeBuf<int32_t> sa(static_cast<size_t>(n) + 1);
  sais_impl<uint8_t>(buf.data(), sa.data(), static_cast<int32_t>(n + 1), 256);
  std::memcpy(sa_out, sa.data() + 1, static_cast<size_t>(n) * sizeof(int32_t));
  return 0;
}

// Matching statistics of `pivot` (records joined by 0x01) against `text`
// (records + RCs, '$'-terminated) via one SA-IS pass over
// text ++ 0x01 ++ pivot ++ 0x00. out[i] = longest prefix of pivot[i:]
// occurring in text; separator slots of `pivot` get arbitrary values the
// caller discards. Caller must clamp out[i] to its pivot record's remaining
// length (matches through the joining separators overshoot past record ends,
// never within them). Inputs must not contain bytes 0x00/0x01.
// Returns 0, -1 if combined length exceeds int32 indexing, -2 on bad bytes.
int64_t ms_sa(const uint8_t* text, int64_t n, const uint8_t* pivot, int64_t m,
              int32_t* out) {
  const int64_t N = n + m + 2;  // + separator + sentinel
  if (N > INT32_MAX - 1) return -1;
  HugeBuf<uint8_t> S(static_cast<size_t>(N));
  std::memcpy(S.data(), text, static_cast<size_t>(n));
  S[n] = 0x01;
  std::memcpy(S.data() + n + 1, pivot, static_cast<size_t>(m));
  S[N - 1] = 0x00;
  // Text must be clean of both control bytes; the pivot may contain 0x01
  // (its own record separators — matches crossing them only overshoot past
  // record ends, which the caller clamps) but never 0x00, and never '$'
  // (0x24): a literal '$' in the pivot would let LCP extension run through
  // the text's unit terminators, silently inflating MS — '$'-freedom is the
  // exactness precondition the per-record clamp relies on.
  for (int64_t i = 0; i < n; ++i)
    if (S[i] <= 0x01) return -2;
  for (int64_t i = n + 1; i < N - 1; ++i)
    if (S[i] == 0x00 || S[i] == 0x24) return -2;

  HugeBuf<int32_t> SA(static_cast<size_t>(N));
  sais_impl<uint8_t>(S.data(), SA.data(), static_cast<int32_t>(N), 256);

  // For each pivot suffix p, ms relative to the text is
  //   max(lcp(p, nearest text suffix above in SA order),
  //       lcp(p, nearest text suffix below)) —
  // nearest suffices because range-min LCP only shrinks with distance.
  // Each direction: one sequential SA pass records the neighbor text
  // position, then a text-order pass computes the lcp with PLCP-style
  // amortization — lcp(p+1, nearest(p+1)) >= lcp(p, nearest(p)) - 1, since
  // dropping the first matched char of (p, u) yields the text suffix u+1
  // still above/below p+1. This replaces Kasai + rank + full LCP (8 B/char
  // and the dominant cache-miss cost) with one int32[m] neighbor array.
  HugeBuf<int32_t> nbr(static_cast<size_t>(m));
  auto scan = [&](bool above) {
    std::fill(nbr.data(), nbr.data() + nbr.size(), -1);
    int64_t last_text = -1;
    const int64_t step = above ? 1 : -1;
    for (int64_t r = above ? 0 : N - 1; r >= 0 && r < N; r += step) {
      int64_t p = SA[r];
      if (p < n) {
        last_text = p;  // genuine text suffix (p == n is the separator)
      } else if (p > n && p < N - 1) {
        nbr[p - n - 1] = static_cast<int32_t>(last_text);
      }
    }
    int64_t h = 0;
    for (int64_t i = 0; i < m; ++i) {
      if (i + 8 < m && nbr[i + 8] >= 0) __builtin_prefetch(&S[nbr[i + 8]]);
      int64_t u = nbr[i];
      if (u < 0) {
        h = 0;
        continue;
      }
      int64_t p = n + 1 + i;
      while (S[p + h] == S[u + h]) ++h;  // 0x00 sentinel is unique: terminates
      if (h > out[i]) out[i] = static_cast<int32_t>(h);
      // Carry h-1 to the next position: valid because u+1 is still a text
      // suffix on the same side of p+1. When u is the LAST text suffix its
      // successor is the separator, so the carry does not hold — reset.
      if (u == n - 1) h = 0;
      else if (h) --h;
    }
  };
  for (int64_t i = 0; i < m; ++i) out[i] = 0;
  scan(true);
  scan(false);
  return 0;
}

// Colored (generalized-SA) matching statistics: MS of `pivot` against EVERY
// document of a group from ONE suffix array over
// all_units ++ 0x01 ++ pivot ++ 0x00 — instead of one SA per document that
// re-sorts the pivot each time. `unit_ends` are cumulative end offsets of the
// '$'-terminated units inside `text`; `unit_color[u]` maps unit u to its
// document (0..n_colors-1; a document's records and RCs share its color).
//
// Per color, ms is the max lcp to the nearest same-color text suffix
// above/below in SA order (nearest suffices: range-min LCP shrinks with
// distance, and suffixes of other colors between them don't affect the min
// to the NEAREST same-color one — lcp(p, u) depends on p and u alone). A
// per-SA-row color table (built once, prefetched) makes the scans purely
// sequential; the PLCP carry argument of ms_sa holds per color unchanged —
// h > 0 implies S[u] is not a terminator, so u+1 is in the same unit and
// keeps the color.
//
// The API is split build/scan/free so the caller streams color BLOCKS with
// bounded memory (a monolithic [n_colors, m] result is gigabytes at HPRC
// widths): gsa_build sorts once, gsa_scan computes any color range into a
// caller buffer, the Python side folds each block into its per-document
// accumulators immediately (memo_tpu_torch.index.ms.pangenome_ms).

namespace {

struct GsaHandle {
  HugeBuf<uint8_t> S;        // text ++ 0x01 ++ pivot ++ 0x00
  HugeBuf<int32_t> SA;       // suffix array of S
  HugeBuf<int32_t> LCP;      // LCP[r] = lcp(S[SA[r-1]:], S[SA[r]:]), LCP[0]=0
  HugeBuf<uint8_t> col_of_row;  // color / kPivot / 0xFF per SA row
  int64_t n = 0, m = 0, N = 0;
  int32_t n_colors = 0;
  // Scan scratch planes ((m+1)*stride int32, 64 B aligned), cached across
  // scan calls: re-allocating hundreds of MB per call re-faults every page,
  // which measurably dominated wide-pivot scans. Keyed by thread slot; the
  // row stride follows the scan call's widest block (narrow strides keep
  // chromosome-scale pivots — m in the hundreds of millions — affordable:
  // a fixed 16-lane stride would be 16 GB per plane at m = 257M).
  std::mutex scratch_mu;
  std::vector<std::pair<int32_t*, int32_t>> scratch;  // (plane, stride)
  int32_t* plane(int32_t slot, int32_t stride) {
    std::lock_guard<std::mutex> g(scratch_mu);
    if (static_cast<size_t>(slot) >= scratch.size())
      scratch.resize(slot + 1, {nullptr, 0});
    auto& e = scratch[slot];
    if (e.second < stride) {
      if (e.first) ::operator delete(e.first, std::align_val_t(64));
      e.first = static_cast<int32_t*>(::operator new(
          (static_cast<size_t>(m) + 1) * stride * sizeof(int32_t),
          std::align_val_t(64)));
      hint_huge(e.first, (static_cast<size_t>(m) + 1) * stride * sizeof(int32_t));
      e.second = stride;
    }
    return e.first;
  }
  ~GsaHandle() {
    for (auto& e : scratch)
      if (e.first) ::operator delete(e.first, std::align_val_t(64));
  }
};

constexpr uint8_t kPivotMark = 0xFE;

}  // namespace

// Build the shared generalized-SA state for one group. On success returns 0
// and sets *out_handle (free with gsa_free). Errors: -1 length overflow
// (combined length exceeds int32 indexing), -2 bad bytes (0x00/0x01 in text,
// 0x00/'$' in pivot), -3 bad colors (need 0 <= color < n_colors <= 250).
int64_t gsa_build(const uint8_t* text, int64_t n, const int64_t* unit_ends,
                  int64_t n_units, const int32_t* unit_color, int32_t n_colors,
                  const uint8_t* pivot, int64_t m, void** out_handle) {
  *out_handle = nullptr;
  const int64_t N = n + m + 2;  // + separator + sentinel
  if (N > INT32_MAX - 1) return -1;
  if (n_colors < 1 || n_colors > 250) return -3;
  if (n_units > 0 && unit_ends[n_units - 1] != n) return -3;
  auto h = std::make_unique<GsaHandle>();
  h->n = n;
  h->m = m;
  h->N = N;
  h->n_colors = n_colors;
  h->S.alloc(static_cast<size_t>(N));
  std::memcpy(h->S.data(), text, static_cast<size_t>(n));
  h->S[n] = 0x01;
  std::memcpy(h->S.data() + n + 1, pivot, static_cast<size_t>(m));
  h->S[N - 1] = 0x00;
  for (int64_t i = 0; i < n; ++i)
    if (h->S[i] <= 0x01) return -2;
  for (int64_t i = n + 1; i < N - 1; ++i)
    if (h->S[i] == 0x00 || h->S[i] == 0x24) return -2;  // no 0x00 / '$' in pivot

  // Per-char color of text positions (temporary — collapsed into the
  // per-SA-row table below).
  HugeBuf<uint8_t> cc(static_cast<size_t>(n));
  {
    int64_t pos = 0;
    for (int64_t u = 0; u < n_units; ++u) {
      int32_t c = unit_color[u];
      if (c < 0 || c >= n_colors) return -3;
      for (; pos < unit_ends[u]; ++pos) cc[pos] = static_cast<uint8_t>(c);
    }
    if (pos != n) return -3;
  }

  h->SA.alloc(static_cast<size_t>(N));
  sais_impl<uint8_t>(h->S.data(), h->SA.data(), static_cast<int32_t>(N), 256);

  // One pass of prefetched random loads turns every later color scan into a
  // sequential read: color (or pivot marker) of each SA row.
  h->col_of_row.alloc(static_cast<size_t>(N));
  {
    constexpr int64_t PF = 24;
    const int32_t* SA = h->SA.data();
    for (int64_t r = 0; r < N; ++r) {
      if (r + PF < N) {
        int64_t q = SA[r + PF];
        if (q < n) __builtin_prefetch(&cc[q]);
      }
      int64_t p = SA[r];
      h->col_of_row[r] = p < n ? cc[p] : (p > n && p < N - 1 ? kPivotMark : 0xFF);
    }
  }

  // LCP array (Kasai, text order, amortized O(N)): built ONCE per group so
  // every color scan is a pure register-min pass over sequential int32
  // reads — the per-color random text reads that dominated pooled builds
  // (gsa_scan's old char re-extension) disappear entirely. lcp(p, u) for a
  // pivot row p and text row u is the range-min of LCP over (rank(u),
  // rank(p)] — exact for ANY two suffixes, and inherently stops at the
  // first byte mismatch, so matches can never cross the pivot's 0x01 record
  // joiners or the text's '$' terminators (those bytes never appear in the
  // other string).
  {
    h->LCP.alloc(static_cast<size_t>(N));
    HugeBuf<int32_t> rank(static_cast<size_t>(N));
    const int32_t* SA = h->SA.data();
    const uint8_t* S = h->S.data();
    for (int64_t r = 0; r < N; ++r) rank[SA[r]] = static_cast<int32_t>(r);
    h->LCP[0] = 0;
    int64_t k = 0;
    // Two prefetch stages: rank -> SA at PF1, then (with that line arrived)
    // SA -> S[j + k] at PF2 using the current k as the position estimate (k
    // drifts by <= PF2 between issue and use; one cache line absorbs it).
    constexpr int64_t PF1 = 24, PF2 = 8;
    for (int64_t i = 0; i < N; ++i) {
      if (i + PF1 < N) {
        int32_t rf = rank[i + PF1];
        if (rf > 0) __builtin_prefetch(&SA[rf - 1]);
      }
      if (i + PF2 < N) {
        int32_t rf = rank[i + PF2];
        if (rf > 0) __builtin_prefetch(&S[SA[rf - 1] + k]);
      }
      int32_t r = rank[i];
      if (r == 0) {
        k = 0;
        continue;
      }
      int64_t j = SA[r - 1];
      while (S[i + k] == S[j + k]) ++k;  // unique 0x00 sentinel terminates
      h->LCP[r] = static_cast<int32_t>(k);
      if (k) --k;
    }
  }
  *out_handle = h.release();
  return 0;
}

void gsa_free(void* handle) { delete static_cast<GsaHandle*>(handle); }

// Matching statistics for colors [c0, c1) of a built group, written to
// out[(c - c0) * m + i]. Per color, ms[i] = max over the nearest same-color
// text suffix above/below pivot row i in SA order of their lcp — and with
// the group's LCP array prebuilt (gsa_build), that lcp is a running MIN of
// sequential LCP reads since the color's last occurrence. One pass serves a
// block of kBlk colors (a min-register per color, SIMD-friendly): per row,
// regs = min(regs, LCP[r]); a color row resets its register to +inf; a
// pivot row stores the whole block's registers into one contiguous scratch
// row. Two directions max-merge. NO text bytes are touched at all — the
// old per-color LCP char re-extension (random reads over a group-sized
// text, the measured pooled-build bottleneck) is gone; row-visit cost is
// 2*ceil(C/kBlk)*N sequential int32 reads with 16-lane vector mins.
// Scratch: two m*kBlk int32 planes per thread (one per direction). `n_threads` parallelizes the
// independent blocks. Returns 0, or -3 on a bad color range.
int64_t gsa_scan(void* handle, int32_t c0, int32_t c1, int32_t* out,
                 int32_t n_threads) {
  GsaHandle& H = *static_cast<GsaHandle*>(handle);
  if (c0 < 0 || c1 <= c0 || c1 > H.n_colors) return -3;
  const int64_t n = H.n, m = H.m, N = H.N;
  const int32_t* SA = H.SA.data();
  const int32_t* LCP = H.LCP.data();
  const uint8_t* col_of_row = H.col_of_row.data();
  constexpr int32_t kInf = INT32_MAX;

  constexpr int32_t kBlk = 16;
  // One 16-lane int32 vector = the whole block's registers. GCC vector
  // extensions compile to AVX-512/AVX2/SSE per -march without intrinsics.
  typedef int32_t v16 __attribute__((vector_size(kBlk * sizeof(int32_t))));
  auto vmin = [](v16 a, v16 b) -> v16 { return a < b ? a : b; };
  auto vmax = [](v16 a, v16 b) -> v16 { return a > b ? a : b; };
  auto vload = [](const int32_t* p) -> v16 {
    v16 v;
    __builtin_memcpy(&v, p, sizeof(v));
    return v;
  };
  auto vstore = [](int32_t* p, v16 v) { __builtin_memcpy(p, &v, sizeof(v)); };
  auto vsplat = [](int32_t x) -> v16 { return (v16){} + x; };
  const v16 lane_ids = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
  // Non-temporal full-line stores for the scratch planes: each pivot row
  // writes exactly one 64 B line at an effectively random offset in an
  // m-row plane (hundreds of MB at chromosome scale) — regular stores pay a
  // read-for-ownership miss per line, which measurably dominated the pass.
  // Each direction streams into its OWN plane (NT stores cannot
  // read-modify-write), and the emit pass max-merges both sequentially.
  auto vstream = [](int32_t* p, v16 v) {
#if defined(__AVX512F__)
    _mm512_stream_si512(reinterpret_cast<__m512i*>(p), (__m512i)v);
#elif defined(__AVX2__)
    __m256i half[2];
    __builtin_memcpy(half, &v, sizeof(half));
    _mm256_stream_si256(reinterpret_cast<__m256i*>(p), half[0]);
    _mm256_stream_si256(reinterpret_cast<__m256i*>(p) + 1, half[1]);
#elif defined(__SSE2__)
    __m128i q[4];
    __builtin_memcpy(q, &v, sizeof(q));
    for (int i = 0; i < 4; ++i)
      _mm_stream_si128(reinterpret_cast<__m128i*>(p) + i, q[i]);
#else
    __builtin_memcpy(p, &v, sizeof(v));
#endif
  };
  auto fence = [] {
#if defined(__x86_64__) || defined(__i386__)
    _mm_sfence();  // NT stores are weakly ordered; emit reads follow
#endif
  };
  auto scan_block = [&](int32_t b0, int32_t nb, int32_t stride,
                        int32_t* tmp1_arg, int32_t* tmp2_arg) {
    // Local __restrict__ copies of the captured pointers: reference capture
    // plus the int32 stores through tmp would otherwise force the compiler
    // to reload every pointer (and N) from the closure each iteration
    // (observed: ~3x slower loop).
    const int32_t* __restrict__ lcp = LCP;
    const uint8_t* __restrict__ col = col_of_row;
    const int32_t* __restrict__ sa = SA;
    int32_t* __restrict__ tmp1 = tmp1_arg;
    int32_t* __restrict__ tmp2 = tmp2_arg;
    const int64_t NN = N, mm = m, nn = n;
    const bool full_line = stride == kBlk;
    const size_t row_bytes = static_cast<size_t>(nb) * sizeof(int32_t);
    // Future pivot rows' scratch lines are known PF rows ahead (sa[] is a
    // sequential read): prefetch-for-write hides the RFO miss that partial
    // (non-NT) row stores otherwise pay on a multi-GB plane.
    constexpr int64_t PFW = 24;
    // Direction 1 (top-down): regs[b] = lcp(row r's suffix, nearest color-b
    // suffix above) as the running min of LCP since that color's last row;
    // -1 = no color-b row above yet (min keeps it; clamped to 0 at emit).
    v16 regs = vsplat(-1);
    for (int64_t r = 0; r < NN; ++r) {
      regs = vmin(regs, vsplat(lcp[r]));
      const uint8_t c = col[r];
      // Lane reset runs branchless every row (in-block color rows are ~half
      // of all rows and data-random — a branch here mispredicts its way to
      // ~20 cycles/row); lane -1 matches nothing for non-color rows.
      const int32_t rel = static_cast<int32_t>(c) - b0;
      const int32_t lane =
          static_cast<uint32_t>(rel) < static_cast<uint32_t>(nb) ? rel : -1;
      regs = lane_ids == vsplat(lane) ? vsplat(kInf) : regs;
      if (!full_line && r + PFW < NN && col[r + PFW] == kPivotMark)
        __builtin_prefetch(
            tmp1 + (static_cast<size_t>(sa[r + PFW]) - nn - 1) * stride, 1);
      // Pivot rows are few (m/N) and the branch mostly not-taken: cheaper
      // than an unconditional store per row. Reset-then-store is order-safe
      // (a row is pivot xor color).
      if (c == kPivotMark) {
        int32_t* dst = tmp1 + (static_cast<size_t>(sa[r]) - nn - 1) * stride;
        if (full_line) vstream(dst, regs);
        else __builtin_memcpy(dst, &regs, row_bytes);
      }
    }
    // Direction 2 (bottom-up): the min now accumulates LCP[r+1] (the gap
    // BELOW row r), so the per-row update order flips: handle the row, then
    // fold its LCP into the registers for the next (higher) row.
    regs = vsplat(-1);
    for (int64_t r = NN - 1; r >= 0; --r) {
      const uint8_t c = col[r];
      if (!full_line && r - PFW >= 0 && col[r - PFW] == kPivotMark)
        __builtin_prefetch(
            tmp2 + (static_cast<size_t>(sa[r - PFW]) - nn - 1) * stride, 1);
      if (c == kPivotMark) {
        int32_t* dst = tmp2 + (static_cast<size_t>(sa[r]) - nn - 1) * stride;
        if (full_line) vstream(dst, regs);
        else __builtin_memcpy(dst, &regs, row_bytes);
      }
      const int32_t rel = static_cast<int32_t>(c) - b0;
      const int32_t lane =
          static_cast<uint32_t>(rel) < static_cast<uint32_t>(nb) ? rel : -1;
      regs = lane_ids == vsplat(lane) ? vsplat(kInf) : regs;
      regs = vmin(regs, vsplat(lcp[r]));
    }
    fence();
    // Emit: max-merge the two direction planes and transpose into the
    // color-major output. Blocked over row chunks so each plane is read
    // ONCE (a color-outer loop would re-stream both full planes per color
    // — nb x the traffic, measured dominating the scan at wide m).
    const int64_t kChunk = std::max<int64_t>(65536 / (stride * 4), 1024);
    for (int64_t i0 = 0; i0 < mm; i0 += kChunk) {
      const int64_t i1 = std::min(i0 + kChunk, mm);
      for (int32_t b = 0; b < nb; ++b) {
        int32_t* __restrict__ out_c =
            out + static_cast<size_t>(b0 - c0 + b) * mm;
        const int32_t* __restrict__ s1 = tmp1 + b;
        const int32_t* __restrict__ s2 = tmp2 + b;
        for (int64_t i = i0; i < i1; ++i) {
          const size_t o = static_cast<size_t>(i) * stride;
          out_c[i] = std::max(std::max(s1[o], s2[o]), 0);
        }
      }
    }
  };
  // Blocks align to absolute color multiples of kBlk so any [c0, c1) split
  // of the full range visits identical blocks (each color's result is
  // independent; alignment just keeps block sizes regular).
  const int32_t first_blk = c0 / kBlk;
  const int32_t last_blk = (c1 - 1) / kBlk;
  const int32_t n_blocks = last_blk - first_blk + 1;
  const int32_t T = std::max<int32_t>(1, std::min<int32_t>(n_threads, n_blocks));
  // Stride = the call's widest block: a narrow color span keeps the planes
  // proportional to the colors actually scanned.
  int32_t stride = 1;
  for (int32_t blk = first_blk; blk <= last_blk; ++blk) {
    int32_t b0 = std::max(blk * kBlk, c0);
    int32_t nb = std::min((blk + 1) * kBlk, c1) - b0;
    stride = std::max(stride, nb);
  }
  auto run_blocks = [&](int32_t t) {
    int32_t* tmp1 = H.plane(2 * t, stride);
    int32_t* tmp2 = H.plane(2 * t + 1, stride);
    for (int32_t blk = first_blk + t; blk <= last_blk; blk += T) {
      int32_t b0 = std::max(blk * kBlk, c0);
      int32_t nb = std::min((blk + 1) * kBlk, c1) - b0;
      scan_block(b0, nb, stride, tmp1, tmp2);
    }
  };
  if (T == 1) {
    run_blocks(0);
  } else {
    std::vector<std::thread> pool;
    pool.reserve(T);
    for (int32_t t = 0; t < T; ++t)
      pool.emplace_back([&, t]() { run_blocks(t); });
    for (auto& th : pool) th.join();
  }
  return 0;
}

// One-shot wrapper (kept for ABI compatibility and small groups): full
// [n_colors, m] result in one call.
int64_t ms_gsa_mt(const uint8_t* text, int64_t n, const int64_t* unit_ends,
                  int64_t n_units, const int32_t* unit_color, int32_t n_colors,
                  const uint8_t* pivot, int64_t m, int32_t* out,
                  int32_t n_threads) {
  void* h = nullptr;
  int64_t rc = gsa_build(text, n, unit_ends, n_units, unit_color, n_colors,
                         pivot, m, &h);
  if (rc != 0) return rc;
  rc = gsa_scan(h, 0, n_colors, out, n_threads);
  gsa_free(h);
  return rc;
}

int64_t ms_gsa(const uint8_t* text, int64_t n, const int64_t* unit_ends,
               int64_t n_units, const int32_t* unit_color, int32_t n_colors,
               const uint8_t* pivot, int64_t m, int32_t* out) {
  return ms_gsa_mt(text, n, unit_ends, n_units, unit_color, n_colors, pivot,
                   m, out, 1);
}

// Convert start-MS of RC(P) vs a text T into start-MS of P vs RC(T)
// (the forward-only pooled layout's RC fold — see index/ms.py _rc_start_ms
// for the derivation). With f(e) = e - msR[m-e] nondecreasing,
// out[p] = max{ e : f(e) <= p } - p, computed by one two-pointer merge:
// both f's argument and p advance monotonically. Replaces a numpy
// histogram+cumsum chain that allocated several m-sized temporaries per
// color and measurably dominated wide pooled builds.
void ms_rc_start(const int32_t* ms_rc, int64_t m, int32_t* out) {
  int64_t e = 0;  // next candidate; f(e) = e - ms_rc[m-e] (f(0) = 0)
  for (int64_t p = 0; p < m; ++p) {
    while (e < m && (e + 1) - ms_rc[m - 1 - e] <= p) ++e;
    out[p] = static_cast<int32_t>(e - p);
  }
}

// Build the automaton over reverse(text). Returns nullptr on alphabet
// overflow, state-id (int32) overflow, or allocation failure. `max_states`
// <= 0 means the int32 ceiling; smaller values are a test hook for the
// overflow guard.
void* ms_build_capped(const uint8_t* text, int64_t n, int64_t max_states) {
  // Pre-count the exact alphabet so transition rows are sized to it.
  bool seen[256] = {false};
  int acap = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (!seen[text[i]]) {
      seen[text[i]] = true;
      ++acap;
    }
  }
  if (acap == 0) acap = 1;
  int64_t cap = 2 * n + 4;  // tight state bound: the arena never grows
  if (max_states > 0 && max_states < cap) cap = max_states;
  Automaton* a = nullptr;
  try {
    a = new Automaton(acap, cap);
    for (int64_t i = n - 1; i >= 0; --i) {
      a->extend(text[i]);
      if (a->overflow) {
        delete a;
        return nullptr;
      }
    }
  } catch (...) {  // arena allocation failure (also covers the old ctor throw)
    delete a;
    return nullptr;
  }
  return a;
}

void* ms_build(const uint8_t* text, int64_t n) {
  return ms_build_capped(text, n, 0);
}

void ms_free(void* h) { delete static_cast<Automaton*>(h); }

int64_t ms_num_states(void* h) { return static_cast<Automaton*>(h)->n_states(); }

// Matching statistics of `pivot` (one record, no '$') against the built text:
// out[p] = length of the longest prefix of pivot[p:] occurring in the text.
void ms_query(void* h, const uint8_t* pivot, int64_t m, int32_t* out) {
  const Automaton& a = *static_cast<const Automaton*>(h);
  int32_t state = 0;
  int32_t l = 0;
  // Stream reversed pivot; longest match ending at reversed index i is the
  // longest match starting at m-1-i in the forward pivot.
  for (int64_t i = m - 1; i >= 0; --i) {
    int c = a.code[pivot[i]];
    if (c < 0) {
      state = 0;
      l = 0;
    } else {
      while (state != 0 && a.tr(state, c) == -1) {
        state = a.link_of(state);
        l = a.len_of(state);
      }
      int32_t nxt = a.tr(state, c);
      if (nxt != -1) {
        state = nxt;
        ++l;
      } else {
        state = 0;
        l = 0;
      }
    }
    out[i] = l;
  }
}

// MEM-overlap interval extraction from a row-major MS matrix (the DAP).
//
// One streaming pass over ms[P*D] implementing the reference's row loop
// (reference dap_to_bed.py:116-134) including the end-of-record sentinel row
// (pos=L, ms=[L]*D -> intervals ending at min(prev_end, 2L)): position p
// starts a MEM for column c iff p == 0 or ms[p-1][c] <= ms[p][c]; on each new
// MEM emit the overlap [p, min(prev_end, p+ms[p][c]))] with the column's
// previous MEM when non-negative (bookends kept). Emission is row-major —
// the reference's BED print order. Replaces the numpy path in
// memo_tpu_torch.index.intervals, which is memory-bound on (P,D) int64 temporaries;
// this pass reads each ms row once and keeps only prev_end[D] hot.
//
// `cap` = caller-computed bound on emissions (exact count of MEM starts);
// returns the number of intervals written, or -1 if cap was insufficient.
// Chunked variant of ms_overlaps: process rows [pos0, pos0+P) of a record,
// carrying per-column state across calls so chromosome-scale DAPs never
// materialize in one array (the combined 128 Mbp x 90-doc build streams
// row chunks gathered from per-document columns). State:
//   prev_end[D]  (in/out) — last MEM end per column; < 0 = none yet.
//   prev_row[D]  (in)     — MS row pos0-1, ignored when pos0 == 0.
// The caller invokes with is_final=1 on (or after) the last chunk to emit
// the reference's end-of-record sentinel row (pos=L, ms=[L]*D -> intervals
// [L, min(prev_end, 2L))], dap_to_bed.py:125-134); P may be 0 then.
// Returns intervals written, or -1 if cap was insufficient.
int64_t ms_overlaps_chunk(const int32_t* ms, int64_t P, int64_t D,
                          int64_t pos0, int64_t L, int32_t is_final,
                          const int32_t* prev_row, int64_t* prev_end,
                          int64_t cap, int64_t* out_s, int64_t* out_e,
                          int32_t* out_o) {
  int64_t k = 0;
  int64_t p0 = pos0;
  if (P > 0 && pos0 == 0) {
    // First row of the record: every column emits a MEM (no previous MEM
    // yet, so no overlap output) — it only seeds prev_end.
    for (int64_t c = 0; c < D; ++c) prev_end[c] = ms[c];
    p0 = 1;
  }
  for (int64_t p = p0; p < pos0 + P; ++p) {
    const int32_t* row = ms + (p - pos0) * D;
    const int32_t* prow = p == pos0 ? prev_row : row - D;
    for (int64_t c = 0; c < D; ++c) {
      if (prow[c] <= row[c]) {
        int64_t end = p + row[c];
        int64_t ov_end = prev_end[c] < end ? prev_end[c] : end;
        if (ov_end >= p && prev_end[c] >= 0) {
          if (k == cap) return -1;
          out_s[k] = p;
          out_e[k] = ov_end;
          out_o[k] = static_cast<int32_t>(c + 1);
          ++k;
        }
        prev_end[c] = end;
      }
    }
  }
  if (is_final) {
    // Sentinel end-of-record row (pos=L, ms=[L]*D): unconditional emit.
    for (int64_t c = 0; c < D; ++c) {
      if (prev_end[c] < 0) continue;
      int64_t ov_end = prev_end[c] < 2 * L ? prev_end[c] : 2 * L;
      if (ov_end >= L) {
        if (k == cap) return -1;
        out_s[k] = L;
        out_e[k] = ov_end;
        out_o[k] = static_cast<int32_t>(c + 1);
        ++k;
      }
    }
  }
  return k;
}

int64_t ms_overlaps(const int32_t* ms, int64_t P, int64_t D, int64_t L,
                    int64_t cap, int64_t* out_s, int64_t* out_e, int32_t* out_o) {
  std::vector<int64_t> prev_end(static_cast<size_t>(D), -1);
  int64_t k = 0;
  bool any_rows = P > 0;
  if (any_rows) {
    // First row of the record: every column emits (no previous MEM yet).
    for (int64_t c = 0; c < D; ++c) prev_end[c] = ms[c];
    for (int64_t p = 1; p < P; ++p) {
      const int32_t* row = ms + p * D;
      const int32_t* prev_row = row - D;
      for (int64_t c = 0; c < D; ++c) {
        if (prev_row[c] <= row[c]) {
          int64_t end = p + row[c];
          int64_t ov_end = prev_end[c] < end ? prev_end[c] : end;
          if (ov_end >= p) {
            if (k == cap) return -1;
            out_s[k] = p;
            out_e[k] = ov_end;
            out_o[k] = static_cast<int32_t>(c + 1);
            ++k;
          }
          prev_end[c] = end;
        }
      }
    }
  }
  // Sentinel end-of-record row (pos=L, ms=[L]*D): unconditional emit.
  if (any_rows) {
    for (int64_t c = 0; c < D; ++c) {
      int64_t ov_end = prev_end[c] < 2 * L ? prev_end[c] : 2 * L;
      if (ov_end >= L) {
        if (k == cap) return -1;
        out_s[k] = L;
        out_e[k] = ov_end;
        out_o[k] = static_cast<int32_t>(c + 1);
        ++k;
      }
    }
  }
  return k;
}

}  // extern "C"
