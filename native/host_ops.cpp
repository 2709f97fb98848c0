// Native host-side hot loops for dsrc_tpu.
//
// The TPU owns the compute path (JAX/XLA); these are the host runtime pieces
// that the reference implements in C++ and that stay on the CPU here too:
// record-boundary scanning for the chunker (reference
// FastqStream.cpp:18-98), 2-bit packing fallbacks, and compressed-payload
// row compaction for archive serialization; for the PyTorch port also block
// staging, FASTQ layout and the tag coder's title passes.  Exposed with a
// plain C ABI for ctypes (no pybind11 in this image).
//
// Build: make -C native   ->  libdsrc_host.so

#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

extern "C" {

// Scan a buffer for FASTQ record boundaries.
//
// A record boundary lies after newline k (0-based, global line index
// lines_before + k) iff (lines_before + k + 1) % 4 == 0.  Returns the number
// of newlines in buf and writes the byte position *after* the last record
// boundary to *cut (-1 if none).  Mirrors io/chunker.py's numpy scan.
int64_t dsrc_scan_records(const uint8_t* buf, int64_t n,
                          int64_t lines_before, int64_t* cut) {
    int64_t count = 0;
    int64_t last = -1;
    const uint8_t* p = buf;
    const uint8_t* end = buf + n;
    // phase: how many more newlines until the next boundary
    int64_t phase = 3 - (lines_before & 3);
    while (p < end) {
        const uint8_t* nl =
            static_cast<const uint8_t*>(memchr(p, '\n', end - p));
        if (!nl) break;
        if (phase == 0) {
            last = (nl - buf) + 1;
            phase = 3;
        } else {
            --phase;
        }
        ++count;
        p = nl + 1;
    }
    *cut = last;
    return count;
}

// 2-bit pack: n (multiple of 4) symbols in [0,3] -> n/4 bytes.
void dsrc_pack2(const uint8_t* syms, int64_t n, uint8_t* out) {
    for (int64_t i = 0; i < n; i += 4) {
        out[i >> 2] = static_cast<uint8_t>(
            syms[i] | (syms[i + 1] << 2) | (syms[i + 2] << 4) |
            (syms[i + 3] << 6));
    }
}

void dsrc_unpack2(const uint8_t* packed, int64_t nbytes, uint8_t* out) {
    for (int64_t i = 0; i < nbytes; ++i) {
        uint8_t b = packed[i];
        out[4 * i] = b & 3;
        out[4 * i + 1] = (b >> 2) & 3;
        out[4 * i + 2] = (b >> 4) & 3;
        out[4 * i + 3] = (b >> 6) & 3;
    }
}

// Compact rANS payload rows: payload is [l][w_max] int32 holding u16 words;
// keep the first nwords[j] of each row, emitting little-endian u16.
// Returns total words written.
int64_t dsrc_compact_payload(const int32_t* payload, int64_t l,
                             int64_t w_max, const int32_t* nwords,
                             uint16_t* out) {
    int64_t k = 0;
    for (int64_t j = 0; j < l; ++j) {
        const int32_t* row = payload + j * w_max;
        int64_t nw = nwords[j];
        for (int64_t w = 0; w < nw; ++w) {
            out[k++] = static_cast<uint16_t>(row[w]);
        }
    }
    return k;
}

// Right-aligned variant: row j's words live at [w_max - nwords[j], w_max)
// (the device encoder's in-scan layout); emitted in that order.
int64_t dsrc_compact_payload_right(const int32_t* payload, int64_t l,
                                   int64_t w_max, const int32_t* nwords,
                                   uint16_t* out) {
    int64_t k = 0;
    for (int64_t j = 0; j < l; ++j) {
        const int32_t* row = payload + j * w_max;
        int64_t nw = nwords[j];
        for (int64_t w = w_max - nw; w < w_max; ++w) {
            out[k++] = static_cast<uint16_t>(row[w]);
        }
    }
    return k;
}

// Inverse: scatter a flat u16 word stream back into [l][w_max] rows.
void dsrc_expand_payload(const uint16_t* words, int64_t l, int64_t w_max,
                         const int32_t* nwords, int32_t* payload) {
    int64_t k = 0;
    for (int64_t j = 0; j < l; ++j) {
        int32_t* row = payload + j * w_max;
        int64_t nw = nwords[j];
        for (int64_t w = 0; w < nw; ++w) row[w] = words[k++];
        for (int64_t w = nw; w < w_max; ++w) row[w] = 0;
    }
}

// ---------------------------------------------------------------------------
// Semi-uniform block staging (compress side): one pass over the block text
// validating the 4-line layout (fixed read length, '+' separator line) and
// filling the quality/sequence matrices + concatenated title stream that
// models/block.py:_compress_semi feeds to the device kernels.  The numpy
// version runs ~6 separate passes (flatnonzero + fancy gathers + isin);
// this is the host-runtime analogue of the reference's scalar record
// parser (FastqParser.cpp:140-235) and keeps worker threads fed at chip
// rate.  Returns num_records, or -1 when the block is not semi-layout
// (caller falls back to the generic codec).
//
// buf[n] must end with '\n'.  qual_mat/seq_mat are [rpad, read_len]
// row-major, pre-zeroed by the caller; title_buf has capacity n;
// title_lens has capacity rpad.
int64_t dsrc_stage_semi(const uint8_t* buf, int64_t n, int64_t read_len,
                        int64_t rpad, uint8_t* qual_mat, uint8_t* seq_mat,
                        uint8_t* title_buf, int64_t* title_lens) {
    if (n <= 0 || buf[n - 1] != '\n' || read_len <= 0 || read_len > 8192)
        return -1;
    // seq/qual byte validity lookup: 1 = ACGTN, 2 = quality [33, 97)
    static uint8_t ok_tab[256];
    static bool init = false;
    if (!init) {
        for (int q = 33; q < 33 + 64; ++q) ok_tab[q] |= 2;
        ok_tab[static_cast<int>('A')] |= 1;
        ok_tab[static_cast<int>('C')] |= 1;
        ok_tab[static_cast<int>('G')] |= 1;
        ok_tab[static_cast<int>('T')] |= 1;
        ok_tab[static_cast<int>('N')] |= 1;
        init = true;
    }
    const uint8_t* p = buf;
    const uint8_t* end = buf + n;
    int64_t rec = 0;
    int64_t tpos = 0;
    while (p < end) {
        if (rec >= rpad) return -1;
        // line 1: @title
        if (*p != '@') return -1;
        const uint8_t* nl = static_cast<const uint8_t*>(
            memchr(p, '\n', end - p));
        if (!nl) return -1;
        int64_t tl = nl - p - 1;
        memcpy(title_buf + tpos, p + 1, tl);
        tpos += tl;
        title_lens[rec] = tl;
        p = nl + 1;
        // line 2: sequence, exactly read_len of ACGTN
        if (end - p < read_len + 1 || p[read_len] != '\n') return -1;
        {
            uint8_t* dst = seq_mat + rec * read_len;
            for (int64_t i = 0; i < read_len; ++i) {
                if (!(ok_tab[p[i]] & 1)) return -1;
                dst[i] = p[i];
            }
        }
        p += read_len + 1;
        // line 3: exactly "+"
        if (end - p < 2 || p[0] != '+' || p[1] != '\n') return -1;
        p += 2;
        // line 4: quality, exactly read_len in [33, 97)
        if (end - p < read_len + 1 || p[read_len] != '\n') return -1;
        {
            uint8_t* dst = qual_mat + rec * read_len;
            for (int64_t i = 0; i < read_len; ++i) {
                if (!(ok_tab[p[i]] & 2)) return -1;
                dst[i] = p[i];
            }
        }
        p += read_len + 1;
        ++rec;
    }
    return rec;
}

// ---------------------------------------------------------------------------
// FASTQ text reassembly (decompress side): the mirror of dsrc_stage_semi for
// the whole decode path — scatter decoded title/sequence/quality streams
// back into 4-line records (reference BlockCompressor::ReadTags text
// layout, BlockCompressor.cpp:503-573; replaces the numpy _scatter_var
// passes in models/block.py:_layout).
//
// titles: concatenated title bytes with per-record title_lens;
// seq/qual: concatenated with per-record qual_lens (sequence length =
// qual_len + (color_space ? 1 : 0), the extra byte being primers[rec]);
// plus_rep repeats the title after '+'.  out must hold the exact total
// (computed by the caller from the length vectors).  Returns bytes written.
int64_t dsrc_layout_records(
    int64_t num_rec, const uint8_t* titles, const int64_t* title_lens,
    const uint8_t* seq, const uint8_t* qual, const int64_t* qual_lens,
    const uint8_t* primers, int32_t color_space, int32_t plus_rep,
    uint8_t* out) {
    uint8_t* o = out;
    int64_t toff = 0, qoff = 0;
    for (int64_t r = 0; r < num_rec; ++r) {
        int64_t tl = title_lens[r];
        int64_t ql = qual_lens[r];
        *o++ = '@';
        memcpy(o, titles + toff, tl);
        o += tl;
        *o++ = '\n';
        if (color_space) *o++ = primers[r];
        memcpy(o, seq + qoff, ql);
        o += ql;
        *o++ = '\n';
        *o++ = '+';
        if (plus_rep) {
            memcpy(o, titles + toff, tl);
            o += tl;
        }
        *o++ = '\n';
        memcpy(o, qual + qoff, ql);
        o += ql;
        *o++ = '\n';
        toff += tl;
        qoff += ql;
    }
    return o - out;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Tag (read-title) coder passes: the byte-level work of
// dsrc_tpu_torch/models/tag.py over a block's concatenated titles, each the
// mirror of a numpy fallback there that gives the same values and bytes.
// A title is split into tokens at the separators " ._,=:/-#".

namespace {

struct SepTable {
    uint8_t is_sep[256];
};

constexpr SepTable make_sep_table() {
    SepTable t{};
    for (const char* p = " ._,=:/-#"; *p; ++p)
        t.is_sep[static_cast<uint8_t>(*p)] = 1;
    return t;
}

constexpr SepTable kSep = make_sep_table();

// 1 for a separator byte, else 0 (a table load: no branch).
inline int64_t sep_byte(uint8_t c) { return kSep.is_sep[c]; }

uint64_t hash_row(const uint8_t* row, int64_t n) {
    uint64_t h = 1469598103934665603ull;        // FNV-1a
    for (int64_t i = 0; i < n; ++i) {
        h ^= row[i];
        h *= 1099511628211ull;
    }
    return h ^ (h >> 29);
}

// "%d" of v, then zero-filled to pad as str.zfill does (the sign first).
// Returns the bytes written, or -1 when pad > 0 and "%d" is longer than
// pad (numpy's zfill then truncates or not by version: the caller renders
// such a field with numpy).
int64_t put_decimal(int64_t v, int64_t pad, uint8_t* o) {
    uint64_t m = v < 0 ? 0 - static_cast<uint64_t>(v)
                       : static_cast<uint64_t>(v);
    uint8_t buf[20];
    int n = 0;
    do {
        buf[n++] = static_cast<uint8_t>('0' + m % 10);
        m /= 10;
    } while (m);
    int64_t len = n + (v < 0);
    if (pad > 0 && len > pad) return -1;
    uint8_t* p = o;
    if (v < 0) *p++ = '-';
    for (int64_t z = len; z < pad; ++z) *p++ = '0';
    while (n) *p++ = buf[--n];
    return p - o;
}

// floor(v / p) mod 10 for p > 0, as numpy's // and % give it.
int64_t floor_digit(int64_t v, int64_t p) {
    int64_t q = v / p;
    if (v % p != 0 && v < 0) --q;
    int64_t d = q % 10;
    return d < 0 ? d + 10 : d;
}

const int64_t kPow10[10] = {1, 10, 100, 1000, 10000, 100000, 1000000,
                            10000000, 100000000, 1000000000};

}  // namespace

extern "C" {

// The block's modal title structure (models/tag.py:_tokenize_numpy).  Each
// record's separator count, capped at max_fields, votes; the modal count
// (the smallest among equal votes, as argmax takes it) gives k = count + 1
// tokens.  Among the records with exactly k - 1 separators, the modal
// separator row is found with a hash table of rows; among equal counts the
// lexicographically smallest row wins, as np.unique(axis=0) then argmax
// take it.  Writes the row to seps[0 .. k-2] and match[r] = 1 for the
// records that have it.  Returns k, or -1 when the block has no dominant
// structure (k > max_fields, or fewer than half the records match), or -2
// when memory ran out.
int64_t dsrc_tag_structure(const uint8_t* stream, const int64_t* lengths,
                           int64_t num_rec, int64_t max_fields,
                           uint8_t* seps, uint8_t* match) {
    try {
        std::vector<int32_t> nsep(num_rec);
        std::vector<int64_t> votes(max_fields + 1, 0);
        const uint8_t* p = stream;
        for (int64_t r = 0; r < num_rec; ++r) {
            int64_t c = 0;
            for (int64_t i = 0, n = lengths[r]; i < n; ++i)
                c += sep_byte(p[i]);
            p += lengths[r];
            if (c > max_fields) c = max_fields;
            nsep[r] = static_cast<int32_t>(c);
            ++votes[c];
        }
        int64_t modal = 0;
        for (int64_t c = 1; c <= max_fields; ++c)
            if (votes[c] > votes[modal]) modal = c;
        int64_t k = modal + 1;
        if (k > max_fields) return -1;
        memset(match, 0, num_rec);
        int64_t matched = 0;
        if (k == 1) {
            for (int64_t r = 0; r < num_rec; ++r) {
                match[r] = nsep[r] == 0;
                matched += match[r];
            }
        } else {
            const int64_t w = k - 1;
            const int64_t ncand = votes[modal];
            // one byte more: a row's writes past its last separator land
            // on the next row's first byte (or this one) and are rewritten
            std::vector<uint8_t> rows(ncand * w + 1);
            std::vector<int64_t> cand(ncand);
            p = stream;
            int64_t j = 0;
            for (int64_t r = 0; r < num_rec; ++r) {
                if (nsep[r] == modal) {
                    uint8_t* row = rows.data() + j * w;
                    int64_t t = 0;
                    for (int64_t i = 0, n = lengths[r]; i < n; ++i) {
                        row[t] = p[i];
                        t += sep_byte(p[i]);
                    }
                    cand[j++] = r;
                }
                p += lengths[r];
            }
            int64_t size = 16;
            while (size < 2 * ncand) size <<= 1;
            // a block holds fewer than 2^31 records
            std::vector<int32_t> slot(size, -1);   // a row's first index
            std::vector<int32_t> count(ncand, 0);  // by first index
            std::vector<int32_t> rep(ncand);       // each row's first index
            for (j = 0; j < ncand; ++j) {
                const uint8_t* row = rows.data() + j * w;
                uint64_t h = hash_row(row, w) & (size - 1);
                while (slot[h] >= 0 &&
                       memcmp(rows.data() + slot[h] * w, row, w) != 0)
                    h = (h + 1) & (size - 1);
                if (slot[h] < 0) slot[h] = static_cast<int32_t>(j);
                rep[j] = slot[h];
                ++count[slot[h]];
            }
            int64_t best = 0;
            for (j = 1; j < ncand; ++j) {
                if (rep[j] != j) continue;
                if (count[j] > count[best] ||
                    (count[j] == count[best] &&
                     memcmp(rows.data() + j * w, rows.data() + best * w,
                            w) < 0))
                    best = j;
            }
            for (j = 0; j < ncand; ++j) {
                if (rep[j] == best) {
                    match[cand[j]] = 1;
                    ++matched;
                }
            }
            memcpy(seps, rows.data() + best * w, w);
        }
        if (matched * 2 < num_rec) return -1;
        return k;
    } catch (const std::bad_alloc&) {
        return -2;
    }
}

// Token offsets (into the stream) and lengths, [Rm, k] row-major, of the
// records with match[r] set, each of which has exactly k - 1 separators.
// Returns 0, or -1 when a token would have a negative length.
int64_t dsrc_tag_tokens(const uint8_t* stream, const int64_t* lengths,
                        int64_t num_rec, int64_t k, const uint8_t* match,
                        int64_t* tok_start, int64_t* tok_len) {
    int64_t off = 0;
    int64_t* ts = tok_start;
    int64_t* tl = tok_len;
    for (int64_t r = 0; r < num_rec; ++r) {
        int64_t end = off + lengths[r];
        if (match[r]) {
            // branch-free: token t's entries are rewritten until its
            // separator (or the title's end) closes it
            int64_t start = off;
            int64_t t = 0;
            for (int64_t i = off; i < end; ++i) {
                const int64_t s = sep_byte(stream[i]);
                ts[t] = start;
                tl[t] = i - start;
                t += s;
                start = s ? i + 1 : start;
            }
            ts[t] = start;
            tl[t] = end - start;
            if (tl[t] < 0) return -1;
            ts += k;
            tl += k;
        }
        off = end;
    }
    return 0;
}

// Each of the k fields of a token table [rm, k] (models/tag.py:_is_const,
// _numeric_values), in one record-major pass over the tokens: kind[f] = 0
// when every token is the same bytes and at most max_const long; 1 when
// every token is 1 to max_digits decimal digits and, if any has a leading
// zero, all have one width (pad[f] = that width, else 0), its values
// written to vals[f * rm .. f * rm + rm - 1]; 2 otherwise (text).
// Returns 0, or -2 when memory ran out.
int64_t dsrc_tag_classify(const uint8_t* stream, const int64_t* tok_start,
                          const int64_t* tok_len, int64_t rm, int64_t k,
                          int64_t max_digits, int64_t max_const,
                          int32_t* kind, int64_t* pad, int64_t* vals) {
    struct Field {
        const uint8_t* first;
        int64_t l0;
        bool is_const, numeric, same_len, has_pad;
    };
    std::vector<Field> st;
    try {
        st.resize(k);
    } catch (const std::bad_alloc&) {
        return -2;
    }
    for (int64_t f = 0; f < k; ++f)
        st[f] = {stream + tok_start[f], tok_len[f], tok_len[f] <= max_const,
                 true, true, false};
    int64_t live = k;
    for (int64_t r = 0; r < rm && live; ++r) {
        const int64_t* ts = tok_start + r * k;
        const int64_t* tl = tok_len + r * k;
        for (int64_t f = 0; f < k; ++f) {
            Field& s = st[f];
            if (!s.is_const && !s.numeric) continue;
            const int64_t len = tl[f];
            const uint8_t* tok = stream + ts[f];
            if (len != s.l0) {
                s.same_len = false;
                s.is_const = false;
            } else if (s.is_const && memcmp(tok, s.first, len) != 0) {
                s.is_const = false;
            }
            if (s.numeric) {
                if (len < 1 || len > max_digits) {
                    s.numeric = false;
                } else {
                    int64_t x = 0;
                    for (int64_t i = 0; i < len; ++i) {
                        unsigned d = tok[i] - static_cast<unsigned>('0');
                        if (d > 9) {
                            s.numeric = false;
                            break;
                        }
                        x = x * 10 + d;
                    }
                    vals[f * rm + r] = x;
                    s.has_pad |= tok[0] == '0' && len > 1;
                }
            }
            if (!s.is_const && !s.numeric) --live;
        }
    }
    for (int64_t f = 0; f < k; ++f) {
        const Field& s = st[f];
        pad[f] = 0;
        if (s.is_const) {
            kind[f] = 0;
        } else if (s.numeric && (!s.has_pad || s.same_len)) {
            kind[f] = 1;
            pad[f] = s.has_pad ? s.l0 : 0;
        } else {
            kind[f] = 2;
        }
    }
    return 0;
}

// The titles of a token-coded section (models/tag.py:decode_tags): record
// by record, either the next exception title (exc_idx strictly increasing)
// or the k fields of the next matching record joined by the k - 1
// separators.  Field f is, by kind[f]: 0 the constant data[f] of arg[f]
// bytes; 1 the int64 values ivec[f][R] rendered by "%d" and zero-filled to
// arg[f] (0: not padded); 2 text, data[f] the field's bytes and ivec[f][R]
// their lengths.  Writes each record's length to out_lens and returns the
// bytes written; -1 when a padded value's "%d" is longer than its width,
// -2 when exc_idx is not strictly increasing within [0, num_rec), -3 when
// memory ran out.
int64_t dsrc_tag_render(int64_t num_rec, int64_t k, const uint8_t* seps,
                        const int32_t* kind, const int64_t* arg,
                        const uint8_t* const* data,
                        const int64_t* const* ivec, const int64_t* exc_idx,
                        int64_t n_exc, const int64_t* exc_lens,
                        const uint8_t* exc_bytes, int64_t* out_lens,
                        uint8_t* out) {
    for (int64_t e = 0; e < n_exc; ++e) {
        if (exc_idx[e] < 0 || exc_idx[e] >= num_rec ||
            (e > 0 && exc_idx[e] <= exc_idx[e - 1]))
            return -2;
    }
    std::vector<int64_t> toff;
    try {
        toff.assign(k, 0);
    } catch (const std::bad_alloc&) {
        return -3;
    }
    uint8_t* o = out;
    int64_t e = 0;
    int64_t eoff = 0;
    int64_t row = 0;
    for (int64_t rec = 0; rec < num_rec; ++rec) {
        uint8_t* start = o;
        if (e < n_exc && exc_idx[e] == rec) {
            memcpy(o, exc_bytes + eoff, exc_lens[e]);
            o += exc_lens[e];
            eoff += exc_lens[e];
            ++e;
        } else {
            for (int64_t f = 0; f < k; ++f) {
                if (kind[f] == 0) {
                    memcpy(o, data[f], arg[f]);
                    o += arg[f];
                } else if (kind[f] == 1) {
                    int64_t n = put_decimal(ivec[f][row], arg[f], o);
                    if (n < 0) return -1;
                    o += n;
                } else {
                    int64_t n = ivec[f][row];
                    memcpy(o, data[f] + toff[f], n);
                    toff[f] += n;
                    o += n;
                }
                if (f < k - 1) *o++ = seps[f];
            }
            ++row;
        }
        out_lens[rec] = o - start;
    }
    return o - out;
}

// The titles of a SEMI title mode 2 block (models/tag.py:
// render_value_titles) from its [num_rec, ncols] int64 value matrix: field
// f is, by kind[f], 0 the constant data[f] of arg[f] bytes; 1 a value
// column in as many digits as the value has (1 to 10); 2 a value column in
// arg[f] <= 10 digits.  Digit i of a w-digit field is floor(v / 10^(w-1-i))
// mod 10, as numpy's // and % give it for any value.  Writes each record's
// length to out_lens and returns the bytes written.
int64_t dsrc_tag_render_values(int64_t num_rec, int64_t k,
                               const uint8_t* seps, const int32_t* kind,
                               const int64_t* arg, const uint8_t* const* data,
                               const int64_t* vmat, int64_t ncols,
                               int64_t* out_lens, uint8_t* out) {
    uint8_t* o = out;
    for (int64_t rec = 0; rec < num_rec; ++rec) {
        uint8_t* start = o;
        const int64_t* vrow = vmat + rec * ncols;
        int64_t col = 0;
        for (int64_t f = 0; f < k; ++f) {
            if (kind[f] == 0) {
                memcpy(o, data[f], arg[f]);
                o += arg[f];
            } else {
                const int64_t v = vrow[col++];
                int64_t w = arg[f];
                if (kind[f] == 1) {
                    w = 1;
                    for (int i = 1; i < 10; ++i) w += v >= kPow10[i];
                }
                if (v >= 0) {
                    int64_t x = v;
                    for (int64_t i = w - 1; i >= 0; --i) {
                        o[i] = static_cast<uint8_t>('0' + x % 10);
                        x /= 10;
                    }
                } else {
                    for (int64_t i = 0; i < w; ++i)
                        o[i] = static_cast<uint8_t>(
                            '0' + floor_digit(v, kPow10[w - 1 - i]));
                }
                o += w;
            }
            if (f < k - 1) *o++ = seps[f];
        }
        out_lens[rec] = o - start;
    }
    return o - out;
}

}  // extern "C"
