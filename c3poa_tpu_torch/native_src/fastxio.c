/* Fast FASTQ/FASTA parsing + encoding for c3poa_tpu.
 *
 * Replaces the role mappy.fastx_read's C parser plays in the reference
 * (C3POa.py:201,239).  Operates on a whole decompressed buffer (Python
 * handles gzip streaming) and emits, in one pass:
 *   - int8 base codes (A=0 C=1 G=2 T=3 other=4) into a flat arena
 *   - int8 phred values (ord-33) into a flat arena (FASTQ)
 *   - per-record offsets into the arenas + name spans in the input buffer
 *
 * Returns the number of records parsed, or -1 on malformed input, -2 if
 * arenas/record capacity were too small (caller grows and retries).
 */

#include <stdint.h>
#include <stddef.h>

static const int8_t ENC[256] = {
    /* initialized below via switch-free table build in c3_build */
};

static int8_t enc_tab[256];
static int enc_ready = 0;

static void build_enc(void) {
    for (int i = 0; i < 256; i++) enc_tab[i] = 4;
    enc_tab['A'] = 0; enc_tab['a'] = 0;
    enc_tab['C'] = 1; enc_tab['c'] = 1;
    enc_tab['G'] = 2; enc_tab['g'] = 2;
    enc_tab['T'] = 3; enc_tab['t'] = 3;
    enc_ready = 1;
}

/* Parse FASTQ from buf[0..n). Records: @name\nseq\n+\nqual\n
 * name_span: (R, 2) int64 byte offsets [start, end) of the name token.
 * arena_off: (R+1) int64 offsets into seq/qual arenas.
 */
int64_t c3_parse_fastq(
    const uint8_t *buf, int64_t n,
    int8_t *seq_arena, int8_t *qual_arena, int64_t arena_cap,
    int64_t *name_span, int64_t *arena_off, int64_t rec_cap
) {
    (void)ENC;
    if (!enc_ready) build_enc();
    int64_t pos = 0, r = 0, used = 0;
    arena_off[0] = 0;
    while (pos < n) {
        if (buf[pos] == '\n') { pos++; continue; }
        if (buf[pos] != '@') return -1;
        pos++;
        if (r >= rec_cap) return -2;
        int64_t ns = pos;
        while (pos < n && buf[pos] != '\n' && buf[pos] != ' ' &&
               buf[pos] != '\t' && buf[pos] != '\r') pos++;
        name_span[r * 2] = ns;
        name_span[r * 2 + 1] = pos;
        while (pos < n && buf[pos] != '\n') pos++; /* rest of header */
        pos++;
        /* sequence line */
        int64_t slen = 0;
        while (pos < n && buf[pos] != '\n') {
            if (used + slen >= arena_cap) return -2;
            uint8_t c = buf[pos];
            if (c != '\r') seq_arena[used + slen++] = enc_tab[c];
            pos++;
        }
        pos++;
        /* '+' line */
        if (pos >= n || buf[pos] != '+') return -1;
        while (pos < n && buf[pos] != '\n') pos++;
        pos++;
        /* qual line (must be slen chars, possibly with \r) */
        int64_t qlen = 0;
        while (pos < n && buf[pos] != '\n' && qlen < slen) {
            uint8_t c = buf[pos];
            if (c != '\r') {
                int v = (int)c - 33;
                if (v < 0) v = 0;
                if (v > 93) v = 93;
                qual_arena[used + qlen++] = (int8_t)v;
            }
            pos++;
        }
        if (qlen != slen) return -1;
        if (pos < n && buf[pos] == '\r') pos++;
        if (pos < n && buf[pos] != '\n') return -1;
        pos++;
        used += slen;
        r++;
        arena_off[r] = used;
    }
    return r;
}

/* Parse FASTA (multi-line sequences). qual_arena unused. */
int64_t c3_parse_fasta(
    const uint8_t *buf, int64_t n,
    int8_t *seq_arena, int64_t arena_cap,
    int64_t *name_span, int64_t *arena_off, int64_t rec_cap
) {
    if (!enc_ready) build_enc();
    int64_t pos = 0, r = -1, used = 0;
    arena_off[0] = 0;
    while (pos < n) {
        if (buf[pos] == '\n' || buf[pos] == '\r') { pos++; continue; }
        if (buf[pos] == '>') {
            pos++;
            r++;
            if (r >= rec_cap) return -2;
            int64_t ns = pos;
            while (pos < n && buf[pos] != '\n' && buf[pos] != ' ' &&
                   buf[pos] != '\t' && buf[pos] != '\r') pos++;
            name_span[r * 2] = ns;
            name_span[r * 2 + 1] = pos;
            while (pos < n && buf[pos] != '\n') pos++;
            pos++;
            arena_off[r] = used; /* start offset; end written as we go */
            arena_off[r + 1] = used;
        } else {
            if (r < 0) return -1;
            while (pos < n && buf[pos] != '\n') {
                uint8_t c = buf[pos];
                if (c != '\r') {
                    if (used >= arena_cap) return -2;
                    seq_arena[used++] = enc_tab[c];
                }
                pos++;
            }
            pos++;
            arena_off[r + 1] = used;
        }
    }
    return r + 1;
}

/* Decode int8 codes back to ACGTN ascii (for writers). */
void c3_decode(const int8_t *codes, int64_t n, uint8_t *out) {
    static const uint8_t DEC[5] = {'A', 'C', 'G', 'T', 'N'};
    for (int64_t i = 0; i < n; i++) {
        int8_t c = codes[i];
        out[i] = DEC[(c >= 0 && c < 5) ? c : 4];
    }
}

/* Format a whole group of records as FASTA/FASTQ ascii in one
 * GIL-released call (the per-record Python f-string building held the
 * GIL for ~0.5 s/group under pipeline contention).  mode 0 = FASTA
 * (">name\nSEQ\n"), 1 = FASTQ ("@name\nSEQ\n+\nQUAL\n"); quals are
 * phred ints clipped to [0, 93] and emitted as chr(q + 33).  Returns
 * bytes written, or -1 if cap is too small. */
int64_t c3_format_fastx(int32_t mode,
                        const uint8_t *names, const int64_t *name_off,
                        const int8_t *codes, const int64_t *seq_off,
                        const int8_t *quals,
                        int32_t n, uint8_t *out, int64_t cap) {
    static const uint8_t DEC[5] = {'A', 'C', 'G', 'T', 'N'};
    int64_t w = 0;
    for (int32_t r = 0; r < n; r++) {
        int64_t nl = name_off[r + 1] - name_off[r];
        int64_t sl = seq_off[r + 1] - seq_off[r];
        int64_t need = 1 + nl + 1 + sl + 1 + (mode ? 2 + sl + 1 : 0);
        if (w + need > cap) return -1;
        out[w++] = mode ? '@' : '>';
        memcpy(out + w, names + name_off[r], (size_t)nl);
        w += nl;
        out[w++] = '\n';
        const int8_t *s = codes + seq_off[r];
        for (int64_t i = 0; i < sl; i++) {
            int8_t c = s[i];
            out[w + i] = DEC[(c >= 0 && c < 5) ? c : 4];
        }
        w += sl;
        out[w++] = '\n';
        if (mode) {
            out[w++] = '+';
            out[w++] = '\n';
            const int8_t *q = quals + seq_off[r];
            for (int64_t i = 0; i < sl; i++) {
                int32_t v = q[i];
                if (v < 0) v = 0;
                if (v > 93) v = 93;
                out[w + i] = (uint8_t)(v + 33);
            }
            w += sl;
            out[w++] = '\n';
        }
    }
    return w;
}
