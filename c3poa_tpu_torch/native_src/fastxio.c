/* FASTQ reading and encoding, and FASTA/FASTQ formatting, for
 * c3poa_tpu_torch.
 *
 * c3_fastq_read replaces the role mappy.fastx_read's C parser plays in
 * the reference (C3POa.py:201,239) for the consensus run's plain FASTQ
 * input: one call reads a chunk of the file and parses and encodes every
 * whole record in it (A=0 C=1 G=2 T=3 other=4; phred = byte - 33), with
 * the GIL released.  Its spec is io/fastx.py:read_fastq_offsets, byte
 * for byte: lines end at '\n' alone; the name is the header's first
 * token under ASCII whitespace; sequence and quality lines lose trailing
 * ASCII whitespace only; the '+' line is not read; at the end of the
 * input a missing line reads as empty.
 */

#define _POSIX_C_SOURCE 200809L

#include <errno.h>
#include <stdint.h>
#include <stddef.h>
#include <string.h>
#include <unistd.h>

static int is_space(uint8_t c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' ||
           c == '\f';
}

/* End (index of its '\n', or n) of the line starting at p. */
static int64_t line_end(const uint8_t *buf, int64_t p, int64_t n) {
    const uint8_t *q = p < n ? memchr(buf + p, '\n', (size_t)(n - p)) : NULL;
    return q ? (int64_t)(q - buf) : n;
}

/* Start of the line after the one ending at e. */
static int64_t next_line(int64_t e, int64_t n) {
    return e < n ? e + 1 : n;
}

/* Length of buf[a, e) without its trailing ASCII whitespace. */
static int64_t rstrip_len(const uint8_t *buf, int64_t a, int64_t e) {
    while (e > a && is_space(buf[e - 1])) e--;
    return e - a;
}

/* Parse the whole records of buf[0, n), which starts at a record
 * boundary; eof says the input ends at n.  Record i gets its base codes
 * and phred values at [arena_off[i], arena_off[i + 1]) of codes and
 * quals, the end of its last line in ends[i], and its name and a '\n'
 * appended to names.  *stop is where parsing stopped (the end of the
 * last whole record), *why why: 0 the rest is an incomplete record or
 * nothing, 1 the record at *stop is malformed (the spec parser says
 * how), 2 rec_cap records were parsed; *nb the bytes written to names.
 * codes and quals need n / 2 bytes, names n + rec_cap.  Returns the
 * records parsed, or -1 if codes would overflow cap. */
static int64_t parse_records(const uint8_t *buf, int64_t n, int eof,
                             int8_t *codes, int8_t *quals, int64_t cap,
                             int64_t *arena_off, int64_t *ends,
                             int64_t rec_cap, uint8_t *names, int64_t *stop,
                             int64_t *why, int64_t *nb) {
    int8_t enc[256];
    for (int i = 0; i < 256; i++) enc[i] = 4;
    enc['A'] = 0; enc['a'] = 0;
    enc['C'] = 1; enc['c'] = 1;
    enc['G'] = 2; enc['g'] = 2;
    enc['T'] = 3; enc['t'] = 3;
    int64_t p = 0, r = 0, used = 0;
    *nb = 0;
    *why = 0;
    arena_off[0] = 0;
    while (p < n) {
        if (r >= rec_cap) { *why = 2; break; }
        int64_t he = line_end(buf, p, n);
        int64_t s0 = next_line(he, n), se = line_end(buf, s0, n);
        int64_t p0 = next_line(se, n), pe = line_end(buf, p0, n);
        int64_t q0 = next_line(pe, n), qe = line_end(buf, q0, n);
        if (!eof && qe >= n) break;  /* the record's last '\n' not read */
        int64_t end = next_line(qe, n);
        if (buf[p] != '@') { *why = 1; break; }
        /* the header's first token: ASCII, else the spec's decode fails */
        int64_t ns = p + 1;
        while (ns < he && is_space(buf[ns])) ns++;
        int64_t ne = ns;
        uint8_t hi = 0;
        while (ne < he && !is_space(buf[ne])) hi |= buf[ne++];
        /* a line past the end reads as empty; a missing '+' line is a
         * truncated record */
        if (p0 >= n) { *why = 1; break; }
        int64_t sl = s0 < n ? rstrip_len(buf, s0, se) : 0;
        int64_t ql = q0 < n ? rstrip_len(buf, q0, qe) : 0;
        if ((hi & 0x80) || ql != sl) { *why = 1; break; }
        if (used + sl > cap) return -1;
        const uint8_t *s = buf + s0, *q = buf + q0;
        int8_t *co = codes + used, *qo = quals + used;
        for (int64_t i = 0; i < sl; i++) {
            hi |= s[i] | q[i];
            co[i] = enc[s[i]];
            qo[i] = (int8_t)(q[i] - 33);
        }
        if (hi & 0x80) { *why = 1; break; }
        memcpy(names + *nb, buf + ns, (size_t)(ne - ns));
        *nb += ne - ns;
        names[(*nb)++] = '\n';
        used += sl;
        ends[r] = end;
        arena_off[++r] = used;
        p = end;
    }
    *stop = p;
    return r;
}

/* One step of streaming a plain FASTQ file from fd into buf (size
 * bytes).  io[0] is where the last step's parsing stopped: buf[0, io[0])
 * is dropped (status[0] says how many bytes), the rest moved to the
 * front; then fd is read until buf is full or the file ends, and the
 * records are parsed as parse_records does, ends[] and io[0] counted
 * from the new buf[0].  io[1] is the bytes held in buf, io[2] 1 once the
 * file has ended; status[1] and status[2] are parse_records' why and nb.
 * Returns the records parsed, -1 if codes would overflow cap, -2 if a
 * read failed (its errno in status[3]). */
int64_t c3_fastq_read(int32_t fd, uint8_t *buf, int64_t size, int64_t *io,
                      int8_t *codes, int8_t *quals, int64_t cap,
                      int64_t *arena_off, int64_t *ends, int64_t rec_cap,
                      uint8_t *names, int64_t *status) {
    int64_t drop = io[0], held = io[1] - drop;
    if (drop > 0) memmove(buf, buf + drop, (size_t)held);
    status[0] = drop;
    status[3] = 0;
    while (!io[2] && held < size) {
        ssize_t got = read(fd, buf + held, (size_t)(size - held));
        if (got < 0) {
            if (errno == EINTR) continue;
            status[3] = errno;
            io[0] = 0;
            io[1] = held;
            return -2;
        }
        if (got == 0) io[2] = 1;
        held += got;
    }
    io[1] = held;
    return parse_records(buf, held, (int)io[2], codes, quals, cap,
                         arena_off, ends, rec_cap, names, &io[0],
                         &status[1], &status[2]);
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
