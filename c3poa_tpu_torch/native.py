"""ctypes bindings for the native host library (C sources in
``native_src/``, built by ``gcc`` at first use).

Provides C fast paths for the host-side hot loops — traceback, indel
normalization, consensus voting, fastx parsing — with automatic fallback to
the pure-Python implementations when the library is absent (no ``gcc``).
Parity between both paths is enforced by tests.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess

import numpy as np

_LIB = None
_TRIED = False

# c3poa_tpu/native.py:20-55 differs: that loader reads native/ and may
# rerun its Makefile.  This one builds its own copy of the sources once
# per content hash into build/c3poa_tpu_torch/native/ (beside the
# package) and never reads or writes native/libc3poa_native.so.
SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "native_src")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "build", "c3poa_tpu_torch", "native")
# the sources and flags of native/Makefile; demux.c is the port's own
SOURCES = ("traceback.c", "fastxio.c", "dpbench.c", "overlap.c", "align.c",
           "poa.c", "demux.c")
CFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c99", "-Wall", "-Wextra",
          "-pthread", "-shared")
# why the last build failed (None when it did not)
build_error = None


def lib_path() -> str:
    """Path of the library for the current sources and flags."""
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(SRC_DIR, name), "rb") as fh:
            h.update(name.encode() + fh.read())
    return os.path.join(BUILD_DIR, f"libc3poa_native-{h.hexdigest()[:16]}.so")


def _find_lib():
    """Build the library unless it is built; None without gcc or when
    gcc fails (the Python paths then run).  A file lock serializes
    concurrent builders (test workers); the library appears by an atomic
    rename, so a reader never sees a partial file."""
    global build_error
    path = lib_path()
    if os.path.exists(path):
        return path
    gcc = shutil.which("gcc")
    if gcc is None:
        build_error = "gcc not found"
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            return path
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [gcc, *CFLAGS, "-o", tmp,
             *(os.path.join(SRC_DIR, n) for n in SOURCES), "-lm"],
            capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            build_error = f"gcc exited {proc.returncode}: {proc.stderr}"
            return None
        os.replace(tmp, path)
    return path


def get_lib():
    """The library, or None where it is absent (no gcc, a failed build or
    a file the loader refuses; the Python paths then run).  A library
    that loads was built from this package's own sources (``lib_path``),
    so it has every symbol bound here: a missing one is a build fault and
    raises, at every call."""
    # c3poa_tpu/native.py:57-170 differs: no symbol is optional
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    path = _find_lib()
    try:
        lib = None if path is None else ctypes.CDLL(path)
    except OSError:
        lib = None
    if lib is None:
        _TRIED = True
        return None

    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32, i64 = ctypes.c_int32, ctypes.c_int64

    lib.c3_traceback.restype = i32
    lib.c3_traceback.argtypes = [
        u8p, i32, i32, i8p, i32, i32, i32,
        i8p, i8p, i32p, i32p, i32p,
    ]
    lib.c3_normalize.restype = None
    lib.c3_normalize.argtypes = [i8p, i8p, i32, i8p, i8p, i32p, i32p, i32p]
    lib.c3_ops_record.restype = i32
    lib.c3_ops_record.argtypes = [
        u8p, i32, i8p, i32, i32, i32,
        i8p, i8p, i32p, i32p, i32p,
    ]
    lib.c3_ops_record_packed.restype = i32
    lib.c3_ops_record_packed.argtypes = lib.c3_ops_record.argtypes
    lib.c3_vote.restype = i32
    lib.c3_vote.argtypes = [
        i32, i32, i8p, i8p, i32p, i32p, i32p, i32p,
        i8p, i8p, i64p, i32, i8p, i8p, i32,
    ]
    lib.c3_format_fastx.restype = i64
    lib.c3_format_fastx.argtypes = [
        i32, u8p, i64p, i8p, i64p, i8p, i32, u8p, i64,
    ]
    lib.c3_fastq_read.restype = i64
    lib.c3_fastq_read.argtypes = [
        i32, u8p, i64, i64p, i8p, i8p, i64, i64p, i64p, i64, u8p, i64p,
    ]
    lib.c3_ops_records_batch.restype = None
    lib.c3_ops_records_batch.argtypes = [
        u8p, i64, i32, i8p, i64p, i8p, i64p, i32p,
        i8p, i8p, i32p, i32p, i32p, i64p, i64p, i32p, i32,
    ]
    lib.c3_vote_jobs.restype = None
    lib.c3_vote_jobs.argtypes = [
        i32, i64p, i64p, i64p, i64p, i64p, i64p, i64p,
        i8p, i8p, i32p, i32p, i32p, i32p,
        i8p, i8p, i32,
        i8p, i8p, i32p, i32,
    ]
    lib.c3_place_records.restype = None
    lib.c3_place_records.argtypes = [
        u8p, i64, i64p, i32, i64p, i32p,
        i8p, i64p, i64p, i64p, i64p, i64p, i64p,
        i8p, i8p, i32p, i32p, i32p, i32p,
    ]
    lib.c3_find_overlap.restype = i32
    lib.c3_find_overlap.argtypes = [
        i8p, i64, i8p, i64, i32, i32, i32, i64p,
    ]
    lib.c3_sliding_min_dist_multi.restype = None
    lib.c3_sliding_min_dist_multi.argtypes = [
        u8p, i64p, u8p, i64p, i32, i32p,
    ]
    lib.c3_post_demux.restype = i64
    lib.c3_post_demux.argtypes = [
        i64, u8p, i64p, u8p, i64p, i32, i64p, i64p, i64p, i64p, i64p,
        i64p, i8p, i64p, i32p, i32, i64, i32,
        i32, u8p, i64p, i64p, i64p, i32p, i32, i32,
        u8p, i8p, i32p, u8p, i64, i64p,
    ]
    lib.c3_dp_score.restype = i64
    lib.c3_dp_score.argtypes = [
        i8p, i64, i8p, i64, i64, i64, i64, i64, i64,
        i64p, i64p, i64p, i64p, i64p,
    ]
    lib.c3_align_moves.restype = i64
    lib.c3_align_moves.argtypes = [
        i8p, i32, i8p, i32, i64, i64, i64, i64, i32,
        u8p, i64p, ctypes.POINTER(i32),
    ]
    lib.c3_poa_consensus.restype = i64
    lib.c3_poa_consensus.argtypes = [
        i8p, i8p, i64p, i32, i64, i64, i64, i64, i8p, i8p, i64,
    ]
    _LIB, _TRIED = lib, True
    return _LIB


def available() -> bool:
    return get_lib() is not None


# ---------------- traceback + normalize ----------------

def traceback_normalize(q: np.ndarray, t: np.ndarray, moves: np.ndarray,
                        j_end: int, band: int):
    """C fast path for kernels.banded.traceback_banded + ref.normalize_record.

    Returns an AlignRecord (already normalized), or None if the native
    library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    from .ref.banded import AlignRecord

    q = np.ascontiguousarray(q, dtype=np.int8)
    t = np.ascontiguousarray(t, dtype=np.int8)
    moves = np.ascontiguousarray(moves, dtype=np.uint8)
    nq, nt = len(q), len(t)
    cover = np.zeros(nt, dtype=np.int8)
    base = np.zeros(nt, dtype=np.int8)
    qpos = np.zeros(nt, dtype=np.int32)
    ins_len = np.zeros(nt + 1, dtype=np.int32)
    ins_qstart = np.zeros(nt + 1, dtype=np.int32)
    j_start = lib.c3_traceback(
        moves, moves.shape[0], band, q, nq, nt, int(j_end),
        cover, base, qpos, ins_len, ins_qstart)
    lib.c3_normalize(q, t, nt, cover, base, qpos, ins_len, ins_qstart)
    return AlignRecord(cover, base, qpos, ins_len, ins_qstart,
                       int(j_start), int(j_end), 0)


def ops_record_normalize(q: np.ndarray, t: np.ndarray, ops: np.ndarray,
                         j_end: int, packed: bool = False):
    """C fast path: record from device-traceback ops + normalization.
    ``packed`` selects the 2-bit/4-per-byte gapped encoding emitted by
    walk_ops_cached.  Returns an AlignRecord or None if the native
    library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    from .ref.banded import AlignRecord

    q = np.ascontiguousarray(q, dtype=np.int8)
    t = np.ascontiguousarray(t, dtype=np.int8)
    ops = np.ascontiguousarray(ops, dtype=np.uint8)
    nq, nt = len(q), len(t)
    cover = np.zeros(nt, dtype=np.int8)
    base = np.zeros(nt, dtype=np.int8)
    qpos = np.zeros(nt, dtype=np.int32)
    ins_len = np.zeros(nt + 1, dtype=np.int32)
    ins_qstart = np.zeros(nt + 1, dtype=np.int32)
    fn = lib.c3_ops_record_packed if packed else lib.c3_ops_record
    j_start = fn(ops, len(ops), q, nq, nt, int(j_end),
                 cover, base, qpos, ins_len, ins_qstart)
    lib.c3_normalize(q, t, nt, cover, base, qpos, ins_len, ins_qstart)
    return AlignRecord(cover, base, qpos, ins_len, ins_qstart,
                       int(j_start), int(j_end), 0)


# ---------------- voting ----------------

import threading

_VOTE_TLS = threading.local()


def _vote_arena(name, shape, dtype):
    """Grow-only per-thread buffers: fresh numpy allocations cost more
    in first-touch page faults than the C vote itself."""
    size = int(np.prod(shape))
    store = getattr(_VOTE_TLS, "arenas", None)
    if store is None:
        store = _VOTE_TLS.arenas = {}
    buf = store.get(name)
    if buf is None or buf.size < size or buf.dtype != dtype:
        buf = np.empty(int(size * 1.5) + 64, dtype=dtype)
        store[name] = buf
    return buf[:size].reshape(shape)


def vote_consensus_c(nt: int, alns, qmin: int = 5):
    """C fast path for consensus.vote.vote_consensus.  Returns
    (codes, quals) or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    N = len(alns)
    cover = _vote_arena("cover", (N, nt), np.int8)
    base = _vote_arena("base", (N, nt), np.int8)
    qpos = _vote_arena("qpos", (N, nt), np.int32)
    ins_len = _vote_arena("ins_len", (N, nt + 1), np.int32)
    ins_qstart = _vote_arena("ins_qstart", (N, nt + 1), np.int32)
    j_span = np.empty((N, 2), dtype=np.int32)
    q_off = np.zeros(N + 1, dtype=np.int64)
    qs_list, ql_list = [], []
    for a, (rec, query, qual) in enumerate(alns):
        cover[a] = rec.cover
        base[a] = rec.base
        qpos[a] = rec.qpos
        ins_len[a] = rec.ins_len
        ins_qstart[a] = rec.ins_qstart
        j_span[a] = rec.j_start, rec.j_end
        qs_list.append(np.asarray(query, dtype=np.int8))
        ql_list.append(np.asarray(qual, dtype=np.int8))
        q_off[a + 1] = q_off[a] + len(qs_list[-1])
    queries = np.concatenate(qs_list) if qs_list else np.zeros(0, np.int8)
    quals = np.concatenate(ql_list) if ql_list else np.zeros(0, np.int8)
    queries = np.ascontiguousarray(queries, dtype=np.int8)
    quals = np.ascontiguousarray(quals, dtype=np.int8)

    cap = 2 * nt + 64
    out_codes = _vote_arena("out_codes", (cap,), np.int8)
    out_quals = _vote_arena("out_quals", (cap,), np.int8)
    n = lib.c3_vote(N, nt, cover, base, qpos, ins_len, ins_qstart,
                    np.ascontiguousarray(j_span.reshape(-1)),
                    queries, quals, q_off, qmin,
                    out_codes, out_quals, cap)
    while n == -1:
        cap *= 4
        out_codes = _vote_arena("out_codes", (cap,), np.int8)
        out_quals = _vote_arena("out_quals", (cap,), np.int8)
        n = lib.c3_vote(N, nt, cover, base, qpos, ins_len, ins_qstart,
                        np.ascontiguousarray(j_span.reshape(-1)),
                        queries, quals, q_off, qmin,
                        out_codes, out_quals, cap)
    return out_codes[:n].copy(), out_quals[:n].copy()


def vote_jobs_c(jobs, index, records, codes, quals, qmin: int = 5,
                nthreads: int = 4):
    """Batched C vote of the jobs ``jobs`` of a group in one GIL-released
    call, straight from the group's vote layout, whose records the record
    build wrote in place: nothing is copied on the way.  ``index`` is the
    layout's (jv_off, vnt_off, q_off, dr_off, job_nt), ``records`` its
    (cover, base, qpos, ins_len, ins_qstart, j_span) buffers, ``codes`` /
    ``quals`` its read blob (``consensus/layout.py:VoteLayout``).  Each
    job's draft is the implicit extra voter (record_for_draft semantics).
    Returns (codes, quals) a job, None for a job whose consensus outgrew
    its buffer (2*nt + 64, pathological: the caller votes it alone), or
    None in place of the list when the library is absent."""
    # c3poa_tpu/native.py:306-393 differs: no records are gathered
    lib = get_lib()
    if lib is None:
        return None
    jobs = np.asarray(jobs, dtype=np.int64)
    n_jobs = len(jobs)
    if n_jobs == 0:
        return []
    job_nt = index[4]
    out_off = np.zeros(n_jobs + 1, dtype=np.int64)
    np.cumsum(2 * job_nt[jobs] + 64, out=out_off[1:])
    out_codes = np.empty(int(out_off[-1]), dtype=np.int8)
    out_quals = np.empty(int(out_off[-1]), dtype=np.int8)
    out_lens = np.empty(n_jobs, dtype=np.int32)

    lib.c3_vote_jobs(n_jobs, jobs, *index, out_off, *records, codes, quals,
                     qmin, out_codes, out_quals, out_lens, nthreads)

    return [None if n < 0 else
            (out_codes[a:a + n].copy(), out_quals[a:a + n].copy())
            for a, n in zip(out_off.tolist(), out_lens.tolist())]


# ---------------- POA fallback (divergence-routed reads) ----------------

def poa_consensus_c(seqs, quals, match=5, mismatch=-4, gap_open=4,
                    gap_ext=2):
    """GIL-released scalar-C twin of ref.poa.poa_consensus (native/poa.c),
    bit-identical tie-breaks.  Returns (codes, quals) or None when the
    library is absent or the C side declines (DP cell cap /
    pred-count cap / allocation failure) — callers fall back to the
    numpy spec path."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(seqs)
    if n == 0:
        return np.zeros(0, dtype=np.int8), np.zeros(0, dtype=np.int8)
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    total = int(lens.sum())
    cat_s = np.empty(max(total, 1), dtype=np.int8)
    cat_q = np.empty(max(total, 1), dtype=np.int8)
    off = 0
    for s, q in zip(seqs, quals):
        cat_s[off:off + len(s)] = s
        cat_q[off:off + len(s)] = q
        off += len(s)
    cap = total + 8
    out_c = np.empty(cap, dtype=np.int8)
    out_q = np.empty(cap, dtype=np.int8)
    m = lib.c3_poa_consensus(cat_s, cat_q, lens, n,
                             match, mismatch, gap_open, gap_ext,
                             out_c, out_q, cap)
    if m < 0:
        return None
    return out_c[:m].copy(), out_q[:m].copy()


# ---------------- overlap ----------------

def find_overlap_c(target: np.ndarray, query: np.ndarray, k: int = 15,
                   band: int = 64, min_matches: int = 3):
    """C fast path for consensus.overlap.find_overlap (exact same
    algorithm and results).  Returns (r_st, r_en, q_st, q_en), None when
    no overlap is found, or the string "unavailable" when the library is
    absent or the C side declines (caller runs the numpy path)."""
    lib = get_lib()
    if lib is None:
        return "unavailable"
    target = np.ascontiguousarray(target, dtype=np.int8)
    query = np.ascontiguousarray(query, dtype=np.int8)
    out4 = np.empty(4, dtype=np.int64)
    r = lib.c3_find_overlap(target, len(target), query, len(query),
                            k, band, min_matches, out4)
    if r <= 0:
        return "unavailable" if r < 0 else None
    return int(out4[0]), int(out4[1]), int(out4[2]), int(out4[3])


_SLIDE_CACHE: dict = {}


def _index_table(idx_seqs: tuple) -> tuple:
    """The index file's sequences as the C index match takes them: the
    joined bytes, their offsets, the prefix max of their lengths in file
    order and the lengths (cached by the sequences)."""
    cached = _SLIDE_CACHE.get(idx_seqs)
    if cached is None:
        blob = np.frombuffer("".join(idx_seqs).encode(), dtype=np.uint8)
        lens = np.array([len(s) for s in idx_seqs], dtype=np.int64)
        off = np.zeros(len(idx_seqs) + 1, dtype=np.int64)
        np.cumsum(lens, out=off[1:])
        maxpref = np.maximum.accumulate(lens)
        cached = _SLIDE_CACHE[idx_seqs] = (np.ascontiguousarray(blob), off,
                                           maxpref, lens)
    return cached


def sliding_min_dists_c(seq: str, idx_seqs: tuple) -> "np.ndarray | None":
    """C fast path: min sliding Levenshtein of every index against seq,
    with the reference match_index's window truncation — its
    position-outer loop breaks at the first index whose window overruns,
    so index i only sees positions p <= len(seq) - max(len of indexes
    listed up to i) (C3POa_postprocessing.py:269-278).  Returns (n_idx,)
    int32 distances, or None when the library is absent or
    an index exceeds the C DP width (the caller runs the Python path).
    """
    lib = get_lib()
    if lib is None:
        return None
    blob, off, maxpref, lens = _index_table(idx_seqs)
    s = np.frombuffer(seq.encode(), dtype=np.uint8)
    # effective seq length per index: windows p <= n - maxpref[i]
    n_eff = np.ascontiguousarray(len(s) - maxpref + lens)
    out = np.empty(len(idx_seqs), dtype=np.int32)
    lib.c3_sliding_min_dist_multi(np.ascontiguousarray(s), n_eff,
                                  blob, off, len(idx_seqs), out)
    if (out < 0).any():  # an index wider than the C DP row
        return None
    return out


def post_demux_c(names: list, seqs: list, hits, combos: tuple,
                 score_min: int, flags: int, idx_seqs: tuple,
                 dest_of_idx: np.ndarray, dest_noindex: int, n_dest: int,
                 comp: np.ndarray):
    """One C call demuxes a postprocess group (``native_src/demux.c``,
    spec ``pipeline/postprocess.py``'s Python demux).  ``hits`` are the
    adapter kernel's six (B, C) outputs; ``combos`` = (on the '+' strand
    (int8), adapter lengths, adapter names as numbers, 5Prime_adapter's
    number or -1); ``flags`` the TRIM = 1, UNDIRECTIONAL = 2 and
    BARCODED = 4 bits of ``demux.c``.  Returns ``(outcome, chosen,
    texts)``: each read's outcome code and index (or -1), and the bytes
    of the 3 * ``n_dest`` + 2 destination files; None when the library
    is absent, a sequence is not ASCII or an index is wider than
    the C DP row (the caller runs the Python path)."""
    lib = get_lib()
    if lib is None:
        return None
    try:
        seq_blob = "".join(seqs).encode("ascii")
    except UnicodeEncodeError:
        return None
    name_bytes = [x.encode("utf-8") for x in names]
    n = len(names)
    name_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(x) for x in name_bytes], out=name_off[1:])
    seq_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(x) for x in seqs], out=seq_off[1:])
    s1, j1, qe1, ts1, qs1, s2 = (np.ascontiguousarray(h, dtype=np.int64)
                                 for h in hits)
    plus, lens, name_ids, five = combos
    blob, off, maxpref, idx_lens = _index_table(idx_seqs)
    # a written read's text: 3 records of at most name + 24 + its length
    # bytes, a 10x record of name + 69, a mux row of name + 43
    cap = 5 * (len(seq_blob) + int(name_off[-1])) + 200 * n + 64
    out = np.empty(cap, dtype=np.uint8)
    outcome = np.empty(n, dtype=np.int8)
    chosen = np.empty(n, dtype=np.int32)
    file_off = np.empty(3 * n_dest + 3, dtype=np.int64)
    w = lib.c3_post_demux(
        n, np.frombuffer(b"".join(name_bytes), dtype=np.uint8), name_off,
        np.frombuffer(seq_blob, dtype=np.uint8), seq_off, s1.shape[1],
        s1, j1, qe1, ts1, qs1, s2, plus, lens, name_ids, five, score_min,
        flags, len(idx_seqs), blob, off, maxpref, idx_lens, dest_of_idx,
        dest_noindex, n_dest, comp, outcome, chosen, out, cap, file_off)
    if w < 0:
        return None
    texts = [out[a:b].tobytes() for a, b in zip(file_off[:-1],
                                                  file_off[1:])]
    return outcome, chosen, texts


# ---------------- fastx ----------------

def format_fastx(names: list, seqs: list, quals=None) -> "str | None":
    """One GIL-released C call formats a whole group of records:
    FASTA when ``quals`` is None (">name\\nSEQ\\n"), FASTQ otherwise
    ("@name\\nSEQ\\n+\\nQUAL\\n", phred+33 clipped to 93).  Returns the
    ascii text, or None when the library is absent or the text overruns
    its buffer."""
    lib = get_lib()
    if lib is None or not names:
        return None if names else ""
    n = len(names)
    # utf-8 in/out: the C formatter treats name bytes opaquely, so
    # non-ASCII read headers pass through unchanged (byte lengths, not
    # str lengths, drive the offsets)
    name_bytes = [x.encode("utf-8") for x in names]
    name_blob = np.frombuffer(b"".join(name_bytes), dtype=np.uint8)
    name_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(x) for x in name_bytes], out=name_off[1:])
    seq_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=seq_off[1:])
    codes = np.ascontiguousarray(
        np.concatenate(seqs) if n else np.zeros(0), dtype=np.int8)
    mode = 0 if quals is None else 1
    if mode:
        qual_blob = np.ascontiguousarray(np.concatenate(quals),
                                         dtype=np.int8)
    else:
        qual_blob = np.zeros(0, dtype=np.int8)
    total_seq = int(seq_off[-1])
    cap = int(name_off[-1]) + n * 6 + total_seq * (2 if mode else 1) + 16
    out = np.empty(cap, dtype=np.uint8)
    w = lib.c3_format_fastx(mode, np.ascontiguousarray(name_blob), name_off,
                            codes, seq_off, qual_blob, n, out, cap)
    if w < 0:
        return None
    return out[:w].tobytes().decode("utf-8")


FASTQ_CHUNK = 8 << 20    # bytes of the input a c3_fastq_read call holds
FASTQ_RECORDS = 4096     # records one call parses at most


def read_fastq_encoded(path: str, start_offset: int = 0,
                       chunk: int = FASTQ_CHUNK,
                       records: int = FASTQ_RECORDS):
    """Plain-FASTQ streaming in C: yields ``(Read, offset_after_record)``
    for the records ``io.fastx.read_fastq_offsets(path, start_offset)``
    yields, already encoded, and raises what it raises at the same
    record (that parser re-reads the malformed record to say how).  Each
    ``c3_fastq_read`` call reads up to ``chunk`` bytes of the file into
    one reused buffer (grown for a longer record) and parses and encodes
    every whole record in it, the GIL released: a group of reads gives
    the GIL away a few times instead of at every line.  Needs the
    library."""
    from .io.fastx import Read, read_fastq_offsets
    lib = get_lib()
    buf = np.empty(chunk, dtype=np.uint8)
    names_s = np.empty(chunk + records, dtype=np.uint8)
    io = np.zeros(3, dtype=np.int64)      # parsed to, held, file ended
    status = np.zeros(4, dtype=np.int64)  # dropped, why, name bytes, errno
    arena_off = np.empty(records + 1, dtype=np.int64)
    ends = np.empty(records, dtype=np.int64)
    base = start_offset                   # file offset of buf[0]
    with open(path, "rb", buffering=0) as fh:
        fh.seek(start_offset)
        while True:
            cap = len(buf) // 2 + 1
            codes = np.empty(cap, dtype=np.int8)
            quals = np.empty(cap, dtype=np.int8)
            r = lib.c3_fastq_read(fh.fileno(), buf, len(buf), io, codes,
                                  quals, cap, arena_off, ends, records,
                                  names_s, status)
            dropped, why, nb, err = status.tolist()
            if r == -2:
                raise OSError(err, os.strerror(err), path)
            if r < 0:
                raise RuntimeError("c3_fastq_read: arena overflow")
            stop, held, eof = io.tolist()
            base += dropped
            offs = arena_off[:r + 1].tolist()
            # the storage of the bases parsed, no more (a shrink in place)
            codes.resize(offs[-1], refcheck=False)
            quals.resize(offs[-1], refcheck=False)
            names = names_s[:nb].tobytes().decode("ascii").split("\n")
            # each read an array of its own over the chunk's storage (its
            # base a memoryview, not the chunk's array), so a subread cut
            # from it has the read's array as its base, as encode()'s had
            cmv, qmv = memoryview(codes), memoryview(quals)
            for i, end in enumerate(ends[:r].tolist()):
                a, b = offs[i], offs[i + 1]
                yield Read(names[i], np.frombuffer(cmv[a:b], dtype=np.int8),
                           np.frombuffer(qmv[a:b], dtype=np.int8), b - a), \
                    base + end
            if why == 1:
                next(read_fastq_offsets(path, base + stop), None)
                raise ValueError(f"{path}: malformed FASTQ record at "
                                 f"byte {base + stop}")
            if why == 0 and eof:
                return
            if why == 0 and stop == 0 and held == len(buf):
                # one record longer than the buffer
                grown = np.empty(2 * len(buf), dtype=np.uint8)
                grown[:held] = buf
                buf = grown
                names_s = np.empty(len(buf) + records, dtype=np.uint8)


# ---------------- scalar-C DP (baseline-bias probe) ----------------

def dp_score_c(q: np.ndarray, t: np.ndarray, match=5, mismatch=-4,
               gap_open=4, gap_ext=2, band=128, work=None):
    """Banded semiglobal DP score via the scalar C routine
    (native/dpbench.c); measures what reference-grade C achieves on this
    host vs the numpy rows of ref/banded.py.  Returns (score, j_end) or
    None when the library is absent."""
    lib = get_lib()
    if lib is None:
        return None
    q = np.ascontiguousarray(q, dtype=np.int8)
    t = np.ascontiguousarray(t, dtype=np.int8)
    nt = len(t)
    if work is None:
        work = [np.empty(nt + 1, dtype=np.int64) for _ in range(4)]
    j_end = np.zeros(1, dtype=np.int64)
    score = lib.c3_dp_score(q, len(q), t, nt, match, mismatch,
                            gap_open, gap_ext, band,
                            work[0], work[1], work[2], work[3], j_end)
    return int(score), int(j_end[0])


# ---------------- scalar-C full aligner (CPU backend hot path) ----------

def align_and_trace_c(q: np.ndarray, t: np.ndarray, match=5, mismatch=-4,
                      gap_open=4, gap_ext=2, band=128, normalize=True):
    """C fast path for ref.banded.align_and_trace: scalar-C banded
    forward with band-local move bytes (native/align.c), then the C
    traceback + homopolymer normalization (traceback.c).  Bit-identical
    records to the numpy spec (tests/test_native.py); ~100x the numpy
    rows — this is what makes the CPU proxy baseline C-grade
    (BENCHMARKS.md).  Returns an AlignRecord, or None when the library is
    absent or the band cannot reach the target's end."""
    # c3poa_tpu/native.py:581-626 differs: no edge flag
    lib = get_lib()
    if lib is None:
        return None
    from .ref.banded import AlignRecord

    q = np.ascontiguousarray(q, dtype=np.int8)
    t = np.ascontiguousarray(t, dtype=np.int8)
    nq, nt = len(q), len(t)
    # fresh buffers per call: allocation is ~us against a ~ms DP, and it
    # keeps the routine trivially thread-safe
    work = np.empty(4 * (nt + 1), dtype=np.int64)
    moves = np.empty((nq, band), dtype=np.uint8)
    j_end = ctypes.c_int32(0)
    score = lib.c3_align_moves(q, nq, t, nt, match, mismatch,
                               gap_open, gap_ext, band, moves, work,
                               ctypes.byref(j_end))
    if score <= -(2 ** 39):
        return None  # unreachable band (nt > 3*nq): numpy path decides
    nt32 = nt
    cover = np.zeros(nt32, dtype=np.int8)
    base = np.zeros(nt32, dtype=np.int8)
    qpos = np.zeros(nt32, dtype=np.int32)
    ins_len = np.zeros(nt32 + 1, dtype=np.int32)
    ins_qstart = np.zeros(nt32 + 1, dtype=np.int32)
    j_start = lib.c3_traceback(
        moves, nq, band, q, nq, nt, int(j_end.value),
        cover, base, qpos, ins_len, ins_qstart)
    if normalize:
        lib.c3_normalize(q, t, nt, cover, base, qpos, ins_len, ins_qstart)
    return AlignRecord(cover, base, qpos, ins_len, ins_qstart,
                       int(j_start), int(j_end.value), int(score))


_ARENAS: dict = {}
_ARENA_SLOT: int = 0
_SLOT_LEASES: dict = {}       # slot -> lease token (an opaque int)
_SLOT_LOCK = None             # lazy threading.Lock
_LEASE_SEQ = 0


class ArenaSlotCollision(RuntimeError):
    """A record-arena slot was claimed while a previous generation's
    records were still live (unreleased).  This is the silent-corruption
    class the round-2 gi%2-under-multihost bug belonged to; the lease
    guard turns it into a loud failure."""


def _slot_lock():
    global _SLOT_LOCK
    if _SLOT_LOCK is None:
        import threading
        _SLOT_LOCK = threading.Lock()
    return _SLOT_LOCK


def claim_arena_slot(slot: int) -> int:
    """Claim a record-arena generation; returns a lease token.

    The pipelined runner claims slot = owned_group % 2 on its prepare
    thread before building records, and releases the lease on the main
    thread once the group's votes/writes have consumed them
    (_finalize_group).  Claiming a slot whose previous lease is still
    open means two live generations would share buffers — raise rather
    than corrupt."""
    global _LEASE_SEQ
    slot = int(slot) & 1
    with _slot_lock():
        held = _SLOT_LEASES.get(slot)
        if held is not None:
            raise ArenaSlotCollision(
                f"record-arena slot {slot} claimed while lease {held} is "
                f"still open: two in-flight groups would share record "
                f"buffers (double-buffer discipline violated)")
        _LEASE_SEQ += 1
        _SLOT_LEASES[slot] = _LEASE_SEQ
        return _LEASE_SEQ


def release_arena_slot(slot: int, lease: int) -> None:
    """Release a lease taken by claim_arena_slot (idempotent per lease)."""
    slot = int(slot) & 1
    with _slot_lock():
        if _SLOT_LEASES.get(slot) == lease:
            del _SLOT_LEASES[slot]


def reset_arena_leases() -> None:
    """Clear every open record-arena lease.

    Called from run_pipeline's cleanup after its executors have shut
    down (no prepare/finalize work can still be in flight), so a run
    that died mid-pipeline — RssRestartNeeded raised at a checkpoint
    with preps queued, or any prep/finalize exception — doesn't leave
    leases stuck in module globals and poison the next in-process run
    with ArenaSlotCollision (ADVICE r3, medium)."""
    with _slot_lock():
        _SLOT_LEASES.clear()


def set_arena_slot(slot: int) -> None:
    """Select the record-arena generation (double buffering).

    The pipelined runner builds group g+1's records on a worker thread
    while group g's records (views into these arenas) are still being
    voted on the main thread; rotating slot = g % 2 keeps the two
    generations in disjoint buffers.  Call only from the (single)
    prepare thread, before its align pass."""
    global _ARENA_SLOT
    _ARENA_SLOT = int(slot) & 1


def slot_arena(name: str, size: int, dtype, phase=0) -> np.ndarray:
    """``size`` elements of the current arena slot's grow-only buffer
    ``(name, phase)``.  Fresh allocations cost ~0.75 s of first-touch
    page faults per 90 MB call, the C loop filling them ~35 ms
    (measured).  What is handed out is a view: its owner consumes it
    before the slot's next generation claims it (claim_arena_slot)."""
    key = (name, _ARENA_SLOT, phase)
    buf = _ARENAS.get(key)
    if buf is None or buf.size < size or buf.dtype != dtype:
        buf = np.empty(int(size * 1.25), dtype=dtype)
        _ARENAS[key] = buf
    return buf[:size]


def place_records(ops, rows, voters, j_ends, blob, index, records) -> None:
    """Build the records of one device launch in place, in one
    GIL-released C call (``traceback.c:c3_place_records``): row
    ``rows[k]`` of the packed walk ``ops`` is voter ``voters[k]``'s,
    written at the voter's slot of a vote layout in its draft's
    coordinates, queries and targets read from ``blob``.  ``index`` is
    the layout's (q_off, q_len, t_off, w_len, w_off, vnt_off), ``records``
    its (cover, base, qpos, ins_len, ins_qstart, j_span) buffers
    (``consensus/layout.py:VoteLayout``).  Needs the library."""
    ops = np.ascontiguousarray(ops, dtype=np.uint8)
    get_lib().c3_place_records(
        ops, ops.shape[1], np.ascontiguousarray(rows, dtype=np.int64),
        len(voters), np.ascontiguousarray(voters, dtype=np.int64),
        np.ascontiguousarray(j_ends, dtype=np.int32), blob, *index,
        *records)


def ops_records_batch(qs, ts, ops, j_ends, packed: bool = False,
                      phase: int = 0):
    """Batched C record building + normalization for one device launch.

    qs/ts: lists of int8 code arrays; ops: (n, L) uint8 walk ops
    (2-bit packed, gapped, when ``packed``); j_ends: (n,) ints.  Returns
    a list of normalized AlignRecords whose arrays are views into shared
    arenas, or None when the library is absent.  One GIL-released C call
    replaces n Python->C round trips.  ``phase`` selects an independent
    arena family — callers issuing several batches whose records must
    stay alive together (e.g. packed + unpacked ops encodings of one
    group) give each batch its own phase.
    """
    lib = get_lib()
    if lib is None:
        return None
    from .ref.banded import AlignRecord

    n = len(qs)
    ops = np.ascontiguousarray(ops, dtype=np.uint8)
    q_off = np.zeros(n + 1, dtype=np.int64)
    t_off = np.zeros(n + 1, dtype=np.int64)
    for r in range(n):
        q_off[r + 1] = q_off[r] + len(qs[r])
        t_off[r + 1] = t_off[r] + len(ts[r])
    q_blob = np.ascontiguousarray(np.concatenate(qs), dtype=np.int8) \
        if n else np.zeros(0, np.int8)
    t_blob = np.ascontiguousarray(np.concatenate(ts), dtype=np.int8) \
        if n else np.zeros(0, np.int8)
    nt_off = t_off
    nt1_off = t_off + np.arange(n + 1, dtype=np.int64)

    total_nt = int(nt_off[n])
    total_nt1 = int(nt1_off[n])
    cover = slot_arena("cover", total_nt, np.int8, phase)
    base = slot_arena("base", total_nt, np.int8, phase)
    qpos = slot_arena("qpos", total_nt, np.int32, phase)
    ins_len = slot_arena("ins_len", total_nt1, np.int32, phase)
    ins_qstart = slot_arena("ins_qstart", total_nt1, np.int32, phase)
    j_starts = np.empty(n, dtype=np.int32)
    je = np.ascontiguousarray(j_ends, dtype=np.int32)

    lib.c3_ops_records_batch(
        ops, ops.shape[1] if ops.ndim == 2 else 0, n,
        q_blob, q_off, t_blob, t_off, je,
        cover, base, qpos, ins_len, ins_qstart, nt_off, nt1_off, j_starts,
        1 if packed else 0)

    out = []
    for r in range(n):
        a, b = int(nt_off[r]), int(nt_off[r + 1])
        a1, b1 = int(nt1_off[r]), int(nt1_off[r + 1])
        out.append(AlignRecord(cover[a:b], base[a:b], qpos[a:b],
                               ins_len[a1:b1], ins_qstart[a1:b1],
                               int(j_starts[r]), int(je[r]), 0))
    return out
