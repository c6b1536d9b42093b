"""Postprocessing: adapter trim, 5'->3' reorientation, oligo-dT index demux.

Mirrors ``C3POa_postprocessing.py`` (reference :112-398) with the BLAT
adapter alignment replaced by the batched device kernel
(kernels/adapters.py) and editdistance by ``ref/lev.py``.

Rules reproduced exactly:
- extrapolated adapter positions (parse_blat :252-263):
  '+': position = read_end + (adapter_len - adapter_end);
  '-': position = read_start - adapter_start (with the '-' combo aligned as
  revcomp(adapter), which is coordinate-equivalent to BLAT's minus-strand
  PSL arithmetic)
- accept reads with exactly one '+' and one '-' hit, minus > plus
  (:323-326); hit threshold: local score > 10 (BLAT matches>10, :252)
- direction from which adapter is on '+' (:328-336); --undirectional
  forces '+'
- oligo-dT demux on 20bp junction windows via sliding Levenshtein,
  accept best < 2 with margin > 1 (:266-285,:338-362)
- output grammar: trimmed (-t) or +-40bp padded consensus, left/right
  splint files, 10x barcode file (-b, with the reference's literal
  'plus'/'minus' suffix on the sequence line, :374-384),
  R2C2_oligodT_multiplexing.tsv, '_len' name suffix (:364-384)

Deviation (documented): records stream to the final files in input order
instead of through post_tmp_* trees catted in glob order.

Tracing (``utils/prof.py``; the reference has none): each run opens its
own profiler and dumps it to ``.c3poa_post_stats.json`` in its output
directory (a host's own directory under several processes; the merge
never reads it).  Stages a group, on the calling thread: ``post_read``
(the FASTA parse), ``post_encode``, ``adapter_hits`` (the backend call,
its device wait included), ``post_demux`` (hit extraction, the rules,
the index match and the record writes: one C call a group and its
texts' writes, or the Python path), ``post_checkpoint``.  Counters, the
run's reads by outcome: ``post_reads`` = ``post_written`` +
``post_no_adapter`` + ``post_wrong_order`` + ``post_no_direction``;
``post_no_index`` counts the written reads filed under
``no_index_found``; ``post_demux_native_groups`` the groups this process
demuxed in C.
"""

from __future__ import annotations

import dataclasses
import gzip
import itertools
import json
import math
import os
from typing import NamedTuple

import numpy as np

from ..io.fastx import read_fastx
from ..ref.lev import sliding_min_distance
from ..utils import prof
from ..utils.mem import RssRestartNeeded, rss_mb
from ..utils.progress import Progress
from ..utils.seqs import _COMP_CHAR, encode, revcomp, revcomp_encoded


@dataclasses.dataclass
class PostprocessConfig:
    undirectional: bool = False   # -u
    trim: bool = False            # -t
    barcoded: bool = False        # -b
    group_size: int = 1000        # -g
    threads: int = 1              # -n: whole groups fan out to spawn
                                  # workers (reference chunked mp,
                                  # C3POa_postprocessing.py:128-161)
    compress: bool = False        # -co
    resume: bool = False          # continue an interrupted run (the
                                  # reference's PSL-cache role,
                                  # C3POa_postprocessing.py:231)
    score_min: int = 10           # BLAT matches>10 analogue
    # multi-host (same recipe as the consensus pipeline, parallel/dist.py):
    # host h owns groups gi % process_count == h, writes under
    # out/host_<h>/, and host 0 merges byte spans by group index
    process_index: int = 0
    process_count: int = 1
    # >0: clean RssRestartNeeded exit at a checkpoint once VmRSS exceeds
    # this (see pipeline/run.PipelineConfig.rss_restart_mb)
    rss_restart_mb: int = 0


class AdapterHit(NamedTuple):
    name: str
    score: float
    position: int


def match_index(seq: str, seq_to_idx: dict) -> str:
    """Exact port of reference match_index (C3POa_postprocessing.py:266-285),
    including its window truncation for mixed-length index files: the
    reference's position-outer loop `break`s at the first index whose
    window overruns, so index i only sees positions
    p <= len(seq) - max(len of indexes listed up to i).  Deviation
    (documented): an index with NO valid window contributes its own
    length as the distance, where the reference raises ValueError /
    IndexError.  seq_to_idx: {index_seq: index_name} in index-file
    order.  A C fast path (native/overlap.c) computes all sliding
    distances in one call (~50x; the per-index numpy DP dominated
    postprocess demux)."""
    if not seq_to_idx:
        return "-"
    from .. import native
    dists = native.sliding_min_dists_c(seq, tuple(seq_to_idx.keys()))
    if dists is not None:
        names = list(seq_to_idx.values())
        dist_list = sorted(zip(names, dists.tolist()), key=lambda x: x[1])
    else:
        maxpref = 0
        pairs = []
        for idx_seq, idx in seq_to_idx.items():
            maxpref = max(maxpref, len(idx_seq))
            pairs.append(
                (idx, sliding_min_distance(
                    seq[:max(0, len(seq) - maxpref + len(idx_seq))],
                    idx_seq)))
        dist_list = sorted(pairs, key=lambda x: x[1])
    second = dist_list[1][1] if len(dist_list) > 1 else np.inf
    if dist_list[0][1] < 2 and second - dist_list[0][1] > 1:
        return dist_list[0][0]
    return "-"


def extract_hits(combo_meta, s1, j1, qe1, ts1, qs1, s2, score_min):
    """Device outputs (per read, per combo) -> {'+': [...], '-': [...]}
    with extrapolated positions; a passing second hit adds a duplicate
    entry so the exactly-one rule rejects the read."""
    hits = {"+": [], "-": []}
    for c, (name, strand, alen) in enumerate(combo_meta):
        if s1[c] <= score_min:
            continue
        start = int(ts1[c]) - int(qs1[c])
        end = int(j1[c]) + 1 + (alen - 1 - int(qe1[c]))
        position = end if strand == "+" else start
        hits[strand].append(AdapterHit(name, float(s1[c]), position))
        if s2[c] > score_min:
            hits[strand].append(AdapterHit(name, float(s2[c]), position))
    return hits


class _Writers:
    """Lazy output files per demux directory ('' = out root);
    resume-capable (uncompressed only): files restore to the last
    checkpointed byte size and append."""

    FLC = "R2C2_full_length_consensus_reads.fasta"
    LEFT = "R2C2_full_length_consensus_reads_left_splint.fasta"
    RIGHT = "R2C2_full_length_consensus_reads_right_splint.fasta"
    TENX = "R2C2_full_length_consensus_reads_10X_sequences.fasta"
    MUX = "R2C2_oligodT_multiplexing.tsv"

    def __init__(self, out_path, compress, restore_sizes=None):
        self.out_path = out_path
        self.compress = compress
        self.restore_sizes = restore_sizes or {}
        self._h: dict = {}

    def _open(self, *parts):
        key = parts
        if key not in self._h:
            path = os.path.join(self.out_path, *parts)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            rel = "/".join(parts)
            if self.compress and not path.endswith(".tsv"):
                self._h[key] = gzip.open(path + ".gz", "wt")
            elif rel in self.restore_sizes and os.path.exists(path):
                with open(path, "r+b") as fh:
                    fh.truncate(self.restore_sizes[rel])
                self._h[key] = open(path, "a")
            else:
                self._h[key] = open(path, "w")
        return self._h[key]

    def trio(self, subdir):
        parts = (subdir,) if subdir else ()
        return (self._open(*parts, self.FLC),
                self._open(*parts, self.LEFT),
                self._open(*parts, self.RIGHT))

    def tenx(self):
        return self._open(self.TENX)

    def mux(self):
        return self._open(self.MUX)

    def sizes(self) -> dict:
        # start from the restored snapshot: files valid from a previous
        # session but untouched in THIS one must stay in the manifest,
        # or a third session would open them in 'w' mode and truncate
        # every earlier record
        out = dict(self.restore_sizes)
        for key, fh in self._h.items():
            fh.flush()
            out["/".join(key)] = fh.tell()
        return out

    def close(self):
        for fh in self._h.values():
            fh.close()


class _MemWriters:
    """Writer-compatible collector for multiprocessing workers: output
    text returns to the parent, which writes it in group order."""

    def __init__(self):
        self._h: dict = {}

    def _open(self, *parts):
        key = "/".join(parts)
        if key not in self._h:
            import io
            self._h[key] = io.StringIO()
        return self._h[key]

    def trio(self, subdir):
        parts = (subdir,) if subdir else ()
        return (self._open(*parts, _Writers.FLC),
                self._open(*parts, _Writers.LEFT),
                self._open(*parts, _Writers.RIGHT))

    def tenx(self):
        return self._open(_Writers.TENX)

    def mux(self):
        return self._open(_Writers.MUX)

    def blobs(self) -> dict:
        return {k: v.getvalue() for k, v in self._h.items()}


@dataclasses.dataclass
class PostprocessStats:
    total: int = 0
    written: int = 0
    no_adapter: int = 0       # failed the exactly-one-per-strand rule
    wrong_order: int = 0
    no_direction: int = 0
    no_index: int = 0         # written under no_index_found


def _process_read(name, sequence, hits, cfg, writers, idx_to_seq, seq_to_idx,
                  stats):
    plus, minus = hits["+"], hits["-"]
    if len(plus) != 1 or len(minus) != 1:
        stats.no_adapter += 1
        return
    plus_name, plus_pos = plus[0].name, plus[0].position
    minus_name, minus_pos = minus[0].name, minus[0].position
    if minus_pos <= plus_pos:
        stats.wrong_order += 1
        return

    odT = bool(seq_to_idx)
    if cfg.undirectional:
        direction = "+"
    elif plus_name != minus_name:
        direction = "+" if plus_name == "5Prime_adapter" else "-"
    else:
        stats.no_direction += 1
        return

    idx_name = None
    if odT:
        fwd_win = sequence[plus_pos - 4:plus_pos + 16]
        rev_win = revcomp(sequence[minus_pos - 16:minus_pos + 4])
        writers.mux().write(f"{name}\t{rev_win}\t{fwd_win}\n")
        forward_index = match_index(fwd_win, seq_to_idx)
        reverse_index = match_index(rev_win, seq_to_idx)
        demux = False
        if forward_index in idx_to_seq and reverse_index not in idx_to_seq:
            direction, idx_name, demux = "-", forward_index, True
        if reverse_index in idx_to_seq and forward_index not in idx_to_seq:
            direction, idx_name, demux = "+", reverse_index, True
        if not demux:
            idx_name = "no_index_found"
            stats.no_index += 1

    out, out3, out5 = writers.trio(idx_name)

    seq = sequence[plus_pos:minus_pos]
    ada = sequence[max(plus_pos - 40, 0):minus_pos + 40]
    name = f"{name}_{len(seq)}"
    if direction == "+":
        out.write(f">{name}\n{seq if cfg.trim else ada}\n")
        out5.write(f">{name}\n{revcomp(sequence[:plus_pos])}\n")
        out3.write(f">{name}\n{sequence[minus_pos:]}\n")
        if cfg.barcoded:
            writers.tenx().write(
                f">{name}\n{revcomp(sequence[minus_pos - 40:minus_pos])}plus\n")
    else:
        out.write(f">{name}\n{revcomp(seq) if cfg.trim else revcomp(ada)}\n")
        out3.write(f">{name}\n{revcomp(sequence[:plus_pos + 40])}\n")
        out5.write(f">{name}\n{sequence[minus_pos:]}\n")
        if cfg.barcoded:
            writers.tenx().write(
                f">{name}\n{sequence[plus_pos:plus_pos + 40]}minus\n")
    stats.written += 1


MANIFEST = ".c3poa_post_progress.json"
STATS = ".c3poa_post_stats.json"


def _resume_key(input_fasta, adapter_fasta, index_fasta,
                cfg: PostprocessConfig) -> dict:
    return {
        "input": os.path.abspath(input_fasta),
        "adapters": os.path.abspath(adapter_fasta),
        "indexes": os.path.abspath(index_fasta) if index_fasta else None,
        "undirectional": cfg.undirectional, "trim": cfg.trim,
        "barcoded": cfg.barcoded, "group_size": cfg.group_size,
        "score_min": cfg.score_min,
        # a manifest from a different round-robin sharding must not be
        # accepted: group ownership (gi % N == h) changes with N, so a
        # stale skip count would skip/duplicate groups (run.py's resume
        # key guards identically)
        "process": [cfg.process_index, cfg.process_count],
    }


def _post_group_worker(payload):
    """Runs in a worker process (numpy backend only — no jax import)."""
    from .backend import NumpyBackend
    gi, group, combo_meta, combo_codes, cfg, idx_to_seq, seq_to_idx = payload
    stats = PostprocessStats()
    writers = _MemWriters()
    _process_group(group, combo_meta, combo_codes, cfg, NumpyBackend(),
                   writers, idx_to_seq, seq_to_idx, stats)
    return gi, writers.blobs(), dataclasses.asdict(stats)


def _read_groups(path: str, group_size: int):
    """Groups of ``group_size`` records, each one's parse timed as the
    stage ``post_read`` under its group index."""
    records = read_fastx(path)
    gi = 0
    while True:
        with prof.current.stage("post_read", group=gi):
            group = list(itertools.islice(records, group_size))
        if not group:
            return
        yield group
        gi += 1


def run_postprocess(input_fasta: str, out_path: str, adapter_fasta: str,
                    index_fasta: str | None = None,
                    cfg: PostprocessConfig | None = None,
                    backend=None) -> PostprocessStats:
    """Adapter trim / reorient / demux over streamed read groups.

    ``cfg.threads > 1`` fans whole groups to spawn workers (the
    reference's chunked mp, C3POa_postprocessing.py:128-216) with
    in-order parent writes; ``cfg.resume`` continues an interrupted run
    byte-identically (the reference's PSL-cache role,
    C3POa_postprocessing.py:231).
    """
    cfg = cfg or PostprocessConfig()
    if backend is None:
        from .backend import NumpyBackend
        backend = NumpyBackend()
    profiler = prof.reset()

    # multi-host: this host works under out/host_<h>/ on its round-robin
    # share of the groups (reference parallelizes postprocessing too,
    # C3POa_postprocessing.py:128-216); host trees are written plain and
    # compressed (if asked) at merge, where spans interleave by group
    multihost = cfg.process_count > 1
    root_out = out_path
    final_compress = cfg.compress
    if multihost:
        out_path = os.path.join(out_path, f"host_{cfg.process_index}")
        cfg = dataclasses.replace(cfg, compress=False)
    os.makedirs(out_path, exist_ok=True)

    adapters = [(r.name, r.seq) for r in read_fastx(adapter_fasta)]
    combo_meta, combo_codes = [], []
    for name, seq in adapters:
        codes = encode(seq)
        combo_meta.append((name, "+", len(seq)))
        combo_codes.append(codes)
        combo_meta.append((name, "-", len(seq)))
        combo_codes.append(revcomp_encoded(codes))

    idx_to_seq: dict = {}
    seq_to_idx: dict = {}
    if index_fasta:
        for r in read_fastx(index_fasta):
            idx_to_seq[r.name] = r.seq
            seq_to_idx[r.seq] = r.name

    stats = PostprocessStats()
    key = _resume_key(input_fasta, adapter_fasta, index_fasta, cfg)
    manifest_path = os.path.join(out_path, MANIFEST)
    skip_groups = 0
    restore_sizes = None
    span_groups: list = []   # multihost: per-group cumulative file sizes
    if cfg.resume and not cfg.compress:
        if os.path.exists(manifest_path):
            try:
                m = json.load(open(manifest_path))
            except (OSError, ValueError):
                m = None
            if m and m.get("key") == key:
                skip_groups = m["groups_done"]
                restore_sizes = m["files"]
                span_groups = m.get("span_groups", [])
                for f, v in m["stats"].items():
                    setattr(stats, f, v)

    writers = _Writers(out_path, cfg.compress, restore_sizes)
    resumed = dataclasses.asdict(stats)
    progress = Progress("c3poa-postprocess")

    def mine(gi):
        """Does this host own 0-based group gi?"""
        return gi % cfg.process_count == cfg.process_index

    def checkpoint(gi):
        if not cfg.compress:
            sizes = writers.sizes()
            if multihost:
                span_groups.append({"gi": gi, "sizes": sizes})
            with open(manifest_path, "w") as fh:
                json.dump({"key": key, "groups_done": gi + 1,
                           "files": sizes,
                           "stats": dataclasses.asdict(stats),
                           "span_groups": span_groups}, fh)
            if (cfg.rss_restart_mb and gi + 1 > skip_groups
                    and rss_mb() > cfg.rss_restart_mb):
                raise RssRestartNeeded(
                    f"RSS {rss_mb()} MB > {cfg.rss_restart_mb} MB after "
                    f"group {gi}; exiting for a clean --resume restart")

    use_mp = cfg.threads > 1 and not getattr(backend, "supports_overlap",
                                             False)
    try:
        if use_mp:
            # fault-surfacing fan-out: worker exceptions and abrupt
            # worker deaths raise here instead of dropping groups
            from ..utils.procpool import imap_strict

            def payloads():
                for gi, group in enumerate(_read_groups(input_fasta,
                                                        cfg.group_size)):
                    if gi < skip_groups or not mine(gi):
                        continue
                    yield (gi, group, combo_meta, combo_codes, cfg,
                           idx_to_seq, seq_to_idx)

            for gi, blobs, wstats in imap_strict(_post_group_worker,
                                                 payloads(), cfg.threads,
                                                 label=lambda pl: pl[0]):
                for rel, text in blobs.items():
                    writers._open(*rel.split("/")).write(text)
                for f, v in wstats.items():
                    setattr(stats, f, getattr(stats, f) + v)
                progress.update(wstats["total"])
                with prof.current.stage("post_checkpoint", group=gi):
                    checkpoint(gi)
        else:
            for gi, group in enumerate(_read_groups(input_fasta,
                                                    cfg.group_size)):
                if gi < skip_groups or not mine(gi):
                    continue
                _process_group(group, combo_meta, combo_codes, cfg, backend,
                               writers, idx_to_seq, seq_to_idx, stats, gi)
                progress.update(len(group))
                with prof.current.stage("post_checkpoint", group=gi):
                    checkpoint(gi)
    finally:
        progress.close()
        writers.close()
    # this run's reads by outcome (a resumed run's earlier ones left out)
    for field, n in dataclasses.asdict(stats).items():
        profiler.count("post_reads" if field == "total" else "post_" + field,
                       n - resumed[field])
    profiler.dump(os.path.join(out_path, STATS))

    if multihost:
        from ..parallel import dist

        # the collective doubles as the completion barrier: when it
        # returns, every host has closed its output files
        totals = dist.allreduce_stats(dataclasses.asdict(stats))
        gstats = PostprocessStats(**totals)
        if cfg.process_index == 0:
            dist.merge_host_outputs(root_out, cfg.process_count,
                                    compress=final_compress,
                                    manifest=MANIFEST)
        return gstats
    return stats


def _process_group(group, combo_meta, combo_codes, cfg, backend, writers,
                   idx_to_seq, seq_to_idx, stats, gi=None):
    with prof.current.stage("post_encode", group=gi):
        enc = [encode(r.seq) for r in group]
    with prof.current.stage("adapter_hits", group=gi):
        res = backend.adapter_hits(enc, combo_codes,
                                   [m[2] for m in combo_meta])
    with prof.current.stage("post_demux", group=gi):
        if _demux(group, res, combo_meta, cfg, writers, idx_to_seq,
                  seq_to_idx, stats):
            prof.current.count("post_demux_native_groups")


def _demux(group, hits, combo_meta, cfg, writers, idx_to_seq, seq_to_idx,
           stats) -> bool:
    """Demux a group from its adapter hits (the backend's six (B, C)
    outputs): in one C call where it runs, else read by read in Python.
    Returns whether the C call did it."""
    if _demux_native(group, hits, combo_meta, cfg, writers, seq_to_idx,
                     stats):
        return True
    _demux_python(group, hits, combo_meta, cfg, writers, idx_to_seq,
                  seq_to_idx, stats)
    return False


def _demux_python(group, hits, combo_meta, cfg, writers, idx_to_seq,
                  seq_to_idx, stats):
    """The demux's spec, and its fallback: ``extract_hits`` and
    ``_process_read`` read by read."""
    s1, j1, qe1, ts1, qs1, s2 = hits
    for b, rec in enumerate(group):
        stats.total += 1
        read_hits = extract_hits(combo_meta, s1[b], j1[b], qe1[b], ts1[b],
                                 qs1[b], s2[b], cfg.score_min)
        _process_read(rec.name, rec.seq, read_hits, cfg, writers,
                      idx_to_seq, seq_to_idx, stats)


def _demux_native(group, hits, combo_meta, cfg, writers, seq_to_idx,
                  stats) -> bool:
    """The group in one C call (``native.post_demux_c``), writing the
    bytes ``_demux_python`` writes, file by file in input order.  False,
    with nothing written, where it does not run: no library or symbol, a
    sequence not ASCII, an index wider than the C DP row or an index
    named '-' (``match_index``'s no-match)."""
    if "-" in seq_to_idx.values():
        return False
    from .. import native
    ids: dict = {}
    combos = (np.array([m[1] == "+" for m in combo_meta], dtype=np.int8),
              np.array([m[2] for m in combo_meta], dtype=np.int64),
              np.array([ids.setdefault(m[0], len(ids)) for m in combo_meta],
                       dtype=np.int32),
              ids.get("5Prime_adapter", -1))
    # destinations by subdir name: indexes sharing a name (or named
    # no_index_found) share their files
    if seq_to_idx:
        subdirs = list(dict.fromkeys([*seq_to_idx.values(),
                                      "no_index_found"]))
        at = {x: d for d, x in enumerate(subdirs)}
        dest_of = np.array([at[x] for x in seq_to_idx.values()],
                           dtype=np.int32)
        noindex = at["no_index_found"]
    else:
        subdirs, dest_of, noindex = [None], np.zeros(0, dtype=np.int32), 0
    flags = bool(cfg.trim) | 2 * bool(cfg.undirectional) | \
        4 * bool(cfg.barcoded)
    # an integer score is > x exactly when it is > floor(x)
    score_min = math.floor(cfg.score_min)
    res = native.post_demux_c(
        [r.name for r in group], [r.seq for r in group], hits, combos,
        score_min, flags, tuple(seq_to_idx), dest_of, noindex,
        len(subdirs), _COMP_CHAR)
    if res is None:
        return False
    outcome, _chosen, texts = res
    for d, subdir in enumerate(subdirs):
        trio = texts[3 * d:3 * d + 3]
        if trio[0]:
            for fh, text in zip(writers.trio(subdir), trio):
                fh.write(text.decode("utf-8"))
    if texts[-2]:
        writers.tenx().write(texts[-2].decode("utf-8"))
    if texts[-1]:
        writers.mux().write(texts[-1].decode("utf-8"))
    n = np.bincount(outcome, minlength=5).tolist()
    stats.total += len(group)
    stats.written += n[0] + n[4]
    stats.no_adapter += n[1]
    stats.wrong_order += n[2]
    stats.no_direction += n[3]
    stats.no_index += n[4]
    return True
