"""The postprocess entry: what the window of a postprocess cell drives.

``c3poa_tpu_torch.pipeline.postprocess.run_postprocess(reads.fasta, out,
adapters.fasta, indexes.fasta, PostprocessConfig(<the configuration's
CLI settings>), backend)`` with the port's ``TorchBackend``, called back
to back on one FASTA of consensus reads until the window's seconds have
passed.  Each call's reads and time count whole; the window runs from the
first call's start to the last call's end.

The reads (``make_reads``) are built from the pool of ``gen.make_pool``
(the ``r2c2`` kind at zero copies): each pool read gives its insert (the
cDNA, ``truth``) and its strand; the rest is drawn from the run's seed:
``[90 random][5' adapter][cDNA][rc(3 nt + index + 3 nt)][rc(3' adapter)]
[110 random]``, the adapters with the configuration's error, the whole
reverse complemented on strand '-'.  A share of the reads lacks the 3'
adapter, another carries a random 16-mer in place of the index block;
the rest carry one of the configuration's indexes, drawn uniformly.

The window's end-to-end value (``reads_per_s``) comes back by name; it
reads nothing the program writes besides its return value.  The stages
and counters come from each call's ``.c3poa_post_stats.json`` where the
program writes one.

The backend is wrapped, not changed: ``Recorder`` times each
``adapter_hits`` call (the harness's span ``adapter``) and, in one call
drawn from the seed (a reservoir over the calls), keeps the six outputs
of the sampled reads.  That call's output tree is kept for the check
(``check``, against ``reference/post.py``).
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np

from h100_bench import gen
from h100_bench.reference import post as ref_post

CLASSES = ("well_formed", "no_3prime_adapter", "no_index")
STATS = ".c3poa_post_stats.json"


def draw_indexes(rng, count: int, length: int, min_dist: int) -> list:
    """[(name, seq)]: ``count`` random indexes of ``length`` bases, each
    at least ``min_dist`` edits from every other."""
    out: list = []
    while len(out) < count:
        seq = gen.decode(rng.integers(0, 4, length, dtype=np.int8)).decode()
        if all(ref_post.levenshtein_windows(seq, s)[0] >= min_dist
               for _n, s in out):
            out.append((f"Index{len(out) + 1}", seq))
    return out


def make_reads(config: dict, mix: dict, pool, seed: int) -> dict:
    """The cell's consensus reads from the pool: ``names``, ``seqs``
    (str), ``cls`` (index into CLASSES), ``index`` (the index number each
    read carries, -1 for none) and ``indexes`` ([(name, seq)])."""
    rng = gen.rng_for(seed, 6)
    n = len(pool.seqs)
    ix = config["indexes"]
    indexes = draw_indexes(rng, int(ix["count"]), int(ix["length"]),
                           int(ix["min_edit_distance"]))
    shares = mix["shares"]
    n_noad = int(round(shares["no_3prime_adapter"] * n))
    n_noix = int(round(shares["no_index"] * n))
    cls = np.zeros(n, dtype=np.int64)
    perm = rng.permutation(n)
    cls[perm[:n_noad]] = 1
    cls[perm[n_noad:n_noad + n_noix]] = 2
    index = np.where(cls == 2, -1, rng.integers(0, len(indexes), n))
    a5 = np.frombuffer(config["adapters"]["5Prime_adapter"].encode(),
                       dtype=np.uint8)
    a3 = np.frombuffer(config["adapters"]["3Prime_adapter"].encode(),
                       dtype=np.uint8)
    enc = np.full(256, 4, dtype=np.int8)
    for k, b in enumerate(b"ACGT"):
        enc[b] = k
    a5, a3rc = enc[a5], gen.revcomp(enc[a3])
    idx_codes = [enc[np.frombuffer(s.encode(), dtype=np.uint8)]
                 for _n, s in indexes]
    # every read's adapters, mutated in one call: 5' then rc(3') where it
    # has one
    parts = []
    for i in range(n):
        parts.append(a5)
        if cls[i] != 1:
            parts.append(a3rc)
    lens = np.array([len(p) for p in parts])
    mutated, out_pos = gen.mutate_many(rng, np.concatenate(parts),
                                       float(config["consensus_error"]))
    ends = np.cumsum(lens)
    starts = ends - lens
    f5, f3 = (int(x) for x in config["flanks"])
    w = f5 + f3 + 22        # the flanks, then 16 bases for the index block
    rand = rng.integers(0, 4, n * w, dtype=np.int8)
    seqs = []
    k = 0
    for i in range(n):
        r = rand[i * w:(i + 1) * w]
        left, right = r[:f5], r[f5:f5 + f3]
        pad = r[f5 + f3:]
        if cls[i] == 2:
            block = pad[:16]
        else:
            block = gen.revcomp(np.concatenate(
                [pad[:3], idx_codes[index[i]], pad[3:6]]))
        five = mutated[out_pos[starts[k]]:out_pos[ends[k]]]
        k += 1
        three = np.zeros(0, dtype=np.int8)
        if cls[i] != 1:
            three = mutated[out_pos[starts[k]]:out_pos[ends[k]]]
            k += 1
        s = np.concatenate([left, five, pool.truth[i], block, three, right])
        if pool.strand[i] == "-":
            s = gen.revcomp(s)
        seqs.append(gen.decode(s).decode())
    return dict(names=list(pool.names), seqs=seqs, cls=cls, index=index,
                indexes=indexes)


def sample_reads(rng, cls: np.ndarray, group: int, quota: dict) -> list:
    """Pool indices: ``quota[c]`` reads of each class, spread evenly over
    the groups (each class's reads ordered by group, then by a random
    key, and taken at even steps from a random offset)."""
    picked = []
    for c, name in enumerate(CLASSES):
        members = np.flatnonzero(cls == c)
        q = min(int(quota[name]), len(members))
        if not q:
            continue
        members = members[np.lexsort((rng.random(len(members)),
                                      members // group))]
        step = len(members) / q
        at = (rng.random() * step + step * np.arange(q)).astype(np.int64)
        picked += members[np.minimum(at, len(members) - 1)].tolist()
    return sorted(set(picked))


class Recorder:
    """The program's backend, with spans and the sampled answers kept."""

    supports_overlap = True

    def __init__(self, inner, lens, group_size: int, sample):
        self.inner = inner
        self.lens = lens
        self.group_size = group_size
        self.sample = set(sample)
        self.spans: list = []          # (layer, t0, t1)
        self.hits: dict = {}           # chosen call: pool idx -> six (C,)
        self.capture = False
        self._groups = 0

    def start_call(self, capture: bool):
        self._groups = 0
        self.capture = capture
        if capture:
            self.hits = {}

    def adapter_hits(self, reads, combo_codes, combo_lens):
        t0 = time.perf_counter()
        out = self.inner.adapter_hits(reads, combo_codes, combo_lens)
        t1 = time.perf_counter()
        base = self._groups * self.group_size
        self._groups += 1
        if self.capture:
            for r, codes in enumerate(reads):
                i = base + r
                if len(codes) != self.lens[i]:
                    raise RuntimeError(f"adapter call {self._groups}: read "
                                       f"{r} is not pool read {i}")
                if i in self.sample:
                    self.hits[i] = [np.array(o[r], dtype=np.int64)
                                    for o in out]
        self.spans.append(("adapter", t0, t1))
        return out


def write_fasta(path: str, records) -> None:
    with open(path, "w") as fh:
        for name, seq in records:
            fh.write(f">{name}\n{seq}\n")


def read_tree(out: str) -> dict:
    """Every record the run wrote: {read name: [(file, text)]}, the
    FASTA records as ``>name_len\\nseq\\n``, the mux lines whole."""
    found: dict = {}
    for d, dirs, files in os.walk(out):
        dirs.sort()
        for f in sorted(files):
            if f.startswith("."):
                continue
            rel = os.path.relpath(os.path.join(d, f), out)
            with open(os.path.join(d, f)) as fh:
                text = fh.read()
            if f.endswith(".tsv"):
                for line in text.splitlines(keepends=True):
                    found.setdefault(line.split("\t", 1)[0], []).append(
                        (rel, line))
                continue
            lines = text.split("\n")
            for k in range(0, len(lines) - 1, 2):
                name = lines[k][1:].rsplit("_", 1)[0]
                found.setdefault(name, []).append(
                    (rel, lines[k] + "\n" + lines[k + 1] + "\n"))
    return found


class Entry:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cli = ctx.config["cli"]

    def setup(self, backend):
        """Builds and writes the reads, the adapters and the indexes,
        draws the check's sample, and warms up on the first reads."""
        from c3poa_tpu_torch.pipeline.postprocess import (PostprocessConfig,
                                                          run_postprocess)
        self._run = run_postprocess
        ctx, pool = self.ctx, self.ctx.pool
        self.reads = make_reads(ctx.config, ctx.mix, pool, ctx.seed)
        indexes = list(self.reads["indexes"])
        swap = getattr(ctx, "swap_index_names", None)
        if swap:
            # a control's fault: two index names swapped in the file
            a, b = swap
            (na, sa), (nb, sb) = indexes[a], indexes[b]
            indexes[a], indexes[b] = (nb, sa), (na, sb)
        self.index_file = indexes
        d = os.path.join(ctx.work, "input")
        os.makedirs(d, exist_ok=True)
        self.files = {k: os.path.join(d, k + ".fasta")
                      for k in ("reads", "adapters", "indexes")}
        names, seqs = self.reads["names"], self.reads["seqs"]
        write_fasta(self.files["reads"], zip(names, seqs))
        write_fasta(self.files["adapters"], ctx.config["adapters"].items())
        write_fasta(self.files["indexes"], indexes)
        self.cfg = PostprocessConfig(
            trim=self.cli["trim"], undirectional=self.cli["undirectional"],
            barcoded=self.cli["barcoded"], group_size=self.cli["group_size"])
        rng = gen.rng_for(ctx.seed, 7)
        self.sample = sample_reads(rng, self.reads["cls"],
                                   self.cfg.group_size,
                                   ctx.mix["check"]["hit_reads"])
        self.recorder = Recorder(backend, [len(s) for s in seqs],
                                 self.cfg.group_size, self.sample)
        warm = os.path.join(ctx.work, "warm")
        os.makedirs(warm, exist_ok=True)
        n_warm = min(len(seqs), int(ctx.mix["warm_reads"]))
        write_fasta(os.path.join(warm, "reads.fasta"),
                    zip(names[:n_warm], seqs[:n_warm]))
        run_postprocess(os.path.join(warm, "reads.fasta"),
                        os.path.join(warm, "out"), self.files["adapters"],
                        self.files["indexes"], self.cfg, backend)
        shutil.rmtree(warm)

    def window(self, seconds: float, sync) -> dict:
        """Back-to-back calls until ``seconds`` have passed; returns the
        end-to-end values by name, the reads, the window's bounds and the
        calls' summed stages and counters."""
        ctx = self.ctx
        rng = gen.rng_for(ctx.seed, 8)
        stages: dict = {}
        counters: dict = {}
        reads = calls = 0
        chosen = None
        sync()
        t0 = time.perf_counter()
        while True:
            out = os.path.join(ctx.work, f"out{calls}")
            capture = rng.random() < 1.0 / (calls + 1)
            self.recorder.start_call(capture)
            stats = self._run(self.files["reads"], out,
                              self.files["adapters"], self.files["indexes"],
                              self.cfg, self.recorder)
            reads += stats.total
            path = os.path.join(out, STATS)
            if os.path.exists(path):
                with open(path) as fh:
                    st = json.load(fh)
                for k, v in st["stages_s"].items():
                    stages[k] = stages.get(k, 0.0) + v
                for k, v in st["counters"].items():
                    counters[k] = counters.get(k, 0) + v
            if capture:
                if chosen is not None:
                    shutil.rmtree(chosen)
                chosen = out
            else:
                shutil.rmtree(out)
            calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        t1 = time.perf_counter()
        self.chosen = chosen
        return dict(values=dict(reads_per_s=reads / (t1 - t0)),
                    reads=reads, calls=calls, t0=t0, t1=t1,
                    stages=stages, counters=counters,
                    attempted=reads, failed=0)

    def check(self, procs: int) -> dict:
        """The numbers compared, each against the plain reference
        (``reference/post.py``) or the generator's truth:

        - ``hits_diff``: (read, combo) pairs of the sampled reads whose
          six outputs in the chosen call differ from the reference's, or
          that the program never produced.  Limit 0.
        - ``records_diff``: sampled reads whose records (every file, name
          and sequence, the splint files, the mux line) differ from those
          the reference writes from its own hits.  Limit 0.
        - ``wrong_index_pct``: of the chosen call's written reads, those
          filed under an index other than the one generated into them,
          in percent (a read generated without one counts under any
          index).  Its limit is the cell's.

        ``procs`` is unused: the reference runs batched in this
        process."""
        del procs
        found = read_tree(self.chosen)
        shutil.rmtree(self.chosen)
        reads = self.reads
        combos = ref_post.combos_of(list(self.ctx.config["adapters"].items()))
        sample = self.sample
        want = ref_post.adapter_hits(
            [ref_post.encode(reads["seqs"][i]) for i in sample],
            [c[3] for c in combos])
        hits_bad = 0
        rec_bad = 0
        for r, i in enumerate(sample):
            got = self.recorder.hits.get(i)
            row = [w[r] for w in want]
            for c in range(len(combos)):
                if got is None or any(int(g[c]) != int(w[c])
                                      for g, w in zip(got, row)):
                    hits_bad += 1
            _outcome, writes = ref_post.read_records(
                reads["names"][i], reads["seqs"][i],
                ref_post.hits_of(combos, row), self.index_file,
                self.cli["trim"], self.cli["undirectional"],
                self.cli["barcoded"])
            if sorted(writes) != sorted(found.get(reads["names"][i], [])):
                rec_bad += 1
        index_names = {n for n, _s in self.index_file}
        pool_idx = {n: k for k, n in enumerate(reads["names"])}
        written = wrong = no_index = 0
        for name, recs in found.items():
            dirs = {f.split("/", 1)[0] for f, _t in recs
                    if f.endswith(ref_post.FLC)}
            if not dirs:
                continue
            written += 1
            d = dirs.pop()
            k = reads["index"][pool_idx[name]]
            if d == ref_post.NO_INDEX:
                no_index += 1
            elif d in index_names and (k < 0 or
                                       d != reads["indexes"][k][0]):
                wrong += 1
        return dict(
            hits_diff=hits_bad, records_diff=rec_bad,
            wrong_index_pct=100.0 * wrong / max(written, 1),
            parts=dict(hit_reads=len(sample),
                       hit_pairs=len(sample) * len(combos),
                       hits_recorded=len(self.recorder.hits),
                       written=written, wrong_index=wrong,
                       no_index_found=no_index))

    def close(self):
        """Lets go of the program's backend (the answers stay)."""
        self.recorder.inner = None
