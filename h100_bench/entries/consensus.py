"""The consensus entry: what the window of a consensus cell drives.

``c3poa_tpu_torch.pipeline.run.run_pipeline(reads, splint, out,
PipelineConfig(<the configuration's CLI settings>), backend)`` with the
port's ``TorchBackend``, called back to back on one pool file until the
window's seconds have passed: ``run_pipeline`` opens its input twice (a
format probe, then the reads), so it cannot take a stream.  Each call's
reads and time count whole; the window runs from the first call's start
to the last call's end.  Every call pays its pipeline's fill and drain
(one locate before the first align, the last group's vote after the last
align).

The window's end-to-end value (``reads_per_s``) comes back by name.

The backend is wrapped, not changed: ``Recorder`` times each
``locate_many`` and ``align_many`` call (the harness's spans) and keeps
the answers the check needs: every call's locate answers (small), and in
one call drawn from the seed (a reservoir over the calls) the score and
end column of every alignment, the whole records of the sampled reads'
alignments, and the output files.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time


from h100_bench import gen
from h100_bench.reference import check as ref_check


class Recorder:
    """The program's backend, with spans and the answers kept."""

    supports_overlap = True

    def __init__(self, inner, pool, group_size: int, align_reads):
        self.inner = inner
        self.pool = pool
        self.group_size = group_size
        self.align_reads = set(align_reads)
        self.spans: list = []          # (layer, t0, t1)
        self.locate: list = []         # per call: {pool idx: answer}
        self.align: dict = {}          # chosen call: sampled reads' records
        self.ends: dict = {}           # chosen call: every pair's ends
        self._lock = threading.Lock()
        self._groups = 0
        self._ids: dict = {}
        self.capture = False

    def start_call(self, capture: bool):
        self._groups = 0
        self._ids = {}
        self.capture = capture
        if capture:
            self.align = {}
            self.ends = {}
        self.locate.append({})

    def locate_many(self, reads, combos, min_dist):
        t0 = time.perf_counter()
        out = self.inner.locate_many(reads, combos, min_dist)
        t1 = time.perf_counter()
        base = self._groups * self.group_size
        self._groups += 1
        answers = self.locate[-1]
        ids = {}
        for r, (codes, res) in enumerate(zip(reads, out)):
            i = base + r
            if len(codes) != len(self.pool.seqs[i]):
                raise RuntimeError(f"locate call {self._groups}: read {r} "
                                   f"is not pool read {i}")
            answers[i] = (res.combo, res.score, res.peaks)
            if self.capture:
                ids[id(codes)] = (i, codes.ctypes.data)
        if ids:
            with self._lock:
                self._ids.update(ids)
        self.spans.append(("locate", t0, t1))
        return out

    def align_many(self, pairs, params, phase_base: int = 0):
        t0 = time.perf_counter()
        out = self.inner.align_many(pairs, params, phase_base)
        t1 = time.perf_counter()
        if self.capture and self._ids:
            with self._lock:
                ids = dict(self._ids)
            for pr, a in zip(pairs, out):
                q, t = pr[0], pr[2]
                codes = q.base
                hit = ids.get(id(codes))
                if hit is None or t.base is not codes \
                        or codes.ctypes.data != hit[1]:
                    continue
                i = hit[0]
                qa = q.ctypes.data - hit[1]
                ta = t.ctypes.data - hit[1]
                key = (i, qa, qa + len(q), ta, ta + len(t))
                rec = a.rec
                self.ends[key] = (int(rec.score), int(rec.j_end))
                if i in self.align_reads:
                    self.align[key] = dict(
                        cover=rec.cover.copy(), base=rec.base.copy(),
                        qpos=rec.qpos.copy(), ins_len=rec.ins_len.copy(),
                        ins_qstart=rec.ins_qstart.copy(),
                        j_start=int(rec.j_start), j_end=int(rec.j_end),
                        score=int(rec.score))
        self.spans.append(("align", t0, t1))
        return out


class Entry:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cli = ctx.config["cli"]

    def setup(self, backend):
        """Writes the pool, builds the pipeline's configuration, and warms
        up on a small group of the cell's own shapes."""
        from c3poa_tpu_torch.pipeline.run import PipelineConfig, run_pipeline
        self._run_pipeline = run_pipeline
        ctx, pool = self.ctx, self.ctx.pool
        self.files = gen.write_inputs(pool, os.path.join(ctx.work, "input"))
        self.cfg = PipelineConfig(
            lencutoff=self.cli["lencutoff"],
            mdistcutoff=self.cli["mdistcutoff"], zero=self.cli["zero"],
            group_size=self.cli["group_size"])
        rng = gen.rng_for(ctx.seed, 3)
        chk = ctx.mix["check"]
        n = len(pool.seqs)
        self.align_reads = sorted(rng.choice(
            n, min(n, chk["align_reads"]), replace=False).tolist())
        self.cons_reads = sorted(rng.choice(
            n, min(n, chk["cons_reads"]), replace=False).tolist())
        self.sample_rng = rng
        self.recorder = Recorder(backend, pool, self.cfg.group_size,
                                 self.align_reads)
        warm = range(min(n, ctx.mix["warm_reads"]))
        warm_dir = os.path.join(ctx.work, "warm")
        os.makedirs(warm_dir, exist_ok=True)
        warm_reads = os.path.join(warm_dir, "reads.fastq")
        pool.write_fastq(warm_reads, warm)
        run_pipeline(warm_reads, self.files["splint"],
                     os.path.join(warm_dir, "out"), self.cfg, backend)
        shutil.rmtree(warm_dir)

    def window(self, seconds: float, sync) -> dict:
        """Back-to-back calls until ``seconds`` have passed; returns the
        end-to-end values by name, the reads, the window's bounds and the
        calls' summed stages and counters (``c3poa_stats.json``)."""
        ctx = self.ctx
        rng = gen.rng_for(ctx.seed, 4)
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
            stats = self._run_pipeline(self.files["reads"],
                                       self.files["splint"], out, self.cfg,
                                       self.recorder)
            reads += stats.total_reads + stats.short_reads
            with open(os.path.join(out, "c3poa_stats.json")) as fh:
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
        """The numbers compared (see ``reference/check.py``)."""
        pool = self.ctx.pool
        splint = next(iter(pool.splints))
        outputs = dict(
            subreads=ref_check.read_subreads(
                os.path.join(self.chosen, splint, "R2C2_Subreads.fastq")),
            consensus=ref_check.read_consensus(
                os.path.join(self.chosen, splint, "R2C2_Consensus.fasta")))
        shutil.rmtree(self.chosen)
        sample = dict(align_reads=self.align_reads,
                      align_pairs=self.ctx.mix["check"]["align_pairs"],
                      record_reads=range(len(pool.seqs)),
                      cons_reads=self.cons_reads, rng=self.sample_rng)
        return ref_check.check_consensus(
            pool, self.cli, self.ctx.config["align"],
            dict(locate=self.recorder.locate, align=self.recorder.align,
                 ends=self.recorder.ends),
            outputs, sample, procs)

    def close(self):
        """Lets go of the program's backend (the answers stay)."""
        self.recorder.inner = None
