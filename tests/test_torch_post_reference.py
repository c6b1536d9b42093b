"""The plain reference of the postprocess run
(``c3poa_tpu_torch/tools/plain_postprocess.py``) against the port on the
CPU: its adapter hits against ``TorchBackend("cpu")`` and the port's
numpy spec, two of its mutants that must differ, whole runs of
``run_postprocess`` against its records, and the run's stats file
(``.c3poa_post_stats.json``) with the output tree, the multi-host merge
and resume unchanged beside it."""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from c3poa_tpu import sim as jax_pkg_sim
from c3poa_tpu.pipeline.postprocess import PostprocessConfig as JaxPkgConfig
from c3poa_tpu.pipeline.postprocess import \
    run_postprocess as jax_pkg_run_postprocess
from c3poa_tpu_torch import sim
from c3poa_tpu_torch.pipeline import postprocess
from c3poa_tpu_torch.pipeline.backend import NumpyBackend
from c3poa_tpu_torch.pipeline.postprocess import (PostprocessConfig,
                                                  run_postprocess)
from c3poa_tpu_torch.pipeline.torch_backend import TorchBackend
from c3poa_tpu_torch.tools import plain_postprocess as P
from c3poa_tpu_torch.utils import encode

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADAPTERS = list(sim.DEFAULT_ADAPTERS.items())
INDEXES = [(f"Index{i}", sim.random_seq(np.random.default_rng(300 + i), 10))
           for i in range(1, 5)]


def hit_reads(seed=7):
    """Reads for the six arrays: consensus-like reads both ways, dimers,
    adapter pieces scoring around ``SCORE_MIN``, reads under 64 bases,
    junk, and a few N bases."""
    rng = np.random.default_rng(seed)
    a5, a3 = sim.DEFAULT_ADAPTERS["5Prime_adapter"], \
        sim.DEFAULT_ADAPTERS["3Prime_adapter"]
    reads = []
    for i in range(150):
        _n, s, _c = sim.make_consensus_like(
            rng, f"c{i}", cdna_len=int(rng.integers(40, 200)),
            index=INDEXES[i % 4][1], direction="+-"[i % 2],
            flank=(int(rng.integers(0, 30)), int(rng.integers(0, 30))),
            error=0.01 + 0.04 * (i % 3 == 0))
        reads.append(s)
    for i in range(12):                     # dimers, either adapter
        a = a5 if i % 2 else sim.revcomp(a3)
        reads.append(sim.random_seq(rng, 20) + a + a +
                     sim.random_seq(rng, int(rng.integers(30, 150))))
    for k in range(8, 15):                  # scores 8..14: near the limit
        for a in (a5, sim.revcomp(a5), a3, sim.revcomp(a3)):
            reads.append(sim.random_seq(rng, 60) + a[:k] +
                         sim.random_seq(rng, 60))
    for i in range(10):                     # under 64 bases
        n = int(rng.integers(1, 64))
        s = sim.random_seq(rng, n)
        if i % 2:
            s = (a5[:min(n, 30)] + s)[:n]
        reads.append(s)
    for i in range(12):                     # junk, some with N
        s = sim.random_seq(rng, int(rng.integers(80, 300)))
        if i % 3 == 0:
            s = s[:20] + "NNNN" + s[24:]
        reads.append(s)
    return reads


@pytest.fixture(scope="module")
def hits_case():
    reads = hit_reads()
    combos = P.combos_of(ADAPTERS)
    enc = [encode(s) for s in reads]
    codes = [c[3].numpy().astype(np.int8) for c in combos]
    lens = [c[2] for c in combos]
    want = NumpyBackend().adapter_hits(enc, codes, lens)
    return dict(reads=reads, combos=combos, enc=enc, codes=codes, lens=lens,
                numpy=want)


def as_numpy(hits):
    return [np.asarray(h, dtype=np.int64) for h in hits]


@pytest.mark.parametrize("backend", ["numpy", "torch_cpu"])
def test_reference_hits_equal_the_backends(hits_case, backend):
    c = hits_case
    assert len(c["reads"]) >= 200
    assert min(len(s) for s in c["reads"]) < 64
    got = as_numpy(P.adapter_hits(c["enc"], [x[3] for x in c["combos"]]))
    want = c["numpy"] if backend == "numpy" else \
        TorchBackend("cpu").adapter_hits(c["enc"], c["codes"], c["lens"])
    for g, w in zip(got, as_numpy(want)):
        assert g.shape == w.shape and np.array_equal(g, w)
    s1, s2 = got[0], got[5]
    # the cases are there: hits at the limit, dimers' second hits, misses
    assert ((s1 == P.SCORE_MIN) | (s1 == P.SCORE_MIN + 1)).any()
    assert (s2 > P.SCORE_MIN).any() and (s1 <= P.SCORE_MIN).any()


def mutant(old: str, new: str):
    """The reference with one edit to its source, as a module."""
    path = P.__file__
    src = open(path).read()
    assert src.count(old) == 1, old
    mod = types.ModuleType("plain_postprocess_mutant")
    exec(compile(src.replace(old, new), path, "exec"), mod.__dict__)
    return mod


@pytest.mark.parametrize("old,new", [
    ("OVERLAP_TOL = 4", "OVERLAP_TOL = 5"),
    ("cols, L).min(1)", "cols, -1).max(1)"),      # the last best column
])
def test_reference_mutants_differ(hits_case, old, new):
    c = hits_case
    m = mutant(old, new)
    got = as_numpy(m.adapter_hits(c["enc"], [x[3] for x in c["combos"]]))
    assert any(not np.array_equal(g, w) for g, w in zip(got, c["numpy"]))


def write_inputs(d, names, seqs, indexes=INDEXES):
    with open(os.path.join(d, "cons.fasta"), "w") as fh:
        for n, s in zip(names, seqs):
            fh.write(f">{n}\n{s}\n")
    sim.write_fasta(os.path.join(d, "adapters.fasta"), dict(ADAPTERS))
    sim.write_fasta(os.path.join(d, "indexes.fasta"), dict(indexes))


def sim_reads(n=200, seed=31):
    """``sim.make_consensus_like`` reads, both ways, with dimers and
    adapter-free reads among them."""
    rng = np.random.default_rng(seed)
    names, seqs = [], []
    a5 = sim.DEFAULT_ADAPTERS["5Prime_adapter"]
    for i in range(n):
        if i % 25 == 3:
            s = a5 + a5 + sim.random_seq(rng, 200)
        elif i % 25 == 7:
            s = sim.random_seq(rng, 300)
        else:
            _n, s, _c = sim.make_consensus_like(
                rng, f"r{i}", cdna_len=int(rng.integers(100, 300)),
                index=INDEXES[i % 4][1] if i % 10 else None,
                direction="+-"[i % 2], flank=(30, 40))
        names.append(f"r{i}")
        seqs.append(s)
    return names, seqs


def entry_reads(n=200, seed=2 ** 31 + 3):
    """The benchmark entry's reads (``h100_bench/entries/postprocess.py``)
    at inserts of 100-300 bases."""
    sys.path.insert(0, ROOT)
    try:
        from h100_bench import gen
        from h100_bench.entries.postprocess import make_reads
    finally:
        sys.path.remove(ROOT)
    with open(os.path.join(ROOT, "h100_bench", "configs",
                           "r2c2_cdna_post.json")) as fh:
        cfg = json.load(fh)
    with open(os.path.join(ROOT, "h100_bench", "traffic", "post.json")) as fh:
        mix = json.load(fh)
    cfg["read_shape"]["insert_len"] = [100, 300]
    mix["reads"] = n
    r = make_reads(cfg, mix, gen.make_pool(cfg, mix, seed), seed)
    assert set(r["cls"].tolist()) == {0, 1, 2}
    return r["names"], r["seqs"], r["indexes"]


def tree(out, dotted=False):
    found = {}
    for d, dirs, files in os.walk(out):
        dirs[:] = [x for x in dirs if not x.startswith("host_")]
        for f in files:
            if f.startswith(".") != dotted:
                continue
            p = os.path.join(d, f)
            found[os.path.relpath(p, out)] = open(p).read()
    return found


@pytest.mark.parametrize("source", ["sim", "entry"])
def test_run_postprocess_records_equal_the_reference(tmp_path, source):
    if source == "sim":
        names, seqs = sim_reads()
        indexes = INDEXES
    else:
        names, seqs, indexes = entry_reads()
    d = str(tmp_path)
    write_inputs(d, names, seqs, indexes)
    stats = run_postprocess(os.path.join(d, "cons.fasta"),
                            os.path.join(d, "out"),
                            os.path.join(d, "adapters.fasta"),
                            os.path.join(d, "indexes.fasta"),
                            PostprocessConfig(trim=True, group_size=64),
                            TorchBackend("cpu"))
    files, outcomes = P.postprocess(list(zip(names, seqs)), ADAPTERS,
                                    indexes, trim=True)
    assert tree(os.path.join(d, "out")) == files
    # every group took the C demux
    with open(os.path.join(d, "out", postprocess.STATS)) as fh:
        counters = json.load(fh)["counters"]
    assert counters["post_demux_native_groups"] == -(-len(seqs) // 64)
    assert (stats.total, stats.written, stats.no_adapter) == \
        (len(seqs), outcomes["written"], outcomes["no_adapter"])
    assert outcomes["no_adapter"] >= 4 and \
        P.NO_INDEX + "/" + P.FLC in files and len(files) > 10


def small_inputs(d, n=27):
    """tests/test_torch_postprocess.py's inputs, through the JAX
    package's simulator so both runs read one file."""
    rng = np.random.default_rng(21)
    with open(os.path.join(d, "cons.fasta"), "w") as fh:
        for i in range(n):
            name, seq, _ = jax_pkg_sim.make_consensus_like(
                rng, f"c_{i}", cdna_len=400, index=INDEXES[i % 4][1],
                direction="+" if i % 2 == 0 else "-", error=0.01)
            fh.write(f">{name}\n{seq}\n")
    sim.write_fasta(os.path.join(d, "adapters.fasta"), dict(ADAPTERS))
    sim.write_fasta(os.path.join(d, "indexes.fasta"), dict(INDEXES))
    return [os.path.join(d, f) for f in ("cons.fasta", "adapters.fasta",
                                         "indexes.fasta")]


def test_stats_file_stages_and_counters(tmp_path):
    d = str(tmp_path)
    names, seqs = sim_reads(60, seed=5)
    write_inputs(d, names, seqs)
    out = os.path.join(d, "out")
    stats = run_postprocess(os.path.join(d, "cons.fasta"), out,
                            os.path.join(d, "adapters.fasta"),
                            os.path.join(d, "indexes.fasta"),
                            PostprocessConfig(trim=True, group_size=16),
                            TorchBackend("cpu"))
    with open(os.path.join(out, postprocess.STATS)) as fh:
        st = json.load(fh)
    assert {"post_read", "post_encode", "adapter_hits", "post_demux",
            "post_checkpoint", "adapter_dispatch",
            "adapter_wait"} <= set(st["stages_s"])
    # one span a group on the calling thread
    assert set(st["threads"]) == {"MainThread"}
    c = st["counters"]
    assert c["post_reads"] == stats.total == 60
    assert c["post_demux_native_groups"] == 4     # every group, in C
    assert c["post_reads"] == c["post_written"] + c["post_no_adapter"] + \
        c["post_wrong_order"] + c["post_no_direction"]
    assert c["post_written"] == stats.written and \
        c["post_no_adapter"] == stats.no_adapter
    no_index = tree(out)[P.NO_INDEX + "/" + P.FLC].count(">")
    assert c["post_no_index"] == no_index > 0
    rows = sum(len(s) for _n, s in ADAPTERS) * 2
    assert c["adapter_read_columns"] == sum(len(s) for s in seqs)
    assert c["adapter_cells_real"] == sum(len(s) for s in seqs) * rows
    assert c["adapter_cells_padded"] >= c["adapter_cells_real"]
    assert c["adapter_launches"] == 4 and "adapter_host_reads" not in c


def test_tree_unchanged_with_the_stats_file(tmp_path):
    files = small_inputs(str(tmp_path))
    cfg = dict(trim=True, group_size=7)
    run_postprocess(*files[:1], out_path=str(tmp_path / "torch"),
                    adapter_fasta=files[1], index_fasta=files[2],
                    cfg=PostprocessConfig(**cfg), backend=TorchBackend("cpu"))
    jax_pkg_run_postprocess(*files[:1], out_path=str(tmp_path / "numpy"),
                            adapter_fasta=files[1], index_fasta=files[2],
                            cfg=JaxPkgConfig(**cfg))
    got, want = tree(tmp_path / "torch"), tree(tmp_path / "numpy")
    assert got and got == want
    assert set(tree(tmp_path / "torch", dotted=True)) == \
        {postprocess.MANIFEST, postprocess.STATS}
    assert set(tree(tmp_path / "numpy", dotted=True)) == \
        {postprocess.MANIFEST}


def test_merge_and_resume_leave_the_stats_file_out(tmp_path):
    """Two hosts run in turn in one process (host 1 first; host 0 then
    merges): the merged tree equals one host's, each host keeps its own
    stats file and the merge writes none; a resumed run that finds every
    group done leaves the tree as it was and counts no read."""
    files = small_inputs(str(tmp_path))
    kw = dict(adapter_fasta=files[1], index_fasta=files[2])
    one = str(tmp_path / "one")
    run_postprocess(files[0], one, cfg=PostprocessConfig(
        trim=True, group_size=5, resume=True), backend=TorchBackend("cpu"),
        **kw)
    two = str(tmp_path / "two")
    for h in (1, 0):
        run_postprocess(files[0], two, cfg=PostprocessConfig(
            trim=True, group_size=5, process_index=h, process_count=2),
            backend=TorchBackend("cpu"), **kw)
    assert tree(two) == tree(one)
    assert postprocess.STATS not in os.listdir(two)
    counts = []
    for h in (0, 1):
        with open(os.path.join(two, f"host_{h}", postprocess.STATS)) as fh:
            counts.append(json.load(fh)["counters"]["post_reads"])
    assert sum(counts) == 27 and min(counts) > 0
    before = tree(one)
    run_postprocess(files[0], one, cfg=PostprocessConfig(
        trim=True, group_size=5, resume=True), backend=TorchBackend("cpu"),
        **kw)
    assert tree(one) == before
    with open(os.path.join(one, postprocess.STATS)) as fh:
        st = json.load(fh)
    assert st["counters"].get("post_reads", 0) == 0
