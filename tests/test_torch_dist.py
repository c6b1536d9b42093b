"""Multi-process runs of the port on the CPU (``c3poa_tpu_torch/parallel/
dist.py``): the original's unit tests on the port's copies, each copied
helper against ``c3poa_tpu.parallel.dist``, a two-process all-reduce, and
two-process runs of both port CLIs (gloo over localhost), each merged
tree byte-identical to one process and to the JAX package's numpy CLI."""

import gzip
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from c3poa_tpu import cli as jax_pkg_cli
from c3poa_tpu import cli_postprocess as jax_pkg_cli_postprocess
from c3poa_tpu.parallel import dist as jax_pkg_dist
from c3poa_tpu.pipeline import postprocess as jax_pkg_postprocess
from c3poa_tpu.pipeline import run as jax_pkg_run
from c3poa_tpu_torch import cli, cli_postprocess, sim
from c3poa_tpu_torch.parallel import dist
from c3poa_tpu_torch.parallel.dist import (allreduce_stats, host_shard_groups,
                                           merge_host_outputs)
from c3poa_tpu_torch.pipeline import postprocess
from c3poa_tpu_torch.pipeline.run import MANIFEST

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# seconds a process of a two-process run may take before it is killed
PROC_TIMEOUT = 240


# ---- tests/test_dist.py:19-77 on the port's copies ----

def test_host_shard_groups_round_robin():
    groups = [[i] for i in range(10)]
    got0 = list(host_shard_groups(iter(groups), 0, 3))
    got1 = list(host_shard_groups(iter(groups), 1, 3))
    got2 = list(host_shard_groups(iter(groups), 2, 3))
    assert [g for g, _ in got0] == [0, 3, 6, 9]
    assert [g for g, _ in got1] == [1, 4, 7]
    assert [g for g, _ in got2] == [2, 5, 8]
    all_groups = sorted(got0 + got1 + got2)
    assert [g for g, _ in all_groups] == list(range(10))


def test_allreduce_stats_single_process():
    assert allreduce_stats({"a": 3, "b": 5}) == {"a": 3, "b": 5}


def _write_host(tmp_path, h, groups, manifest=MANIFEST):
    """groups: list of (gi, {relfile: text_to_append})."""
    d = tmp_path / f"host_{h}"
    os.makedirs(d, exist_ok=True)
    sizes: dict = {}
    span_groups = []
    for gi, files in groups:
        for rel, text in files.items():
            p = d / rel
            os.makedirs(os.path.dirname(p), exist_ok=True)
            with open(p, "a") as fh:
                fh.write(text)
            sizes[rel] = os.path.getsize(p)
        span_groups.append({"gi": gi, "sizes": dict(sizes)})
    with open(d / manifest, "w") as fh:
        json.dump({"key": {}, "groups_done": groups[-1][0],
                   "files": sizes, "stats": {},
                   "span_groups": span_groups}, fh)


def test_merge_host_outputs_interleaves_by_group(tmp_path):
    """Round-robin over 2 hosts with 2 groups each: merged record order
    must be group order 1,2,3,4 — not host-major 1,3,2,4."""
    rel = "Splint1/R2C2_Consensus.fasta"
    _write_host(tmp_path, 0, [(1, {rel: ">g1\nAA\n"}),
                              (3, {rel: ">g3\nCC\n"})])
    _write_host(tmp_path, 1, [(2, {rel: ">g2\nGG\n"}),
                              (4, {rel: ">g4\nTT\n"})])
    merge_host_outputs(str(tmp_path), 2)
    got = (tmp_path / rel).read_text()
    assert got == ">g1\nAA\n>g2\nGG\n>g3\nCC\n>g4\nTT\n"


def test_merge_host_outputs_lazy_files(tmp_path):
    """Files that only some hosts/groups touch merge correctly (a splint
    seen only by host 1, a subread file appearing late)."""
    a = "S1/R2C2_Consensus.fasta"
    b = "S2/R2C2_Consensus.fasta"
    _write_host(tmp_path, 0, [(1, {a: "r1\n"}), (3, {a: "r3\n"})])
    _write_host(tmp_path, 1, [(2, {b: "x2\n"}), (4, {a: "r4\n", b: "x4\n"})])
    merge_host_outputs(str(tmp_path), 2)
    assert (tmp_path / a).read_text() == "r1\nr3\nr4\n"
    assert (tmp_path / b).read_text() == "x2\nx4\n"


# ---- each copied helper against its original ----

def test_manifest_names_match_originals():
    assert MANIFEST == jax_pkg_run.MANIFEST == jax_pkg_dist.MANIFEST
    assert postprocess.MANIFEST == jax_pkg_postprocess.MANIFEST


@pytest.mark.parametrize("n_groups,count", [(0, 2), (1, 3), (7, 2), (10, 3),
                                            (5, 8)])
def test_host_shard_groups_matches_original(n_groups, count):
    groups = [[f"r{i}"] for i in range(n_groups)]
    for h in range(count):
        assert list(host_shard_groups(iter(groups), h, count)) == \
            list(jax_pkg_dist.host_shard_groups(iter(groups), h, count))


def _three_hosts(tmp_path, manifest):
    """Three hosts, round-robin groups 1..7, files that appear late, a
    .tsv, and a host with a group that wrote nothing."""
    a, b, t = "S1/R2C2_Consensus.fasta", "S2/R2C2_Subreads.fastq", "m.tsv"
    _write_host(tmp_path, 0, [(1, {a: "a1\n", t: "t1\n"}), (4, {}),
                              (7, {a: "a7\n", b: "b7\n"})], manifest)
    _write_host(tmp_path, 1, [(2, {b: "b2\n"}), (5, {a: "a5\n", t: "t5\n"})],
                manifest)
    _write_host(tmp_path, 2, [(3, {a: "a3\n" * 3}), (6, {b: "b6\n"})],
                manifest)


@pytest.mark.parametrize("manifest", [MANIFEST, postprocess.MANIFEST])
def test_host_spans_match_original(tmp_path, manifest):
    _three_hosts(tmp_path, manifest)
    for h in range(4):  # host_3 has no manifest: no spans
        d = str(tmp_path / f"host_{h}")
        assert dist._host_spans(d, manifest) == \
            jax_pkg_dist._host_spans(d, manifest)
    assert dist._host_spans(str(tmp_path / "host_0"), manifest)


def _files(root):
    """{relative path: bytes} of the merged files (host trees left out;
    gzip members by their content: their headers hold a time stamp)."""
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if not x.startswith("host_")]
        for f in files:
            p = os.path.join(d, f)
            data = open(p, "rb").read()
            out[os.path.relpath(p, root)] = \
                gzip.decompress(data) if f.endswith(".gz") else data
    return out


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("manifest", [MANIFEST, postprocess.MANIFEST])
def test_merge_host_outputs_matches_original(tmp_path, compress, manifest):
    trees = {}
    for who, fn in (("port", merge_host_outputs),
                    ("orig", jax_pkg_dist.merge_host_outputs)):
        root = tmp_path / who
        _three_hosts(root, manifest)
        fn(str(root), 3, compress=compress, manifest=manifest)
        trees[who] = _files(root)
    assert trees["port"] and trees["port"] == trees["orig"]
    # .tsv stays plain; the rest is gzipped when asked
    assert ("m.tsv" in trees["port"]) and \
        ("S1/R2C2_Consensus.fasta.gz" in trees["port"]) == compress
    assert trees["port"][
        "S1/R2C2_Consensus.fasta.gz" if compress
        else "S1/R2C2_Consensus.fasta"] == b"a1\na3\na3\na3\na5\na7\n"


def test_initialize_single_process_and_its_refusals():
    assert dist.initialize(None, 1, None) == (0, 1)
    assert dist.initialize(None, None, None) == (0, 1)
    dist.shutdown()   # nothing to leave
    with pytest.raises(ValueError, match="--coordinator"):
        dist.initialize(None, 2, 0)
    with pytest.raises(ValueError, match="--process_id"):
        dist.initialize("localhost:1", 2, None)
    with pytest.raises(ValueError, match="outside"):
        dist.initialize("localhost:1", 2, 2)


# ---- real processes (gloo over localhost) ----

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    return dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                C3POA_PROGRESS="0")


def _run_processes(cmds):
    """Start every command, wait for all (each within PROC_TIMEOUT), and
    kill whatever is left if one fails or hangs.  Returns their
    (returncode, stdout, stderr)."""
    procs = [subprocess.Popen(c, cwd=ROOT, env=_env(), text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for c in cmds]
    try:
        outs = [p.communicate(timeout=PROC_TIMEOUT) for p in procs]
        return [(p.returncode, *o) for p, o in zip(procs, outs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _two_process(base):
    """``base`` (a CLI command without the multi-host flags) as two
    processes; asserts both exit 0."""
    port = _free_port()
    res = _run_processes([
        base + ["--coordinator", f"localhost:{port}", "--num_processes",
                "2", "--process_id", str(i)] for i in range(2)])
    for rc, _out, err in res:
        assert rc == 0, err[-3000:]
    return res


ALLREDUCE = """
import json, sys
from c3poa_tpu_torch.parallel import dist
rank, world = dist.initialize(sys.argv[1], 2, int(sys.argv[2]))
tot = dist.allreduce_stats({"b": 10 * (rank + 1), "a": rank + 1})
dist.shutdown()
print(json.dumps([rank, world, tot]))
"""


def test_allreduce_stats_two_processes():
    port = _free_port()
    res = _run_processes([[sys.executable, "-c", ALLREDUCE,
                           f"localhost:{port}", str(i)] for i in range(2)])
    got = []
    for rc, out, err in res:
        assert rc == 0, err[-3000:]
        got.append(json.loads(out.strip().splitlines()[-1]))
    assert got == [[0, 2, {"a": 3, "b": 30}], [1, 2, {"a": 3, "b": 30}]]


def _tree(out):
    """{relative path: content} of a run's outputs: host trees, hidden
    files and the timing JSON left out; gzip members by content."""
    found = {}
    for d, dirs, files in os.walk(out):
        dirs[:] = [x for x in dirs if not x.startswith(("host_", "."))]
        for f in files:
            if f.startswith(".") or f.endswith(".json"):
                continue
            p = os.path.join(d, f)
            data = open(p, "rb").read()
            if f.endswith(".gz"):
                data = gzip.decompress(data)
            found[os.path.relpath(p, out)] = data
    return found


@pytest.fixture(scope="module")
def consensus_inputs(tmp_path_factory):
    """tests/test_dist.py's two-process data: 10 reads, one splint."""
    d = tmp_path_factory.mktemp("consensus_inputs")
    reads, splints = sim.make_dataset(
        n_reads=10, seed=3, insert_len=(300, 600), copies=(3, 6),
        error=0.04)
    sim.write_fastq(str(d / "reads.fastq"), reads)
    sim.write_fasta(str(d / "splint.fasta"), splints)
    return d


@pytest.mark.parametrize("backend,group,flags", [
    ("numpy", 3, []),          # 4 groups: 2 a host
    ("cpu", 2, []),            # 5 groups, TorchBackend's deep pipeline:
                               # consecutive owned groups take the two
                               # record-arena slots in turn
    ("cpu", 4, []),            # 3 groups: the hosts' shares differ
    ("numpy", 3, ["-co"]),     # host trees plain, merged tree gzipped
])
def test_two_process_cli_matches_one_process_and_jax_cli(
        consensus_inputs, tmp_path, capsys, backend, group, flags):
    d = consensus_inputs
    common = ["-r", str(d / "reads.fastq"), "-s", str(d / "splint.fasta"),
              "-l", "500", "-g", str(group), *flags]
    two = tmp_path / "two"
    res = _two_process([sys.executable, "-m", "c3poa_tpu_torch.cli",
                        *common, "-o", str(two), "--backend", backend])
    capsys.readouterr()
    assert cli.main([*common, "-o", str(tmp_path / "one"), "--backend",
                     backend]) == 0
    one_line = capsys.readouterr().err.strip().splitlines()[-1]
    assert jax_pkg_cli.main([*common, "-o", str(tmp_path / "jax"),
                             "--backend", "numpy"]) == 0
    t2, t1 = _tree(two), _tree(tmp_path / "one")
    tj = _tree(tmp_path / "jax")
    assert "Splint1/R2C2_Consensus.fasta" + (".gz" if flags else "") in t2
    assert t2 == t1 == tj
    # every host reports the summed counters
    assert one_line.startswith("consensus written:")
    for _rc, _out, err in res:
        assert err.strip().splitlines()[-1] == one_line
    # each host wrote plain files and the stats of its own groups
    reads = []
    for h in range(2):
        host = two / f"host_{h}"
        assert not list(host.rglob("*.gz"))
        counters = json.load(open(host / "c3poa_stats.json"))["counters"]
        reads.append(counters["reads"])
        if backend == "cpu":
            assert counters["locate_launches"] > 0
            assert counters["align_launches"] > 0
    assert min(reads) > 0 and sum(reads) == 10
    if group == 4:
        assert reads[0] != reads[1]


def test_two_process_postprocess_matches_one_process_and_jax_cli(tmp_path):
    rng = np.random.default_rng(17)
    indexes = {f"Index{i}": sim.random_seq(np.random.default_rng(400 + i),
                                           10) for i in range(1, 5)}
    with open(tmp_path / "cons.fasta", "w") as fh:
        for i in range(25):
            name, seq, _ = sim.make_consensus_like(
                rng, f"c_{i}", cdna_len=400,
                index=indexes[f"Index{(i % 4) + 1}"],
                direction="+" if i % 2 == 0 else "-", error=0.01)
            fh.write(f">{name}\n{seq}\n")
        fh.write(f">junk\n{sim.random_seq(rng, 500)}\n")
    sim.write_fasta(str(tmp_path / "adapters.fasta"),
                    dict(sim.DEFAULT_ADAPTERS))
    sim.write_fasta(str(tmp_path / "indexes.fasta"), indexes)
    common = ["-i", str(tmp_path / "cons.fasta"),
              "-a", str(tmp_path / "adapters.fasta"),
              "-x", str(tmp_path / "indexes.fasta"), "-t", "-g", "4"]
    _two_process([sys.executable, "-m", "c3poa_tpu_torch.cli_postprocess",
                  *common, "-o", str(tmp_path / "two"), "--backend", "cpu"])
    assert cli_postprocess.main([*common, "-o", str(tmp_path / "one"),
                                 "--backend", "cpu"]) == 0
    assert jax_pkg_cli_postprocess.main([*common, "-o", str(tmp_path / "jax"),
                                         "--backend", "numpy"]) == 0
    t2, t1 = _tree(tmp_path / "two"), _tree(tmp_path / "one")
    tj = _tree(tmp_path / "jax")
    assert "R2C2_oligodT_multiplexing.tsv" in t2
    assert len(t2) > 3 and t2 == t1 == tj
