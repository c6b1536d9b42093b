"""Several devices in one process on the CPU (``c3poa_tpu_torch/parallel/
mesh.py``, ``TorchBackend(devices=...)``): the dry run of
``__graft_entry__.py:dryrun_multichip`` through ``["cpu"] * n`` byte-
identical to one device and to numpy, the postprocess run and
``sharded_step`` over shares, and the ``--mesh_devices`` rules of both
CLIs."""

import os

import numpy as np
import pytest
import torch

from c3poa_tpu_torch import cli, cli_postprocess, sim
from c3poa_tpu_torch.parallel import dist, mesh
from c3poa_tpu_torch.parallel.mesh import (Mesh, mesh_devices, share_bounds,
                                           sharded_step)
from c3poa_tpu_torch.pipeline import torch_backend
from c3poa_tpu_torch.pipeline.backend import NumpyBackend
from c3poa_tpu_torch.pipeline.postprocess import (PostprocessConfig,
                                                  run_postprocess)
from c3poa_tpu_torch.pipeline.run import PipelineConfig, run_pipeline
from c3poa_tpu_torch.pipeline.torch_backend import TorchBackend
from c3poa_tpu_torch.utils import encode

torch.set_num_threads(1)


def _tree(out):
    """{relative path: bytes} of every file a run wrote but its timing
    JSON."""
    found = {}
    for d, _dirs, files in os.walk(out):
        for f in files:
            if f.endswith(".json"):
                continue
            p = os.path.join(d, f)
            found[os.path.relpath(p, out)] = open(p, "rb").read()
    return found


@pytest.mark.parametrize("n_items,n_shares,want", [
    (10, 3, [(0, 0, 4), (1, 4, 7), (2, 7, 10)]),
    (2, 3, [(0, 0, 1), (1, 1, 2)]),          # an empty share is left out
    (0, 2, []),
    (7, 1, [(0, 0, 7)]),
    (16, 8, [(k, 2 * k, 2 * k + 2) for k in range(8)]),
])
def test_share_bounds(n_items, n_shares, want):
    assert share_bounds(n_items, n_shares) == want
    sizes = [len(x) for x in np.array_split(np.arange(n_items), n_shares)]
    assert [hi - lo for _k, lo, hi in want] == [s for s in sizes if s]


def test_mesh_devices(monkeypatch):
    assert mesh_devices(3, "cpu") == [torch.device("cpu")] * 3
    assert mesh_devices(None, "cpu") == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh_devices(None) == [torch.device("cuda", 0),
                                  torch.device("cuda", 1)]
    assert mesh_devices(1) == [torch.device("cuda", 0)]
    # the original's message (c3poa_tpu/cli.py:_local_mesh)
    with pytest.raises(ValueError, match="--mesh_devices 3: only 2 local "
                                         "devices"):
        mesh_devices(3)


@pytest.mark.parametrize("kind,arg,count,want", [
    ("cpu", "auto", 0, None),               # auto is one CPU
    ("cpu", "1", 0, None),
    ("cpu", "off", 0, None),
    ("cpu", "3", 0, ["cpu"] * 3),           # the dry run
    ("cuda", "auto", 0, None),              # no card: TorchBackend raises
    ("cuda", "auto", 1, None),              # one H100: unchanged path
    ("cuda", "auto", 2, ["cuda:0", "cuda:1"]),
    ("cuda", "2", 4, ["cuda:0", "cuda:1"]),
    ("cuda", "1", 4, None),
])
def test_local_devices_rules(monkeypatch, kind, arg, count, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    got = cli.local_devices(kind, arg)
    assert got == (None if want is None else [torch.device(d) for d in want])


def test_local_devices_refuses_more_cards_than_visible(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1 local devices"):
        cli.local_devices("cuda", "2")


class _Picked(Exception):
    pass


@pytest.mark.parametrize("module,argv", [
    (cli, ["-r", "x", "-s", "y"]),
    (cli_postprocess, ["-i", "x", "-a", "y"]),
])
@pytest.mark.parametrize("procs,flag,want", [
    (1, [], "auto"),
    (2, [], "1"),                            # auto -> 1 under processes
    (2, ["--mesh_devices", "2"], "2"),       # an explicit count stays
    (1, ["--mesh_devices", "3"], "3"),
])
def test_mesh_devices_flag_rules(monkeypatch, module, argv, procs, flag,
                                 want):
    """``initialize`` runs before the backend is built, and 'auto' means
    one device a process under --num_processes > 1
    (``c3poa_tpu/cli.py:245-247``)."""
    seen = []

    def initialize(coordinator, num_processes, process_id):
        seen.append(("init", coordinator, num_processes, process_id))
        return 1, num_processes

    def pick_backend(name, mesh_devices):
        seen.append(("pick", name, mesh_devices))
        raise _Picked

    monkeypatch.setattr(dist, "initialize", initialize)
    monkeypatch.setattr(module, "pick_backend", pick_backend)
    extra = ["--coordinator", "h:1", "--num_processes", str(procs),
             "--process_id", "1"] if procs > 1 else []
    with pytest.raises(_Picked):
        module.main(argv + ["--backend", "cpu"] + extra + flag)
    assert seen[0] == ("init", "h:1" if procs > 1 else None, procs,
                       1 if procs > 1 else None)
    assert seen[1] == ("pick", "cpu", want)


@pytest.mark.parametrize("module,argv", [
    (cli, ["-r", "x", "-s", "y"]),
    (cli_postprocess, ["-i", "x", "-a", "y"]),
])
@pytest.mark.parametrize("flag", [["--num_processes", "2"], ["-co"]])
def test_rss_restart_refused_with_processes_or_compression(
        module, argv, flag, capsys):
    with pytest.raises(SystemExit) as exc:
        module.main(argv + ["--rss-restart-mb", "100"] + flag)
    assert exc.value.code == 1
    err = capsys.readouterr().err
    assert "--rss-restart-mb needs the resume manifest" in err
    assert "--num_processes > 1" in err


def test_cli_flags_parse_with_the_original_defaults():
    for module, argv in ((cli, ["-r", "x", "-s", "y"]),
                         (cli_postprocess, ["-i", "x", "-a", "y"])):
        args = module.parse_args(argv)
        assert (args.mesh_devices, args.coordinator, args.num_processes,
                args.process_id) == ("auto", None, 1, None)
        args = module.parse_args(argv + [
            "--mesh_devices", "4", "--coordinator", "h:5", "--num_processes",
            "3", "--process_id", "2"])
        assert (args.mesh_devices, args.coordinator, args.num_processes,
                args.process_id) == ("4", "h:5", 3, 2)


def test_backend_devices_must_match_its_device():
    with pytest.raises(ValueError, match="not all cpu"):
        TorchBackend("cpu", devices=["cpu", "cuda:0"])
    assert TorchBackend("cpu", devices=["cpu"] * 2).mesh.devices == \
        [torch.device("cpu")] * 2
    assert TorchBackend("cpu").mesh.devices == [torch.device("cpu")]


# ---- the dry run (__graft_entry__.py:97-122) ----

def _dryrun_corpus(d):
    """64 reads over two splints, copies 0-12 (0: a single peak), every
    5th dangling-heavy; groups of 18 leave an uneven tail (18/18/18/10)."""
    rng = np.random.default_rng(0)
    splints = {"Splint1": sim.random_seq(rng, 200),
               "Splint2": sim.random_seq(rng, 240)}
    reads = []
    for i in range(64):
        copies = i % 13
        frag = (0.85, 0.85) if (copies == 0 or i % 5 == 0) else (0.4, 0.4)
        sp = "Splint1" if i % 3 else "Splint2"
        reads.append(sim.make_read(
            rng, name=f"simread_{i}", splint=splints[sp], splint_name=sp,
            insert_len=int(rng.integers(300, 601)), n_copies=copies,
            error=0.05, frag_frac=frag))
    sim.write_fastq(os.path.join(d, "reads.fastq"), reads)
    sim.write_fasta(os.path.join(d, "splint.fasta"), splints)
    return reads


class _Spy:
    """Rows of every launch the backend makes through one wrapper."""

    def __init__(self, monkeypatch, name):
        self.rows = []
        fn = getattr(torch_backend, name)

        def spy(*args, **kw):
            self.rows.append(int(args[0].shape[0]))
            return fn(*args, **kw)
        monkeypatch.setattr(torch_backend, name, spy)


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dryrun"))
    reads = _dryrun_corpus(d)
    cfg = PipelineConfig(lencutoff=500, group_size=18)
    trees = {}
    with pytest.MonkeyPatch.context() as mp:
        spies = [_Spy(mp, n) for n in ("locate_device", "banded_align_trace")]
        for name, backend in (("numpy", NumpyBackend()),
                              ("one", TorchBackend("cpu"))):
            out = os.path.join(d, name)
            stats = run_pipeline(os.path.join(d, "reads.fastq"),
                                 os.path.join(d, "splint.fasta"), out, cfg,
                                 backend)
            trees[name] = _tree(out)
    return d, cfg, reads, stats, trees, [s.rows for s in spies]


@pytest.mark.parametrize("n", [2, 3, 8])
def test_dryrun_devices_match_one_device_and_numpy(dryrun, monkeypatch, n):
    d, cfg, reads, one_stats, trees, one_rows = dryrun
    spies = [_Spy(monkeypatch, name)
             for name in ("locate_device", "banded_align_trace")]
    out = os.path.join(d, f"mesh{n}")
    stats = run_pipeline(os.path.join(d, "reads.fastq"),
                         os.path.join(d, "splint.fasta"), out, cfg,
                         TorchBackend("cpu", devices=["cpu"] * n))
    got = _tree(out)
    assert set(got) == set(trees["one"]) == set(trees["numpy"])
    for rel in got:
        assert got[rel] == trees["one"][rel] == trees["numpy"][rel], rel
    assert stats == one_stats
    # the work is what __graft_entry__ asks of it: 4 groups, both splints,
    # zero-repeat splices, real segmentation
    n_zero = sum(1 for r in reads if r.n_copies == 0)
    assert stats.total_reads == 64
    assert stats.consensus_written > 64 - 2 * n_zero
    assert {"Splint1/R2C2_Consensus.fasta",
            "Splint2/R2C2_Consensus.fasta"} <= set(got)
    # every launch of one device became min(n, rows) contiguous shares
    for spy, rows in zip(spies, one_rows):
        want = [size for r in rows
                for size in (hi - lo for _k, lo, hi in share_bounds(r, n))]
        assert sorted(spy.rows) == sorted(want)
        assert len(spy.rows) > len(rows)


def _post_inputs(d):
    rng = np.random.default_rng(5)
    indexes = {f"Index{i}": sim.random_seq(np.random.default_rng(300 + i),
                                           10) for i in range(1, 5)}
    with open(os.path.join(d, "cons.fasta"), "w") as fh:
        for i in range(14):
            name, seq, _ = sim.make_consensus_like(
                rng, f"c_{i}", cdna_len=300,
                index=indexes[f"Index{(i % 4) + 1}"],
                direction="+" if i % 2 == 0 else "-", error=0.01)
            fh.write(f">{name}\n{seq}\n")
    sim.write_fasta(os.path.join(d, "adapters.fasta"),
                    dict(sim.DEFAULT_ADAPTERS))
    sim.write_fasta(os.path.join(d, "indexes.fasta"), indexes)


def test_postprocess_devices_match_numpy(tmp_path, monkeypatch):
    d = str(tmp_path)
    _post_inputs(d)
    spy = _Spy(monkeypatch, "adapter_hits")
    trees = {}
    for name, backend in (("numpy", NumpyBackend()),
                          ("mesh", TorchBackend("cpu",
                                                devices=["cpu"] * 3))):
        run_postprocess(os.path.join(d, "cons.fasta"),
                        os.path.join(d, name),
                        os.path.join(d, "adapters.fasta"),
                        os.path.join(d, "indexes.fasta"),
                        PostprocessConfig(trim=True, group_size=8), backend)
        trees[name] = _tree(os.path.join(d, name))
    assert len(trees["mesh"]) > 3 and trees["mesh"] == trees["numpy"]
    # groups of 8 and 6 reads, each cut into 3 shares
    assert sorted(spy.rows) == [2, 2, 2, 2, 3, 3]


def test_sharded_step_matches_one_device():
    rng = np.random.default_rng(9)
    splint = sim.random_seq(rng, 100)
    B, L = 7, 1024
    reads = np.full((B, L), 4, dtype=np.int8)
    lens = np.zeros(B, dtype=np.int32)
    for b in range(B):
        s = sim.random_seq(rng, 150) + splint + sim.random_seq(rng, 250) + \
            splint + sim.random_seq(rng, int(rng.integers(0, 300)))
        reads[b, :len(s)] = encode(s)
        lens[b] = len(s)
    splints = np.full((2, 128), 4, dtype=np.int8)
    splints[0, :100] = encode(splint)
    splints[1, :100] = encode(splint)[::-1]
    P, nq = 5, 192
    queries = np.full((P, nq), 4, dtype=np.int8)
    targets = np.full((P, nq), 4, dtype=np.int8)
    ql = np.zeros(P, dtype=np.int32)
    tl = np.zeros(P, dtype=np.int32)
    for p in range(P):
        t = sim.random_seq(rng, int(rng.integers(100, 180)))
        q = sim.mutate(rng, t, 0.05, 0.03, 0.03)[:nq]
        queries[p, :len(q)], targets[p, :len(t)] = encode(q), encode(t)
        ql[p], tl[p] = len(q), len(t)
    args = (reads, lens, splints, queries, targets, ql, tl)
    one = sharded_step(["cpu"])(*args)
    three = sharded_step(["cpu"] * 3)(*args)
    for a, b in zip(one[:7], three[:7]):
        np.testing.assert_array_equal(a, b)
    assert one[7:] == three[7:]
    assert one[7] == int(one[3].sum()) > 0
    assert one[8] == pytest.approx(float(one[4].mean()))


def test_mesh_gather_joins_shares_in_order():
    m = Mesh(["cpu"] * 3)
    x = np.arange(20, dtype=np.int32).reshape(10, 2)
    pend = m.dispatch(lambda dev, t: (t * 2, t[:, 0]), x)
    assert [k for k, _ in pend] == [0, 1, 2]
    a, b = m.gather(pend)
    np.testing.assert_array_equal(a, x * 2)
    np.testing.assert_array_equal(b, x[:, 0])
    assert m.streams == [None] * 3
    one = mesh.Mesh(["cpu"])
    (y,) = one.gather(one.dispatch(lambda dev, t: (t + 1,), x))
    np.testing.assert_array_equal(y, x + 1)
