"""The port's long-read tool (``c3poa_tpu_torch/tools/stress_bigreads.py``)
on the CPU: its generator byte-equal to the original
``tools/stress_bigreads.py``'s; long reads through ``--backend cpu``
byte-identical to the port's numpy backend and to the JAX package's
numpy run; the overlong-read host route (its limit lowered) and one read
truly over ``MAX_READ_LEN``; the fast band's escalation rule."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from c3poa_tpu.pipeline.backend import NumpyBackend as JaxPkgNumpyBackend
from c3poa_tpu.pipeline.run import PipelineConfig as JaxPkgConfig
from c3poa_tpu.pipeline.run import run_pipeline as jax_pkg_run_pipeline
from c3poa_tpu_torch import sim
from c3poa_tpu_torch.pipeline import torch_backend
from c3poa_tpu_torch.pipeline.backend import Combo, NumpyBackend
from c3poa_tpu_torch.tools import stress_bigreads
from c3poa_tpu_torch.utils import encode, prof, revcomp_encoded

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTPUT_FILES = ("c3poa.log", "Splint1/R2C2_Consensus.fasta",
                "Splint1/R2C2_Subreads.fastq")
N_LONG = 4


def _original():
    spec = importlib.util.spec_from_file_location(
        "original_stress_bigreads",
        os.path.join(ROOT, "tools", "stress_bigreads.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_tree(a, b):
    for rel in OUTPUT_FILES:
        x = open(os.path.join(a, rel), "rb").read()
        assert x and x == open(os.path.join(b, rel), "rb").read(), rel


@pytest.mark.parametrize("n_reads,seed", [(2, 0), (3, 5)])
def test_make_big_dataset_matches_original(tmp_path, n_reads, seed):
    """The reads and splint of ``(n_reads, seed)`` byte-equal to the
    original generator's."""
    for d in ("port", "orig"):
        (tmp_path / d).mkdir()
    stress_bigreads.make_big_dataset(str(tmp_path / "port"), n_reads, seed)
    _original().make_big_dataset(str(tmp_path / "orig"), n_reads, seed)
    for f in ("reads.fastq", "splint.fasta"):
        a = (tmp_path / "port" / f).read_bytes()
        assert a and a == (tmp_path / "orig" / f).read_bytes(), f


@pytest.fixture(scope="module")
def long_set(tmp_path_factory):
    """N_LONG reads of the tool's generator (seed 0, 10-45 kb) and the
    port's numpy tree of them."""
    d = str(tmp_path_factory.mktemp("long"))
    stress_bigreads.make_big_dataset(d, N_LONG)
    out = os.path.join(d, "numpy")
    stress_bigreads.run(d, out, stress_bigreads.make_backend("numpy"))
    return d, out


def test_long_reads_cpu_match_numpy_and_jax_package(long_set, tmp_path):
    d, out_np = long_set
    out = str(tmp_path / "cpu")
    stats, _dt, st = stress_bigreads.run(d, out,
                                         stress_bigreads.make_backend("cpu"))
    assert stats.consensus_written == N_LONG
    c = st["counters"]
    assert c["locate_launches"] == 1 and c["align_launches"] >= 1
    assert c["locate_cells_padded"] > c["locate_cells_real"] > 0
    assert "overlong_reads_host_located" not in c
    _same_tree(out, out_np)
    out_jax = str(tmp_path / "jax_numpy")
    jax_pkg_run_pipeline(os.path.join(d, "reads.fastq"),
                         os.path.join(d, "splint.fasta"), out_jax,
                         JaxPkgConfig(), JaxPkgNumpyBackend())
    _same_tree(out, out_jax)


def test_overlong_route_keeps_the_tree(long_set, tmp_path, monkeypatch):
    """With ``MAX_READ_LEN`` below the two longest reads, those two are
    located on the host (counted) and the tree is unchanged."""
    d, out_np = long_set
    lens = sorted(len(s) for s in open(os.path.join(
        d, "reads.fastq")).read().split("\n")[1::4])
    limit = lens[-3]
    monkeypatch.setattr(torch_backend, "MAX_READ_LEN", limit)
    out = str(tmp_path / "cpu")
    _s, _dt, st = stress_bigreads.run(d, out,
                                      stress_bigreads.make_backend("cpu"))
    assert st["counters"]["overlong_reads_host_located"] == \
        sum(n > limit for n in lens) == 2
    _same_tree(out, out_np)


def test_a_read_over_max_read_len_locates_as_numpy():
    """A 148 kb read (over ``MAX_READ_LEN`` = 131072) beside a 10 kb one
    in one ``locate_many`` call: the long one on the host route, the
    other through the plain versions, both equal to ``NumpyBackend``."""
    rng = np.random.default_rng(11)
    splint = sim.random_seq(rng, 284)
    reads = [encode(sim.make_read(rng, f"r{k}", splint, insert_len=il,
                                  n_copies=nc, error=0.05).seq)
             for k, (il, nc) in enumerate(((4500, 30), (2000, 4)))]
    assert len(reads[0]) > torch_backend.MAX_READ_LEN > len(reads[1])
    codes = encode(splint)
    combos = [Combo("Splint1", "+", codes, len(codes)),
              Combo("Splint1", "-", revcomp_encoded(codes), len(codes))]
    prof.reset()
    got = torch_backend.TorchBackend("cpu").locate_many(reads, combos, 500)
    assert prof.current.counts["overlong_reads_host_located"] == 1
    want = NumpyBackend().locate_many(reads, combos, 500)
    for x, y in zip(got, want):
        assert (x.combo, x.score) == (y.combo, y.score)
        assert np.array_equal(x.peaks, y.peaks) and len(x.peaks) > 2


def test_fast_band_cpu_matches_numpy(long_set, tmp_path, monkeypatch):
    """Under ``C3POA_FAST_BAND=64`` the core pairs launch at W = 64 and the
    rest at 128 (two align launches); the tree equals the numpy
    backend's under the same setting and the one without it."""
    d, out_plain = long_set
    monkeypatch.setenv("C3POA_FAST_BAND", "64")
    out = str(tmp_path / "cpu")
    _s, _dt, st = stress_bigreads.run(d, out,
                                      stress_bigreads.make_backend("cpu"))
    assert st["counters"]["align_launches"] == 2
    out_np = str(tmp_path / "numpy")
    stress_bigreads.run(d, out_np, stress_bigreads.make_backend("numpy"))
    _same_tree(out, out_np)
    _same_tree(out, out_plain)


def test_main_prints_both_runs_counters(capsys):
    """The tool's two runs on the plain versions, each line with the
    port's counters in place of the original's compile-shape ones."""
    stress_bigreads.main(2, "cpu")
    lines = capsys.readouterr().out.splitlines()
    runs = [ln for ln in lines if ln.startswith(("warm:", "steady:"))]
    assert len(runs) == 2
    for ln in runs:
        assert "2/2 consensi" in ln
        for k in stress_bigreads.COUNTERS:
            assert f" {k}=" in ln, k
    with pytest.raises(ValueError, match="tpu"):
        stress_bigreads.make_backend("tpu")
