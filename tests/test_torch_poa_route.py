"""The port's POA-route tool (``c3poa_tpu_torch/tools/poa_stress.py``)
on the CPU: its generators byte-equal to the original
``tools/poa_stress.py``'s; a chimera-heavy set through the plain
versions byte-identical to the port's numpy backend and to the JAX
package's numpy run, with the same reads routed to the POA consensus;
the tool's interleaved rounds and verdict."""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from c3poa_tpu.pipeline.backend import NumpyBackend as JaxPkgNumpyBackend
from c3poa_tpu.pipeline.run import PipelineConfig as JaxPkgConfig
from c3poa_tpu.pipeline.run import run_pipeline as jax_pkg_run_pipeline
from c3poa_tpu_torch.pipeline.backend import NumpyBackend
from c3poa_tpu_torch.pipeline.torch_backend import TorchBackend
from c3poa_tpu_torch.tools import poa_stress

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTPUT_FILES = ("c3poa.log", "Splint1/R2C2_Consensus.fasta",
                "Splint1/R2C2_Subreads.fastq")


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _original():
    return _load("original_poa_stress", os.path.join("tools",
                                                     "poa_stress.py"))


@pytest.mark.parametrize("frac", [0.0, 0.18])
def test_make_dataset_matches_original(tmp_path, frac):
    """The reads and splint of 12 reads at seed 3 byte-equal to the
    original generator's, clean and chimera-heavy."""
    for d in ("port", "orig"):
        (tmp_path / d).mkdir()
    poa_stress.make_dataset(str(tmp_path / "port"), 12, frac, seed=3)
    _original().make_dataset(str(tmp_path / "orig"), 12, frac, seed=3)
    for f in ("reads.fastq", "splint.fasta"):
        a = (tmp_path / "port" / f).read_bytes()
        assert a and a == (tmp_path / "orig" / f).read_bytes(), f


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_chimeric_read_matches_original(seed):
    """One chimeric concatemer, every field equal to the original's."""
    from c3poa_tpu_torch import sim
    splint = sim.random_seq(np.random.default_rng(99), 200)
    got = poa_stress.make_chimeric_read(np.random.default_rng(seed), "c",
                                        splint, 700, 6, 0.05)
    want = _original().make_chimeric_read(np.random.default_rng(seed), "c",
                                          splint, 700, 6, 0.05)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_a_set_starts_with_the_smaller_set(tmp_path):
    """``chip_smoke.head_reads`` of the 8-read set is the 4-read set: the
    reads are drawn one after another from one generator."""
    chip_smoke = _load("chip_smoke", "chip_smoke.py")
    for n in (4, 8):
        (tmp_path / str(n)).mkdir()
        poa_stress.make_dataset(str(tmp_path / str(n)), n, 0.18, seed=3)
    chip_smoke.head_reads(str(tmp_path / "8"), str(tmp_path / "head"), 4)
    for f in ("reads.fastq", "splint.fasta"):
        assert (tmp_path / "head" / f).read_bytes() == \
            (tmp_path / "4" / f).read_bytes(), f


def test_poa_route_cpu_matches_numpy_and_jax_package(tmp_path):
    """48 reads at chimera fraction 0.18 in groups of 24 (the tool's
    group size): the plain versions' tree equals both numpy runs', and
    the port's two arms route the same reads, at least one."""
    d = str(tmp_path)
    poa_stress.make_dataset(d, 48, 0.18, seed=3)
    gs = 24
    _rps, got = poa_stress.run_once(d, os.path.join(d, "cpu"),
                                    TorchBackend("cpu"), gs)
    _rps, want = poa_stress.run_once(d, os.path.join(d, "numpy"),
                                     NumpyBackend(), gs)
    assert got["poa_fallback_reads"] == want["poa_fallback_reads"] > 0
    jax_pkg_run_pipeline(os.path.join(d, "reads.fastq"),
                         os.path.join(d, "splint.fasta"),
                         os.path.join(d, "jax_numpy"),
                         JaxPkgConfig(group_size=gs), JaxPkgNumpyBackend())
    for rel in OUTPUT_FILES:
        a = open(os.path.join(d, "cpu", rel), "rb").read()
        assert a, rel
        for ref in ("numpy", "jax_numpy"):
            assert a == open(os.path.join(d, ref, rel), "rb").read(), \
                (rel, ref)


def test_main_prints_medians_and_verdict(capsys):
    """The tool's warm runs and one round on the numpy backend: a round
    line, the medians with the routed share, and the verdict."""
    res = poa_stress.main(["8", "1", "numpy"])
    out = capsys.readouterr().out
    assert "round 0: clean" in out and "medians: clean" in out
    assert "target (>=10% routed, <20% loss): " in out
    assert len(res["clean"]) == len(res["heavy"]) == 1
    assert res["ratio"] == res["median_heavy"] / res["median_clean"]
    with pytest.raises(ValueError, match="tpu"):
        poa_stress.make_backend("tpu")
