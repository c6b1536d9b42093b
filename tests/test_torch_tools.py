"""The port's copies of ``c3poa_tpu/tools/`` write what the originals
write: ``make_example`` the same files byte for byte for the same ``-n``
and ``--seed``, ``demux_nextera_tso`` the same ``Indexed_reads.fasta``."""

import os

import numpy as np
import pytest

from c3poa_tpu import sim as jax_pkg_sim
from c3poa_tpu.tools import demux_nextera_tso as jax_pkg_demux
from c3poa_tpu.tools import make_example as jax_pkg_make_example
from c3poa_tpu_torch.tools import demux_nextera_tso, make_example


def _tree(root):
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


@pytest.mark.parametrize("n,seed", [(6, 7), (3, 11)])
def test_make_example_matches_original(tmp_path, n, seed):
    argv = ["-n", str(n), "--seed", str(seed)]
    assert make_example.main(["-o", str(tmp_path / "port"), *argv]) == 0
    assert jax_pkg_make_example.main(
        ["-o", str(tmp_path / "jax_package"), *argv]) == 0
    port, orig = _tree(tmp_path / "port"), _tree(tmp_path / "jax_package")
    assert sorted(port) == ["adapters.fasta", "oligodt_indexes.fasta",
                            "reads.fastq", "splint.fasta", "truth.tsv"]
    assert port == orig


def _demux_inputs(d):
    """The case of ``tests/test_resume_tools.py::test_demux_nextera_tso``:
    a read with both indexes, a short read, a read with neither."""
    rng = np.random.default_rng(0)
    nexts = {f"A{i}": jax_pkg_sim.random_seq(np.random.default_rng(i), 15)
             for i in range(1, 5)}
    tsos = {f"T{i}": jax_pkg_sim.random_seq(np.random.default_rng(100 + i),
                                            12)
            for i in range(1, 4)}
    jax_pkg_sim.write_fasta(str(d / "n.fasta"), nexts)
    jax_pkg_sim.write_fasta(str(d / "t.fasta"), tsos)
    with open(d / "in.fasta", "w") as fh:
        seq = jax_pkg_sim.random_seq(rng, 40) + nexts["A2"] + \
            jax_pkg_sim.random_seq(rng, 60) + tsos["T1"] + \
            jax_pkg_sim.random_seq(rng, 400)
        fh.write(f">r1\n{seq}\n")
        fh.write(f">r2\n{jax_pkg_sim.random_seq(rng, 200)}\n")
        fh.write(f">r3\n{jax_pkg_sim.random_seq(rng, 500)}\n")
    return [str(d / f) for f in ("in.fasta", "n.fasta", "t.fasta")]


def test_demux_matches_original(tmp_path):
    inp, n, t = _demux_inputs(tmp_path)
    for mod, out in ((demux_nextera_tso, "port"),
                     (jax_pkg_demux, "jax_package")):
        assert mod.main(["-i", inp, "-o", str(tmp_path / out), "-n", n,
                         "-t", t]) == 0
    port = open(tmp_path / "port" / "Indexed_reads.fasta", "rb").read()
    orig = open(tmp_path / "jax_package" / "Indexed_reads.fasta", "rb").read()
    assert port == orig
    assert b">r1|A2_T1\n" in port and b">r2" not in port


def test_demux_matches_original_on_example_reads(tmp_path):
    """Every read of an example set (most longer than 300 bp), against
    the example's oligo-dT indexes as both index families."""
    assert make_example.main(["-o", str(tmp_path), "-n", "12"]) == 0
    args = ["-i", str(tmp_path / "reads.fastq"),
            "-n", str(tmp_path / "oligodt_indexes.fasta"),
            "-t", str(tmp_path / "oligodt_indexes.fasta")]
    assert demux_nextera_tso.main([*args, "-o", str(tmp_path / "p")]) == 0
    assert jax_pkg_demux.main([*args, "-o", str(tmp_path / "j")]) == 0
    port = open(tmp_path / "p" / "Indexed_reads.fasta", "rb").read()
    assert port.count(b">") == 12
    assert port == open(tmp_path / "j" / "Indexed_reads.fasta", "rb").read()
