"""The postprocess run through the port on the CPU: ``run_postprocess``
with ``TorchBackend("cpu")`` and the port's CLI against the JAX
package's with the numpy backend (byte for byte), and the consensus then
postprocess chain through both port CLIs against ground truth."""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from c3poa_tpu import sim
from c3poa_tpu.pipeline.postprocess import PostprocessConfig as JaxPkgConfig
from c3poa_tpu.pipeline.postprocess import \
    run_postprocess as jax_pkg_run_postprocess
from c3poa_tpu_torch import cli, cli_postprocess
from c3poa_tpu_torch.io.fastx import read_fastx
from c3poa_tpu_torch.pipeline.postprocess import (PostprocessConfig,
                                                  run_postprocess)
from c3poa_tpu_torch.pipeline.run import PipelineConfig, run_pipeline
from c3poa_tpu_torch.pipeline.torch_backend import TorchBackend
from c3poa_tpu_torch.ref import banded
from c3poa_tpu_torch.utils import encode, revcomp

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _make_post_inputs(d, n_reads=25, seed=21):
    """tests/test_postprocess.py:_make_post_inputs, plus an adapter-free
    read and a dimer."""
    rng = np.random.default_rng(seed)
    indexes = {f"Index{i}": sim.random_seq(np.random.default_rng(300 + i), 10)
               for i in range(1, 5)}
    with open(d / "cons.fasta", "w") as fh:
        for i in range(n_reads):
            name, seq, _ = sim.make_consensus_like(
                rng, f"c_{i}", cdna_len=400,
                index=indexes[f"Index{(i % 4) + 1}"],
                direction="+" if i % 2 == 0 else "-", error=0.01)
            fh.write(f">{name}\n{seq}\n")
        a5 = sim.DEFAULT_ADAPTERS["5Prime_adapter"]
        fh.write(f">junk\n{sim.random_seq(rng, 500)}\n")
        fh.write(f">dimer\n{a5}{a5}{sim.random_seq(rng, 300)}\n")
    sim.write_fasta(str(d / "adapters.fasta"), dict(sim.DEFAULT_ADAPTERS))
    sim.write_fasta(str(d / "indexes.fasta"), indexes)


def _tree(out):
    """{relative path: content} of every output file; gzip members are
    compared by their content (their headers hold a time stamp)."""
    tree = {}
    for root, _dirs, files in os.walk(out):
        for f in files:
            if f.startswith("."):
                continue
            p = os.path.join(root, f)
            data = open(p, "rb").read()
            if f.endswith(".gz"):
                data = gzip.decompress(data)
            tree[os.path.relpath(p, out)] = data
    return tree


@pytest.mark.parametrize("kw,indexed", [
    (dict(trim=True, group_size=7), True),
    (dict(trim=False), False),
    (dict(trim=True, barcoded=True, group_size=10), True),
    (dict(trim=True, undirectional=True), False),
    (dict(trim=True, compress=True, group_size=4), True),
])
def test_run_postprocess_torch_cpu_matches_jax_package_numpy(tmp_path, kw,
                                                             indexed):
    _make_post_inputs(tmp_path)
    args = (str(tmp_path / "cons.fasta"),)
    files = dict(adapter_fasta=str(tmp_path / "adapters.fasta"),
                 index_fasta=str(tmp_path / "indexes.fasta")
                 if indexed else None)
    got = run_postprocess(*args, out_path=str(tmp_path / "torch"),
                          cfg=PostprocessConfig(**kw),
                          backend=TorchBackend("cpu"), **files)
    want = jax_pkg_run_postprocess(*args, out_path=str(tmp_path / "numpy"),
                                   cfg=JaxPkgConfig(**kw), **files)
    assert (got.total, got.written, got.no_adapter) == \
        (want.total, want.written, want.no_adapter)
    assert got.written and got.no_adapter >= 2
    a, b = _tree(tmp_path / "torch"), _tree(tmp_path / "numpy")
    assert a and a == b


@pytest.mark.parametrize("flags", [["-t"], ["-u"], ["-x"],
                                   ["-co", "-t", "-x"]])
def test_cli_postprocess_cpu_matches_jax_cli_numpy(tmp_path, flags):
    _make_post_inputs(tmp_path, n_reads=12)
    flags = [f for f in flags if f != "-x"] + (
        ["-x", str(tmp_path / "indexes.fasta")] if "-x" in flags else [])
    common = ["-i", str(tmp_path / "cons.fasta"),
              "-a", str(tmp_path / "adapters.fasta"), "-g", "5", *flags]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    for mod, backend, out in (
            ("c3poa_tpu_torch.cli_postprocess", "cpu", "torch"),
            ("c3poa_tpu.cli_postprocess", "numpy", "numpy")):
        r = subprocess.run([sys.executable, "-m", mod, *common, "--backend",
                            backend, "-o", str(tmp_path / out)], cwd=ROOT,
                           env=env, capture_output=True, text=True,
                           timeout=600)
        assert r.returncode == 0, r.stderr[-2000:]
    a, b = _tree(tmp_path / "torch"), _tree(tmp_path / "numpy")
    assert a and a == b


def test_cli_postprocess_flags():
    args = cli_postprocess.parse_args(["-i", "x", "-a", "y"])
    assert args.backend == "cuda"
    for gone in ("--mesh_devices", "--num_processes", "--coordinator",
                 "--process_id"):
        with pytest.raises(SystemExit):
            cli_postprocess.parse_args(["-i", "x", "-a", "y", gone, "1"])
    if not torch.cuda.is_available():
        # no silent CPU run when the card was asked for
        with pytest.raises(RuntimeError, match="is_available"):
            cli_postprocess.main(["-i", "x", "-a", "y"])


def test_multi_host_runs_are_not_ported(tmp_path):
    _make_post_inputs(tmp_path, n_reads=2)
    with pytest.raises(NotImplementedError, match="1.8"):
        run_postprocess(str(tmp_path / "cons.fasta"), str(tmp_path / "o"),
                        str(tmp_path / "adapters.fasta"),
                        cfg=PostprocessConfig(process_count=2))
    with pytest.raises(NotImplementedError, match="1.8"):
        run_pipeline(str(tmp_path / "cons.fasta"),
                     str(tmp_path / "adapters.fasta"), str(tmp_path / "p"),
                     PipelineConfig(process_count=2))


def test_consensus_then_postprocess_chain_through_port_clis(tmp_path):
    """tests/test_full_chain.py's chain: R2C2 reads whose inserts carry
    adapters and an oligo-dT index, through ``c3poa_tpu_torch.cli`` and
    ``c3poa_tpu_torch.cli_postprocess`` on the CPU, against ground
    truth."""
    rng = np.random.default_rng(77)
    splint = sim.random_seq(rng, 200)
    adapters = dict(sim.DEFAULT_ADAPTERS)
    indexes = {f"Index{i}": sim.random_seq(np.random.default_rng(800 + i), 10)
               for i in range(1, 4)}
    reads, truth = [], {}
    for i in range(6):
        idx = f"Index{(i % 3) + 1}"
        cdna = sim.random_seq(rng, 700)
        w = sim.random_seq(rng, 3) + indexes[idx] + sim.random_seq(rng, 3)
        insert = (adapters["5Prime_adapter"] + cdna + revcomp(w) +
                  revcomp(adapters["3Prime_adapter"]))
        parts = []
        for _ in range(int(rng.integers(3, 7))):
            parts.append(sim.mutate(rng, splint, 0.02, 0.01, 0.01))
            parts.append(sim.mutate(rng, insert, 0.02, 0.01, 0.01))
        parts.append(sim.mutate(rng, splint, 0.02, 0.01, 0.01))
        seq = sim.random_seq(rng, 300) + "".join(parts) + \
            sim.random_seq(rng, 300)
        q = np.clip(np.random.default_rng(i).normal(25, 3, len(seq)), 3, 40)
        reads.append(sim.SimRead(f"mol_{i}", seq,
                                 "".join(chr(int(x) + 33) for x in q),
                                 insert, "Splint1", "+", len(parts) // 2))
        truth[f"mol_{i}"] = (idx, cdna)
    sim.write_fastq(str(tmp_path / "reads.fastq"), reads)
    sim.write_fasta(str(tmp_path / "splint.fasta"), {"Splint1": splint})
    sim.write_fasta(str(tmp_path / "adapters.fasta"), adapters)
    sim.write_fasta(str(tmp_path / "indexes.fasta"), indexes)

    cons_out = str(tmp_path / "cons")
    assert cli.main(["-r", str(tmp_path / "reads.fastq"),
                     "-s", str(tmp_path / "splint.fasta"), "-o", cons_out,
                     "--backend", "cpu"]) == 0
    post_out = str(tmp_path / "post")
    assert cli_postprocess.main([
        "-i", os.path.join(cons_out, "Splint1", "R2C2_Consensus.fasta"),
        "-a", str(tmp_path / "adapters.fasta"),
        "-x", str(tmp_path / "indexes.fasta"), "-o", post_out, "-t",
        "--backend", "cpu"]) == 0

    found = {}
    for idx_name in list(indexes) + ["no_index_found"]:
        p = os.path.join(post_out, idx_name,
                         "R2C2_full_length_consensus_reads.fasta")
        if os.path.exists(p):
            for rec in read_fastx(p):
                found["_".join(rec.name.split("_")[:2])] = (idx_name,
                                                            rec.seq)
    n_good = 0
    for name, (want_idx, cdna) in truth.items():
        if name not in found or found[name][0] != want_idx:
            continue
        a, b = encode(found[name][1]), encode(cdna)
        band = max(256, 2 * abs(len(a) - len(b)) + 64)
        rec = banded.align_and_trace(b, a, band=band)
        if int(((rec.cover == 1) & (rec.base == a)).sum()) / len(b) > 0.98:
            n_good += 1
    assert n_good >= 5, f"only {n_good} molecules fully recovered"
