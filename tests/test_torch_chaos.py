"""Faults in the port's runs: the counterparts of ``tests/test_chaos.py``
run on ``c3poa_tpu_torch``.  A worker that raises or dies surfaces in
the parent (``utils/procpool.imap_strict``, ``C3POA_FAULT_GROUP``); a
consensus CLI killed with SIGKILL mid-run resumes byte-identically; and
both CLIs under ``--rss-restart-mb 1`` restart after every group and
give the uninterrupted run's bytes.  The CLIs run ``--backend cpu``
(``TorchBackend`` with the kernels' plain versions); the uninterrupted
trees are also held to the JAX package's numpy runs."""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from c3poa_tpu_torch import cli, cli_postprocess, sim
from c3poa_tpu_torch.pipeline.postprocess import (
    PostprocessConfig, run_postprocess,
)
from c3poa_tpu_torch.pipeline.run import MANIFEST, PipelineConfig, run_pipeline
from c3poa_tpu_torch.utils.procpool import WorkerDied, WorkerFailed

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
           C3POA_PROGRESS="0")


def _dataset(tmp_path, n_reads=8, seed=5):
    reads, splints = sim.make_dataset(
        n_reads=n_reads, seed=seed, insert_len=(300, 500), copies=(3, 5),
        error=0.04)
    sim.write_fastq(str(tmp_path / "reads.fastq"), reads)
    sim.write_fasta(str(tmp_path / "splint.fasta"), splints)


def _consensus_like(tmp_path, n, seed):
    rng = np.random.default_rng(seed)
    with open(tmp_path / "cons.fasta", "w") as fh:
        for i in range(n):
            name, seq, _ = sim.make_consensus_like(rng, f"c_{i}",
                                                   cdna_len=300)
            fh.write(f">{name}\n{seq}\n")
    sim.write_fasta(str(tmp_path / "adapters.fasta"),
                    dict(sim.DEFAULT_ADAPTERS))


def _tree(out):
    found = {}
    for root, dirs, files in os.walk(out):
        dirs[:] = [d for d in dirs if not d.startswith(".")]
        for f in files:
            if f.startswith(".") or f.endswith(".json"):
                continue
            p = os.path.join(root, f)
            found[os.path.relpath(p, out)] = open(p, "rb").read()
    return found


def test_worker_exception_surfaces(tmp_path, monkeypatch):
    """``test_chaos.py:33``: a worker's exception raises in the parent
    naming its group."""
    _dataset(tmp_path)
    monkeypatch.setenv("C3POA_FAULT_GROUP", "1:raise")
    with pytest.raises(WorkerFailed, match="group 1"):
        run_pipeline(str(tmp_path / "reads.fastq"),
                     str(tmp_path / "splint.fasta"),
                     str(tmp_path / "out"),
                     PipelineConfig(group_size=2, num_threads=2,
                                    lencutoff=100))


def test_worker_death_surfaces_not_hangs(tmp_path, monkeypatch):
    """``test_chaos.py:46``: a worker that dies abruptly raises
    ``WorkerDied`` promptly, not a hang on the lost result."""
    _dataset(tmp_path)
    monkeypatch.setenv("C3POA_FAULT_GROUP", "2:kill")
    t0 = time.time()
    with pytest.raises(WorkerDied, match="worker"):
        run_pipeline(str(tmp_path / "reads.fastq"),
                     str(tmp_path / "splint.fasta"),
                     str(tmp_path / "out"),
                     PipelineConfig(group_size=2, num_threads=2,
                                    lencutoff=100))
    assert time.time() - t0 < 120


def test_postprocess_worker_failures_surface(tmp_path, monkeypatch):
    """``test_chaos.py:62``: both failures through the postprocess
    run's workers."""
    _consensus_like(tmp_path, 10, 6)
    monkeypatch.setenv("C3POA_FAULT_GROUP", "1:raise")
    with pytest.raises(WorkerFailed, match="group 1"):
        run_postprocess(str(tmp_path / "cons.fasta"), str(tmp_path / "o"),
                        str(tmp_path / "adapters.fasta"), None,
                        PostprocessConfig(group_size=3, threads=2))
    monkeypatch.setenv("C3POA_FAULT_GROUP", "0:kill")
    with pytest.raises(WorkerDied):
        run_postprocess(str(tmp_path / "cons.fasta"), str(tmp_path / "o2"),
                        str(tmp_path / "adapters.fasta"), None,
                        PostprocessConfig(group_size=3, threads=2))


def test_sigkill_midrun_resume(tmp_path):
    """``test_chaos.py:98`` (marked slow there): SIGKILL the consensus CLI
    (``--backend cpu``: the deep pipeline over ``TorchBackend``) once its
    manifest records 2 of 8 groups, then ``--resume`` to the end: the
    tree equals an uninterrupted run's, and the JAX package's numpy
    run's.  The kill must land mid-run."""
    _dataset(tmp_path, n_reads=16, seed=7)
    reads, splint = str(tmp_path / "reads.fastq"), str(tmp_path / "splint.fasta")
    args = ["-r", reads, "-s", splint, "-l", "100", "-g", "2",
            "--backend", "cpu"]
    base = [sys.executable, "-m", "c3poa_tpu_torch.cli", *args]

    clean = str(tmp_path / "clean")
    assert cli.main(args + ["-o", clean]) == 0

    out = str(tmp_path / "killed")
    proc = subprocess.Popen(base + ["-o", out, "--resume"], env=ENV,
                            cwd=ROOT)
    manifest = os.path.join(out, MANIFEST)
    deadline = time.time() + 240
    killed_mid = False
    try:
        while time.time() < deadline:
            if proc.poll() is not None:
                break  # finished before the kill: fails below
            try:
                m = json.load(open(manifest))
                if m.get("groups_done", 0) >= 2:
                    os.kill(proc.pid, signal.SIGKILL)
                    proc.wait(timeout=60)
                    killed_mid = proc.returncode == -signal.SIGKILL
                    break
            except (OSError, ValueError):
                pass
            time.sleep(0.05)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert killed_mid, "the CLI finished or stalled before the SIGKILL"
    assert json.load(open(manifest))["groups_done"] < 8

    subprocess.run(base + ["-o", out, "--resume"], check=True, env=ENV,
                   cwd=ROOT, timeout=300)
    t1, t2 = _tree(clean), _tree(out)
    assert sorted(t1) == sorted(t2)
    for rel in t1:
        assert t1[rel] == t2[rel], f"{rel} differs"

    from c3poa_tpu.pipeline.backend import NumpyBackend as JaxNumpy
    from c3poa_tpu.pipeline.run import PipelineConfig as JaxConfig
    from c3poa_tpu.pipeline.run import run_pipeline as jax_run_pipeline
    jax_out = str(tmp_path / "jax")
    jax_run_pipeline(reads, splint, jax_out,
                     JaxConfig(lencutoff=100, group_size=2), JaxNumpy())
    assert _tree(jax_out) == t1


def _identity(x):
    return x


def _return_lambda(x):
    return lambda: x  # unpicklable


def test_unpicklable_result_raises_not_hangs():
    """``test_chaos.py:153``: a result that does not pickle raises
    ``WorkerFailed`` in the parent."""
    from c3poa_tpu_torch.utils.procpool import imap_strict

    t0 = time.time()
    with pytest.raises(WorkerFailed, match="pickle|Pickling"):
        list(imap_strict(_return_lambda, [1, 2], workers=2))
    assert time.time() - t0 < 60


def test_imap_strict_labels_name_real_groups(monkeypatch):
    """``test_chaos.py:165``: errors and fault injection name the
    caller's group label, not the submission index."""
    from c3poa_tpu_torch.utils.procpool import imap_strict

    monkeypatch.setenv("C3POA_FAULT_GROUP", "7:raise")
    with pytest.raises(WorkerFailed, match="group 7"):
        list(imap_strict(_identity, [(7, "payload")], workers=1,
                         label=lambda pl: pl[0]))


def _supervised(module, args, tmp_path):
    """The CLI's uninterrupted tree (in this process), and its tree under
    ``--rss-restart-mb 1`` (a supervisor and its sessions) with the
    supervisor's stderr."""
    clean = str(tmp_path / "clean")
    assert module.main(args + ["-o", clean]) == 0
    out = str(tmp_path / "supervised")
    r = subprocess.run([sys.executable, "-m", module.__name__, *args, "-o",
                        out, "--rss-restart-mb", "1"],
                       env=ENV, cwd=ROOT, timeout=300, capture_output=True,
                       text=True)
    assert r.returncode == 0, r.stderr[-3000:]
    t1, t2 = _tree(clean), _tree(out)
    assert t1 and sorted(t1) == sorted(t2)
    for rel in t1:
        assert t1[rel] == t2[rel], f"{rel} differs"
    return t1, r.stderr


def test_rss_restart_supervisor_byte_identical(tmp_path):
    """``test_chaos.py:179`` with ``--backend cpu``: 12 reads in 3
    groups, a restart after each (any process holds more than 1 MB), the
    tree the uninterrupted run's."""
    _dataset(tmp_path, n_reads=12, seed=9)
    args = ["-r", str(tmp_path / "reads.fastq"),
            "-s", str(tmp_path / "splint.fasta"),
            "-l", "100", "-g", "4", "--backend", "cpu"]
    _, err = _supervised(cli, args, tmp_path)
    assert "rss supervisor: 3 restart(s)" in err, err[-3000:]


def test_postprocess_rss_restart_supervisor(tmp_path):
    """``test_chaos.py:205`` with ``--backend cpu``: the postprocess CLI
    restarts after each of its 3 groups, and its tree equals the
    uninterrupted run's and the JAX package's numpy run's."""
    _consensus_like(tmp_path, 9, 11)
    args = ["-i", str(tmp_path / "cons.fasta"),
            "-a", str(tmp_path / "adapters.fasta"),
            "-t", "-g", "3", "--backend", "cpu"]
    tree, err = _supervised(cli_postprocess, args, tmp_path)
    assert "rss supervisor: 3 restart(s)" in err, err[-3000:]

    from c3poa_tpu.pipeline.backend import NumpyBackend as JaxNumpy
    from c3poa_tpu.pipeline.postprocess import (
        PostprocessConfig as JaxPostConfig,
    )
    from c3poa_tpu.pipeline.postprocess import (
        run_postprocess as jax_run_postprocess,
    )
    jax_out = str(tmp_path / "jax")
    jax_run_postprocess(str(tmp_path / "cons.fasta"), jax_out,
                        str(tmp_path / "adapters.fasta"), None,
                        JaxPostConfig(trim=True, group_size=3), JaxNumpy())
    assert _tree(jax_out) == tree
