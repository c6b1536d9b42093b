"""Resume of the port's consensus run, in-process: the counterparts of
``tests/test_resume_tools.py:22,149,201,251`` run on ``c3poa_tpu_torch``
(its numpy backend and ``TorchBackend("cpu")``, the plain versions of
the kernels), each held to the port's own uninterrupted run and once to
the JAX package's ``run_pipeline`` with its ``NumpyBackend``; and a
mutant writer that does not truncate on resume, which the forged resume
must catch."""

import json
import os
import shutil

import pytest
import torch

from c3poa_tpu_torch import sim
from c3poa_tpu_torch.io.fastx import read_fastx
from c3poa_tpu_torch.pipeline import run as port_run
from c3poa_tpu_torch.pipeline.backend import NumpyBackend
from c3poa_tpu_torch.pipeline.run import MANIFEST, PipelineConfig, run_pipeline
from c3poa_tpu_torch.pipeline.torch_backend import TorchBackend
from c3poa_tpu_torch.utils.mem import RssRestartNeeded

torch.set_num_threads(1)

FILES = ("c3poa.log", "Splint1/R2C2_Consensus.fasta",
         "Splint1/R2C2_Subreads.fastq")
SPLINT_FILES = FILES[1:]


def _inputs(d, n_reads, seed):
    reads, splints = sim.make_dataset(
        n_reads=n_reads, seed=seed, insert_len=(300, 500), copies=(3, 5),
        error=0.04)
    sim.write_fastq(str(d / "r.fastq"), reads)
    sim.write_fasta(str(d / "s.fasta"), splints)
    return str(d / "r.fastq"), str(d / "s.fasta")


def _files(out, rels=FILES):
    return {rel: open(os.path.join(out, rel), "rb").read() for rel in rels}


def _backend(name):
    return NumpyBackend() if name == "numpy" else TorchBackend("cpu")


def _forge_after_group_1(d, reads, splint, cfg, backend, full, tail):
    """The state of a run stopped after its first group: a manifest
    claiming group 1 done, with the sizes of the first group's outputs
    (a run over the first ``group_size`` reads alone).  With ``tail`` the
    files hold the whole uninterrupted output past those sizes, as a
    SIGKILL between a group's writes and its checkpoint leaves them;
    without, they end at the recorded sizes."""
    small = str(d / "small")
    first = list(read_fastx(reads))[:cfg.group_size]
    with open(d / "first.fastq", "w") as fh:
        for r in first:
            fh.write(f"@{r.name}\n{r.seq}\n+\n{r.qual}\n")
    run_pipeline(str(d / "first.fastq"), splint, small,
                 PipelineConfig(group_size=cfg.group_size,
                                lencutoff=cfg.lencutoff), backend)
    sizes = {rel: os.path.getsize(os.path.join(small, rel))
             for rel in SPLINT_FILES}
    resumed = str(d / "resumed")
    os.makedirs(os.path.join(resumed, "Splint1"))
    for rel in SPLINT_FILES:
        src = os.path.join(full if tail else small, rel)
        shutil.copy(src, os.path.join(resumed, rel))
        if tail:
            body = open(src, "rb").read()
            assert len(body) > sizes[rel]
            assert body[:sizes[rel]] == \
                open(os.path.join(small, rel), "rb").read()
    n_cons = sum(1 for _ in read_fastx(
        os.path.join(small, "Splint1", "R2C2_Consensus.fasta")))
    with open(os.path.join(resumed, MANIFEST), "w") as fh:
        json.dump({"key": cfg.resume_key(reads, splint), "groups_done": 1,
                   "files": sizes,
                   "stats": {"total_reads": len(first), "short_reads": 0,
                             "no_splint": 0, "consensus_written": n_cons}},
                  fh)
    return resumed


@pytest.mark.parametrize("backend", ["numpy", "cpu"])
@pytest.mark.parametrize("tail", [False, True], ids=["at_sizes", "tail"])
def test_resume_reproduces_full_run(tmp_path, backend, tail):
    """``test_resume_tools.py:22`` (numpy backend) and ``:149`` (the deep
    pipeline: ``TorchBackend("cpu")`` where the original has
    ``TpuBackend``): a forged manifest after group 1, then ``resume``
    over the whole input, gives the uninterrupted run's bytes; the numpy
    arm also equals the JAX package's run on the same inputs."""
    reads, splint = _inputs(tmp_path, 8, 3)
    cfg = PipelineConfig(group_size=3, lencutoff=100)
    be = _backend(backend)
    assert getattr(be, "supports_overlap", False) == (backend == "cpu")
    full = str(tmp_path / "full")
    run_pipeline(reads, splint, full, cfg, be)
    resumed = _forge_after_group_1(tmp_path, reads, splint, cfg, be, full,
                                   tail)
    run_pipeline(reads, splint, resumed,
                 PipelineConfig(group_size=3, lencutoff=100, resume=True), be)
    assert json.load(open(os.path.join(resumed, MANIFEST)))[
        "groups_done"] == 3
    assert _files(resumed) == _files(full)

    if backend == "numpy" and not tail:
        from c3poa_tpu.pipeline.backend import NumpyBackend as JaxNumpy
        from c3poa_tpu.pipeline.run import PipelineConfig as JaxConfig
        from c3poa_tpu.pipeline.run import run_pipeline as jax_run_pipeline
        jax_out = str(tmp_path / "jax")
        jax_run_pipeline(reads, splint, jax_out,
                         JaxConfig(group_size=3, lencutoff=100), JaxNumpy())
        assert _files(full) == _files(jax_out)


def test_resume_without_truncation_differs(tmp_path, monkeypatch):
    """The mutant: a writer that appends on resume without truncating to
    the checkpointed size keeps the killed session's tail, and the forged
    resume must then give other bytes than the uninterrupted run."""
    reads, splint = _inputs(tmp_path, 8, 3)
    cfg = PipelineConfig(group_size=3, lencutoff=100)
    full = str(tmp_path / "full")
    run_pipeline(reads, splint, full, cfg)
    resumed = _forge_after_group_1(tmp_path, reads, splint, cfg,
                                   NumpyBackend(), full, tail=True)

    def no_truncate(self, path, rel):
        return open(path, "a" if rel in self.restore_sizes else "w")

    monkeypatch.setattr(port_run._SplintWriters, "_open", no_truncate)
    run_pipeline(reads, splint, resumed,
                 PipelineConfig(group_size=3, lencutoff=100, resume=True))
    got, want = _files(resumed, SPLINT_FILES), _files(full, SPLINT_FILES)
    for rel in SPLINT_FILES:
        assert got[rel] != want[rel], f"{rel}: the mutant went unnoticed"
        assert got[rel].startswith(want[rel])


def _sessions(reads, splint, out, cfg, backend=None):
    """Runs ``run_pipeline`` again after every ``RssRestartNeeded``, as
    the supervisor does in new processes; returns the session count."""
    sessions = 0
    while True:
        sessions += 1
        assert sessions < 20
        try:
            run_pipeline(reads, splint, out, cfg, backend)
            return sessions
        except RssRestartNeeded:
            continue


def _spy_starts(monkeypatch) -> list:
    """The offsets the group stream starts parsing the FASTQ at, by the
    C parse (``native.read_fastq_encoded``) or, without the library, the
    Python one (``io.fastx.read_fastq_offsets``)."""
    import c3poa_tpu_torch.io.fastx as fastx
    from c3poa_tpu_torch import native

    starts = []
    for mod, name in ((native, "read_fastq_encoded"),
                      (fastx, "read_fastq_offsets")):
        def spy(path, start_offset=0, _orig=getattr(mod, name)):
            starts.append(start_offset)
            return _orig(path, start_offset)
        monkeypatch.setattr(mod, name, spy)
    return starts


def test_seek_resume_skips_completed_input(tmp_path, monkeypatch):
    """``test_resume_tools.py:201``: sessions after the first seek into
    the FASTQ (the group stream's parse starts mid-file) and the output,
    ``c3poa.log`` included, is the uninterrupted run's."""
    reads, splint = _inputs(tmp_path, 9, 13)
    clean = str(tmp_path / "clean")
    run_pipeline(reads, splint, clean,
                 PipelineConfig(group_size=3, lencutoff=100))

    starts = _spy_starts(monkeypatch)
    out = str(tmp_path / "restarted")
    sessions = _sessions(reads, splint, out,
                         PipelineConfig(group_size=3, lencutoff=100,
                                        resume=True, rss_restart_mb=1))
    assert sessions == 4  # a restart after each of the 3 groups
    assert starts[0] == 0 and all(s > 0 for s in starts[1:]), starts
    assert _files(out) == _files(clean)


@pytest.mark.parametrize("backend", ["numpy", "cpu"])
def test_seek_resume_from_c_parse_checkpoint(tmp_path, monkeypatch,
                                             backend):
    """The C parse writes each checkpoint's offset and later sessions seek
    to it through the C parse; every session's groups come from it
    (``stream_native_groups``), and the tree is the uninterrupted run's
    byte for byte, on the numpy backend and ``TorchBackend("cpu")``."""
    from c3poa_tpu_torch import native
    if not native.available():
        pytest.skip("native library not built")
    reads, splint = _inputs(tmp_path, 11, 23)
    be = _backend(backend)
    clean = str(tmp_path / "clean")
    run_pipeline(reads, splint, clean,
                 PipelineConfig(group_size=4, lencutoff=100), be)

    starts = _spy_starts(monkeypatch)
    offsets, native_groups = [], []
    orig = port_run._GroupStream.checkpoint_fields

    def checkpoint_fields(self, gi):
        fields = orig(self, gi)
        offsets.append(fields.get("next_offset"))
        native_groups.append(
            port_run.prof.current.counts["stream_native_groups"])
        return fields

    monkeypatch.setattr(port_run._GroupStream, "checkpoint_fields",
                        checkpoint_fields)
    out = str(tmp_path / "restarted")
    sessions = _sessions(reads, splint, out,
                         PipelineConfig(group_size=4, lencutoff=100,
                                        resume=True, rss_restart_mb=1), be)
    assert sessions == 4  # a restart after each of the 3 groups
    # the last group is partial: it stores no offset, so the session that
    # finds every group done streams from the start and skips by count
    assert starts == [0] + offsets[:2] + [0] and offsets[2] is None, \
        (starts, offsets)
    # at its checkpoint a session has streamed its group, and the deep
    # pipeline (``TorchBackend``) up to two groups ahead of it
    assert native_groups == ([1, 1, 1] if backend == "numpy"
                             else [3, 2, 1])
    assert _files(out) == _files(clean)


def test_rss_restart_in_process_with_deep_pipeline(tmp_path):
    """``test_resume_tools.py:251`` with ``TorchBackend("cpu")``: a
    restart raised at a checkpoint while the deep pipeline has preps in
    flight leaks no record-arena lease, so the retry in the same process
    raises no ``ArenaSlotCollision`` and gives the same bytes."""
    reads, splint = _inputs(tmp_path, 12, 17)
    backend = TorchBackend("cpu")
    assert backend.supports_overlap
    clean = str(tmp_path / "clean")
    run_pipeline(reads, splint, clean,
                 PipelineConfig(group_size=3, lencutoff=100), backend)
    out = str(tmp_path / "restarted")
    sessions = _sessions(reads, splint, out,
                         PipelineConfig(group_size=3, lencutoff=100,
                                        resume=True, rss_restart_mb=1),
                         backend)
    assert sessions == 5  # a restart after each of the 4 groups
    assert _files(out) == _files(clean)
