"""The port's soak tool (``c3poa_tpu_torch/tools/soak.py``) on the CPU:
its generator byte-equal to the original ``tools/soak.py``'s, its flat
verdict, and a small soak end to end with ``--backend cpu``, once
uninterrupted and once SIGKILLed and resumed, the two trees equal."""

import importlib.util
import json
import os
import shutil

import pytest

from c3poa_tpu_torch.tools import soak

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _original():
    spec = importlib.util.spec_from_file_location(
        "original_soak", os.path.join(ROOT, "tools", "soak.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n_reads,seed", [(3, 0), (7, 11)])
def test_generate_matches_original(tmp_path, n_reads, seed):
    """The dataset of ``(reads, seed)``: reads, splint and meta byte-equal
    to the original generator's."""
    soak.generate(str(tmp_path / "port"), n_reads, seed=seed)
    _original().generate(str(tmp_path / "orig"), n_reads, seed=seed)
    for f in ("reads.fastq", "splint.fasta", "meta.json"):
        a = (tmp_path / "port" / f).read_bytes()
        assert a and a == (tmp_path / "orig" / f).read_bytes(), f


def test_flat_verdict():
    """Thirds after the first 5% of the wall; the last third's largest
    within 1.10 x the first's + 64 MB."""
    ramp = [(t, 1000 + 10 * t) for t in range(0, 101, 5)]
    assert soak.flat(ramp, 100) is False
    assert soak.flat([(t, 1000 + t % 7) for t in range(101)], 100) is True
    assert soak.flat([(t, 200) for t in range(40)] + [(99, 280)], 100)
    assert soak.flat([(1, 5), (2, 5)], 100) is None


def test_refuses_paths_in_the_checkout_outside_build():
    with pytest.raises(SystemExit, match="build/"):
        soak.main(["--reads", "1", "--out", os.path.join(ROOT, "SOAK.json")])
    with pytest.raises(SystemExit, match="build/"):
        soak.main(["--reads", "1", "--dir", os.path.join(ROOT, "soakdata")])
    assert not os.path.exists(os.path.join(ROOT, "soakdata"))


def test_soak_cpu_resume_matches_uninterrupted(tmp_path, monkeypatch,
                                               capsys):
    """30 reads in groups of 5 through ``--backend cpu``: uninterrupted,
    then with ``--resume-test`` (one SIGKILL of the CLI's process group
    mid-run, and a resume); both trees and their hashes equal, the
    result's keys present and its consensus verdict a pass."""
    monkeypatch.setattr(soak, "SAMPLE_S", 0.5)
    monkeypatch.setattr(soak, "GROUP_SIZE", 5)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    d = str(tmp_path / "soak")
    common = ["--reads", "30", "--dir", d, "--backend", "cpu"]
    soak.main(common + ["--out", str(tmp_path / "plain.json")])
    plain = json.load(open(tmp_path / "plain.json"))
    shutil.copytree(os.path.join(d, "out"), tmp_path / "plain")
    soak.main(common + ["--out", str(tmp_path / "resumed.json"),
                        "--resume-test", "--kill-after", "8"])
    resumed = json.load(open(tmp_path / "resumed.json"))
    assert "dataset cached" in capsys.readouterr().err

    keys = {"reads", "wall_s", "reads_per_sec", "consensi", "rss_mb_min",
            "rss_mb_max", "rss_samples", "sigkills", "launches",
            "log_exists", "device_used_mb_min", "device_used_mb_max",
            "reserved_mb_min", "reserved_mb_max", "output_sha256", "pass",
            "stages_s"}
    for res in (plain, resumed):
        assert keys <= set(res)
        assert res["reads"] == 30 and res["log_exists"]
        assert res["consensi"] > 0 and res["pass"]["consensi"] is True
        assert res["launches"]["locate_launches"] > 0
        assert res["launches"]["align_launches"] > 0
        assert res["rss_mb_max"] > 0
        assert res["pass"]["flat_device"] is None  # no card here
    assert plain["sigkills"] == 0
    assert resumed["sigkills"] == 1 and resumed["killed_at_groups"][0] < 6
    assert resumed["consensi"] == plain["consensi"]
    assert resumed["output_sha256"] == plain["output_sha256"]
    assert len(plain["output_sha256"]) == 3
    for rel in soak.OUTPUT_FILES:
        assert (tmp_path / "plain" / rel).read_bytes() == \
            open(os.path.join(d, "out", rel), "rb").read(), rel
