"""The port's group stream parses plain FASTQ in C
(``native.read_fastq_encoded`` over ``native_src/fastxio.c``); its spec
is the Python parse (``io.fastx.read_fastq_offsets``, encoded read by
read).  Each edge input runs through ``_GroupStream`` both ways, the C
way at chunk sizes that cut its records at every byte position: the
same groups (names, codes, qualities, lengths), the same resume offsets
and short-read count, and the same exception where the Python parse
raises.  Whole runs on plain FASTQ, gzip FASTQ and FASTA inputs give
the JAX package's numpy trees byte for byte, and count the groups the
C path made in ``stream_native_groups``."""

import functools
import gzip
import json
import os

import numpy as np
import pytest

from c3poa_tpu_torch import native, sim
from c3poa_tpu_torch.pipeline import run as port_run
from c3poa_tpu_torch.pipeline.backend import NumpyBackend
from c3poa_tpu_torch.pipeline.run import PipelineConfig, run_pipeline
from c3poa_tpu_torch.pipeline.torch_backend import TorchBackend

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library not built")

LENCUTOFF = 4
GROUP = 2


def _rec(name, seq, qual=None, plus=b"+", nl=b"\n"):
    qual = b"I" * len(seq) if qual is None else qual
    return b"@" + name + nl + seq + nl + plus + nl + qual + nl


FIRST = _rec(b"r1 comment", b"ACGTACGTAC")
REST = (_rec(b"r2", b"AC")                         # under LENCUTOFF
        + _rec(b"r3", b"acgtNNRYacgt", b"!#+5?IJK~~~~")
        + _rec(b"r4", b"GGGG")
        + _rec(b"r5", b"TTTTTTTTTTTTTTTTTTTTTTTTTTTTTT"))
GOOD = FIRST + REST

CASES = {
    "clean": GOOD,
    "empty_file": b"",
    "crlf": GOOD.replace(b"\n", b"\r\n"),
    "trailing_space_tab": (_rec(b"r1 \t", b"ACGTAC \t", b"IIIIII\t \t")
                           + _rec(b"r2\t", b"ACGTT  ", b"IIIII")),
    "header_vt_ff": (_rec(b"\x0b r1\x0cdesc", b"ACGTAC")
                     + _rec(b"r2\x0bx", b"ACGTACG")
                     + _rec(b"\x0c", b"ACGTACGT")
                     + _rec(b"", b"ACGTA")),
    "cr_inside": (_rec(b"r\r1", b"AC\rGTA", b"II\rIII")
                  + _rec(b"r2", b"\rACGT\r", b"\rIIII\r")),
    "empty_seq": _rec(b"e1", b"") + GOOD + _rec(b"e2", b""),
    "low_quals": _rec(b"q1", b"ACGTACGT", b"I\x01\x1f \x00\t!I")
    + _rec(b"q2", b"ACGTAC", b"\x7f\x20\x0b\x0c\x1fI"),
    "nul_and_spaces_in_seq": _rec(b"n1", b"AC\x00G T\x7fA", b"IIIIIIII"),
    "plus_line_ignored": (_rec(b"p1", b"ACGTA", plus=b"+p1 \xff")
                          + _rec(b"p2", b"ACGTAC", plus=b"")
                          + _rec(b"p3", b"ACGTACG", plus=b"@notaheader")),
    "no_final_newline": GOOD + _rec(b"last", b"ACGTACGT")[:-1],
    "final_plus_no_qual": GOOD + b"@e\n\n+",
    "non_ascii_comment": _rec(b"r1 caf\xc3\xa9", b"ACGTAC") + GOOD,
    # the Python parse raises on each of these (RAISES)
    "blank_line_between": FIRST + b"\n" + REST,
    "blank_line_first": b"\n" + GOOD,
    "trailing_blank_line": GOOD + b"\n",
    "trailing_crlf_line": GOOD + b"\r\n",
    "truncated_no_plus": GOOD + b"@t1\nACGTACGT\n",
    "truncated_header_only": GOOD + b"@t1",
    "truncated_last_qual": GOOD + b"@t1\nACGTACGT\n+\nIIII",
    "qual_longer": GOOD + _rec(b"m1", b"ACGTA", b"IIIIII"),
    "qual_shorter": _rec(b"m1", b"ACGTACGT", b"IIIIIII") + GOOD,
    "separator_not_at": GOOD + b">r6\nACGTACGT\n+\nIIIIIIII\n",
    "non_ascii_name": GOOD + _rec(b"caf\xc3\xa9", b"ACGTACGT"),
    "non_ascii_seq": GOOD + _rec(b"s1", b"ACG\xe9TACG", b"IIIIIIII"),
    "non_ascii_qual": GOOD + _rec(b"s1", b"ACGTACGT", b"IIII\x80III"),
    "non_ascii_trailing": GOOD + _rec(b"s1", b"ACGTACGT\xa0", b"IIIIIIII\xa0"),
}
RAISES = {
    "blank_line_between", "blank_line_first", "trailing_blank_line",
    "trailing_crlf_line", "truncated_no_plus", "truncated_header_only",
    "truncated_last_qual", "qual_longer", "qual_shorter",
    "separator_not_at", "non_ascii_name", "non_ascii_seq",
    "non_ascii_qual", "non_ascii_trailing",
}


def _stream_out(path, monkeypatch, use_c, skip=0, manifest=None,
                chunk=None, records=None):
    """Every group of ``_GroupStream`` over ``path`` as plain data, its
    checkpoint fields, the short-read count and the exception raised."""
    with monkeypatch.context() as m:
        if not use_c:
            m.setattr(native, "available", lambda: False)
        elif chunk is not None:
            m.setattr(native, "read_fastq_encoded", functools.partial(
                native.read_fastq_encoded, chunk=chunk, records=records))
        stats = port_run.PipelineStats()
        stream = port_run._GroupStream(
            path, PipelineConfig(lencutoff=LENCUTOFF, group_size=GROUP),
            stats, skip, manifest)
        # a file not starting with '@' is not plain FASTQ: read_fastx
        assert stream.native == (use_c and stream.seekable)
        groups, err = [], None
        try:
            for gi, group in stream:
                groups.append((gi, [
                    (r.name, r.codes.dtype, r.codes.tobytes(),
                     r.quals.dtype, r.quals.tobytes(), r.length)
                    for r in group], stream.checkpoint_fields(gi)))
        except Exception as e:  # noqa: BLE001 -- compared below
            err = (type(e), str(e))
        return groups, stats.short_reads, err


@pytest.mark.parametrize("case", sorted(CASES))
def test_c_stream_matches_python_parse(tmp_path, monkeypatch, case):
    data = CASES[case]
    path = str(tmp_path / "r.fastq")
    with open(path, "wb") as fh:
        fh.write(data)
    want = _stream_out(path, monkeypatch, use_c=False)
    assert _stream_out(path, monkeypatch, use_c=True) == want
    for chunk in range(1, max(len(data), 1) + 2):
        for records in (1, 3):
            got = _stream_out(path, monkeypatch, True, chunk=chunk,
                              records=records)
            assert got == want, (chunk, records)
    # every group's checkpoint resumes to the same rest of the stream
    for gi, _group, fields in want[0]:
        if not fields:
            continue
        rest = [_stream_out(path, monkeypatch, use_c, skip=gi,
                            manifest=fields, chunk=7, records=2)
                for use_c in (False, True)]
        assert rest[0] == rest[1]
        assert rest[0][0] == [g for g in want[0] if g[0] > gi]
        assert rest[0][1:] == want[1:]
    assert (want[2] is not None) == (case in RAISES), want[2]


def test_c_stream_matches_python_parse_on_reads(tmp_path, monkeypatch):
    """A simulated R2C2 pool (reads of 1.5-6 kb) at the default chunk,
    at one a little longer than a read (the buffer grows) and at a few
    records a call."""
    reads, _ = sim.make_dataset(n_reads=40, seed=5, insert_len=(300, 1200),
                                copies=(3, 5), error=0.05)
    path = str(tmp_path / "r.fastq")
    sim.write_fastq(path, reads)
    want = _stream_out(path, monkeypatch, use_c=False)
    assert want[2] is None and len(want[0]) == 20
    assert _stream_out(path, monkeypatch, use_c=True) == want
    assert _stream_out(path, monkeypatch, True, chunk=4096,
                       records=3) == want


def _write_input(d, fmt, reads):
    if fmt == "fasta":
        path = str(d / "r.fasta")
        sim.write_fasta(path, {r.name: r.seq for r in reads})
        return path
    path = str(d / "r.fastq")
    sim.write_fastq(path, reads)
    if fmt == "fastq.gz":
        with open(path, "rb") as src, gzip.open(path + ".gz", "wb") as dst:
            dst.write(src.read())
        path += ".gz"
    return path


TREE = ("c3poa.log", "Splint1/R2C2_Consensus.fasta",
        "Splint1/R2C2_Subreads.fastq")


@pytest.mark.parametrize("backend", ["numpy", "cpu"])
@pytest.mark.parametrize("fmt", ["fastq", "fastq.gz", "fasta"])
def test_tree_matches_jax_package_and_counts_native_groups(tmp_path, fmt,
                                                           backend):
    """The output tree equals the JAX package's numpy run on the same
    input, and ``stream_native_groups`` counts every group of a plain
    FASTQ input and none of a gzip or FASTA one."""
    from c3poa_tpu.pipeline.backend import NumpyBackend as JaxNumpy
    from c3poa_tpu.pipeline.run import PipelineConfig as JaxConfig
    from c3poa_tpu.pipeline.run import run_pipeline as jax_run_pipeline

    reads, splints = sim.make_dataset(n_reads=7, seed=11,
                                      insert_len=(300, 500), copies=(3, 5),
                                      error=0.04)
    path = _write_input(tmp_path, fmt, reads)
    splint = str(tmp_path / "s.fasta")
    sim.write_fasta(splint, splints)
    out, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    be = NumpyBackend() if backend == "numpy" else TorchBackend("cpu")
    run_pipeline(path, splint, out, PipelineConfig(group_size=3,
                                                   lencutoff=100), be)
    jax_run_pipeline(path, splint, ref, JaxConfig(group_size=3,
                                                  lencutoff=100), JaxNumpy())
    for rel in TREE:
        assert open(os.path.join(out, rel), "rb").read() == \
            open(os.path.join(ref, rel), "rb").read(), rel
    counters = json.load(open(os.path.join(out, "c3poa_stats.json")))[
        "counters"]
    assert counters.get("stream_native_groups", 0) == \
        (3 if fmt == "fastq" else 0)
    assert counters["reads"] == 7


def test_records_pickle_as_int8_arrays():
    """Groups cross to the CPU path's worker processes by pickle: a
    record of the C path keeps its own bytes only, as int8.  Each read's
    codes are an array of their own, the base of a subread cut from
    them, as ``encode``'s are (the benchmark's recorder finds a pair's
    read by it)."""
    import pickle
    path = os.path.join(os.path.dirname(__file__), "golden", "reads.fastq")
    rec, _off = next(native.read_fastq_encoded(path))
    assert rec.codes[3:9].base is rec.codes
    assert rec.quals[3:9].base is rec.quals
    blob = pickle.dumps(rec)
    assert len(blob) < 2 * rec.length + 1024  # not the whole chunk's
    back = pickle.loads(blob)
    assert back.codes.dtype == np.int8 and back.quals.dtype == np.int8
    assert (back.name, back.length) == (rec.name, rec.length)
    assert np.array_equal(back.codes, rec.codes)
    assert np.array_equal(back.quals, rec.quals)
