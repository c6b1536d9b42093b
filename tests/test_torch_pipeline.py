"""The whole consensus run through the port on the CPU: the golden
fixtures, the port's CLI against the JAX package's CLI (numpy backend),
and the port's freedom from jax."""

import os
import subprocess
import sys

import pytest
import torch

from c3poa_tpu_torch import cli
from c3poa_tpu_torch.pipeline.run import PipelineConfig, run_pipeline
from c3poa_tpu_torch.pipeline.torch_backend import TorchBackend

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
GOLDEN_FILES = (
    "c3poa.log",
    "Splint1/R2C2_Consensus.fasta",
    "Splint1/R2C2_Subreads.fastq",
    "Splint2/R2C2_Consensus.fasta",
    "Splint2/R2C2_Subreads.fastq",
)


def test_golden_torch_backend_cpu(tmp_path):
    """The committed golden output, byte for byte, through TorchBackend
    (7-read groups: the pipelined locate and align threads both run)."""
    out = str(tmp_path / "out")
    run_pipeline(os.path.join(GOLDEN, "reads.fastq"),
                 os.path.join(GOLDEN, "splint.fasta"), out,
                 PipelineConfig(lencutoff=500, group_size=7),
                 TorchBackend("cpu"))
    for rel in GOLDEN_FILES:
        exp = open(os.path.join(GOLDEN, "expected", rel), "rb").read()
        got = open(os.path.join(out, rel), "rb").read()
        assert got == exp, f"{rel} differs from the golden fixture"


def _run(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return r


def test_cli_cpu_matches_jax_cli_numpy(tmp_path):
    d = str(tmp_path)
    _run(["-m", "c3poa_tpu.tools.make_example", "-o", d, "-n", "8"],
         tmp_path)
    common = ["-r", os.path.join(d, "reads.fastq"),
              "-s", os.path.join(d, "splint.fasta"), "-g", "5"]
    _run(["-m", "c3poa_tpu_torch.cli", *common, "-o",
          os.path.join(d, "torch"), "--backend", "cpu"], tmp_path)
    _run(["-m", "c3poa_tpu.cli", *common, "-o", os.path.join(d, "numpy"),
          "--backend", "numpy"], tmp_path)
    for rel in ("c3poa.log", "Splint1/R2C2_Consensus.fasta",
                "Splint1/R2C2_Subreads.fastq"):
        a = open(os.path.join(d, "torch", rel), "rb").read()
        b = open(os.path.join(d, "numpy", rel), "rb").read()
        assert a and a == b, rel


NO_JAX = """
import sys
for k in [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib')]:
    del sys.modules[k]

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib'):
            raise ImportError('jax imported by ' + repr(name))
        return None

sys.meta_path.insert(0, _Block())
import c3poa_tpu_torch.cli
import c3poa_tpu_torch.pipeline.torch_backend
import c3poa_tpu_torch.kernels.locate, c3poa_tpu_torch.kernels.banded
assert not [k for k in sys.modules if k.split('.')[0] == 'jax'], 'jax'
print('no jax')
"""


def test_port_never_imports_jax(tmp_path):
    """In a fresh interpreter (this test process has jax loaded through
    conftest), with any jax import made an error."""
    r = _run(["-c", NO_JAX], tmp_path)
    assert r.stdout.strip() == "no jax"


def test_cli_backend_choices():
    args = cli.parse_args(["-r", "x", "-s", "y"])
    assert args.backend == "cuda"
    with pytest.raises(SystemExit):
        cli.parse_args(["-r", "x", "-s", "y", "--backend", "auto"])
    assert isinstance(cli.pick_backend("cpu"), TorchBackend)
    if not torch.cuda.is_available():
        # no silent CPU run when the card was asked for
        with pytest.raises(RuntimeError, match="is_available"):
            cli.pick_backend("cuda")
