"""The port stands alone: no module of ``c3poa_tpu_torch`` (nor
``chip_smoke.py``) imports the JAX package or jax, statically or at run
time; its native loader builds its own copy of the C sources and never
touches ``native/libc3poa_native.so``; and its numpy backend, pipeline
and CLI are byte-identical to the JAX package's on the golden
fixtures."""

import ast
import hashlib
import os
import shutil
import subprocess
import sys
import time

import pytest

from c3poa_tpu.pipeline.backend import NumpyBackend as JaxPkgNumpyBackend
from c3poa_tpu.pipeline.run import PipelineConfig as JaxPkgConfig
from c3poa_tpu.pipeline.run import run_pipeline as jax_pkg_run_pipeline
from c3poa_tpu_torch.pipeline.backend import NumpyBackend
from c3poa_tpu_torch.pipeline.run import PipelineConfig, run_pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "c3poa_tpu_torch")
GOLDEN = os.path.join(ROOT, "tests", "golden")
GOLDEN_FILES = (
    "c3poa.log",
    "Splint1/R2C2_Consensus.fasta",
    "Splint1/R2C2_Subreads.fastq",
    "Splint2/R2C2_Consensus.fasta",
    "Splint2/R2C2_Subreads.fastq",
)


def _port_sources():
    out = []
    for d, _dirs, files in os.walk(PORT):
        out += [os.path.relpath(os.path.join(d, f), ROOT)
                for f in files if f.endswith(".py")]
    return sorted(out) + ["chip_smoke.py"]


def _imported(path):
    """Absolute module names a file imports (relative imports resolved
    against its package)."""
    pkg = os.path.relpath(path, ROOT)[:-3].split(os.sep)[:-1]
    names = []
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg[:len(pkg) - node.level + 1]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module
            names.append(mod)
    return names


@pytest.mark.parametrize("rel", _port_sources())
def test_module_imports_neither_jax_nor_the_jax_package(rel):
    for name in _imported(os.path.join(ROOT, rel)):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "c3poa_tpu"), \
            f"{rel} imports {name}"


NO_JAX_PACKAGE = """
import sys
for k in [k for k in sys.modules
          if k.split('.')[0] in ('jax', 'jaxlib', 'c3poa_tpu')]:
    del sys.modules[k]
sys.path.insert(0, ROOT)
import c3poa_tpu_torch.cli
import c3poa_tpu_torch.cli_postprocess
import c3poa_tpu_torch.pipeline.torch_backend
import c3poa_tpu_torch.pipeline.postprocess
import c3poa_tpu_torch.parallel.dist
import c3poa_tpu_torch.parallel.mesh
import c3poa_tpu_torch.tools.adapters_time
import c3poa_tpu_torch.tools.banded_sass
import c3poa_tpu_torch.tools.banded_chain
import c3poa_tpu_torch.tools.demux_nextera_tso
import c3poa_tpu_torch.tools.floor_probe
import c3poa_tpu_torch.tools.int16_probe
import c3poa_tpu_torch.tools.make_example
import c3poa_tpu_torch.tools.poa_stress
import c3poa_tpu_torch.tools.smooth_error
import c3poa_tpu_torch.tools.soak
import c3poa_tpu_torch.tools.stress_bigreads
import chip_smoke
bad = sorted(k for k in sys.modules
             if k.split('.')[0] in ('jax', 'jaxlib', 'c3poa_tpu'))
print('leaked', bad)
"""


def test_entry_points_load_no_jax_package():
    """In a fresh interpreter: the port's entry points (the CLIs and the
    tools) and chip_smoke leave no c3poa_tpu.* and no jax* module in
    sys.modules."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c",
                        f"ROOT = {ROOT!r}\n" + NO_JAX_PACKAGE],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "leaked []"


def _copy_tree(tmp_path):
    """A checkout-like copy with the port and ``native/``, where
    ``native/libc3poa_native.so`` is planted older than the C sources
    (the JAX package's loader would rerun ``make -B`` on it)."""
    root = tmp_path / "repo"
    shutil.copytree(PORT, root / "c3poa_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(os.path.join(ROOT, "native"), root / "native",
                    ignore=shutil.ignore_patterns("*.so"))
    so = root / "native" / "libc3poa_native.so"
    so.write_bytes(b"not a library")
    old = time.time() - 10 * 86400
    os.utime(so, (old, old))
    return root, so


LOAD = ("import sys; sys.path.insert(0, {root!r}); "
        "from c3poa_tpu_torch import native; "
        "print(native.available(), native.get_lib()._name)")


def test_native_loader_leaves_the_jax_package_library_alone(tmp_path):
    root, so = _copy_tree(tmp_path)
    before = (so.read_bytes(), os.stat(so).st_mtime_ns)
    r = subprocess.run([sys.executable, "-c", LOAD.format(root=str(root))],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    ok, path = r.stdout.split()
    assert ok == "True"
    assert path.startswith(str(root / "build" / "c3poa_tpu_torch" /
                               "native"))
    assert (so.read_bytes(), os.stat(so).st_mtime_ns) == before


def test_native_build_is_safe_under_concurrent_loaders(tmp_path):
    """Six processes load at once into an empty build directory (tier-1
    runs with six workers): all load the one library, no partial file
    is left."""
    root, _ = _copy_tree(tmp_path)
    procs = [subprocess.Popen([sys.executable, "-c",
                               LOAD.format(root=str(root))],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        outs.append(out.split())
    assert {o[0] for o in outs} == {"True"}
    assert len({o[1] for o in outs}) == 1
    built = os.listdir(root / "build" / "c3poa_tpu_torch" / "native")
    assert sorted(f for f in built if not f.startswith(".")) == \
        [os.path.basename(outs[0][1])]


def _digest(path):
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def test_golden_numpy_backend_matches_jax_package(tmp_path):
    """The port's run_pipeline + NumpyBackend writes what the JAX
    package's does, which is the committed golden output."""
    args = (os.path.join(GOLDEN, "reads.fastq"),
            os.path.join(GOLDEN, "splint.fasta"))
    run_pipeline(*args, str(tmp_path / "port"),
                 PipelineConfig(lencutoff=500, group_size=7), NumpyBackend())
    jax_pkg_run_pipeline(*args, str(tmp_path / "jax_package"),
                         JaxPkgConfig(lencutoff=500, group_size=7),
                         JaxPkgNumpyBackend())
    for rel in GOLDEN_FILES:
        want = _digest(os.path.join(GOLDEN, "expected", rel))
        assert _digest(tmp_path / "port" / rel) == want, rel
        assert _digest(tmp_path / "jax_package" / rel) == want, rel


def test_port_cli_numpy_matches_jax_cli_numpy_on_golden(tmp_path):
    common = ["-r", os.path.join(GOLDEN, "reads.fastq"),
              "-s", os.path.join(GOLDEN, "splint.fasta"), "-l", "500",
              "-g", "7", "--backend", "numpy"]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    for mod, out in (("c3poa_tpu_torch.cli", "port"),
                     ("c3poa_tpu.cli", "jax_package")):
        r = subprocess.run([sys.executable, "-m", mod, *common, "-o",
                            str(tmp_path / out)], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, r.stderr[-2000:]
    for rel in GOLDEN_FILES:
        a = open(tmp_path / "port" / rel, "rb").read()
        assert a and a == open(tmp_path / "jax_package" / rel, "rb").read()
        assert a == open(os.path.join(GOLDEN, "expected", rel), "rb").read()
