"""The port's probe kernels on the CPU against the TPU probes: the plain
torch versions against the JAX probe kernels of ``tools/int16_probe.py``
and ``tools/mosaic_floor_probe.py`` run in Pallas interpret mode (exact),
a g++ build of the int16 kernel's lane arithmetic
(``csrc/int16_probe.cuh``) against the same, the probes' entry points
on ``--device cpu``, and the SASS reading the floor probe's table rests
on.  The repo-root ``tools/`` files are loaded by path."""

import ctypes
import functools
import importlib.util
import os
import shutil
import subprocess
import sys

import jax
import jax.experimental.pallas
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c3poa_tpu_torch.kernels import _build, probes
from c3poa_tpu_torch.tools import floor_probe, int16_probe

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "c3poa_tpu_torch", "kernels", "csrc")


def _tpu_tool(name):
    """``tools/<name>.py`` as a module (it puts "." on sys.path when
    imported; that is undone)."""
    saved = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            f"tpu_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


@pytest.fixture(scope="module")
def tpu_int16():
    return _tpu_tool("int16_probe")


@pytest.fixture(scope="module")
def tpu_floor():
    return _tpu_tool("mosaic_floor_probe")


def _jax_int16(mod, x, y):
    fn = jax.experimental.pallas.pallas_call(
        mod.kernel, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int16),
        interpret=True)
    return np.asarray(fn(x, y))


def _full_range(B, seed):
    """int16 inputs over the whole range, with 32767 (whose + 1 wraps)
    and -32768 planted."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2 ** 15, 2 ** 15, (B, 128)).astype(np.int16)
    y = rng.integers(-2 ** 15, 2 ** 15, (B, 128)).astype(np.int16)
    y[:, 1::7] = -32768
    x[:, ::5] = 32767
    return x, y


@pytest.mark.parametrize("B", [1, 16, 40])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int16_plain_matches_jax_probe(tpu_int16, seed, B):
    """The original's input generator (seed 0, B = 16 is its own input)."""
    x, y = int16_probe.inputs(B, 128, seed)
    got = probes.int16_probe_plain(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(got.numpy(), _jax_int16(tpu_int16, x, y))


def test_int16_plain_wraps_as_jax(tpu_int16):
    x, y = _full_range(16, 3)
    got = probes.int16_probe_plain(torch.from_numpy(x), torch.from_numpy(y))
    want = _jax_int16(tpu_int16, x, y)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, 3::5] == -32768).all()


@pytest.fixture(scope="module")
def int16_host_lib(tmp_path_factory):
    """``i16p_host``: the kernel's lane arithmetic, built with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++")
    so = str(tmp_path_factory.mktemp("i16p") / "i16p_host.so")
    driver = os.path.join(ROOT, "tests", "int16_probe_host_driver.cpp")
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall",
                    "-Wextra", "-Werror", "-I", CSRC, "-o", so, driver],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(so)
    lib.i16p_host.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.i16p_host.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("B,full", [(1, False), (16, False), (40, True)])
def test_int16_kernel_lanes_match_jax_probe(tpu_int16, int16_host_lib, B,
                                            full):
    """Every lane's roll across the lane boundary, lane 31 to lane 0 with
    it, through the header's byte selectors and column mask."""
    x, y = _full_range(B, 4) if full else int16_probe.inputs(B, 128, 5)
    out = np.empty_like(x)
    assert int16_host_lib.i16p_host(x.ctypes.data, y.ctypes.data,
                                    out.ctypes.data, B) == 0
    np.testing.assert_array_equal(out, _jax_int16(tpu_int16, x, y))


@pytest.fixture
def interpret(monkeypatch):
    """``pallas_call`` in interpret mode, as ``build`` looks it up."""
    monkeypatch.setattr(jax.experimental.pallas, "pallas_call",
                        functools.partial(jax.experimental.pallas.pallas_call,
                                          interpret=True))


@pytest.mark.parametrize("M", [8, 16])
@pytest.mark.parametrize("S", [8, 16])
@pytest.mark.parametrize("mode", ["chain", "indep2", "indep4"])
def test_floor_plain_matches_jax_probe(tpu_floor, interpret, mode, S, M):
    niter = 16
    x = np.random.default_rng(S * M).integers(1, 7, (S, 128)).astype(
        np.int32)
    want = np.asarray(tpu_floor.build(S, M, niter, 128, mode)(x))
    got = probes.floor_probe_plain(torch.from_numpy(x), M, niter, mode)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["chain", "indep4"])
def test_floor_plain_wraps_as_jax(tpu_floor, interpret, mode):
    """Values near 2**30: the adds overflow int32 and wrap in both."""
    x = np.random.default_rng(9).integers(2 ** 29, 2 ** 30, (8, 128)).astype(
        np.int32)
    want = np.asarray(tpu_floor.build(8, 16, 3, 128, mode)(x))
    got = probes.floor_probe_plain(torch.from_numpy(x), 16, 3, mode)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < 0).any()


def test_int16_tool_on_cpu(capsys):
    assert int16_probe.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("INT16 OK")


def test_floor_tool_on_cpu_prints_its_table(capsys):
    assert floor_probe.main(["8", "2", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[1].split() == ["S", "tiles", "mode", "ms", "ns/op",
                                "ns/op/tile"]
    rows = [ln.split() for ln in lines[2:]]
    assert [(int(r[0]), r[2]) for r in rows] == [
        (S, m) for S in floor_probe.SIZES for m in floor_probe.MODES]
    assert all(float(r[3]) > 0 for r in rows)


@pytest.mark.parametrize("tool", [int16_probe, floor_probe])
def test_tools_on_cuda_without_a_card_raise(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tool.main(["--device", "cuda"])


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    x = torch.from_numpy(np.arange(16 * 128, dtype=np.int16).reshape(16, 128))
    assert torch.equal(probes.int16_probe(x, x),
                       probes.int16_probe_plain(x, x))
    with pytest.raises(ValueError, match="CUDA"):
        probes.int16_probe_cuda(x, x)
    f = torch.ones((8, 128), dtype=torch.int32)
    assert torch.equal(probes.floor_probe(f, 8, 2, "indep2"),
                       probes.floor_probe_plain(f, 8, 2, "indep2"))
    with pytest.raises(ValueError, match="CUDA"):
        probes.floor_probe_cuda(f, 8, 2, "chain")
    with pytest.raises(ValueError, match=r"\(8, 16, 32, 64, 128\)"):
        probes.floor_probe_cuda(f, 24, 2, "chain")
    with pytest.raises(ValueError, match="multiple of 8"):
        probes.floor_probe_plain(f, 12, 2, "indep4")
    with pytest.raises(ValueError, match="mode"):
        probes.floor_probe_plain(f, 8, 2, "indep3")


@pytest.mark.parametrize("S,mode,E", [(8, "chain", 1), (32, "chain", 4),
                                      (256, "chain", 8), (256, "indep2", 4),
                                      (256, "indep4", 2), (24, "chain", 1),
                                      (48, "indep2", 2)])
def test_floor_pass_elems(S, mode, E):
    assert probes.floor_pass_elems(S, mode) == E


# cuobjdump's layout: a function header, instructions with their address
# and encoding, a predicated branch back to an address; besides the
# NITER loop, a copy loop with a load, a store and a max
SASS = """
        Function : _ZN5_anon18floor_probe_kernelILi1ELi8ELi1EEEvPKiPiii
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00 */
                                                                   /* 0x00 */
        /*0010*/                   LDG.E R2, desc[UR6][R4.64] ;    /* 0x00 */
        /*0020*/                   VIADDMNMX R3, R2, 0x1, R2, !PT ; /* 0x00 */
        /*0030*/                   STG.E desc[UR6][R4.64], R3 ;    /* 0x00 */
        /*0040*/               @P0 BRA 0x10 ;                      /* 0x00 */
        /*0050*/                   IMAD.MOV R6, RZ, RZ, -R7 ;      /* 0x00 */
        /*0060*/                   UIADD3 UR4, UR4, 0x1, URZ ;     /* 0x00 */
        /*0070*/                   VIADDMNMX R7, R7, R0, R6, !PT ; /* 0x00 */
        /*0080*/                   IMAD.MOV R6, RZ, RZ, -R7 ;      /* 0x00 */
        /*0090*/                   VIADDMNMX R7, R7, R0, R6, !PT ; /* 0x00 */
        /*00a0*/              @!P0 BRA 0x50 ;                      /* 0x00 */
        /*00b0*/                   EXIT ;                          /* 0x00 */
        Function : _ZN5_anon16int16_probe_kernelEPK5uint2S2_PS0_i
        /*0000*/                   VIMNMX.S16x2 R5, R2, R5, !PT ;  /* 0x00 */
        /*0010*/                   VIADD.16x2 R5, R5, 0x10001 ;    /* 0x00 */
"""


def test_sass_reading():
    funcs = _build.parse_sass(SASS)
    assert len(funcs) == 2
    body = funcs["_ZN5_anon18floor_probe_kernelILi1ELi8ELi1EEEvPKiPiii"]
    assert len(body) == 12
    assert body[4] == (0x40, "@P0 BRA 0x10")
    assert _build.sass_mnemonic(body[4][1]) == "BRA"
    assert _build.sass_mnemonic(body[5][1]) == "IMAD.MOV"
    # the NITER loop: 5 instructions, not the copy loop's 3
    assert floor_probe.loop_body_insns(funcs, 1, 8, 1) == 5
    ops = [_build.sass_mnemonic(i) for _, i in funcs[
        "_ZN5_anon16int16_probe_kernelEPK5uint2S2_PS0_i"]]
    assert ops == ["VIMNMX.S16x2", "VIADD.16x2"]
