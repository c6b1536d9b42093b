"""The port's banded aligner (plain torch forward pass and walk) against
the JAX package's XLA scan, its Pallas kernel in interpret mode, and
the host helpers it copies; and a g++ build of the CUDA kernels' own
arithmetic (``csrc/banded.cuh``, ``csrc/band_lo.cuh`` under
``tests/banded_host_driver.cpp``) against the plain versions, and the
reader of the forward kernel's SASS against a sample and against the
kernel as built.

The CUDA kernels run only on a card: chip_smoke.py holds them against
these plain versions there."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from c3poa_tpu import sim
from c3poa_tpu.kernels import banded as jb
from c3poa_tpu.kernels.pallas_banded import banded_fwd_pallas
from c3poa_tpu.utils import encode
from c3poa_tpu_torch.kernels import _build
from c3poa_tpu_torch.kernels import banded as tb
from c3poa_tpu_torch.tools import banded_sass
from torch_banded_cases import ragged_pairs

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "c3poa_tpu_torch", "kernels", "csrc")

SCORINGS = {"main": (5, -4, 4, 2), "zero": (20, -7, 10, 5)}


def _pairs(seed, P, nq, nt, err=0.05, dummy=0):
    rng = np.random.default_rng(seed)
    Q = np.full((P, nq), 4, np.int8)
    T = np.full((P, nt), 4, np.int8)
    ql = np.ones(P, np.int32)
    tl = np.ones(P, np.int32)
    for p in range(P - dummy):
        n = int(rng.integers(nt // 2, nt))
        t = sim.random_seq(rng, n)
        q = sim.mutate(rng, t, err, 0.6 * err, 0.6 * err)[:nq]
        T[p, :len(t)] = encode(t)
        Q[p, :len(q)] = encode(q)
        tl[p], ql[p] = len(t), len(q)
    return Q, T, ql, tl


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("W,scoring,seed", [
    (64, "main", 1), (128, "zero", 2), (32, "main", 3)])
def test_forward_matches_jax(W, scoring, seed):
    mt, mm, go, ge = SCORINGS[scoring]
    Q, T, ql, tl = _pairs(seed, 6, 320, 320, dummy=1)
    s, je, mv = tb.banded_align_batch(*_t(Q, T, ql, tl), band=W, match=mt,
                                      mismatch=mm, gap_open=go, gap_ext=ge)
    s1, j1, m1 = jb.banded_align_batch(Q, T, ql, tl, band=W, match=mt,
                                       mismatch=mm, gap_open=go, gap_ext=ge)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s1))
    np.testing.assert_array_equal(je.numpy(), np.asarray(j1))
    moves = tb.unpack_moves(mv, Q.shape[1]).numpy()
    m1 = np.asarray(m1)
    for p in range(len(ql)):
        np.testing.assert_array_equal(moves[p, :ql[p]], m1[p, :ql[p]],
                                      err_msg=f"pair {p}")
        # rows past the query are 0 in the port's layout
        assert not moves[p, ql[p]:].any()


def test_forward_matches_pallas_interpret():
    Q, T, ql, tl = _pairs(4, 8, 256, 256)
    s1, j1, m1 = banded_fwd_pallas(Q, T, ql, tl, band=64, interpret=True,
                                   p_tile=8, superblock=True, fold=True)
    s, je, mv = tb.banded_fwd(*_t(Q, T, ql, tl), band=64)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s1))
    np.testing.assert_array_equal(je.numpy(), np.asarray(j1))
    moves = tb.unpack_moves(mv, Q.shape[1]).numpy()
    m1 = np.asarray(m1)
    for p in range(len(ql)):
        np.testing.assert_array_equal(moves[p, :ql[p]], m1[p, :ql[p]])


@pytest.mark.parametrize("W,scoring,seed,err", [
    (64, "main", 5, 0.05), (128, "zero", 6, 0.05), (64, "main", 7, 0.12)])
def test_walk_matches_jax(W, scoring, seed, err):
    mt, mm, go, ge = SCORINGS[scoring]
    Q, T, ql, tl = _pairs(seed, 6, 320, 320, err=err, dummy=1)
    sc, je, js, ir, ops, edge = tb.banded_align_trace(
        *_t(Q, T, ql, tl), band=W, match=mt, mismatch=mm, gap_open=go,
        gap_ext=ge)
    r = jb.banded_align_trace_batch(Q, T, ql, tl, band=W, match=mt,
                                    mismatch=mm, gap_open=go, gap_ext=ge)
    for got, want in zip((sc, je, js, ir, edge),
                         (r[0], r[1], r[2], r[3], r[5])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ops.dtype == torch.uint8
    assert ops.shape[1] == tb.ops_bytes(tb.walk_steps(Q.shape[1], W))
    jops = np.asarray(r[4])
    for p in range(len(ql)):
        dense = tb.unpack_ops_packed(ops[p].numpy())
        np.testing.assert_array_equal(dense, jops[p][jops[p] != 0])
        # no gaps in the port's stream: ops then zeros
        n = len(dense)
        flat = np.stack([(ops[p].numpy() >> (2 * s)) & 3
                         for s in range(4)], axis=1).reshape(-1)
        assert flat[:n].all() and not flat[n:].any()


def test_walk_dispatch_and_cuda_wrapper_checks():
    Q, T, ql, tl = _pairs(8, 2, 64, 64)
    args = _t(Q, T, ql, tl)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tb.banded_fwd_cuda(*args, band=64)
    s, je, mv = tb.banded_fwd(*args, band=64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tb.banded_walk_cuda(mv, args[2], args[3], je, 64, 64)
    plain = tb.banded_walk_batch(mv, args[2], args[3], je, 64, 64)
    disp = tb.banded_walk(mv, args[2], args[3], je, 64, 64)
    for a, b in zip(plain, disp):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("nq,nt,W", [
    (4, 2, 2), (2000, 1900, 128), (777, 1555, 64), (1000, 999, 32),
    (5, 11, 4), (1, 1, 128), (3, 0, 8)])
def test_band_lo_matches_host_twins(nq, nt, W):
    want = jb.band_starts_np(nq, nt, W)
    np.testing.assert_array_equal(tb.band_starts_np(nq, nt, W), want)
    P = nq + 1
    got = tb.band_lo(torch.arange(P, dtype=torch.int32),
                     torch.full((P,), nq, dtype=torch.int32),
                     torch.full((P,), nt, dtype=torch.int32), W)
    np.testing.assert_array_equal(got.numpy(), want)


def test_host_helper_copies_match_originals():
    assert tb.SMAX == jb.SMAX
    assert tb.NEG == int(jb.NEG)
    rng = np.random.default_rng(9)
    row = rng.integers(0, 256, 40).astype(np.uint8)
    np.testing.assert_array_equal(tb.unpack_ops_packed(row),
                                  jb.unpack_ops_packed(row))
    Q, T, ql, tl = _pairs(10, 3, 128, 128)
    r = jb.banded_align_trace_batch(Q, T, ql, tl, band=64)
    ops = np.asarray(r[4])
    for p in range(3):
        q, t = Q[p, :ql[p]], T[p, :tl[p]]
        a = tb.ops_to_record(q, t, ops[p], int(np.asarray(r[1])[p]))
        b = jb.ops_to_record(q, t, ops[p], int(np.asarray(r[1])[p]))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_unpack_moves_layout():
    words = torch.tensor([[[0x76543210, -1]]], dtype=torch.int32)
    got = tb.unpack_moves(words, 8).numpy()
    assert got.shape == (1, 8, 2)
    np.testing.assert_array_equal(got[0, :, 0], np.arange(8))
    np.testing.assert_array_equal(got[0, :, 1], np.full(8, 15))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """tests/banded_host_driver.cpp over csrc/banded.cuh and band_lo.cuh,
    built with g++ (the kernels' control flow, run serially); float
    contraction off, as band_lo needs."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++")
    so = str(tmp_path_factory.mktemp("bnd") / "bnd_host.so")
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-Wall", "-Wextra", "-Werror", "-I", CSRC,
                    "-o", so,
                    os.path.join(ROOT, "tests", "banded_host_driver.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.bnd_band_lo_host.argtypes = [I, I, I, I, P]
    lib.bnd_band_lo_host.restype = None
    lib.bnd_fwd_host.argtypes = [P] * 4 + [I] * 8 + [P] * 3
    lib.bnd_fwd_host.restype = I
    lib.bnd_walk_host.argtypes = [P] * 4 + [I] * 5 + [P] * 4
    lib.bnd_walk_host.restype = I
    return lib


def _host_forward(lib, Q, T, ql, tl, W, scoring):
    """The host driver's forward pass into buffers filled with garbage: every
    word must be written."""
    P, nq = Q.shape
    score = np.full(P, 0x5a5a5a5a, np.int32)
    jend = np.full(P, 0x5a5a5a5a, np.int32)
    moves = np.full((P, -(-nq // 8), W), 0x5a5a5a5a, np.int32)
    rc = lib.bnd_fwd_host(Q.ctypes.data, T.ctypes.data, ql.ctypes.data,
                          tl.ctypes.data, P, nq, T.shape[1], W, *scoring,
                          score.ctypes.data, jend.ctypes.data,
                          moves.ctypes.data)
    assert rc == 0
    return score, jend, moves


def _host_walk(lib, moves, ql, tl, jend, nq, W):
    P, nq8, _ = moves.shape
    n_steps = tb.walk_steps(nq, W)
    words = tb.ops_bytes(n_steps) // 4
    js = np.full(P, 0x5a5a5a5a, np.int32)
    ir = np.full(P, 0x5a5a5a5a, np.int32)
    edge = np.full(P, 0x5a, np.uint8)
    ops = np.full((P, words), 0x5a5a5a5a, np.int32)
    moves = np.ascontiguousarray(moves)
    rc = lib.bnd_walk_host(moves.ctypes.data, ql.ctypes.data, tl.ctypes.data,
                           jend.ctypes.data, P, nq8, W, n_steps, words,
                           js.ctypes.data, ir.ctypes.data, edge.ctypes.data,
                           ops.ctypes.data)
    assert rc == 0
    return js, ir, ops.view(np.uint8), edge.astype(bool)


@pytest.mark.parametrize("scoring", sorted(SCORINGS))
@pytest.mark.parametrize("W", [32, 64, 128, 256])
def test_kernel_header_matches_plain(host_lib, W, scoring):
    """Whole alignments and whole walks through the kernels' arithmetic
    on ragged pairs (empty and tiny queries, targets shorter than the
    band, shifts of 3, N codes, a deletion longer than a lane's reach, a
    path longer than the step budget): every output equal."""
    sc = SCORINGS[scoring]
    Q, T, ql, tl, names = ragged_pairs(W, seed=W + len(scoring))
    nq = Q.shape[1]
    kw = dict(band=W, match=sc[0], mismatch=sc[1], gap_open=sc[2],
              gap_ext=sc[3])
    s0, j0, m0 = tb.banded_align_batch(*_t(Q, T, ql, tl), **kw)
    s1, j1, m1 = _host_forward(host_lib, Q, T, ql, tl, W, sc)
    np.testing.assert_array_equal(s1, s0.numpy())
    np.testing.assert_array_equal(j1, j0.numpy())
    for p, name in enumerate(names):
        np.testing.assert_array_equal(m1[p], m0[p].numpy(),
                                      err_msg=f"moves of pair {p} ({name})")
    want = tb.banded_walk_batch(m0, *_t(ql, tl), j0, nq, W)
    got = _host_walk(host_lib, m1, ql, tl, j1, nq, W)
    for what, a, b in zip(("j_start", "i_rem", "ops", "edge"), got, want):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=what)
    assert (want[1].numpy() > 0).any(), "no path ran out of steps"
    assert (want[1].numpy() == 0).any()


def test_kernel_header_matches_jax(host_lib):
    Q, T, ql, tl, _ = ragged_pairs(64, seed=11)
    s1, j1, m1 = _host_forward(host_lib, Q, T, ql, tl, 64, SCORINGS["main"])
    r = jb.banded_align_trace_batch(Q, T, ql, tl, band=64)
    np.testing.assert_array_equal(s1, np.asarray(r[0]))
    np.testing.assert_array_equal(j1, np.asarray(r[1]))
    _, _, jm = jb.banded_align_batch(Q, T, ql, tl, band=64)
    moves = tb.unpack_moves(torch.from_numpy(m1), Q.shape[1]).numpy()
    for p in range(len(ql)):
        np.testing.assert_array_equal(moves[p, :ql[p]],
                                      np.asarray(jm)[p, :ql[p]])
    js, ir, ops, edge = _host_walk(host_lib, m1, ql, tl, j1, Q.shape[1], 64)
    np.testing.assert_array_equal(js, np.asarray(r[2]))
    np.testing.assert_array_equal(ir, np.asarray(r[3]))
    np.testing.assert_array_equal(edge, np.asarray(r[5]))
    jops = np.asarray(r[4])
    for p in range(len(ql)):
        np.testing.assert_array_equal(tb.unpack_ops_packed(ops[p]),
                                      jops[p][jops[p] != 0])


@pytest.mark.parametrize("nq,nt,W", [
    (2000, 1900, 128), (777, 1555, 64), (1000, 999, 32), (5, 11, 32),
    (1, 1, 128), (3, 0, 64), (0, 7, 32), (2048, 4097, 256),
    (1333, 1999, 128)])
def test_host_band_lo_matches_twins(host_lib, nq, nt, W):
    """The header's host band_lo (plain float multiply, divide, rintf)
    against numpy's; includes halves (ties to even)."""
    out = np.zeros(nq + 2, np.int32)
    host_lib.bnd_band_lo_host(nq, nt, W, nq + 2, out.ctypes.data)
    want = jb.band_starts_np(nq, nt, W)
    np.testing.assert_array_equal(out[:nq + 1], want)
    assert out[nq + 1] == want[nq]      # rows past the query stay put


SASS_SAMPLE = """
	Function : _Z17banded_fwd_kernelILi4EEvPKaS1_PKiS3_PiS4_Pjiiiiiiii
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   SHFL.IDX PT, R2, R3, R4, 0x1f ;
        /*0020*/                   ISETP.NE.AND P0, PT, R2, RZ, PT ;
        /*0030*/                   BRX R2 -0x40 ;
        /*0040*/                   IMAD.MOV.U32 R5, RZ, RZ, R6 ;
        /*0050*/                   BRA 0x90 ;
        /*0060*/                   IADD3 R5, R5, 0x1, RZ ;
        /*0070*/                   SHFL.DOWN PT, R2, R3, 0x1, 0x1f ;
        /*0080*/                   LOP3.LUT R5, R5, R2, RZ, 0xfc, !PT ;
        /*0090*/                   BSSY B0, 0xd0 ;
        /*00a0*/              @P1  BRA 0xc0 ;
        /*00b0*/                   STG.E.128 [R8.64], R4 ;
        /*00c0*/                   BSYNC B0 ;
        /*00d0*/                   VIADDMNMX R9, R5, R7, R2, !PT ;
        /*00e0*/                   BRA.DIV UR4, 0x120 ;
        /*00f0*/                   IDP.4A.S8.S8 R9, R5, R7, R2 ;
        /*0100*/              @P2  BRA 0x10 ;
        /*0110*/                   EXIT ;
        /*0120*/                   WARPSYNC.COLLECTIVE R21, 0x130 ;
        /*0130*/                   BRA 0xf0 ;
"""


def test_sass_row_loop_paths():
    """The row loop is [0x10, 0x100]: the out-of-line arm after EXIT is
    no loop, the indirect branch's arms are the blocks nothing else leads
    to, and the paths differ by the longer arm and the store."""
    funcs = _build.parse_sass(SASS_SAMPLE)
    body = next(iter(funcs.values()))
    assert banded_sass.row_loop(body) == (0x10, 0x100)
    res = banded_sass.forward_row_pipes(funcs, 128)
    assert res["min"]["all"] == 12 and res["max"]["all"] == 14
    assert res["min"]["shfl"] == 1 and res["max"]["shfl"] == 2
    assert res["max"]["mem"] == 1 and res["min"]["mem"] == 0
    assert res["loop"]["all"] == 16
    assert res["min"]["fma"] == 2 and res["min"]["alu"] == 2
    with pytest.raises(RuntimeError, match="no kernel"):
        banded_sass.forward_row_pipes(funcs, 64)


def test_sass_row_pipes_of_the_built_kernel():
    """The reader on the forward kernel as nvcc 12.8 built it for sm_90a
    (``tests/banded_fwd_w128.sass.gz``: ``cuobjdump -sass`` of the built
    library, the W = 128 instance, one ``/*address*/ instruction ;`` a
    line).  The kernel holds two row loops: the main path's and, past
    the kernel's first EXIT where the reader does not look, a longer one
    for pairs whose target is shorter than the band (0x5410-0x8720, 30
    instructions more).  The reader finds the first, the way through its
    band-shift switch and the eighth-row store; a row's shortest path
    has no conversion left (lo(i) is computed 32 rows at a time outside
    it), two shared loads and the row's 13 shuffles."""
    import gzip
    with gzip.open(os.path.join(ROOT, "tests", "banded_fwd_w128.sass.gz"),
                   "rt") as f:
        funcs = _build.parse_sass(f.read())
    body = next(iter(funcs.values()))
    assert len(body) == 4696
    assert banded_sass.row_loop(body) == (0x1080, 0x41b0)
    res = banded_sass.forward_row_pipes(funcs, 128)
    assert res["min"] == dict(all=142, alu=67, fma=41, xu=0, shfl=13, lds=2,
                              mem=1, ctrl=12, uni=6, other=0)
    assert res["max"]["all"] == 349 and res["max"]["shfl"] == 59
    assert res["loop"]["all"] == 788


@pytest.mark.parametrize("op,pipe", [
    ("IADD3", "alu"), ("LOP3.LUT", "alu"), ("ISETP.GE.AND", "alu"),
    ("VIADDMNMX", "alu"), ("VIMNMX", "alu"), ("SHF.L.W.U32.HI", "alu"),
    ("PRMT", "alu"), ("IMAD.MOV.U32", "fma"), ("IDP.4A.S8.S8", "fma"),
    ("FFMA", "fma"), ("MUFU.RCP", "xu"), ("I2F.RP", "xu"),
    ("SHFL.UP", "shfl"), ("LDS", "lds"), ("STG.E.128", "mem"),
    ("LDG.E.U8.CONSTANT", "mem"), ("BRA", "ctrl"), ("BSYNC", "ctrl"),
    ("ULDC.64", "uni"), ("S2R", "other")])
def test_sass_pipe_of(op, pipe):
    assert banded_sass.pipe_of(op) == pipe
