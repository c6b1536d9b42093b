"""Several devices in one process (counterpart of
``c3poa_tpu/parallel/mesh.py`` and of ``TpuBackend(mesh=...)``,
``c3poa_tpu/pipeline/tpu_backend.py:312-380``).

The original shards every kernel batch over a 1-D ``data`` mesh
(``shard_map``), padded to a multiple of the mesh size, with the splint
and adapter references replicated.  Here there are no compile shapes, so
nothing is padded: ``Mesh.dispatch`` cuts a launch's batch into n
contiguous shares (sizes as ``np.array_split`` gives them), copies each
share to its device and launches it there through the same wrappers, on
a CUDA stream of its own; ``Mesh.gather`` waits for each share on its
stream and joins the outputs in order on the host.  An empty share
launches nothing.  With one device there is one share, on the calling
thread's current stream: the single-device path unchanged.

``devices`` may repeat a device: ``["cuda:0"] * n`` runs n streams of one
card, ``["cpu"] * n`` is the CPU dry run of the sharding.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.banded import banded_fwd
from ..kernels.locate import locate_device
from ..state import to_device


def mesh_devices(n: int | None = None, kind: str = "cuda"
                 ) -> list[torch.device]:
    """The counterpart of ``make_mesh``: this process's first ``n`` cards
    (every visible card when ``n`` is None); for ``kind`` "cpu", the CPU
    ``n`` times (default once).  Raises when more cards are asked for than
    are visible."""
    if kind == "cpu":
        return [torch.device("cpu")] * (n or 1)
    local = torch.cuda.device_count()
    n = local if n is None else n
    if n > local:
        raise ValueError(f"--mesh_devices {n}: only {local} local devices")
    return [torch.device("cuda", i) for i in range(n)]


def share_bounds(n_items: int, n_shares: int
                 ) -> list[tuple[int, int, int]]:
    """[(share, lo, hi)] of the non-empty contiguous shares of ``n_items``
    rows over ``n_shares`` (the first ``n_items % n_shares`` one longer)."""
    size, extra = divmod(n_items, n_shares)
    out, lo = [], 0
    for k in range(n_shares):
        hi = lo + size + (k < extra)
        if hi > lo:
            out.append((k, lo, hi))
        lo = hi
    return out


class Mesh:
    """The devices of one process, each share with a stream of its own."""

    def __init__(self, devices):
        self.devices = [resolve_device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        # one device keeps the caller's current stream (and so the
        # single-device path's behaviour exactly)
        self.streams = [
            torch.cuda.Stream(device=d)
            if d.type == "cuda" and len(self.devices) > 1 else None
            for d in self.devices]

    def stream(self, k: int):
        """Context that makes share ``k``'s stream current."""
        s = self.streams[k]
        return torch.cuda.stream(s) if s is not None else \
            contextlib.nullcontext()

    def replicate(self, arr: np.ndarray) -> dict:
        """{device: ``arr`` on it}, one copy a device (the replicated
        operand: splint or adapter references).  Made on the device's
        current stream and synchronous, so every share's stream may read
        it; call it outside ``dispatch``."""
        return {d: to_device(arr, d) for d in dict.fromkeys(self.devices)}

    def dispatch(self, fn, *arrays: np.ndarray) -> list:
        """Launch ``fn(device, *tensors)`` on each non-empty share of the
        arrays' rows, under the share's stream.  Returns the pending
        [(share, outputs)] for ``gather``."""
        n_rows = len(arrays[0])
        pending = []
        for k, lo, hi in share_bounds(n_rows, len(self.devices)):
            dev = self.devices[k]
            with self.stream(k):
                pending.append((k, fn(dev, *(to_device(a[lo:hi], dev)
                                             for a in arrays))))
        return pending

    def gather(self, pending: list) -> list[np.ndarray]:
        """The outputs of ``dispatch``, each joined over the shares in
        order as a host array.  Each share's copy to the host runs on its
        own stream, after its kernels, and the host waits for it."""
        parts = []
        for k, outs in pending:
            with self.stream(k):
                parts.append([x.cpu().numpy() for x in outs])
        if len(parts) == 1:
            return parts[0]
        return [np.concatenate(col) for col in zip(*parts)]


def sharded_step(devices):
    """The full device step (locate + the consensus alignment's forward
    pass at band 64) over a batch cut into shares, plus the summed stats
    (total peak candidates, mean alignment score): the multi-device unit
    that ``__graft_entry__.dryrun_multichip`` ran on the original.  A
    function of host arrays (reads, lens, splints, queries, targets, ql,
    tl) returning host arrays."""
    mesh = Mesh(devices)

    def fn(reads, lens, splints, queries, targets, ql, tl):
        S = mesh.replicate(splints)
        combo, score, cand_pos, _h, _med, _deep, _marg = mesh.gather(
            mesh.dispatch(lambda dev, r, ln: locate_device(r, ln, S[dev]),
                          reads, lens))
        n_cand = (cand_pos >= 0).sum(axis=1).astype(np.int32)
        a_score, j_end, moves = mesh.gather(mesh.dispatch(
            lambda _dev, q, t, a, b: banded_fwd(q, t, a, b, band=64),
            queries, targets, ql, tl))
        return (combo, score, cand_pos, n_cand, a_score, j_end, moves,
                int(n_cand.sum()), float(a_score.mean()))

    return fn
