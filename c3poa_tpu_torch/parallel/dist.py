"""Multi-process and multi-host runs (counterpart of
``c3poa_tpu/parallel/dist.py``).

The recipe is the original's; only the collective differs:

- ``initialize()`` -> ``torch.distributed`` with the gloo backend, one
  process per host (or several sharing one card): only counters cross
  processes, so they travel as CPU tensors and no NCCL is needed;
- input sharding is by *read group round-robin*: process h takes the
  groups g with g % process_count == h, streaming the same input from
  its own offset (input and output paths are shared across hosts);
- each process writes its own output tree under ``out/host_<h>/`` and
  records per-group file sizes in its progress manifest;
  ``merge_host_outputs`` interleaves those byte spans by global group
  index, reproducing the single-process bytes exactly;
- ``allreduce_stats`` sums the counters (one int64 all-reduce); it is
  also the completion barrier before host 0 merges.

``host_shard_groups``, ``_host_spans`` and ``merge_host_outputs`` are
copies of the original's (they need no jax, but live in the JAX
package), held to it by ``tests/test_torch_dist.py``.
"""

from __future__ import annotations

import datetime
import json
import os
from typing import Iterator

# per-host progress/span manifest name (same file the resume path uses)
from ..pipeline.run import MANIFEST

# how long a process waits for its peers to join and for each collective;
# a peer that died leaves the others waiting this long, not torch's 30
# minutes (the closing all-reduce waits for the slowest host's last group)
TIMEOUT = datetime.timedelta(minutes=10)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> tuple[int, int]:
    """Join the process group when multi-process; returns
    (process_index, process_count), (0, 1) for a single process.

    ``coordinator_address`` is host 0's ``host:port`` (gloo's TCP store
    listens there)."""
    if not num_processes or num_processes <= 1:
        return 0, 1
    if not coordinator_address or process_id is None:
        raise ValueError("--num_processes > 1 needs --coordinator host:port "
                         "and --process_id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process_id {process_id} is outside "
                         f"[0, {num_processes})")
    import torch.distributed as tdist

    tdist.init_process_group("gloo",
                             init_method=f"tcp://{coordinator_address}",
                             rank=process_id, world_size=num_processes,
                             timeout=TIMEOUT)
    return tdist.get_rank(), tdist.get_world_size()


def shutdown() -> None:
    """Leave the process group (after the merge), so that no process
    lingers at exit; nothing to do for a single process."""
    import torch.distributed as tdist

    if tdist.is_available() and tdist.is_initialized():
        tdist.destroy_process_group()


def host_shard_groups(groups: Iterator[list], process_index: int,
                      process_count: int) -> Iterator[tuple[int, list]]:
    """Round-robin read groups over hosts; yields (group_index, group)."""
    for gi, group in enumerate(groups):
        if gi % process_count == process_index:
            yield gi, group


def allreduce_stats(values: dict) -> dict:
    """Sum integer counters across processes: one int64 CPU tensor in
    sorted key order, all-reduced with SUM (every process gets the
    totals).  A single process gets its own counters back."""
    import torch
    import torch.distributed as tdist

    if not (tdist.is_available() and tdist.is_initialized()) or \
            tdist.get_world_size() == 1:
        return dict(values)
    keys = sorted(values)
    t = torch.tensor([int(values[k]) for k in keys], dtype=torch.int64)
    tdist.all_reduce(t, op=tdist.ReduceOp.SUM)
    return {k: int(v) for k, v in zip(keys, t.tolist())}


def _host_spans(host_dir: str, manifest: str = MANIFEST
                ) -> list[tuple[int, str, int, int]]:
    """Per-group byte spans for one host: [(gi, relfile, start, end)].

    Reconstructed by diffing the cumulative per-file sizes recorded in
    the host's progress manifest after each group.  ``manifest`` selects
    which progress file to read (the consensus pipeline's and the
    postprocessor's manifests share the span_groups schema)."""
    path = os.path.join(host_dir, manifest)
    if not os.path.exists(path):
        return []
    m = json.load(open(path))
    events: list = []
    prev: dict = {}
    for entry in m.get("span_groups", []):
        gi = entry["gi"]
        for rel, sz in entry["sizes"].items():
            p = prev.get(rel, 0)
            if sz > p:
                events.append((gi, rel, p, sz))
            prev[rel] = sz
    return events


def merge_host_outputs(out_path: str, process_count: int,
                       splints: list[str] | None = None,
                       compress: bool = False,
                       manifest: str = MANIFEST) -> None:
    """Merge per-host output trees (out/host_<h>/...) into the single-host
    layout, interleaving per-group byte spans by global group index — the
    merged files are byte-identical to a single-host run.  ``compress``
    gzips the merged outputs (host trees are always written plain).
    ``manifest`` selects the span manifest (consensus pipeline vs
    postprocessor)."""
    import gzip

    del splints  # discovered from the span manifests
    events: list = []  # (gi, host, rel, start, end)
    for h in range(process_count):
        host_dir = os.path.join(out_path, f"host_{h}")
        for gi, rel, start, end in _host_spans(host_dir, manifest):
            events.append((gi, h, rel, start, end))
    events.sort(key=lambda e: e[0])

    handles: dict = {}
    try:
        for gi, h, rel, start, end in events:
            if rel not in handles:
                dst = os.path.join(out_path, rel)
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                if compress and not rel.endswith(".tsv"):
                    # .tsv stays plain, matching _Writers._open
                    handles[rel] = gzip.open(dst + ".gz", "wb")
                else:
                    handles[rel] = open(dst, "wb")
            src = os.path.join(out_path, f"host_{h}", rel)
            with open(src, "rb") as fh:
                fh.seek(start)
                handles[rel].write(fh.read(end - start))
    finally:
        for fh in handles.values():
            fh.close()
