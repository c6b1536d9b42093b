"""``python -m c3poa_tpu_torch.cli`` — the c3poa consensus run on PyTorch.

The flag surface of ``c3poa_tpu/cli.py`` (that of the reference's
C3POa.py:26-63), with ``--backend {cuda,cpu,numpy}`` (default cuda):
- cuda: the hand-written CUDA kernels on the card; an error if there is
  no usable card (no silent fallback);
- cpu: the same backend with the plain torch versions on the CPU;
- numpy: the reference numpy/C backend (this package's copy of
  ``pipeline/backend.py:NumpyBackend``).

Several processes or hosts (``--coordinator``, ``--num_processes``,
``--process_id``; ``parallel/dist.py``) and several devices in one
process (``--mesh_devices``; ``parallel/mesh.py``) follow the original's
rules.
"""

from __future__ import annotations

import argparse
import sys

from . import __version__
from .consensus.engine import ConsensusParams
from .pipeline.run import PipelineConfig, run_pipeline

VERSION = f"v2.2.3+torch ({__version__})"


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Makes consensus sequences from R2C2 reads (PyTorch/"
                    "CUDA).", add_help=True, prefix_chars="-")
    parser.add_argument("--reads", "-r", type=str,
                        help="FASTQ file that contains the long R2C2 reads.")
    parser.add_argument("--splint_file", "-s", type=str,
                        help="Path to the splint FASTA file.")
    parser.add_argument("--out_path", "-o", type=str, default=".",
                        help="Directory where all the files will end up.")
    parser.add_argument("--config", "-c", type=str, default="",
                        help="Accepted for compatibility; ignored (no "
                             "external binaries are used).")
    parser.add_argument("--lencutoff", "-l", type=int, default=1000,
                        help="Raw read length cutoff (default 1000).")
    parser.add_argument("--mdistcutoff", "-d", type=int, default=500,
                        help="Median distance cutoff (default 500).")
    parser.add_argument("--zero", "-z", action="store_false", default=True,
                        help="Use to exclude zero repeat reads. Defaults to "
                             "True (includes zero repeats).")
    parser.add_argument("--numThreads", "-n", type=int, default=1,
                        help="Worker processes for the numpy backend.")
    parser.add_argument("--groupSize", "-g", type=int, default=1000,
                        help="Reads per processing group (default 1000).")
    parser.add_argument("--blatThreads", "-b", action="store_true",
                        default=False,
                        help="Chunk reads by thread count instead of "
                             "--groupSize (one group per worker; numpy "
                             "backend with -n > 1).")
    parser.add_argument("--compress_output", "-co", action="store_true",
                        default=False,
                        help="gzip the consensus fasta and subread fastq.")
    parser.add_argument("--resume", action="store_true", default=False,
                        help="Continue an interrupted run from the last "
                             "completed read group (uncompressed output "
                             "only).")
    parser.add_argument("--backend", type=str, default="cuda",
                        choices=["cuda", "cpu", "numpy"],
                        help="Compute backend (default: cuda).")
    parser.add_argument("--mesh_devices", type=str, default="auto",
                        help="Devices to use in THIS process: 'auto' (all "
                             "local cards for --backend cuda, one for "
                             "cpu), '1' (single device), or an explicit "
                             "count.  >1 cuts every kernel batch into one "
                             "share a device (single-host multi-card; "
                             "combine with --num_processes for "
                             "multi-host).")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="Multi-host: coordinator address "
                             "(host:port) for torch.distributed.")
    parser.add_argument("--num_processes", type=int, default=1,
                        help="Multi-host: total number of host processes; "
                             "read groups shard round-robin and host 0 "
                             "merges the per-host trees byte-identically "
                             "to a single-host run.")
    parser.add_argument("--process_id", type=int, default=None,
                        help="Multi-host: this process's index.")
    parser.add_argument("--rss-restart-mb", type=int, default=0,
                        help="Bound process memory: exit cleanly at a "
                             "group checkpoint once RSS exceeds this many "
                             "MB and relaunch with --resume "
                             "(byte-identical); 0 disables.")
    parser.add_argument("--version", "-v", action="version", version=VERSION)

    if argv is None and len(sys.argv) == 1:
        parser.print_help()
        sys.exit(0)
    return parser.parse_args(argv)


def pick_backend(name: str, mesh_devices: str = "1"):
    if name == "numpy":
        from .pipeline.backend import NumpyBackend
        return NumpyBackend()
    if name in ("cuda", "cpu"):
        from .pipeline.torch_backend import TorchBackend
        return TorchBackend(name, devices=local_devices(name, mesh_devices))
    raise ValueError(name)


def local_devices(kind: str, mesh_devices: str = "auto"):
    """This process's devices for ``--mesh_devices``, or None for the
    single-device path (the role of ``c3poa_tpu/cli.py:_local_mesh``):
    'auto' is every local card for cuda and one device for cpu; an
    explicit count on the CPU repeats the one CPU (a dry run of the
    sharding)."""
    if mesh_devices in ("off", "0", "1"):
        return None
    import torch

    local = torch.cuda.device_count() if kind == "cuda" else 1
    n = local if mesh_devices == "auto" else int(mesh_devices)
    if n <= 1:
        return None
    from .parallel.mesh import mesh_devices as devices_of
    return devices_of(n, kind)


def supervise(argv, module="c3poa_tpu_torch.cli"):
    """Relaunch the CLI under a restart loop: the child exits with
    RESTART_EXIT_CODE at a durable group checkpoint when RSS crosses
    --rss-restart-mb; every relaunch continues via --resume
    (byte-identical, progress guaranteed — the child only restarts after
    completing at least one new group).  A copy of
    ``c3poa_tpu/cli.py:162`` (that module imports jax paths)."""
    import os
    import subprocess

    from .utils.mem import RESTART_EXIT_CODE

    cmd = [sys.executable, "-m", module] + list(argv)
    env = dict(os.environ, C3POA_SUPERVISED="1")
    restarts = -1
    while True:
        restarts += 1
        rc = subprocess.call(cmd, env=env)
        if rc != RESTART_EXIT_CODE:
            if restarts:
                print(f"rss supervisor: {restarts} restart(s)",
                      file=sys.stderr)
            return rc
        # the first child launch uses the user's flags verbatim; only
        # RESTARTS imply resume semantics — otherwise a fresh run into an
        # output dir holding an old completed manifest would silently
        # skip all work (ADVICE r3)
        if "--resume" not in cmd:
            cmd.append("--resume")


def main(argv=None):
    import os

    args = parse_args(argv)
    if not args.reads or not args.splint_file:
        print("Reads (--reads/-r) and splint (--splint_file/-s) are required",
              file=sys.stderr)
        sys.exit(1)
    if args.rss_restart_mb:
        from .utils.mem import rss_mb
        if rss_mb() == 0:
            print("--rss-restart-mb: RSS monitoring unavailable on this "
                  "platform (/proc/self/status unreadable); the memory "
                  "bound will never trigger", file=sys.stderr)
            sys.exit(1)
        if args.compress_output or args.num_processes > 1:
            print("--rss-restart-mb needs the resume manifest: not "
                  "supported with -co or --num_processes > 1 (compress "
                  "at the end, or bound each host's run separately)",
                  file=sys.stderr)
            sys.exit(1)
        if os.environ.get("C3POA_SUPERVISED") != "1":
            return supervise(argv if argv is not None else sys.argv[1:],
                             module="c3poa_tpu_torch.cli")
    from .parallel import dist
    process_index, process_count = dist.initialize(
        args.coordinator, args.num_processes, args.process_id)
    try:
        return _run(args, process_index, process_count)
    finally:
        dist.shutdown()


def _run(args, process_index: int, process_count: int) -> int:
    group_size = args.groupSize
    if args.blatThreads and args.numThreads > 1:
        # reference -b: chunk = reads // threads (bin/preprocess.py:81-84)
        from .io.fastx import read_fastx
        n_pass = sum(1 for r in read_fastx(args.reads)
                     if len(r.seq) >= args.lencutoff)
        group_size = max(1, -(-n_pass // args.numThreads))
    cfg = PipelineConfig(
        lencutoff=args.lencutoff,
        mdistcutoff=args.mdistcutoff,
        zero=args.zero,
        group_size=group_size,
        num_threads=args.numThreads,
        compress=args.compress_output,
        resume=args.resume,
        process_index=process_index,
        process_count=process_count,
        rss_restart_mb=args.rss_restart_mb,
        cons=ConsensusParams(),
    )
    # 'auto' uses all local cards only in single-process runs; under
    # --num_processes, pass an explicit --mesh_devices count to shard
    # each process's groups over its own local cards too
    mesh_devices = args.mesh_devices
    if process_count > 1 and mesh_devices == "auto":
        mesh_devices = "1"
    backend = pick_backend(args.backend, mesh_devices)
    from .utils.mem import RESTART_EXIT_CODE, RssRestartNeeded
    try:
        stats = run_pipeline(args.reads, args.splint_file, args.out_path,
                             cfg, backend)
    except RssRestartNeeded as exc:
        print(f"c3poa: {exc}", file=sys.stderr)
        sys.exit(RESTART_EXIT_CODE)
    except (ValueError, OSError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        sys.exit(1)
    print(f"consensus written: {stats.consensus_written} "
          f"(of {stats.total_reads} length-passing reads; "
          f"{stats.no_splint} no-splint, {stats.short_reads} short)",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
