"""``python -m c3poa_tpu_torch.cli_postprocess`` — the c3poa-postprocess
run on PyTorch.

The flag surface of ``c3poa_tpu/cli_postprocess.py`` (that of the
reference postprocessor, C3POa_postprocessing.py:17-62: -i -o -a -x -c
-u -t -b -n -g -bt -co -v, and the original's --mesh_devices,
--coordinator, --num_processes and --process_id, with its rules), with
``--backend {cuda,cpu,numpy}`` (default cuda) picked as in ``cli``: no
probe, no fallback.  -c/-bt are accepted and ignored (no external
binaries).
"""

from __future__ import annotations

import argparse
import sys

from . import __version__
from .cli import pick_backend, supervise
from .pipeline.postprocess import PostprocessConfig, run_postprocess

VERSION = f"v2.2.3+torch ({__version__})"


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Reorients/demuxes/trims consensus reads (PyTorch/"
                    "CUDA).", add_help=True, prefix_chars="-")
    parser.add_argument("--input_fasta_file", "-i", type=str,
                        help="Fasta file with consensus called R2C2 reads")
    parser.add_argument("--output_path", "-o", type=str, default=".",
                        help="Directory where all the files will end up.")
    parser.add_argument("--adapter_file", "-a", type=str,
                        help="Fasta file with adapter (3 and 5 prime) sequences")
    parser.add_argument("--index_file", "-x", type=str,
                        help="Fasta file with oligo dT indexes")
    parser.add_argument("--config", "-c", type=str, default="",
                        help="Accepted for compatibility; ignored.")
    parser.add_argument("--undirectional", "-u", action="store_true",
                        help="cDNA molecules are undirectional; one adapter "
                             "named 'Adapter' expected.")
    parser.add_argument("--trim", "-t", action="store_true",
                        help="Trim the adapters off the ends of sequences.")
    parser.add_argument("--barcoded", "-b", action="store_true", default=False,
                        help="Produce a separate file with 10x barcodes.")
    parser.add_argument("--threads", "-n", type=int, default=1,
                        help="Worker processes for the numpy backend "
                             "(whole read groups fan out; output order "
                             "stays deterministic).")
    parser.add_argument("--groupSize", "-g", type=int, default=1000,
                        help="Reads per processing group.")
    parser.add_argument("--resume", action="store_true", default=False,
                        help="Continue an interrupted run from the last "
                             "completed read group (uncompressed output "
                             "only; the reference's PSL-cache role).")
    parser.add_argument("--blatThreads", "-bt", action="store_true",
                        default=False, help="Accepted for compatibility; ignored.")
    parser.add_argument("--compress_output", "-co", action="store_true",
                        default=False, help="gzip the output fastas.")
    parser.add_argument("--backend", type=str, default="cuda",
                        choices=["cuda", "cpu", "numpy"],
                        help="Compute backend (default: cuda).")
    parser.add_argument("--mesh_devices", type=str, default="auto",
                        help="Devices for this process: 'auto' (all local "
                             "cards for cuda, one for cpu), '1', or a "
                             "count (see cli).")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="Multi-host: coordinator address "
                             "(host:port) for torch.distributed.")
    parser.add_argument("--num_processes", type=int, default=1,
                        help="Multi-host: total number of host processes; "
                             "read groups shard round-robin and host 0 "
                             "merges the per-host trees byte-identically "
                             "to a single-host run (the reference "
                             "parallelizes postprocessing too, "
                             "C3POa_postprocessing.py:128-216).")
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


def main(argv=None):
    args = parse_args(argv)
    if not args.input_fasta_file or not args.adapter_file:
        print("Reads (--input_fasta_file/-i) and adapter (--adapter_file/-a) "
              "are required", file=sys.stderr)
        sys.exit(1)
    if args.undirectional and args.barcoded:
        print("Error: undirectional and barcoded are mutually exclusive.")
        sys.exit(1)
    import os
    if args.rss_restart_mb:
        from .utils.mem import rss_mb
        if rss_mb() == 0:
            print("--rss-restart-mb: RSS monitoring unavailable on this "
                  "platform (/proc/self/status unreadable); the memory "
                  "bound will never trigger", file=sys.stderr)
            sys.exit(1)
        if args.compress_output or args.num_processes > 1:
            print("--rss-restart-mb needs the resume manifest: not "
                  "supported with -co or --num_processes > 1",
                  file=sys.stderr)
            sys.exit(1)
        if os.environ.get("C3POA_SUPERVISED") != "1":
            return supervise(argv if argv is not None else sys.argv[1:],
                             module="c3poa_tpu_torch.cli_postprocess")
    from .parallel import dist
    process_index, process_count = dist.initialize(
        args.coordinator, args.num_processes, args.process_id)
    try:
        return _run(args, process_index, process_count)
    finally:
        dist.shutdown()


def _run(args, process_index: int, process_count: int) -> int:
    # 'auto' uses all local cards only in single-process runs (see cli)
    mesh_devices = args.mesh_devices
    if process_count > 1 and mesh_devices == "auto":
        mesh_devices = "1"
    backend = pick_backend(args.backend, mesh_devices)
    cfg = PostprocessConfig(
        undirectional=args.undirectional, trim=args.trim,
        barcoded=args.barcoded, group_size=args.groupSize,
        threads=args.threads, compress=args.compress_output,
        resume=args.resume, rss_restart_mb=args.rss_restart_mb,
        process_index=process_index, process_count=process_count)
    from .utils.mem import RESTART_EXIT_CODE, RssRestartNeeded
    try:
        stats = run_postprocess(args.input_fasta_file, args.output_path,
                                args.adapter_file, args.index_file, cfg,
                                backend)
    except RssRestartNeeded as exc:
        print(f"c3poa-postprocess: {exc}", file=sys.stderr)
        sys.exit(RESTART_EXIT_CODE)
    print(f"postprocessed: {stats.written}/{stats.total} written "
          f"({stats.no_adapter} bad adapters, {stats.wrong_order} misordered, "
          f"{stats.no_direction} directionless)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
