"""``python -m c3poa_tpu_torch.cli_postprocess`` — the c3poa-postprocess
run on PyTorch.

The flag surface of ``c3poa_tpu/cli_postprocess.py`` (that of the
reference postprocessor, C3POa_postprocessing.py:17-62: -i -o -a -x -c
-u -t -b -n -g -bt -co -v) without the multi-host flags, and with
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
        if args.compress_output:
            print("--rss-restart-mb needs the resume manifest: not "
                  "supported with -co", file=sys.stderr)
            sys.exit(1)
        if os.environ.get("C3POA_SUPERVISED") != "1":
            return supervise(argv if argv is not None else sys.argv[1:],
                             module="c3poa_tpu_torch.cli_postprocess")
    backend = pick_backend(args.backend)
    cfg = PostprocessConfig(
        undirectional=args.undirectional, trim=args.trim,
        barcoded=args.barcoded, group_size=args.groupSize,
        threads=args.threads, compress=args.compress_output,
        resume=args.resume, rss_restart_mb=args.rss_restart_mb)
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
