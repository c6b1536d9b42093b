"""``python -m c3poa_tpu_torch.cli`` — the c3poa consensus run on PyTorch.

The flag surface of ``c3poa_tpu/cli.py`` (that of the reference's
C3POa.py:26-63) without the multi-host flags, and with
``--backend {cuda,cpu,numpy}`` (default cuda):
- cuda: the hand-written CUDA kernels on the card; an error if there is
  no usable card (no silent fallback);
- cpu: the same backend with the plain torch versions on the CPU;
- numpy: the reference numpy/C backend of ``c3poa_tpu``.
"""

from __future__ import annotations

import argparse
import sys

from c3poa_tpu.consensus.engine import ConsensusParams
from c3poa_tpu.pipeline.run import PipelineConfig, run_pipeline

from . import __version__

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


def pick_backend(name: str):
    if name == "numpy":
        from c3poa_tpu.pipeline.backend import NumpyBackend
        return NumpyBackend()
    if name in ("cuda", "cpu"):
        from .pipeline.torch_backend import TorchBackend
        return TorchBackend(name)
    raise ValueError(name)


def main(argv=None):
    import os

    args = parse_args(argv)
    if not args.reads or not args.splint_file:
        print("Reads (--reads/-r) and splint (--splint_file/-s) are required",
              file=sys.stderr)
        sys.exit(1)
    if args.rss_restart_mb:
        from c3poa_tpu.utils.mem import rss_mb
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
            from c3poa_tpu.cli import supervise
            return supervise(argv if argv is not None else sys.argv[1:],
                             module="c3poa_tpu_torch.cli")
    group_size = args.groupSize
    if args.blatThreads and args.numThreads > 1:
        # reference -b: chunk = reads // threads (bin/preprocess.py:81-84)
        from c3poa_tpu.io.fastx import read_fastx
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
        rss_restart_mb=args.rss_restart_mb,
        cons=ConsensusParams(),
    )
    backend = pick_backend(args.backend)
    from c3poa_tpu.utils.mem import RESTART_EXIT_CODE, RssRestartNeeded
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
