#!/usr/bin/env python3
"""Streaming soak of the port's consensus run: a copy of ``tools/soak.py``
that runs ``python -m c3poa_tpu_torch.cli`` on the card.

Generates a production-shaped R2C2 fastq with a VECTORIZED simulator
(the per-char sim.mutate would take hours at this scale), then runs the
full pipeline while sampling host RSS over the CLI's process tree, the
device memory of that tree's processes (``nvidia-smi``) and, for an
unsupervised run, the CLI's own ``torch.cuda.memory_reserved`` and
``memory_allocated``.  Pass criteria: flat host RSS, flat device memory,
every consensus record accounted for; sustained reads/s.

    python -m c3poa_tpu_torch.tools.soak [--reads 1000000] [--dir build/soak]
        [--out build/soak/soak.json] [--resume-test] [--kill-after 300]
        [--rss-restart-mb 0] [--backend cuda]

--resume-test: SIGKILLs the pipeline's process group mid-soak and
resumes it.  The dataset is cached in --dir keyed by its meta, so reruns
skip generation; the run's tree is --dir/out, made anew by every soak.
--dir and --out default to the checkout's git-ignored ``build/``; a
--dir inside the checkout must lie under it.  The result holds the
SHA-256 of the three output files, so two soaks' trees can be compared.
"""

import argparse
import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD = os.path.join(ROOT, "build")
LUT = np.frombuffer(b"ACGTN", dtype=np.uint8)
# tools/soak.py:162 samples every 30 s: too few samples in a run of a
# few minutes for the flat verdicts
SAMPLE_S = 5.0
# reads per group, passed to the CLI as -g (its default)
GROUP_SIZE = 1000
OUTPUT_FILES = ("c3poa.log", "Splint1/R2C2_Consensus.fasta",
                "Splint1/R2C2_Subreads.fastq")


def mutate_fast(rng, codes, sub, ins, dele):
    """Vectorized sub/ins/del channel (same rates as sim.mutate; inserts
    follow emitted bases with geometric counts)."""
    n = len(codes)
    r = rng.random(n)
    keep = r >= dele
    out_codes = codes.copy()
    submask = keep & (r < dele + sub)
    out_codes[submask] = rng.integers(0, 4, int(submask.sum()))
    counts = (rng.geometric(1.0 - ins, size=n) - 1).astype(np.int64)
    counts[~keep] = 0
    contrib = keep.astype(np.int64) + counts
    ends = np.cumsum(contrib)
    total = int(ends[-1]) if n else 0
    out = rng.integers(0, 4, total).astype(np.int8)  # prefill = inserts
    starts = ends - contrib
    out[starts[keep]] = out_codes[keep]
    return out


def generate(path, n_reads, seed=0, insert_len=(500, 2000), copies=(5, 15),
             error=0.05, chunk=2000):
    """Write reads.fastq + splint.fasta under path (cached by meta)."""
    os.makedirs(path, exist_ok=True)
    meta_p = os.path.join(path, "meta.json")
    meta = {"n": n_reads, "seed": seed, "insert_len": insert_len,
            "copies": copies, "error": error, "v": 2}
    if os.path.exists(meta_p):
        try:
            if json.load(open(meta_p)) == json.loads(json.dumps(meta)):
                print(f"# dataset cached in {path}", file=sys.stderr)
                return
        except (OSError, ValueError):
            pass
    rng = np.random.default_rng(seed)
    splint = rng.integers(0, 4, 200).astype(np.int8)
    with open(os.path.join(path, "splint.fasta"), "w") as fh:
        fh.write(">Splint1\n" + LUT[splint].tobytes().decode() + "\n")
    sub, ins, dele = error * 0.5, error * 0.25, error * 0.25
    comp = np.array([3, 2, 1, 0, 4], dtype=np.int8)
    t0 = time.time()
    with open(os.path.join(path, "reads.fastq"), "w") as fh:
        for i in range(n_reads):
            il = int(rng.integers(insert_len[0], insert_len[1] + 1))
            nc = int(rng.integers(copies[0], copies[1] + 1))
            insert = rng.integers(0, 4, il).astype(np.int8)
            lead = insert[-il // 2:]
            trail = insert[:il // 2]
            parts = [lead]
            for _ in range(nc):
                parts.append(splint)
                parts.append(insert)
            parts.append(splint)
            parts.append(trail)
            clean = np.concatenate(parts)
            read = mutate_fast(rng, clean, sub, ins, dele)
            if rng.random() < 0.5:
                read = comp[read][::-1]
            seq = LUT[read].tobytes().decode()
            fh.write(f"@soak_{i}_{nc}\n{seq}\n+\n{'5' * len(seq)}\n")
            if i % 50000 == 0 and i:
                print(f"# generated {i}/{n_reads} "
                      f"({i / (time.time() - t0):.0f} reads/s)",
                      file=sys.stderr, flush=True)
    json.dump(meta, open(meta_p, "w"))


def rss_mb(pid):
    try:
        with open(f"/proc/{pid}/status") as fh:
            for line in fh:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) // 1024
    except OSError:
        return None
    return None


def tree_pids(root_pid):
    """root_pid and its descendants (under --rss-restart-mb the CLI is a
    small supervisor whose worker child holds the memory)."""
    try:
        pids = [int(p) for p in os.listdir("/proc") if p.isdigit()]
    except OSError:
        return {root_pid}
    parent = {}
    for p in pids:
        try:
            with open(f"/proc/{p}/stat") as fh:
                parent[p] = int(fh.read().split()[3])
        except (OSError, ValueError, IndexError):
            pass
    tree = {root_pid}
    grew = True
    while grew:
        grew = False
        for p, pp in parent.items():
            if pp in tree and p not in tree:
                tree.add(p)
                grew = True
    return tree


def rss_tree_mb(pids):
    """Max VmRSS over ``pids`` (tools/soak.py:113 walks the tree here;
    the port's soak shares the walk with the device sample)."""
    best = None
    for p in pids:
        m = rss_mb(p)
        if m is not None and (best is None or m > best):
            best = m
    return best


def device_used_mb(pids):
    """(MB of device memory used by ``pids``, whether any pid matched),
    from ``nvidia-smi --query-compute-apps``.  Where none of ``pids``
    appears (a container may see other pids than nvidia-smi reports),
    the sum over every compute process on the card; None without
    ``nvidia-smi`` or without a compute process."""
    try:
        done = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None, False
    used = {}
    for line in done.stdout.splitlines():
        pid, _, mb = (part.strip() for part in line.partition(","))
        if pid.isdigit() and mb.isdigit():
            used[int(pid)] = used.get(int(pid), 0) + int(mb)
    if done.returncode != 0 or not used:
        return None, False
    mine = [mb for pid, mb in used.items() if pid in pids]
    if mine:
        return sum(mine), True
    return sum(used.values()), False


def cli_entry(samples_path, every_s, argv):
    """``python -m c3poa_tpu_torch.cli ARGV`` in this process, with a
    thread appending one JSON line of this process's
    ``torch.cuda.memory_reserved`` and ``memory_allocated`` (MB) to
    ``samples_path`` every ``every_s`` seconds once CUDA is initialised
    (the manner of ``chip_smoke.py:cli_process``)."""
    import torch

    from .. import cli

    stop = threading.Event()

    def sample():
        with open(samples_path, "a") as fh:
            while True:
                if torch.cuda.is_initialized():
                    fh.write(json.dumps({
                        "t": time.time(), "pid": os.getpid(),
                        "reserved_mb": torch.cuda.memory_reserved() / 2 ** 20,
                        "allocated_mb":
                            torch.cuda.memory_allocated() / 2 ** 20}) + "\n")
                    fh.flush()
                if stop.wait(every_s):
                    return

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    try:
        return cli.main(argv)
    finally:
        stop.set()
        th.join()


def run_soak(d, out, resume_test=False, kill_after_s=300,
             rss_restart_mb=0, backend="cuda", samples_path=None):
    env = dict(os.environ, C3POA_PROGRESS="1",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    # tools/soak.py:147-150 runs -m c3poa_tpu.cli --backend tpu
    args = ["-r", os.path.join(d, "reads.fastq"),
            "-s", os.path.join(d, "splint.fasta"),
            "-o", out, "--backend", backend, "--resume",
            "-g", str(GROUP_SIZE)]
    if rss_restart_mb:
        # the supervisor's sessions are new processes: only nvidia-smi
        # sees their device memory
        cmd = [sys.executable, "-m", "c3poa_tpu_torch.cli", *args,
               "--rss-restart-mb", str(rss_restart_mb)]
    else:
        cmd = [sys.executable, "-m", "c3poa_tpu_torch.tools.soak",
               "--cli-entry", samples_path, str(SAMPLE_S), *args]
    samples = []
    t0 = time.time()
    kills = 0
    killed_at_groups = []

    def sample_loop(pid, stop):
        while not stop.is_set():
            pids = tree_pids(pid)
            m = rss_tree_mb(pids)
            dev, matched = device_used_mb(pids)
            if m is not None:
                samples.append((round(time.time() - t0, 1), m, dev, matched))
            stop.wait(SAMPLE_S)

    while True:
        # own session: the resume-test SIGKILL must take out the whole
        # tree (supervisor + worker), not orphan a still-writing worker
        proc = subprocess.Popen(cmd, env=env, start_new_session=True)
        stop = threading.Event()
        th = threading.Thread(target=sample_loop, args=(proc.pid, stop),
                              daemon=True)
        th.start()
        if resume_test and kills == 0:
            time.sleep(kill_after_s)
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                kills += 1
                proc.wait()
                stop.set()
                th.join()
                killed_at_groups.append(groups_done(out))
                print("# SIGKILLed mid-soak; resuming", file=sys.stderr)
                continue
        rc = proc.wait()
        stop.set()
        th.join()
        if rc != 0:
            raise SystemExit(f"pipeline exited {rc}")
        break
    return time.time() - t0, t0, samples, kills, killed_at_groups


def groups_done(out):
    try:
        with open(os.path.join(out, ".c3poa_progress.json")) as fh:
            return json.load(fh).get("groups_done", 0)
    except (OSError, ValueError):
        return 0


def flat(samples, wall):
    """Over the (t, value) samples after the first 5% of the wall: is the
    largest in the last third at most 1.10 x the largest in the first
    third + 64 MB?  None when a third holds no sample."""
    start = 0.05 * wall
    third = (wall - start) / 3
    first = [v for t, v in samples if start <= t < start + third]
    last = [v for t, v in samples if t >= wall - third]
    if not first or not last:
        return None
    return max(last) <= 1.10 * max(first) + 64


def sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def inside(path, root):
    path, root = os.path.realpath(path), os.path.realpath(root)
    return os.path.commonpath([path, root]) == root


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--cli-entry"]:
        return cli_entry(argv[1], float(argv[2]), argv[3:])
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=1000000)
    # tools/soak.py:193-194 default to /tmp/c3poa_soak and the root
    # SOAK.json, the JAX package's TPU record
    ap.add_argument("--dir", default=os.path.join(BUILD, "soak"))
    ap.add_argument("--out", default=os.path.join(BUILD, "soak",
                                                  "soak.json"))
    ap.add_argument("--resume-test", action="store_true")
    ap.add_argument("--kill-after", type=int, default=300)
    ap.add_argument("--rss-restart-mb", type=int, default=0,
                    help="pass through to the CLI's restart supervisor")
    ap.add_argument("--backend", default="cuda",
                    choices=["cuda", "cpu", "numpy"],
                    help="the CLI's --backend (cpu: the plain versions)")
    args = ap.parse_args(argv)
    for flag, path in (("--dir", args.dir), ("--out", args.out)):
        if inside(path, ROOT) and not inside(path, BUILD):
            raise SystemExit(f"{flag} {path}: inside the checkout but not "
                             f"under its git-ignored build/")

    generate(args.dir, args.reads)
    out_dir = os.path.join(args.dir, "out")
    # tools/soak.py:204 reuses out/: its --resume would find the last
    # soak's finished manifest and run nothing
    shutil.rmtree(out_dir, ignore_errors=True)
    samples_path = os.path.join(args.dir, "device_samples.jsonl")
    if os.path.exists(samples_path):
        os.remove(samples_path)
    wall, t0, samples, kills, killed_at = run_soak(
        args.dir, out_dir, resume_test=args.resume_test,
        kill_after_s=args.kill_after, rss_restart_mb=args.rss_restart_mb,
        backend=args.backend, samples_path=samples_path)
    stats = {}
    sp = os.path.join(out_dir, "c3poa_stats.json")
    if os.path.exists(sp):
        stats = json.load(open(sp))
    n_cons = 0
    log_p = os.path.join(out_dir, "c3poa.log")
    cons = os.path.join(out_dir, "Splint1", "R2C2_Consensus.fasta")
    if os.path.exists(cons):
        with open(cons, "rb") as fh:
            n_cons = sum(1 for line in fh if line.startswith(b">"))
    written, total = None, None
    mp = os.path.join(out_dir, ".c3poa_progress.json")
    if os.path.exists(mp):
        written = json.load(open(mp))["stats"].get("consensus_written")
    if os.path.exists(log_p):
        for line in open(log_p):
            if line.startswith("Total reads:"):
                total = int(line.split()[2])
    rss_vals = [m for _, m, _, _ in samples]
    dev = [(t, v) for t, _, v, _ in samples if v is not None]
    mem = []
    if os.path.exists(samples_path):
        with open(samples_path) as fh:
            for line in fh:
                try:
                    mem.append(json.loads(line))
                except ValueError:
                    pass  # the line a SIGKILL cut short
    reserved = [(round(s["t"] - t0, 1), s["reserved_mb"]) for s in mem]
    allocated = [s["allocated_mb"] for s in mem]
    verdicts = [v for v in (flat(dev, wall), flat(reserved, wall))
                if v is not None]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True) if shutil.which("nvidia-smi") else None

    def every(vals):
        return vals[:: max(1, len(vals) // 50)]

    result = {
        "reads": args.reads,
        "backend": args.backend,
        "nvidia_smi": smi.stdout.strip() if smi else None,
        "wall_s": round(wall, 1),
        "reads_per_sec": round(args.reads / wall, 2),
        "consensi": n_cons,
        "rss_mb_min": min(rss_vals, default=None),
        "rss_mb_max": max(rss_vals, default=None),
        "rss_samples": every([(t, m) for t, m, _, _ in samples]),
        "device_used_mb_min": min((v for _, v in dev), default=None),
        "device_used_mb_max": max((v for _, v in dev), default=None),
        "device_used_pid_matched": sum(1 for *_, m in samples if m),
        "device_used_samples": every(dev),
        "reserved_mb_min": min((v for _, v in reserved), default=None),
        "reserved_mb_max": max((v for _, v in reserved), default=None),
        "allocated_mb_min": min(allocated, default=None),
        "allocated_mb_max": max(allocated, default=None),
        "reserved_samples": every(reserved),
        "sigkills": kills,
        "killed_at_groups": killed_at,
        # tools/soak.py:229 reports the TPU's compiled shapes
        "launches": {k: v for k, v in stats.get("counters", {}).items()
                     if "launches" in k},
        # the last session's own rate and stage seconds
        "session_reads_per_sec": stats.get("reads_per_sec"),
        "stages_s": stats.get("stages_s"),
        "log_exists": os.path.exists(log_p),
        "output_sha256": {rel: sha256(os.path.join(out_dir, rel))
                          for rel in OUTPUT_FILES
                          if os.path.exists(os.path.join(out_dir, rel))},
        "pass": {
            "flat_rss": flat([(t, m) for t, m, _, _ in samples], wall),
            "flat_device": all(verdicts) if verdicts else None,
            # every record the run counted as written is in the file once,
            # and the log accounts for every read
            "consensi": 0 < n_cons == written and total == args.reads,
        },
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    json.dump(result, open(args.out, "w"), indent=1)
    print(json.dumps({k: v for k, v in result.items()
                      if not k.endswith("_samples")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
