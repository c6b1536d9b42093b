"""Fault-surfacing spawn pool for whole-group CPU fan-out.

The reference's ``mp.Pool.apply_async`` + callback silently swallows
worker exceptions — a failed group's reads just vanish from the output
(C3POa.py:245-248, SURVEY.md §5).  ``multiprocessing.Pool.imap`` fixes
the raise case but still HANGS forever when a worker dies abruptly
(SIGKILL/OOM): the pool replaces the worker, the in-flight task is lost,
and the result never arrives.

This pool makes both failure modes LOUD:
- a worker exception is re-raised in the parent (with the worker's
  traceback text, naming the group);
- a worker death is detected by liveness checks while waiting and raises
  ``WorkerDied`` naming the lost groups — never a silent drop or hang;
- an UNPICKLABLE result is a worker exception too (the worker pickles
  its result inside the reporting try block), not the feeder-thread
  stall ``mp.Queue`` gives you.

Results are yielded strictly in submission order (deterministic parent
writes); the task queue is fed lazily with a bounded number in flight,
so streaming inputs never buffer whole files.

Groups are named by ``label`` (a callable over the payload — the
pipelines pass the real 1-based group index, which survives resume
skips and multihost sharding) in every error message and in fault
injection: ``C3POA_FAULT_GROUP="<label>:<mode>"`` makes the worker
processing that group either raise (mode ``raise``) or die with
``os._exit`` (mode ``kill``) — the chaos hooks SURVEY.md §5 calls for.
"""

from __future__ import annotations

import os
import pickle
import queue
import traceback
from typing import Callable, Iterable, Iterator


class WorkerDied(RuntimeError):
    pass


class WorkerFailed(RuntimeError):
    pass


def _pool_worker(fn, task_q, result_q):
    while True:
        item = task_q.get()
        if item is None:
            return
        key, label, payload = item
        try:
            fault = os.environ.get("C3POA_FAULT_GROUP")
            if fault:
                fkey, _, mode = fault.partition(":")
                if fkey == str(label):
                    if mode == "kill":
                        os._exit(13)
                    raise RuntimeError(f"injected fault at group {label}")
            # pickle HERE so an unpicklable result raises in this try
            # block (-> WorkerFailed in the parent) instead of dying in
            # mp.Queue's feeder thread, which would hang the parent
            blob = pickle.dumps(fn(payload), pickle.HIGHEST_PROTOCOL)
            result_q.put((key, True, blob))
        except BaseException:  # noqa: BLE001 — workers must report, not die
            result_q.put((key, False, traceback.format_exc()))


def imap_strict(fn: Callable, payloads: Iterable, workers: int,
                poll_s: float = 2.0,
                label: Callable = None) -> Iterator:
    """Run ``fn(payload)`` on ``workers`` spawn processes; yield results
    in submission order.  Raises WorkerFailed (worker exception, incl.
    unpicklable results) or WorkerDied (abrupt worker death) instead of
    dropping work.  ``label(payload)`` names the group in errors and
    fault injection (default: the 0-based submission index)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    task_q = ctx.Queue()
    result_q = ctx.Queue()
    procs = [ctx.Process(target=_pool_worker, args=(fn, task_q, result_q),
                         daemon=True) for _ in range(workers)]
    for p in procs:
        p.start()

    it = iter(payloads)
    inflight: dict[int, object] = {}   # key -> label
    pending: dict[int, object] = {}
    next_key = 0       # next key to submit
    next_out = 0       # next key to yield
    exhausted = False
    try:
        while True:
            # keep up to 2 tasks per worker queued/in flight
            while not exhausted and len(inflight) < 2 * workers:
                try:
                    payload = next(it)
                except StopIteration:
                    exhausted = True
                    break
                lbl = label(payload) if label is not None else next_key
                task_q.put((next_key, lbl, payload))
                inflight[next_key] = lbl
                next_key += 1
            if exhausted and not inflight:
                return
            # wait for a result, checking worker liveness while idle
            while True:
                try:
                    key, ok, value = result_q.get(timeout=poll_s)
                    break
                except queue.Empty:
                    dead = [p for p in procs
                            if not p.is_alive() and p.exitcode != 0]
                    if dead:
                        lost = sorted(inflight.values(),
                                      key=lambda v: str(v))
                        raise WorkerDied(
                            f"{len(dead)} worker(s) died "
                            f"(exit {dead[0].exitcode}); groups "
                            f"{lost} lost — rerun with "
                            f"--resume after fixing the cause") from None
            if not ok:
                raise WorkerFailed(
                    f"group {inflight.get(key, key)} failed in a "
                    f"worker:\n{value}")
            inflight.pop(key, None)
            pending[key] = pickle.loads(value)
            while next_out in pending:
                yield pending.pop(next_out)
                next_out += 1
    finally:
        for _ in procs:
            task_q.put(None)
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
