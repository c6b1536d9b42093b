"""The benchmark's one traffic generator: R2C2 read pools, made with
vectorised numpy from a configuration (the read shape) and a traffic mix
(the pool), both plain JSON files read by name.

The shape is that of the port's own generator, drawn from the same
distributions with the same parameters (the CPU tests hold it to them):
``c3poa_tpu_torch.sim.make_read`` / ``make_dataset`` (``bench.py``'s
shape): ``[lead][splint][copy]...[splint][trail]``, the lead the
insert's last half and the trail its first half, every base mutated
independently (substitution, deletion and a geometric run of insertions
after it: error split 50/25/25), reverse-complemented on strand '-',
qualities N(20, 4) clipped to 2..40.

A base is mutated exactly as ``sim.mutate`` does it, in one call for a
whole pool: mutating the parts of a read one by one or their
concatenation at once draws from the same distribution.

Every seed gets the same set of sizes (insert lengths, copy counts,
strands) in the same groups: they are drawn and placed from the mix's
own fixed ``size_seed``, and the run's seed draws the bases, the errors,
the splint and the order of the reads within each group of the
configuration's ``group_size``.  So runs with different seeds do the same
work, on other sequences: which reads share a group (and so a locate
batch and its padding) never changes.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

_DEC = np.frombuffer(b"ACGTN", dtype=np.uint8)
_COMP = np.array([3, 2, 1, 0, 4], dtype=np.int8)


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    if seed < 0:
        raise ValueError(f"seed {seed} is negative")
    return np.random.default_rng(np.random.SeedSequence([seed, *stream]))


def revcomp(codes: np.ndarray) -> np.ndarray:
    return _COMP[codes][::-1]


def decode(codes: np.ndarray) -> bytes:
    return _DEC[codes].tobytes()


def mutate_many(rng: np.random.Generator, template: np.ndarray,
                error: float) -> tuple[np.ndarray, np.ndarray]:
    """``sim.mutate`` over a whole template at once: per base, deletion
    with probability error/4, a random base (of four) with error/2, then
    a geometric number of random inserted bases, each with error/4.
    Returns (codes, out_pos) where ``out_pos[i]`` is where template base
    ``i``'s output run starts (len(template) + 1 entries), so part
    boundaries of the template map to the output."""
    sub, ins, dele = error * 0.5, error * 0.25, error * 0.25
    n = len(template)
    r = rng.random(n)
    keep = r >= dele
    subst = keep & (r < dele + sub)
    base = np.where(subst, rng.integers(0, 4, n, dtype=np.int8), template)
    n_ins = rng.geometric(1.0 - ins, n) - 1 if ins > 0 else np.zeros(n, int)
    run = keep.astype(np.int64) + n_ins
    out_pos = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(run, out=out_pos[1:])
    out = rng.integers(0, 4, int(out_pos[-1]), dtype=np.int8)
    out[out_pos[:-1][keep]] = base[keep]
    return out, out_pos


@dataclasses.dataclass
class Pool:
    """One run's reads, in the order they are fed.  ``truth`` holds each
    read's insert on the read's strand before any reverse complement
    (the consensus the reference expects), ``strand`` '+' or '-'."""
    names: list
    seqs: list            # int8 code arrays
    quals: list           # int8 phred arrays
    truth: list           # int8 code arrays
    strand: list
    splints: dict         # name -> int8 codes

    def write_fastq(self, path: str, idx=None) -> None:
        idx = range(len(self.seqs)) if idx is None else idx
        with open(path, "wb") as fh:
            for i in idx:
                q = (np.clip(self.quals[i].astype(np.int16), 0, 93) + 33
                     ).astype(np.uint8).tobytes()
                fh.write(b"@" + self.names[i].encode() + b"\n" +
                         decode(self.seqs[i]) + b"\n+\n" + q + b"\n")

    def write_splints(self, path: str) -> None:
        with open(path, "wb") as fh:
            for name, codes in self.splints.items():
                fh.write(b">" + name.encode() + b"\n" + decode(codes) + b"\n")


def r2c2_sizes(shape: dict, mix: dict) -> dict:
    """The pool's sizes, the same for every seed: insert lengths, copy
    counts and strands, from the mix's ``size_seed``."""
    rng = np.random.default_rng(int(mix["size_seed"]))
    n = int(mix["reads"])
    lo, hi = shape["insert_len"]
    ins = rng.integers(lo, hi, n)
    c_lo, c_hi = shape["copies"]
    copies = (c_lo + np.floor(rng.random(n) * (c_hi - c_lo + 1))).astype(int)
    minus = rng.random(n) < 0.5
    return dict(insert_len=ins, copies=copies, minus=minus)


def group_order(rng: np.random.Generator, n: int, group: int) -> np.ndarray:
    """The seed's order of the reads: each group of ``group`` places
    (as the pipeline cuts them) keeps the same reads, shuffled within.
    So the pipeline's groups, and the batches cut from them, hold the
    same sizes for every seed."""
    return np.concatenate([a + rng.permutation(min(group, n - a))
                           for a in range(0, n, group)])


def make_r2c2_pool(config: dict, mix: dict, seed: int) -> Pool:
    shape = config["read_shape"]
    sizes = r2c2_sizes(shape, mix)
    rng = rng_for(seed, 1)
    n = len(sizes["insert_len"])
    splints = {s["name"]: rng.integers(0, 4, int(s["length"]), dtype=np.int8)
               for s in config["splints"]}
    splint = next(iter(splints.values()))
    order = group_order(rng, n, int(config["cli"]["group_size"]))

    templates, truths = [], []
    for i in order:
        L = int(sizes["insert_len"][i])
        insert = rng.integers(0, 4, L, dtype=np.int8)
        parts = [insert[L - L // 2:]]
        for _c in range(int(sizes["copies"][i])):
            parts += [splint, insert]
        parts += [splint, insert[:L // 2]]
        templates.append(np.concatenate(parts))
        truths.append(insert)
    bounds = np.array([len(t) for t in templates])
    mutated, out_pos = mutate_many(rng, np.concatenate(templates),
                                   float(shape["error"]))
    ends = np.cumsum(bounds)
    starts = ends - bounds
    seqs, quals, strand = [], [], []
    q_mean, q_sd = shape.get("qual", (20, 4))
    for k, i in enumerate(order):
        s = mutated[out_pos[starts[k]]:out_pos[ends[k]]]
        if sizes["minus"][i]:
            s = revcomp(s)
        seqs.append(np.ascontiguousarray(s))
        quals.append(np.clip(rng.normal(q_mean, q_sd, len(s)), 2, 40
                             ).astype(np.int8))
        strand.append("-" if sizes["minus"][i] else "+")
    names = [f"read{k}" for k in range(n)]
    return Pool(names, seqs, quals, truths, strand, splints)


def make_pool(config: dict, mix: dict, seed: int) -> Pool:
    kind = mix["kind"]
    if kind == "r2c2":
        return make_r2c2_pool(config, mix, seed)
    raise ValueError(f"traffic kind {kind!r} (r2c2)")


def write_inputs(pool: Pool, path: str) -> dict:
    os.makedirs(path, exist_ok=True)
    files = dict(reads=os.path.join(path, "reads.fastq"),
                 splint=os.path.join(path, "splint.fasta"))
    pool.write_fastq(files["reads"])
    pool.write_splints(files["splint"])
    return files
