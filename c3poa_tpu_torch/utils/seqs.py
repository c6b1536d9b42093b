"""Sequence encoding utilities.

DNA is carried on device as int8: A=0 C=1 G=2 T=3, anything else (N, IUPAC
ambiguity codes) = 4.  Code 4 is also the pad value; the alignment kernels
score it as neutral (0) so padding can never create score.

Replaces the reference's reliance on mappy for revcomp (``C3POa.py:234``,
``C3POa_postprocessing.py:341``) and on str/ord loops for phred handling
(``C3POa.py:168``).
"""

from __future__ import annotations

import numpy as np

BASE_A, BASE_C, BASE_G, BASE_T, BASE_N = 0, 1, 2, 3, 4

_ENC = np.full(256, BASE_N, dtype=np.int8)
for i, b in enumerate("ACGT"):
    _ENC[ord(b)] = i
    _ENC[ord(b.lower())] = i

_DEC = np.frombuffer(b"ACGTN", dtype=np.uint8)

# complement in encoded space: A<->T, C<->G, N->N
_COMP_ENC = np.array([BASE_T, BASE_G, BASE_C, BASE_A, BASE_N], dtype=np.int8)

_COMP_CHAR = np.arange(256, dtype=np.uint8)
for a, b in [("A", "T"), ("C", "G"), ("G", "C"), ("T", "A"),
             ("a", "t"), ("c", "g"), ("g", "c"), ("t", "a")]:
    _COMP_CHAR[ord(a)] = ord(b)


def encode(seq: str) -> np.ndarray:
    """str -> int8 codes."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _ENC[raw]


def decode(codes: np.ndarray) -> str:
    """int8 codes -> str (pad/ambiguity renders as N)."""
    return _DEC[np.asarray(codes, dtype=np.int64)].tobytes().decode("ascii")


def revcomp(seq: str) -> str:
    """Reverse complement of a string (IUPAC chars other than ACGT -> kept via table, N stays N)."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _COMP_CHAR[raw][::-1].tobytes().decode("ascii")


def revcomp_encoded(codes: np.ndarray) -> np.ndarray:
    return _COMP_ENC[np.asarray(codes, dtype=np.int64)][::-1].astype(np.int8)


def phred_to_array(qual: str) -> np.ndarray:
    """Phred string -> int8 array of quality values (ord(c) - 33)."""
    raw = np.frombuffer(qual.encode("ascii"), dtype=np.uint8)
    return (raw.astype(np.int16) - 33).astype(np.int8)


def array_to_phred(q: np.ndarray) -> str:
    return (np.clip(np.asarray(q, dtype=np.int16), 0, 93) + 33).astype(np.uint8).tobytes().decode("ascii")


def round_to_base(x: float, base: int = 50) -> int:
    """Round to the nearest multiple of ``base`` using Python banker's rounding.

    Exact-parity reimplementation of ``rounding`` (reference C3POa.py:106-108):
    ``int(base * round(float(x) / base))``.
    """
    return int(base * round(float(x) / base))
