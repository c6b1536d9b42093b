"""Exact partial-order-alignment consensus (host-side oracle).

Spec-grade, correctness-only re-implementation of the algorithm CLASS the
reference outsources to abPOA (/root/reference/bin/determine_consensus.py:42-47
builds ``pyabpoa.msa_aligner(match=5)`` and takes ``cons_seq[0]``) and racon's
SIMD POA windows.  The production engine replaces POA with banded
align-to-medoid + column vote (consensus/engine.py), which assumes tandem
copies stay near-linear; THIS module is the stronger fallback for
structurally divergent copies (chimeras, truncations, repeat-length
variants), used as

- the accuracy oracle in the adversarial QV sweeps (tools/qv_sweep.py
  --oracle), bounding where the redesigned engine falls behind the
  abPOA-class algorithm, and
- the routed path for reads a cheap divergence detector flags
  (consensus/engine.py poa_fallback), counted in c3poa_stats.json.

Algorithm (Lee, Grasso & Sharlow 2002; spoa's formulation):
- the graph starts as the linear chain of the first sequence;
- each later sequence is aligned to the graph with affine-gap DP over the
  nodes in topological order (vectorized over the sequence axis), free end
  gaps on both sides (overlap mode — robust to truncated copies);
- the traceback path is fused into the graph: matched nodes gain weight,
  mismatches reuse or extend the matched node's aligned column, insertions
  add fresh nodes;
- consensus = heaviest path (max accumulated edge weight, ties to higher
  node support), like spoa's heaviest bundle.

Pure numpy, no device dependencies; O(nodes * len) per aligned sequence.
"""

from __future__ import annotations

import numpy as np

NEG = -(2 ** 28)


class PoaGraph:
    def __init__(self, match: int = 5, mismatch: int = -4,
                 gap_open: int = 4, gap_ext: int = 2):
        self.match = match
        self.mismatch = mismatch
        self.oe = gap_open + gap_ext
        self.e = gap_ext
        self.base: list[int] = []       # node -> base code
        self.weight: list[int] = []     # node -> support count
        self.quals: list[int] = []      # node -> summed phred support
        self.preds: list[list[int]] = []   # node -> predecessor nodes
        self.edge_w: dict = {}          # (u, v) -> weight
        self.column: list[int] = []     # node -> aligned-column id
        self.col_nodes: list[list[int]] = []  # column -> nodes
        self.order: list[int] = []      # topological order (maintained)

    # ---------- construction ----------

    def _new_node(self, base: int, qual: int, column: int | None) -> int:
        v = len(self.base)
        self.base.append(int(base))
        self.weight.append(1)
        self.quals.append(int(qual))
        self.preds.append([])
        if column is None:
            column = len(self.col_nodes)
            self.col_nodes.append([])
        self.column.append(column)
        self.col_nodes[column].append(v)
        return v

    def _add_edge(self, u: int, v: int) -> None:
        if u < 0:
            return
        key = (u, v)
        self.edge_w[key] = self.edge_w.get(key, 0) + 1
        if u not in self.preds[v]:
            self.preds[v].append(u)

    def add_first(self, seq: np.ndarray, qual: np.ndarray) -> None:
        prev = -1
        for c, q in zip(seq, qual):
            v = self._new_node(c, q, None)
            self._add_edge(prev, v)
            prev = v
        self.order = list(range(len(self.base)))

    # ---------- alignment ----------

    def align(self, seq: np.ndarray):
        """Affine-gap dovetail alignment of ``seq`` to the graph.

        Free end gaps on both sides (graph prefix/suffix skip free; seq
        prefix/suffix chars before/after the aligned core stay OUT of
        the graph) — robust to truncated and chimeric copies.  Interior
        gaps are affine-charged.  Returns the aligned-core traceback as
        a list of (node | -1, seq_pos | -1) pairs: (v, j) = char j
        aligned to node v; (v, -1) = node skipped (deletion); (-1, j) =
        char j inserted between nodes.
        """
        L = len(seq)
        n = len(self.base)
        order = self.order
        rank = {v: k for k, v in enumerate(order)}
        seq = np.asarray(seq, dtype=np.int64)
        karr = np.arange(L + 1, dtype=np.int64)

        # H[k] = score ending at node order[k-1]; row 0 = virtual start.
        # H[0, :] = 0: any seq prefix may be skipped free (not fused);
        # rank 0 also joins every node's pred list: alignment may START
        # at any node (free graph prefix).
        H = np.zeros((n + 1, L + 1), dtype=np.int64)
        E = np.full((n + 1, L + 1), NEG, dtype=np.int64)   # graph-gap state
        # move codes: 0 diag, 1 = graph gap (E, skip node), 2 = seq gap
        # (F, insert char); plus best-predecessor bookkeeping
        mv = np.zeros((n + 1, L + 1), dtype=np.uint8)
        bp_diag = np.zeros((n + 1, L + 1), dtype=np.int32)  # pred rank
        bp_e = np.zeros((n + 1, L + 1), dtype=np.int32)
        e_ext = np.zeros((n + 1, L + 1), dtype=bool)
        f_ext = np.zeros((n + 1, L + 1), dtype=bool)

        for k, v in enumerate(order, start=1):
            pranks = [rank[p] + 1 for p in self.preds[v]] + [0]
            sub = np.where(seq == self.base[v], self.match, self.mismatch)

            # E (skip node v) and diag, best over predecessors
            Ev = np.full(L + 1, NEG, dtype=np.int64)
            bpe = np.full(L + 1, pranks[0], dtype=np.int32)
            e_from_e = np.zeros(L + 1, dtype=bool)
            diag_best = np.full(L + 1, NEG, dtype=np.int64)
            bpd = np.full(L + 1, pranks[0], dtype=np.int32)
            for pr in pranks:
                open_ = H[pr] - self.oe
                ext_ = E[pr] - self.e
                cand = np.maximum(open_, ext_)
                better = cand > Ev
                Ev = np.where(better, cand, Ev)
                bpe = np.where(better, pr, bpe)
                e_from_e = np.where(better, ext_ > open_, e_from_e)
                dcand = H[pr][:-1] + sub          # aligned to char j-1
                dbetter = dcand > diag_best[1:]
                diag_best[1:] = np.where(dbetter, dcand, diag_best[1:])
                bpd[1:] = np.where(dbetter, pr, bpd[1:])

            Ht = np.maximum(diag_best, Ev)
            # F (insert chars from seq): within-row prefix-max recurrence
            A = Ht + self.e * karr
            Acm = np.maximum.accumulate(A)
            F = np.full(L + 1, NEG, dtype=np.int64)
            F[1:] = Acm[:-1] - self.oe - self.e * karr[1:] + self.e
            Hv = np.maximum(Ht, F)

            mv[k] = np.where((diag_best >= Ev) & (diag_best >= F), 0,
                             np.where(Ev >= F, 1, 2)).astype(np.uint8)
            bp_diag[k] = bpd
            bp_e[k] = bpe
            e_ext[k] = e_from_e
            fp = np.full(L + 1, NEG, dtype=np.int64)
            fp[1:] = F[:-1]
            htp = np.full(L + 1, NEG, dtype=np.int64)
            htp[1:] = Ht[:-1]
            f_ext[k] = (fp - self.e) > (htp - self.oe)
            H[k] = Hv
            E[k] = Ev

        # dovetail end: best cell anywhere (free graph suffix AND free
        # unaligned seq suffix — trailing chars are not fused)
        k_end, j_end = np.unravel_index(int(np.argmax(H)), H.shape)
        path = []
        k, j, st = int(k_end), int(j_end), 0
        while k > 0 and (j > 0 or st == 1):
            v = order[k - 1]
            if st == 0:
                m = mv[k, j]
                if m == 0 and j > 0:
                    path.append((v, j - 1))
                    k2 = int(bp_diag[k, j])
                    j -= 1
                    k = k2
                elif m == 1:
                    st = 1
                else:
                    st = 2
            elif st == 1:
                path.append((v, -1))
                nk = int(bp_e[k, j])
                if not e_ext[k, j]:
                    st = 0
                k = nk
            else:
                path.append((-1, j - 1))
                if not f_ext[k, j]:
                    st = 0
                j -= 1
        path.reverse()
        return path

    # ---------- fusion ----------

    def fuse(self, seq: np.ndarray, qual: np.ndarray, path) -> None:
        prev = -1
        for v, j in path:
            if j < 0:
                continue  # graph node skipped: no seq char, no new node
            c, q = int(seq[j]), int(qual[j])
            if v >= 0:
                if self.base[v] == c:
                    node = v
                    self.weight[v] += 1
                    self.quals[v] += q
                else:
                    node = None
                    for alt in self.col_nodes[self.column[v]]:
                        if self.base[alt] == c:
                            node = alt
                            self.weight[alt] += 1
                            self.quals[alt] += q
                            break
                    if node is None:
                        node = self._new_node(c, q, self.column[v])
            else:
                node = self._new_node(c, q, None)
            self._add_edge(prev, node)
            prev = node
        self._retopo()

    def _retopo(self) -> None:
        """Recompute a topological order (Kahn) — new nodes/edges may
        invalidate the maintained one."""
        n = len(self.base)
        indeg = np.zeros(n, dtype=np.int64)
        succs: list[list[int]] = [[] for _ in range(n)]
        for (u, v) in self.edge_w:
            succs[u].append(v)
            indeg[v] += 1
        stack = sorted([v for v in range(n) if indeg[v] == 0])
        order = []
        while stack:
            u = stack.pop()
            order.append(u)
            for v in succs[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    stack.append(v)
        assert len(order) == n, "POA graph has a cycle (fusion bug)"
        self.order = order

    # ---------- consensus ----------

    def consensus(self) -> tuple[np.ndarray, np.ndarray]:
        """Heaviest path: max accumulated edge weight, ties broken by
        node support.  Returns (codes int8, quals int8)."""
        n = len(self.base)
        if n == 0:
            # empty graph (all-empty inputs): empty consensus — matches
            # the C twin (native/poa.c) instead of crashing on argmax
            return np.zeros(0, dtype=np.int8), np.zeros(0, dtype=np.int8)
        score = np.zeros(n, dtype=np.int64)
        best_pred = np.full(n, -1, dtype=np.int64)
        for v in self.order:
            # EDGE weights only (spoa's heaviest bundle): adding node
            # weights would reward detours through insertion nodes (a
            # detour collects an extra node's support); node support is
            # the tie-break
            best = None      # (path score, edge w, pred support)
            for p in self.preds[v]:
                w = self.edge_w[(p, v)]
                cand = (score[p] + w, w, self.weight[p])
                if best is None or cand > best:
                    best = cand
                    best_pred[v] = p
            score[v] = best[0] if best else 0
        end = int(np.argmax(score))
        path = []
        v = end
        while v >= 0:
            path.append(v)
            v = int(best_pred[v])
        path.reverse()
        codes = np.array([self.base[v] for v in path], dtype=np.int8)
        quals = np.array(
            [min(93, self.quals[v] // max(self.weight[v], 1))
             for v in path], dtype=np.int8)
        return codes, quals


def poa_consensus(seqs, quals, match: int = 5, mismatch: int = -4,
                  gap_open: int = 4, gap_ext: int = 2):
    """POA consensus of ``seqs`` (int8 code arrays) with support quals.

    The abPOA-role oracle entry point: graph from the first sequence,
    others aligned + fused in the given order, heaviest-path consensus.
    """
    seqs = [np.asarray(s, dtype=np.int8) for s in seqs]
    quals = [np.asarray(q, dtype=np.int8) for q in quals]
    g = PoaGraph(match=match, mismatch=mismatch, gap_open=gap_open,
                 gap_ext=gap_ext)
    g.add_first(seqs[0], quals[0])
    for s, q in zip(seqs[1:], quals[1:]):
        if len(s) == 0:
            continue
        path = g.align(s)
        g.fuse(s, q, path)
    return g.consensus()
