"""Weight-run minimizing permutation ("sshash permute").

Re-implementation of the reference's cover computation semantics
(reference: include/cover/cover.hpp:14-463, include/cover/parse_file.hpp,
tools/permute.cpp:6-102): sequences are edges (front_weight, back_weight) of
a multigraph; walks that chain equal endpoints let adjacent sequences share
weight runs, reducing the run count of the run-length weight encoding.

Phases (same algorithm, Pythonic data structures):
  1. pre_process  — canonicalize edges (front <= back), collapse groups of
     identical edges into chains, merge (w,w) self-loops into neighbours;
  2. merge_even   — repeatedly pair up two edges incident to the weight of
     smallest even frequency, building binary parent nodes;
  3. greedy_cover — grow maximal walks by matching endpoints through an
     incidence map;
  4. flatten      — emit (sequence_id, sign) in walk order with orientation
     propagation (cover.hpp save_chain/save_tree/save_leaf) — sign=False
     means the sequence is written reverse-complemented with reversed
     weights (parse_file.hpp reverse_header / permute_and_write).

The exact walks depend on set iteration order (the C++ uses unordered_set
too); the contract is validity (every emitted walk is endpoint-linked) and
final_runs = initial_runs - num_sequences + num_walks.
"""

import gzip
from dataclasses import dataclass

import numpy as np

from . import kmer as K

INVALID = -1


@dataclass
class Node:
    id: int = INVALID
    front: int = INVALID
    back: int = INVALID
    sign: bool = True
    chain_id: int = INVALID
    left: int = INVALID
    right: int = INVALID

    def flip(self):
        self.front, self.back = self.back, self.front
        self.sign = not self.sign


@dataclass
class PermuteData:
    num_runs_weights: int
    num_sequences: int
    nodes: list


def _open(path):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def parse_weighted_headers(path, k):
    """Headers only: per sequence (front_weight, back_weight) + run count
    (parse_file.hpp:20-122)."""
    nodes = []
    num_runs = 0
    with _open(path) as f:
        while True:
            header = f.readline()
            if not header:
                break
            header = header.rstrip(b"\r\n")
            seq = f.readline().rstrip(b"\r\n")
            if len(seq) < k:
                # match the build parser: dropping records would silently
                # change the collection's kmer/weight content
                raise ValueError(f"sequence shorter than k: {len(seq)} < {k}")
            idx = header.index(b"ab:Z:") + 5
            weights = header[idx:].split()
            ln = int(header[header.index(b"LN:i:") + 5 :].split()[0])
            if len(weights) != ln - k + 1 or ln != len(seq):
                raise ValueError("malformed weighted header")
            prev = None
            for w in weights:
                if w != prev:
                    num_runs += 1
                prev = w
            nodes.append(Node(id=len(nodes), front=int(weights[0]), back=int(weights[-1])))
    return PermuteData(num_runs_weights=num_runs, num_sequences=len(nodes), nodes=nodes)


class Cover:
    def __init__(self, data: PermuteData):
        self.num_sequences = data.num_sequences
        self.initial_runs = data.num_runs_weights
        self.nodes = list(data.nodes)
        self.chains = []  # list[list[Node]]
        self.walks = []  # list[list[Node]]
        self.incidence = {}  # weight -> set of node offsets
        self.unvisited = set()

    # ----------------------------------------------------------- plumbing

    def _insert(self, u, off):
        self.unvisited.add(off)
        self.incidence.setdefault(u.front, set()).add(off)
        self.incidence.setdefault(u.back, set()).add(off)

    def _erase(self, u, off):
        self.unvisited.discard(off)
        self.incidence.get(u.front, set()).discard(off)
        self.incidence.get(u.back, set()).discard(off)

    def _merge(self, x, y, w, off_x, off_y):
        """Merge nodes x, y on weight w into a parent (cover.hpp:438-447)."""
        if x.front == w:
            x.flip()
        if y.back == w:
            y.flip()
        return Node(front=x.front, back=y.back, left=off_x, right=off_y)

    @staticmethod
    def _append_to_walk(u, walk):
        if not walk:
            walk.append(u)
            return
        if walk[0].front == u.front or walk[-1].back == u.back:
            u.flip()
        if walk[0].front == u.back:
            walk.insert(0, u)
        elif walk[-1].back == u.front:
            walk.append(u)

    # -------------------------------------------------------------- phases

    def compute(self):
        self._pre_process()
        self._merge_even()
        self._greedy_cover()
        return self

    def _pre_process(self):
        for u in self.nodes:
            if u.front > u.back:
                u.flip()
        self.nodes.sort(key=lambda u: (u.front, u.back))

        # collapse groups of identical (front, back) edges into chains
        tmp = []
        group = []
        for u in self.nodes + [None]:
            if group and (u is None or (u.front, u.back) != (group[0].front, group[0].back)):
                front, back = group[0].front, group[-1].back
                if len(group) == 1:
                    tmp.append(group[0])
                elif front != back and len(group) % 2 == 0:
                    # two parents keep the component's endpoint parity odd
                    p1 = group.pop()
                    if len(group) == 1:
                        p2 = group[0]
                    else:
                        p2 = Node(front=group[0].front, back=group[-1].back,
                                  chain_id=len(self.chains))
                        self.chains.append(group)
                    tmp.extend([p1, p2])
                else:
                    p = Node(front=group[0].front, back=group[-1].back,
                             chain_id=len(self.chains))
                    self.chains.append(group)
                    tmp.append(p)
                group = []
            if u is not None:
                chain = group
                self._append_to_walk(u, chain)
        self.nodes = tmp

        for off, u in enumerate(self.nodes):
            self._insert(u, off)

        # merge (w,w) self-loops into a neighbour on w (cover.hpp:237-259)
        off_u = 0
        while off_u < len(self.nodes):
            u = self.nodes[off_u]
            if u.front == u.back and off_u in self.unvisited:
                w = u.front
                inc = self.incidence.get(w, set())
                if len(inc) > 1:
                    self._erase(u, off_u)
                    off_x = next(iter(inc))
                    x = self.nodes[off_x]
                    self._erase(x, off_x)
                    p = self._merge(x, u, w, off_x, off_u)
                    self.nodes.append(p)
                    self._insert(p, len(self.nodes) - 1)
            off_u += 1

    def _merge_even(self):
        # frequency of each weight over unvisited nodes
        freq = {}
        for off in self.unvisited:
            u = self.nodes[off]
            freq[u.front] = freq.get(u.front, 0) + 1
            freq[u.back] = freq.get(u.back, 0) + 1

        # bucket-by-frequency priority structure (even_frequency_weights.hpp):
        # repeatedly take a weight of minimal EVEN frequency
        import heapq

        heap = [(f, w) for w, f in freq.items() if f % 2 == 0 and f > 0]
        heapq.heapify(heap)

        def push(w):
            f = freq.get(w, 0)
            if f % 2 == 0 and f > 0:
                heapq.heappush(heap, (f, w))

        while heap:
            f, w = heapq.heappop(heap)
            if freq.get(w, 0) != f or f % 2 != 0 or f == 0:
                continue  # stale entry
            inc = self.incidence.get(w, set())
            if len(inc) <= 1:
                continue
            it = iter(inc)
            off_x = next(it)
            off_y = next(it)
            x, y = self.nodes[off_x], self.nodes[off_y]
            p = self._merge(x, y, w, off_x, off_y)
            self._erase(x, off_x)
            self._erase(y, off_y)
            freq[w] -= 2
            push(w)
            off_p = len(self.nodes)
            self.nodes.append(p)
            if p.front == p.back:
                ww = p.front
                freq[ww] -= 2  # merging (ww,ww) onto a neighbour next
                inc_ww = self.incidence.get(ww, set())
                if inc_ww:
                    off_xx = next(iter(inc_ww))
                    xx = self.nodes[off_xx]
                    self._insert(p, off_p)
                    pp = self._merge(xx, self.nodes[off_p], ww, off_xx, off_p)
                    self._erase(xx, off_xx)
                    self._erase(self.nodes[off_p], off_p)
                    off_p = len(self.nodes)
                    self.nodes.append(pp)
                    p = pp
                else:
                    freq[ww] += 2  # stays: single component node
                push(ww)
            self._insert(p, off_p)

    def _greedy_cover(self):
        while self.unvisited:
            off_u = next(iter(self.unvisited))
            walk = []
            while True:
                u = self.nodes[off_u]
                self._append_to_walk(u, walk)
                self._erase(u, off_u)
                inc = self.incidence.get(walk[-1].back, set())
                if inc:
                    off_u = next(iter(inc))
                    continue
                inc = self.incidence.get(walk[0].front, set())
                if inc:
                    off_u = next(iter(inc))
                    continue
                break
            self.walks.append(walk)

    # -------------------------------------------------------------- flatten

    def permutation_and_signs(self):
        """Emit (sequence_id, sign) in walk order; returns
        (permutation uint[num_seqs], signs bool[num_seqs], num_walks).
        permutation[seq_id] = new position (tools/permute.cpp:84-92)."""
        order = []

        def emit_leaf(u, sign_flip):
            if sign_flip:
                u.flip()
            order.append((u.id, u.sign))

        def emit_chain(parent_sign, v):
            chain = self.chains[v.chain_id]
            new_sign = parent_sign == v.sign
            if new_sign:
                for u in chain:
                    emit_leaf(u, False)
            else:
                for u in reversed(chain):
                    emit_leaf(u, True)

        def emit_tree(parent_sign, u):
            # iterative post-order with orientation propagation
            stack = [(parent_sign, u)]
            while stack:
                sign, v = stack.pop()
                if v.left == INVALID and v.right == INVALID:
                    if v.chain_id != INVALID:
                        emit_chain(sign, v)
                    else:
                        emit_leaf(v, not sign)
                    continue
                new_sign = sign == v.sign
                lt, rt = self.nodes[v.left], self.nodes[v.right]
                if new_sign:
                    stack.extend([(new_sign, rt), (new_sign, lt)])
                else:
                    stack.extend([(new_sign, lt), (new_sign, rt)])

        for walk in self.walks:
            for u in walk:
                if u.chain_id != INVALID:
                    emit_chain(True, u)
                elif u.left != INVALID and u.right != INVALID:
                    emit_tree(True, u)
                else:
                    emit_leaf(u, False)

        assert len(order) == self.num_sequences, (len(order), self.num_sequences)
        perm = np.empty(self.num_sequences, dtype=np.int64)
        signs = np.empty(self.num_sequences, dtype=bool)
        for pos, (sid, sign) in enumerate(order):
            perm[sid] = pos
            signs[sid] = sign
        return perm, signs, len(self.walks)

    @property
    def final_runs(self):
        return self.initial_runs - self.num_sequences + len(self.walks)


# ------------------------------------------------------------------ rewriting


def _reverse_header(header, k):
    """Reverse the ab:Z: weights (parse_file.hpp reverse_header)."""
    i = header.index(b"ab:Z:") + 5
    weights = header[i:].split()
    return header[:i] + b" ".join(reversed(weights))


def permute_file(input_path, k, output_path):
    """Full permute pipeline (tools/permute.cpp): parse headers, compute
    cover, rewrite the FASTA in permuted order with orientations applied."""
    data = parse_weighted_headers(input_path, k)
    cov = Cover(data).compute()
    perm, signs, num_walks = cov.permutation_and_signs()

    records = [None] * data.num_sequences
    i = 0
    with _open(input_path) as f:
        while True:
            header = f.readline()
            if not header:
                break
            header = header.rstrip(b"\r\n")
            seq = f.readline().rstrip(b"\r\n")
            if len(seq) < k:
                raise ValueError(f"sequence shorter than k: {len(seq)} < {k}")
            if not signs[i]:
                seq = K.revcomp_str(seq).encode()
                header = _reverse_header(header, k)
            records[perm[i]] = (header, seq)
            i += 1

    with open(output_path, "wb") as out:
        for header, seq in records:
            out.write(header + b"\n" + seq + b"\n")

    return {
        "num_sequences": data.num_sequences,
        "initial_runs": data.num_runs_weights,
        "final_runs": cov.final_runs,
        "num_walks": num_walks,
    }
