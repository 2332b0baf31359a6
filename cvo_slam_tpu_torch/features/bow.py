"""Bag-of-binary-words vocabulary, DBoW2-equivalent (copy of
cvo_slam_tpu.features.bow; NumPy only).

Functional re-expression of the reference place-recognition layer
(reference thirdparty/ORB_SLAM2/Thirdparty/DBoW2,
TemplatedVocabulary.h): a k-ary hierarchical vocabulary over 256-bit
descriptors with TF-IDF weighting, `transform(descriptors, levelsup)`
producing (BowVector, FeatureVector) and L1 similarity scoring
(ScoringObject.h L1Scoring: s = 1 - 0.5 |v/|v| - w/|w||_1).

The reference ships no vocabulary (ORBvoc.txt is a missing large blob,
.MISSING_LARGE_BLOBS); we support the DBoW2 text format when a file is
provided and otherwise train a per-run vocabulary ONLINE over the keyframes
mapped so far (GrowingVocabulary): hierarchical binary k-means with
majority-bit centroids, retrained at power-of-two keyframe counts with real
TF-IDF weights (each keyframe = one document, DBoW2 TF_IDF weighting), and a
deeper tree once enough descriptors accumulate. Keyframes carry a
`bow_version`; consumers lazily re-transform stale BoW vectors after a
retrain (backend.loop_closure).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

_POPCOUNT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                          axis=1).sum(1).astype(np.uint8)


_HAS_BITWISE_COUNT = hasattr(np, "bitwise_count")   # NumPy >= 2.0


def _popcount_sum(x: np.ndarray) -> np.ndarray:
    """Sum of per-byte popcounts over the last axis (= Hamming distance of
    packed descriptors). Native np.bitwise_count (NumPy >= 2.0) over a uint64
    view is ~8x the byte-LUT path; the LUT serves odd lengths and NumPy 1.x."""
    if _HAS_BITWISE_COUNT and x.shape[-1] % 8 == 0:
        x64 = np.ascontiguousarray(x).view(np.uint64)
        return np.bitwise_count(x64).sum(axis=-1).astype(np.int32)
    return _POPCOUNT[x].sum(axis=-1).astype(np.int32)


def hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise Hamming distances between (Na,32) and (Nb,32) uint8."""
    x = np.bitwise_xor(a[:, None, :], b[None, :, :])
    return _popcount_sum(x)


def _majority_centroid(descs: np.ndarray) -> np.ndarray:
    bits = np.unpackbits(descs, axis=1)
    maj = (bits.sum(0) * 2 >= len(descs)).astype(np.uint8)
    return np.packbits(maj)


class Vocabulary:
    """Array-form k-ary tree: node 0 is the root."""

    def __init__(self, k: int, L: int):
        self.k = k
        self.L = L
        self.children: list = [[]]        # per node: list of child node ids
        self.node_desc = [np.zeros(32, np.uint8)]
        self.node_weight = [0.0]
        self.node_depth = [0]
        self.word_of_node: Dict[int, int] = {}
        self.node_of_word: list = []
        self._packed = None

    # -- training ----------------------------------------------------------
    def _new_node(self, parent_depth: int, desc: np.ndarray) -> int:
        nid = len(self.children)
        self.children.append([])
        self.node_desc.append(desc)
        self.node_weight.append(0.0)
        self.node_depth.append(parent_depth + 1)
        return nid

    @staticmethod
    def train(descriptors: np.ndarray, k: int = 10, L: int = 3,
              seed: int = 42) -> "Vocabulary":
        """Hierarchical binary k-means (k-means++ seeding, majority-bit
        centroids) — the DBoW2 creation recipe on our own data."""
        rng = np.random.default_rng(seed)
        voc = Vocabulary(k, L)

        def kmeans(descs, kk, iters=8):
            n = len(descs)
            if n <= kk:
                return [np.array([i]) for i in range(n)], descs.copy()
            # k-means++ seeding
            centers = [descs[rng.integers(n)]]
            for _ in range(kk - 1):
                d = hamming(descs, np.array(centers)).min(axis=1).astype(np.float64)
                if d.sum() == 0:
                    centers.append(descs[rng.integers(n)])
                    continue
                centers.append(descs[rng.choice(n, p=d / d.sum())])
            C = np.array(centers)
            for _ in range(iters):
                assign = hamming(descs, C).argmin(axis=1)
                newC = []
                for c in range(kk):
                    m = assign == c
                    newC.append(_majority_centroid(descs[m]) if m.any()
                                else descs[rng.integers(n)])
                C2 = np.array(newC)
                if np.array_equal(C2, C):
                    break
                C = C2
            assign = hamming(descs, C).argmin(axis=1)
            groups = [np.flatnonzero(assign == c) for c in range(kk)]
            return [g for g in groups if len(g)], C

        def build(node, descs, depth):
            if depth == L or len(descs) == 0:
                wid = len(voc.node_of_word)
                voc.word_of_node[node] = wid
                voc.node_of_word.append(node)
                return
            groups, _ = kmeans(descs, k)
            for g in groups:
                child = voc._new_node(depth, _majority_centroid(descs[g]))
                voc.children[node].append(child)
                build(child, descs[g], depth + 1)

        build(0, np.asarray(descriptors, np.uint8), 0)
        # uniform idf default (single training "document"); callers with
        # multiple documents overwrite via set_idf_weights
        for node in voc.node_of_word:
            voc.node_weight[node] = 1.0
        voc._pack()
        return voc

    def _word_nodes(self, descriptors: np.ndarray) -> np.ndarray:
        """Leaf (word) node id per descriptor — the transform descent only."""
        child_arr, node_desc = self._packed[0], self._packed[1]
        descs = np.asarray(descriptors, np.uint8)
        cur = np.zeros(len(descs), np.int64)
        for _ in range(self.L):
            ch = child_arr[cur]
            has = ch >= 0
            if not has.any():
                break
            cd = node_desc[np.where(has, ch, 0)]
            x = np.bitwise_xor(cd, descs[:, None, :])
            dist = _popcount_sum(x)
            dist = np.where(has, dist, 1 << 30)
            nxt = np.take_along_axis(ch, dist.argmin(axis=1)[:, None],
                                     axis=1)[:, 0]
            cur = np.where(has.any(axis=1), nxt, cur)
        return cur

    def set_idf_weights(self, docs) -> None:
        """Real IDF over training documents (DBoW2 TemplatedVocabulary::
        setNodeWeights, TF_IDF): weight_i = ln(N / N_i) with N_i = number of
        documents containing word i — smoothed to ln((N+1)/N_i) so a
        single-document vocabulary still scores (documented deviation)."""
        n_docs = len(docs)
        if n_docs == 0:
            return
        counts = np.zeros(len(self.node_of_word), np.int64)
        for d in docs:
            if d is None or len(d) == 0:
                continue
            words = {self.word_of_node[int(n)]
                     for n in self._word_nodes(d) if int(n) in self.word_of_node}
            for w in words:
                counts[w] += 1
        for wid, node in enumerate(self.node_of_word):
            ni = max(int(counts[wid]), 1)
            self.node_weight[node] = float(np.log((n_docs + 1.0) / ni))
        self._pack()

    def _pack(self):
        n = len(self.children)
        kmax = max((len(c) for c in self.children), default=1) or 1
        child_arr = np.full((n, kmax), -1, np.int64)
        for i, c in enumerate(self.children):
            child_arr[i, :len(c)] = c
        wid_of_node = np.full(n, -1, np.int64)
        for node, wid in self.word_of_node.items():
            wid_of_node[node] = wid
        self._packed = (child_arr, np.array(self.node_desc, np.uint8),
                        np.array(self.node_weight, np.float64),
                        np.array(self.node_depth, np.int32), wid_of_node)

    # -- runtime -----------------------------------------------------------
    def transform(self, descriptors: np.ndarray, levelsup: int = 4):
        """(BowVector word->weight L1-normalized, FeatureVector node->[kp idx])
        — TemplatedVocabulary::transform(features, bv, fv, levelsup)."""
        child_arr, node_desc, node_weight, node_depth, wid_of_node = \
            self._packed
        nd = len(descriptors)
        bow: Dict[int, float] = {}
        fv: Dict[int, list] = {}
        if nd == 0:
            return bow, fv
        descs = np.asarray(descriptors, np.uint8)
        cur = np.zeros(nd, np.int64)
        nid_level = max(self.L - levelsup, 0)
        nid = np.zeros(nd, np.int64)
        for depth in range(self.L):
            ch = child_arr[cur]                       # (nd, kmax)
            has = ch >= 0
            if not has.any():
                break
            # hamming to each child's centroid
            cd = node_desc[np.where(has, ch, 0)]      # (nd, kmax, 32)
            x = np.bitwise_xor(cd, descs[:, None, :])
            dist = _popcount_sum(x)
            dist = np.where(has, dist, 1 << 30)
            nxt = np.take_along_axis(ch, dist.argmin(axis=1)[:, None],
                                     axis=1)[:, 0]
            cur = np.where(has.any(axis=1), nxt, cur)
            if depth == nid_level:
                nid = cur.copy()
        # vectorized tail (was a per-descriptor Python loop): descriptors
        # whose leaf is a word contribute its weight to the BowVector and
        # their index to the FeatureVector bucket of the levelsup node
        wid_arr = wid_of_node[cur]
        sel = np.flatnonzero(wid_arr >= 0)
        if len(sel):
            w_arr = node_weight[cur[sel]]
            pos = sel[w_arr > 0]
            if len(pos):
                uw, inv = np.unique(wid_arr[pos], return_inverse=True)
                sums = np.bincount(inv, weights=node_weight[cur[pos]])
                total = float(sums.sum())
                scale = 1.0 / total if total > 0 else 1.0
                bow = {int(k): float(v) * scale for k, v in zip(uw, sums)}
            order = np.argsort(nid[sel], kind="stable")
            so = nid[sel][order]
            si = sel[order]
            starts = np.flatnonzero(np.r_[True, so[1:] != so[:-1]])
            ends = np.r_[starts[1:], len(so)]
            for b, e in zip(starts, ends):
                fv[int(so[b])] = si[b:e].tolist()
        return bow, fv

    @staticmethod
    def score(v1: Dict[int, float], v2: Dict[int, float]) -> float:
        """L1 similarity (ScoringObject L1Scoring on L1-normalized vectors)."""
        s = 0.0
        for w, x in v1.items():
            y = v2.get(w)
            if y is not None:
                s += abs(x) + abs(y) - abs(x - y)
        return 0.5 * s


def load_orbvoc_text(path: str) -> Vocabulary:
    """DBoW2 text format: header 'k L scoring weighting'; one line per node:
    'parent_id is_leaf d0..d31 weight' (TemplatedVocabulary::loadFromTextFile,
    TemplatedVocabulary.h:1338)."""
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        voc = Vocabulary(k, L)
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parent = int(parts[0])
            is_leaf = int(parts[1])
            desc = np.array([int(v) for v in parts[2:34]], np.uint8)
            weight = float(parts[34])
            nid = voc._new_node(voc.node_depth[parent], desc)
            voc.children[parent].append(nid)
            voc.node_weight[nid] = weight
            if is_leaf:
                wid = len(voc.node_of_word)
                voc.word_of_node[nid] = wid
                voc.node_of_word.append(nid)
    voc._pack()
    return voc


class GrowingVocabulary:
    """Online vocabulary growing with the map.

    Each keyframe contributes one "document" (a deterministic subsample of
    its descriptors). The tree is retrained from scratch at power-of-two
    document counts (1, 2, 4, 8, ... — O(log N) retrains, each O(N) work)
    with real TF-IDF weights, and deepens to L+1 once the corpus is large
    enough to populate a 10x bigger vocabulary. `version` increments per
    retrain so consumers can lazily refresh stale BoW vectors
    (Keyframe.bow_version)."""

    def __init__(self, k: int = 10, L: int = 3, max_desc_per_doc: int = 300,
                 seed: int = 42, deepen_at: int = 4000):
        self.k, self.L = k, L
        self.max_desc_per_doc = max_desc_per_doc
        self.seed = seed
        self.deepen_at = deepen_at
        self.docs: list = []
        self._voc: Optional[Vocabulary] = None
        self.version = 0

    def add_document(self, descriptors: np.ndarray):
        if descriptors is None or len(descriptors) < 1:
            return
        d = np.asarray(descriptors, np.uint8)
        if len(d) > self.max_desc_per_doc:
            idx = np.linspace(0, len(d) - 1, self.max_desc_per_doc,
                              dtype=np.int64)
            d = d[idx]
        self.docs.append(d)
        n = len(self.docs)
        total = sum(len(x) for x in self.docs)
        if (self._voc is None and total >= self.k) or (n & (n - 1)) == 0:
            self._retrain()

    def _retrain(self):
        all_desc = np.concatenate(self.docs)
        if len(all_desc) < self.k:
            return
        L = self.L + 1 if len(all_desc) >= self.deepen_at else self.L
        voc = Vocabulary.train(all_desc, self.k, L, seed=self.seed)
        voc.set_idf_weights(self.docs)
        self._voc = voc
        self.version += 1

    def transform(self, descriptors: np.ndarray, levelsup: int = 4):
        if self._voc is None:
            return {}, {}
        return self._voc.transform(descriptors, levelsup)

    @staticmethod
    def score(v1, v2):
        return Vocabulary.score(v1, v2)


# backward-compatible alias (round-1 name)
LazyVocabulary = GrowingVocabulary


def default_vocabulary() -> GrowingVocabulary:
    return GrowingVocabulary()
