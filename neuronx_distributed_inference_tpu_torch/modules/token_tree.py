"""Static token-tree speculation structures (counterpart:
``neuronx_distributed_inference_tpu/modules/token_tree.py`` — ``TokenTree``
:20, ``from_config`` :69, ``leaf_path_matrix`` :78, ``node_positions`` :95,
``attention_mask`` :99, ``DEFAULT_TREE`` :125; a copy, since the port
imports nothing of the JAX package).

A tree is defined by a list of paths (mc_sim-style): each path is a list of
branch indices from the root, e.g. ``[[0], [1], [0, 0], [0, 1]]`` = two
children of the root, plus two children of the first child. Node 0 is the
implicit root (the last committed token). Everything here is host-side
numpy; ``models/speculation.py`` moves the arrays to the device once and
builds the per-step masks there."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class TokenTree:
    """Precomputed tree layout.

    Node 0 = root. Nodes are sorted by (depth, path) so siblings are
    adjacent and depth levels are contiguous.
    """

    paths: List[Tuple[int, ...]]
    num_nodes: int = field(init=False)
    depth: np.ndarray = field(init=False)        # (N,) root = 0
    parent: np.ndarray = field(init=False)       # (N,) root's parent = -1
    branch: np.ndarray = field(init=False)       # (N,) child index at parent
    ancestor_mask: np.ndarray = field(init=False)  # (N, N) bool, incl. self
    max_depth: int = field(init=False)
    # per (depth-1) level: how many distinct branch slots (top-k width the
    # proposer must produce for that level)
    level_widths: np.ndarray = field(init=False)

    def __post_init__(self):
        norm = [tuple(p) for p in self.paths]
        if () not in norm:
            norm.append(())
        norm = sorted(set(norm), key=lambda p: (len(p), p))
        for p in norm:
            if p and p[:-1] not in norm:
                raise ValueError(f"path {p} missing its parent {p[:-1]}")
        self.paths = norm
        n = len(norm)
        self.num_nodes = n
        idx = {p: i for i, p in enumerate(norm)}
        self.depth = np.array([len(p) for p in norm], np.int32)
        self.parent = np.array(
            [idx[p[:-1]] if p else -1 for p in norm], np.int32)
        self.branch = np.array([p[-1] if p else 0 for p in norm], np.int32)
        self.max_depth = int(self.depth.max())
        anc = np.zeros((n, n), bool)
        for i, p in enumerate(norm):
            anc[i, i] = True
            for d in range(len(p)):
                anc[i, idx[p[:d]]] = True
        self.ancestor_mask = anc
        widths = np.zeros((self.max_depth,), np.int32)
        for p in norm:
            if p:
                widths[len(p) - 1] = max(widths[len(p) - 1], p[-1] + 1)
        self.level_widths = widths

    @classmethod
    def from_config(cls, cfg) -> "TokenTree":
        """Accept a list of paths or a dict {"paths": [...]} (reference:
        token_tree_config JSON, models/config.py:243-274)."""
        if isinstance(cfg, dict):
            cfg = cfg.get("paths", cfg.get("tree", cfg))
        return cls(list(cfg))

    # -- verify-time helpers -------------------------------------------------

    def leaf_path_matrix(self) -> Tuple[np.ndarray, np.ndarray]:
        """(P, max_depth+1) node-index matrix of every root->node chain usable
        as an acceptance path (every node defines one), padded with -1, and
        (P,) path lengths (in nodes, incl. root)."""
        chains = []
        idx = {p: i for i, p in enumerate(self.paths)}
        for p in self.paths:
            chain = [idx[p[:d]] for d in range(len(p) + 1)]
            chains.append(chain)
        P = len(chains)
        out = np.full((P, self.max_depth + 1), -1, np.int32)
        lens = np.zeros((P,), np.int32)
        for i, c in enumerate(chains):
            out[i, :len(c)] = c
            lens[i] = len(c)
        return out, lens

    def node_positions(self, base_pos: np.ndarray) -> np.ndarray:
        """(B, N) absolute position of each node: base_pos + depth."""
        return np.asarray(base_pos)[:, None] + self.depth[None, :]

    def attention_mask(self, base_pos: np.ndarray, cache_len: int) -> np.ndarray:
        """(B, N, S) bool mask for tree verification over a contiguous cache:
        node i attends every real cache slot (< base_pos) plus the slots of
        its ancestors (written at base_pos + node index ordering).

        Node j is written at cache slot base_pos + j (node-index order), so
        ancestor visibility = ancestor_mask columns shifted by base_pos
        (reference: per-level tree masks, modules/eagle/token_tree.py)."""
        base_pos = np.asarray(base_pos)
        b = base_pos.shape[0]
        n = self.num_nodes
        kv = np.arange(cache_len, dtype=np.int64)[None, None, :]
        mask = kv < base_pos[:, None, None]                 # committed tokens
        slot = base_pos[:, None, None] + np.arange(n)[None, None, :]
        anc = np.broadcast_to(self.ancestor_mask[None], (b, n, n))
        tree_part = np.zeros((b, n, cache_len), bool)
        rows = np.arange(n)
        for i in range(b):
            cols = slot[i, 0]
            valid = cols < cache_len
            tree_part[i][:, cols[valid]] = anc[i][:, valid]
        return mask | tree_part


# the default medusa tree shipped as mc_sim_7b_63 in the reference ecosystem,
# trimmed to a small generic default
DEFAULT_TREE = [[0], [1], [2], [0, 0], [0, 1], [1, 0], [0, 0, 0]]
