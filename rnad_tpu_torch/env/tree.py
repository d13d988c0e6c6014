"""The stochastic matrix-tree game as a dataclass of torch tensors.

Counterpart of ``rnad_tpu/env/tree.py``.  A game is seven aligned tensors
over states ``s``, chance actions ``t`` and row/column actions ``r, c``,
plus a depth index.  State 0 is a self-looping absorbing state standing in
for every terminal, so a fixed-length rollout needs no masking; state 1 is
the root.  ``value`` holds each child's exact Nash value (or the terminal
reward), so the tree is its own ground-truth oracle.

Two generators, each giving for a config and seed the same game as its
``rnad_tpu`` counterpart.  ``generate_tree`` is the host-side numpy
generator, drawn from one ``numpy.random.Generator`` in exactly the same
order (Dirichlet chance profiles, the three shaping-rule uniforms, the
terminal draws), its levels solved by the native batched simplex
(``env/solver.py``), so values and content hash are those of
``rnad_tpu``'s default.  ``generate_tree_native`` runs the C++ generator
(``native.py``), the one that scales to the 785,768-node trees.  Both store,
on a degenerate node, the equilibrium ``TreeConfig.equilibrium_selection``
picks; ``select_equilibria`` re-selects on a stored or loaded tree.  The
selection never enters the hash.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import List

import numpy as np
import torch

from ..config import TreeConfig
from . import solver


@dataclasses.dataclass(frozen=True)
class GameTree:
    """The seven game tensors (+ depth index) and static sizes."""

    index: torch.Tensor  # (S, T, A, A) int32, child state id, 0 = terminal
    value: torch.Tensor  # (S, T, A, A) f32, child NE value / terminal reward
    chance: torch.Tensor  # (S, T, A, A) f32, chance strategy, sums to 1 over T
    expected_value: torch.Tensor  # (S, 1, A, A) f32, sum_t chance * value
    legal: torch.Tensor  # (S, 1, A, A) f32, joint legality mask
    solution: torch.Tensor  # (S, 2A) f32, exact NE (row || col strategies)
    root_value: torch.Tensor  # (S, 1) f32, exact NE value of each node
    depth: torch.Tensor  # (S,) int32, longest distance to a terminal

    max_actions: int
    max_transitions: int
    max_depth: int  # == depth at the root
    hash: int = 0

    @property
    def size(self) -> int:
        return self.index.shape[0]

    @property
    def device(self) -> torch.device:
        return self.index.device

    def num_half_steps(self) -> int:
        """Rollout length: two half-steps per level of the tree."""
        return 2 * self.max_depth

    def to(self, device) -> "GameTree":
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device) for k in _ARRAY_FIELDS})


# ---------------------------------------------------------------------------
# Generation (host-side numpy, one batched LP solve per level)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Level:
    ids: np.ndarray  # (n,) node ids of this level
    rows: np.ndarray  # (n,) active row action counts
    cols: np.ndarray  # (n,)
    chance: np.ndarray  # (n, T, A, A)
    legal: np.ndarray  # (n, 1, A, A)
    index: np.ndarray  # (n, T, A, A) child ids (0 = terminal)
    term_value: np.ndarray  # (n, T, A, A) terminal rewards where index == 0


def _sample_chance(rng: np.random.Generator, n: int, A: int, T: int,
                   threshold: float) -> np.ndarray:
    """Dirichlet(1/T) chance profiles, thresholded and renormalized, in
    (n, A, A, T) layout; a row the threshold kills keeps its argmax."""
    if T == 1:
        return np.ones((n, A, A, 1))
    raw = rng.dirichlet((1.0 / T,) * T, size=(n, A, A))  # (n, A, A, T)
    ch = np.where(raw < threshold, 0.0, raw)
    dead = ch.sum(axis=-1) == 0.0
    if dead.any():
        mx = np.zeros_like(ch)
        np.put_along_axis(mx, raw.argmax(axis=-1, keepdims=True), 1.0, axis=-1)
        ch = np.where(dead[..., None], mx, ch)
    ch = ch / ch.sum(axis=-1, keepdims=True)
    return ch


def generate_tree(config: TreeConfig, seed: int = 0, device="cuda",
                  max_nodes: int = 1 << 24) -> GameTree:
    """Generates and exactly solves a random matrix-tree game.

    Topology is built top-down one level at a time; values are solved
    bottom-up with one batched zero-sum LP call per level.  ``max_nodes``
    bounds runaway configs (a depth rule that never decrements)."""
    A, T = config.max_actions, config.max_transitions
    if config.depth_bound < 1:
        raise ValueError("depth_bound must be >= 1")
    rng = np.random.default_rng(seed)
    terminal_values = np.asarray(config.terminal_values, dtype=np.float64)

    levels: List[_Level] = []
    frontier_rows = np.array([config.root_row_actions()], dtype=np.int64)
    frontier_cols = np.array([config.root_col_actions()], dtype=np.int64)
    frontier_depth = np.array([config.depth_bound], dtype=np.int64)
    frontier_ids = np.array([1], dtype=np.int64)
    next_id = 2

    while frontier_ids.size:
        n = frontier_ids.size
        ch = _sample_chance(rng, n, A, T, config.transition_threshold)
        r_idx = np.arange(A)
        legal2d = ((r_idx[None, :, None] < frontier_rows[:, None, None])
                   & (r_idx[None, None, :] < frontier_cols[:, None, None]))
        ch = ch * legal2d[..., None]

        # Children in (node, row, col, chance) lexicographic order.
        mask = ch > 0.0
        ci, cr, cc, ct = np.nonzero(mask)
        n_children = ci.size
        child_rows = np.clip(
            config.row_actions_rule.apply(frontier_rows[ci],
                                          rng.random(n_children)), 1, A)
        child_cols = np.clip(
            config.col_actions_rule.apply(frontier_cols[ci],
                                          rng.random(n_children)), 1, A)
        child_depth = np.maximum(
            0, config.depth_bound_rule.apply(frontier_depth[ci],
                                             rng.random(n_children)))
        internal = child_depth > 0
        n_internal = int(internal.sum())
        child_ids = np.zeros(n_children, dtype=np.int64)
        child_ids[internal] = next_id + np.arange(n_internal)
        next_id += n_internal
        if next_id > max_nodes:
            raise ValueError(
                f"tree exceeded max_nodes={max_nodes}; check the shaping "
                "rules (a non-decrementing depth rule never terminates)")

        term_draw = rng.choice(terminal_values, size=n_children)

        index = np.zeros((n, T, A, A), dtype=np.int64)
        index[ci, ct, cr, cc] = child_ids
        term_value = np.zeros((n, T, A, A), dtype=np.float64)
        term_value[ci[~internal], ct[~internal], cr[~internal],
                   cc[~internal]] = term_draw[~internal]

        levels.append(_Level(
            ids=frontier_ids, rows=frontier_rows, cols=frontier_cols,
            chance=np.moveaxis(ch, 3, 1),
            legal=legal2d[:, None].astype(np.float64),
            index=index, term_value=term_value))

        frontier_rows = child_rows[internal].astype(np.int64)
        frontier_cols = child_cols[internal].astype(np.int64)
        frontier_depth = child_depth[internal].astype(np.int64)
        frontier_ids = child_ids[internal]

    S = next_id
    node_value = np.zeros(S, dtype=np.float64)
    node_depth = np.zeros(S, dtype=np.int64)
    solution = np.zeros((S, 2 * A), dtype=np.float64)

    full_index = np.zeros((S, T, A, A), dtype=np.int64)
    full_value = np.zeros((S, T, A, A), dtype=np.float64)
    full_chance = np.zeros((S, T, A, A), dtype=np.float64)
    full_ev = np.zeros((S, 1, A, A), dtype=np.float64)
    full_legal = np.zeros((S, 1, A, A), dtype=np.float64)

    # Bottom-up: solve all nodes of each level in one batched LP call.
    for level in reversed(levels):
        is_internal = level.index > 0
        value = np.where(is_internal, node_value[level.index], level.term_value)
        ev = (level.chance * value).sum(axis=1)  # (n, A, A)
        x, y, v = solver.solve_zero_sum_batch(ev, level.rows, level.cols)
        node_value[level.ids] = v
        solution[level.ids, :A] = x
        solution[level.ids, A:] = y
        child_depth = np.where(is_internal, node_depth[level.index], 0)
        child_depth = child_depth * (level.chance > 0)
        node_depth[level.ids] = 1 + child_depth.max(axis=(1, 2, 3))

        full_index[level.ids] = level.index
        full_value[level.ids] = value
        full_chance[level.ids] = level.chance
        full_ev[level.ids, 0] = ev
        full_legal[level.ids] = level.legal

    # Absorbing state at id 0: one legal joint action self-looping with
    # certainty.
    full_chance[0, 0, 0, 0] = 1.0
    full_legal[0, 0, 0, 0] = 1.0

    if config.equilibrium_selection != "vertex":
        # re-select the stored equilibrium of degenerate nodes on the
        # float64 games; the values, and so the hash, do not change
        node_rows = full_legal[:, 0, :, 0].sum(axis=1).astype(np.int64)
        node_cols = full_legal[:, 0, 0, :].sum(axis=1).astype(np.int64)
        x, y = solver.refine_equilibrium_batch(
            full_ev[:, 0], node_rows, node_cols, solution[:, :A],
            solution[:, A:], node_value, config.equilibrium_selection)
        solution = np.concatenate([x, y], axis=1)

    tree_hash = _content_hash(config, seed, full_index, full_value)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    return GameTree(
        index=torch.as_tensor(full_index, dtype=torch.int32),
        value=f32(full_value),
        chance=f32(full_chance),
        expected_value=f32(full_ev),
        legal=f32(full_legal),
        solution=f32(solution),
        root_value=f32(node_value[:, None]),
        depth=torch.as_tensor(node_depth, dtype=torch.int32),
        max_actions=A,
        max_transitions=T,
        max_depth=int(node_depth[1]),
        hash=tree_hash,
    ).to(device)


def _content_hash(config: TreeConfig, seed: int, index: np.ndarray,
                  value: np.ndarray) -> int:
    """Identity of the GAME (config without the equilibrium selection, seed,
    child ids, f32 child values), as ``rnad_tpu`` computes it."""
    digest = hashlib.blake2b(digest_size=8)
    cfg_json = config.to_json()
    cfg_json.pop("equilibrium_selection", None)
    digest.update(json.dumps(cfg_json, sort_keys=True).encode())
    digest.update(np.int64(seed).tobytes())
    digest.update(index.tobytes())
    digest.update(value.astype(np.float32).tobytes())
    return int.from_bytes(digest.digest(), "little", signed=True)


def generate_tree_native(config: TreeConfig, seed: int = 0, device="cuda",
                         max_nodes: int = 1 << 24) -> GameTree:
    """Generates a tree with the native C++ level-synchronous generator
    (``native.py``): the game semantics and tensor conventions of
    :func:`generate_tree`, about ten times faster on large trees.  Its RNG
    stream is its own, so for a seed it makes another tree than the numpy
    path, the same tree (and hash) as ``rnad_tpu``'s native path.  A failed
    build of the generator raises."""
    from .. import native

    rules = tuple(
        (r.delta, r.stochastic_delta, r.stochastic_prob)
        for r in (config.row_actions_rule, config.col_actions_rule,
                  config.depth_bound_rule))
    arrays = native.generate_tree_arrays(
        seed, config.max_actions, config.max_transitions, config.depth_bound,
        config.root_row_actions(), config.root_col_actions(),
        config.transition_threshold, config.terminal_values, rules,
        max_nodes)
    meta = {"max_actions": config.max_actions,
            "max_transitions": config.max_transitions,
            "max_depth": int(arrays["depth"][1]),
            "hash": _content_hash(config, seed, arrays["index"],
                                  arrays["value"])}
    tree = tree_from_arrays(arrays, meta, "cpu")
    return select_equilibria(tree, config.equilibrium_selection).to(device)


def select_equilibria(tree: GameTree, mode: str,
                      tol: float = 3e-6) -> GameTree:
    """Re-selects the stored equilibrium of each degenerate node of a
    generated or loaded tree (``rnad_tpu``'s ``select_equilibria``): each
    node's ``expected_value`` matrix is the game its ``solution`` row
    solves.  The default ``tol`` suits float32 tensors (generation refines
    the float64 games with a tighter one).  Values, topology and the hash
    are unchanged."""
    if mode == "vertex":
        return tree
    A = tree.max_actions
    host = lambda t: t.detach().cpu().double().numpy()
    legal = host(tree.legal)
    sol = host(tree.solution)
    node_rows = legal[:, 0, :, 0].sum(axis=1).astype(np.int64)
    node_cols = legal[:, 0, 0, :].sum(axis=1).astype(np.int64)
    x, y = solver.refine_equilibrium_batch(
        host(tree.expected_value[:, 0]), node_rows, node_cols, sol[:, :A],
        sol[:, A:], host(tree.root_value[:, 0]), mode, tol=tol)
    solution = torch.as_tensor(np.concatenate([x, y], axis=1),
                               dtype=tree.solution.dtype,
                               device=tree.device)
    return dataclasses.replace(tree, solution=solution)


def depth_from_index(index: np.ndarray, chance: np.ndarray) -> np.ndarray:
    """Longest distance to a terminal of every node, from the index tensor
    alone (a reference ``tree.tar`` stores no depth index), in the
    generator's convention: children reached with chance 0 do not count,
    every node is at least depth 1 and the absorbing node 0 is depth 0.
    Child ids exceed parent ids, so the gather-max reaches its fixpoint in
    max_depth passes; a cyclic index never would, and raises."""
    index = np.asarray(index)
    reachable = (index > 0) & (np.asarray(chance) > 0)
    depth = np.zeros(index.shape[0], dtype=np.int64)
    for _ in range(index.shape[0] + 1):
        child = np.where(reachable, depth[index], 0)
        new = 1 + child.max(axis=(1, 2, 3))
        new[0] = 0
        if np.array_equal(new, depth):
            return depth
        depth = new
    raise ValueError("index tensor contains a cycle (not a tree)")


# ---------------------------------------------------------------------------
# Invariants
# ---------------------------------------------------------------------------


def assert_index_is_tree(tree: GameTree) -> None:
    """The index tensor describes a tree iff its nonzero entries are strictly
    increasing (child id > parent id) and one-to-one with [2, size)."""
    assert_index_array_is_tree(tree.index.cpu().numpy())


def assert_index_array_is_tree(index: np.ndarray) -> None:
    """:func:`assert_index_is_tree` on a raw (S, T, A, A) array, usable
    before a ``GameTree`` exists (on imported tensors, whose depth index
    needs acyclicity first)."""
    index = np.asarray(index)
    nonzero = np.sort(index[index != 0].ravel())
    expected = np.arange(2, 2 + nonzero.size)
    if not np.array_equal(nonzero, expected):
        raise AssertionError("index entries are not one-to-one with [2, size)")
    size = index.shape[0]
    ids = np.arange(size).reshape(size, 1, 1, 1)
    ok = (index == 0) | (index > ids)
    if not ok.all():
        raise AssertionError("index tensor contains non-increasing edges")


def validate(tree: GameTree, atol: float = 1e-5) -> None:
    """Structural self-checks: tree topology, chance sums, expected values
    and the depth index."""
    assert_index_is_tree(tree)
    chance = tree.chance.double().cpu().numpy()
    legal = tree.legal.double().cpu().numpy()
    psum = chance.sum(axis=1, keepdims=True)
    if not np.allclose(psum * legal, legal, atol=atol):
        raise AssertionError("chance does not sum to 1 over legal cells")
    ev = (chance * tree.value.double().cpu().numpy()).sum(axis=1,
                                                          keepdims=True)
    if not np.allclose(ev, tree.expected_value.cpu().numpy(), atol=atol):
        raise AssertionError("expected_value inconsistent with chance * value")
    depth = tree.depth.cpu().numpy()
    if depth[0] != 0 or (tree.size > 1 and depth[1] != tree.max_depth):
        raise AssertionError("depth index inconsistent")


# ---------------------------------------------------------------------------
# Serialization: numpy array payload + JSON metadata (utils/checkpoint.py)
# ---------------------------------------------------------------------------

_ARRAY_FIELDS = ("index", "value", "chance", "expected_value", "legal",
                 "solution", "root_value", "depth")


def tree_to_arrays(tree: GameTree) -> dict:
    return {k: getattr(tree, k).cpu().numpy() for k in _ARRAY_FIELDS}


def tree_meta(tree: GameTree) -> dict:
    return {
        "max_actions": tree.max_actions,
        "max_transitions": tree.max_transitions,
        "max_depth": tree.max_depth,
        "hash": tree.hash,
    }


def tree_from_arrays(arrays: dict, meta: dict, device="cuda") -> GameTree:
    kwargs = {k: torch.as_tensor(np.array(arrays[k])) for k in _ARRAY_FIELDS}
    kwargs["index"] = kwargs["index"].to(torch.int32)
    kwargs["depth"] = kwargs["depth"].to(torch.int32)
    return GameTree(max_actions=int(meta["max_actions"]),
                    max_transitions=int(meta["max_transitions"]),
                    max_depth=int(meta["max_depth"]),
                    hash=int(meta["hash"]), **kwargs).to(device)
