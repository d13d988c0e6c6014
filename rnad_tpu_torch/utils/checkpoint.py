"""Tree and run persistence.

Counterpart of ``rnad_tpu/utils/checkpoint.py``, with its two stores:

* Trees: ``saved_trees/<name>/`` plus a ``recent/`` mirror, each a
  ``tree.npz`` array payload and a ``meta.json`` holding the identity hash.
  The form is ``rnad_tpu``'s, so a tree saved by either package loads in
  the other.  ``load_reference_tree`` imports the reference's ``tree.tar``.
* Runs: ``saved_runs/<name>/params.json`` (the config snapshot), one
  checkpoint per ``(m, n)`` under ``saved_runs/<name>/<m>/<n>.ckpt`` and the
  best-evaluated checkpoint ``best.ckpt`` (with a ``best.json`` mirror).
  Resume takes the largest saved ``(m, n)``.

A checkpoint's payload is ``torch.save`` bytes of what makes a resumed run
bit-exact: the four nets' state dicts, Adam's moments and count, the step
counter and the rollout generator's state.  Every file is written to a
temporary name and renamed into place.
"""

from __future__ import annotations

import io
import json
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..env import tree as tree_lib

# best.ckpt container format marker (see RunStore.save_best).
_BEST_MAGIC = b"RNADBEST1\n"
# the four nets of a TrainState
NETS = ("net", "net_target", "net_reg", "net_reg_")


def _default_root(sub: str) -> str:
    return os.path.join(os.getcwd(), sub)


# ---------------------------------------------------------------------------
# Tree store
# ---------------------------------------------------------------------------


def save_tree(tree: tree_lib.GameTree, name: Optional[str] = None,
              root: Optional[str] = None, desc: str = "",
              config_json: Optional[dict] = None) -> str:
    root = root or _default_root("saved_trees")
    os.makedirs(root, exist_ok=True)
    if name is None:
        name = str(int(time.time()))
    meta = tree_lib.tree_meta(tree)
    meta["desc"] = desc
    if config_json is not None:
        meta["config"] = config_json
    arrays = tree_lib.tree_to_arrays(tree)
    for target in (name, "recent"):
        path = os.path.join(root, target)
        os.makedirs(path, exist_ok=True)
        np.savez_compressed(os.path.join(path, "tree.npz"), **arrays)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2)
    return os.path.join(root, name)


def load_tree(name: str = "recent", root: Optional[str] = None,
              device="cuda") -> tree_lib.GameTree:
    root = root or _default_root("saved_trees")
    path = os.path.join(root, name)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "tree.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    return tree_lib.tree_from_arrays(arrays, meta, device)


def load_reference_tree(path: str, device="cuda") -> tree_lib.GameTree:
    """Imports a tree saved by the reference implementation: ``torch.save``
    of its ``saved_keys`` dict as ``saved_trees/<name>/tree.tar`` (the seven
    game tensors, max_actions, max_transitions and the identity hash).  The
    layouts are the port's, so the import is a dtype cast and the depth
    index, which the reference does not store, recomputed after the index is
    checked to be a tree.  ``path`` is the ``tree.tar`` or its directory."""
    if os.path.isdir(path):
        path = os.path.join(path, "tree.tar")
    saved = torch.load(path, map_location="cpu", weights_only=False)

    def arr(key, dtype):
        return np.asarray(saved[key].detach().cpu().numpy(), dtype=dtype)

    index = arr("index_tensor", np.int32)
    chance = arr("chance_tensor", np.float32)
    tree_lib.assert_index_array_is_tree(index)
    depth = tree_lib.depth_from_index(index, chance)
    arrays = dict(index=index, value=arr("value_tensor", np.float32),
                  chance=chance,
                  expected_value=arr("expected_value_tensor", np.float32),
                  legal=arr("legal_tensor", np.float32),
                  solution=arr("solution_tensor", np.float32),
                  root_value=arr("root_value_tensor", np.float32),
                  depth=depth.astype(np.int32))
    meta = {"max_actions": int(saved["max_actions"]),
            "max_transitions": int(saved["max_transitions"]),
            "max_depth": int(depth[1]), "hash": int(saved["hash"])}
    return tree_lib.tree_from_arrays(arrays, meta, device)


# ---------------------------------------------------------------------------
# Run store
# ---------------------------------------------------------------------------


def state_bytes(state) -> bytes:
    """``torch.save`` bytes of a ``learn/rnad.py::TrainState``."""
    payload = {name: getattr(state, name).state_dict() for name in NETS}
    payload.update(mu=list(state.opt.mu), nu=list(state.opt.nu),
                   count=int(state.opt.count),
                   total_steps=int(state.total_steps),
                   generator=state.generator.get_state())
    buf = io.BytesIO()
    torch.save(payload, buf)
    return buf.getvalue()


@torch.no_grad()
def load_state_bytes(template, data: bytes):
    """Restores ``state_bytes`` into the ``TrainState`` ``template`` in
    place, on the template's devices, and returns it."""
    payload = torch.load(io.BytesIO(data), map_location="cpu",
                         weights_only=True)
    for name in NETS:
        getattr(template, name).load_state_dict(payload[name])
    for dst, src in zip(template.opt.mu + template.opt.nu,
                        payload["mu"] + payload["nu"]):
        dst.copy_(src)
    template.opt.count = int(payload["count"])
    template.total_steps = int(payload["total_steps"])
    template.generator.set_state(payload["generator"])
    return template


def _write_atomic(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


class RunStore:
    """Directory-backed store of one training run's config and checkpoints."""

    def __init__(self, name: str, root: Optional[str] = None):
        self.root = root or _default_root("saved_runs")
        self.name = name
        self.directory = os.path.join(self.root, name)

    def exists(self) -> bool:
        return os.path.exists(os.path.join(self.directory, "params.json"))

    def save_params(self, params: dict) -> None:
        os.makedirs(self.directory, exist_ok=True)
        _write_atomic(os.path.join(self.directory, "params.json"),
                      json.dumps(params, indent=2, sort_keys=True).encode())

    def load_params(self) -> dict:
        with open(os.path.join(self.directory, "params.json")) as f:
            return json.load(f)

    def checkpoint_path(self, m: int, n: int) -> str:
        return os.path.join(self.directory, str(m), f"{n}.ckpt")

    def save_checkpoint(self, m: int, n: int, state) -> str:
        path = self.checkpoint_path(m, n)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _write_atomic(path, state_bytes(state))
        return path

    def load_checkpoint(self, m: int, n: int, template):
        """Restores checkpoint (m, n) into ``template`` (a fresh
        ``TrainState`` of the run's nets, on its device)."""
        with open(self.checkpoint_path(m, n), "rb") as f:
            return load_state_bytes(template, f.read())

    def save_best(self, state, meta: dict) -> str:
        """Atomic write of the best-evaluated checkpoint and its meta.

        ``RNaD.run`` calls this whenever a whole-tree eval improves on the
        best seen, so the served policy is the curve's minimum.  It is apart
        from the (m, n) resume chain: ``latest()`` never returns it.  The
        meta rides inside best.ckpt (magic header, 8-byte length, JSON, then
        the state), so one ``os.replace`` publishes the pair; best.json is a
        human-readable mirror that ``load_best`` never reads."""
        path = os.path.join(self.directory, "best.ckpt")
        os.makedirs(self.directory, exist_ok=True)
        meta_b = json.dumps(meta, sort_keys=True).encode()
        _write_atomic(path, _BEST_MAGIC + len(meta_b).to_bytes(8, "little")
                      + meta_b + state_bytes(state))
        _write_atomic(os.path.join(self.directory, "best.json"),
                      json.dumps(meta, indent=2, sort_keys=True).encode())
        return path

    def _read_best(self, whole: bool) -> Optional[Tuple[dict, bytes]]:
        path = os.path.join(self.directory, "best.ckpt")
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            head = f.read(len(_BEST_MAGIC) + 8)
            if not head.startswith(_BEST_MAGIC):
                raise ValueError(f"{path} is not a best checkpoint")
            n = int.from_bytes(head[len(_BEST_MAGIC):], "little")
            meta = json.loads(f.read(n))
            return meta, (f.read() if whole else b"")

    def load_best_meta(self) -> Optional[dict]:
        """The meta dict of the stored best checkpoint, or None; read from
        best.ckpt's embedded header."""
        found = self._read_best(whole=False)
        return found[0] if found else None

    def load_best(self, template):
        """(state, meta) of the best-evaluated checkpoint, restored into
        ``template``, or None."""
        found = self._read_best(whole=True)
        if found is None:
            return None
        meta, data = found
        return load_state_bytes(template, data), meta

    def latest(self) -> Optional[Tuple[int, int]]:
        """Max (m, n) with a saved checkpoint.  An m-directory left empty by
        an interrupted save is skipped in favor of the newest complete one,
        so a crash mid-checkpoint never silently restarts the run."""
        if not os.path.isdir(self.directory):
            return None
        ms = sorted((int(d) for d in os.listdir(self.directory)
                     if d.isdigit()
                     and os.path.isdir(os.path.join(self.directory, d))),
                    reverse=True)
        for m in ms:
            ns = [int(f[:-5])
                  for f in os.listdir(os.path.join(self.directory, str(m)))
                  if f.endswith(".ckpt")]
            if ns:
                return m, max(ns)
        return None
