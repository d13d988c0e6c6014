"""Tree store: ``saved_trees/<name>/`` plus a ``recent/`` mirror.

Counterpart of the tree half of ``rnad_tpu/utils/checkpoint.py``
(``save_tree``/``load_tree``).  The on-disk form is the same ``tree.npz``
array payload and ``meta.json`` metadata, so a tree saved by ``rnad_tpu``
loads here unchanged and the other way round.  The run store (checkpoints,
resume) is not ported yet.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np

from ..env import tree as tree_lib


def _default_root(sub: str) -> str:
    return os.path.join(os.getcwd(), sub)


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
