"""Nested containers of tensors keyed by the reference's leaf paths.

The reference's train state is a JAX pytree of dicts and tuples; its
checkpoints name each leaf by its path, the keys (dicts) and indices
(tuples) joined with "/" (``stack/0/mixer/wq``), in the order
``jax.tree.leaves`` gives: dict keys sorted, tuple items in order.  The
port keeps such paths as dict keys, and these helpers turn nested
containers into that flat form and back.
"""
from __future__ import annotations

from typing import Any, Dict


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{path: leaf} in the reference's leaf order: dict keys sorted,
    tuple and list items in order."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix[:-1]: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}{k}/"))
    return out


def unflatten(flat: Dict[str, Any]):
    """The nested form of ``flatten``'s output: a level whose keys are
    all indices 0..n-1 becomes a tuple."""
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = root
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf

    def tuples(node):
        if not isinstance(node, dict):
            return node
        node = {k: tuples(v) for k, v in node.items()}
        if node and sorted(node) == sorted(str(i) for i in range(len(node))):
            return tuple(node[str(i)] for i in range(len(node)))
        return node

    return tuples(root)
