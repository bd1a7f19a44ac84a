"""Radix (compressed trie) index over block-aligned token runs.

A copy of ``repro/runtime/radix.py``.  The paged KV arena shares
common-prompt-prefix KV *blocks* between rows copy-free: a block holds
``block_size`` consecutive tokens' K/V, and two prompts that agree on
their first ``n × block_size`` tokens can reference the same ``n``
physical blocks.  This index is the lookup
structure that makes the sharing findable: keys are token sequences
consumed a whole block at a time, values are one payload per block (the
engine stores physical block ids; the fleet router stores member
indices).

Structure: a compressed trie.  Each node carries a *run* of one or more
consecutive blocks (``tokens``: the run's flat token tuple, ``vals``: one
payload per block).  Matching walks block-by-block; an insert that
diverges mid-run splits the node at the block boundary where agreement
ends — block granularity means a split can never cut through a payload.

Eviction is LRU over *leaf* runs (a monotone clock stamps every node a
match or insert touches), bounded by a token budget.  The index never
frees anything itself — ``evict`` returns the payloads it dropped and the
caller (which refcounts blocks across rows AND this index) decides when a
physical block is actually reusable.  That is what makes "LRU eviction
never frees a block a live row references" hold by construction.
"""
from __future__ import annotations

from typing import Any, Sequence


class _Node:
    __slots__ = ("tokens", "vals", "children", "parent", "stamp")

    def __init__(self, tokens: tuple, vals: list, parent: "_Node | None"):
        self.tokens = tokens            # flat run, len == len(vals) * bs
        self.vals = vals                # one payload per block in the run
        self.children: dict[tuple, _Node] = {}   # first block -> child
        self.parent = parent
        self.stamp = 0

    def edge(self, bs: int) -> tuple:
        """The child-map key: this run's first block."""
        return self.tokens[:bs]


class RadixIndex:
    """Block-aligned radix index: token runs -> one payload per block."""

    def __init__(self, block_size: int, budget_tokens: int = 1 << 16):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.bs = int(block_size)
        self.budget = int(budget_tokens)
        self.root = _Node((), [], None)
        self.tokens = 0                 # total tokens resident in the index
        self._clock = 0

    # ------------------------------------------------------------ helpers --
    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.stamp = self._clock

    def _blocks(self, tokens: Sequence[int]) -> list[tuple]:
        bs = self.bs
        n = len(tokens) // bs
        t = tuple(int(x) for x in tokens[:n * bs])
        return [t[i * bs:(i + 1) * bs] for i in range(n)]

    def _split(self, node: _Node, at_block: int) -> None:
        """Split ``node`` so its run keeps blocks [0, at_block) and a new
        child inherits blocks [at_block, ...) plus the old children."""
        bs = self.bs
        tail = _Node(node.tokens[at_block * bs:], node.vals[at_block:], node)
        tail.children = node.children
        for ch in tail.children.values():
            ch.parent = tail
        tail.stamp = node.stamp
        node.tokens = node.tokens[:at_block * bs]
        node.vals = node.vals[:at_block]
        node.children = {tail.edge(bs): tail}

    # ------------------------------------------------------------- lookup --
    def match(self, tokens: Sequence[int]) -> tuple[int, list[Any]]:
        """Longest block-aligned prefix of ``tokens`` resident in the index.

        Returns ``(matched_token_count, payloads)`` — one payload per
        matched block, in order.  Touches every node on the matched path
        (LRU renewal)."""
        blocks = self._blocks(tokens)
        node, i, payloads = self.root, 0, []
        while i < len(blocks):
            child = node.children.get(blocks[i])
            if child is None:
                break
            nb = len(child.vals)
            j = 0
            while j < nb and i + j < len(blocks) \
                    and child.tokens[j * self.bs:(j + 1) * self.bs] \
                    == blocks[i + j]:
                j += 1
            if j == 0:
                break
            payloads.extend(child.vals[:j])
            self._touch(child)
            i += j
            if j < nb:
                break                   # diverged (or ran out) mid-run
            node = child
        return i * self.bs, payloads

    # ------------------------------------------------------------- insert --
    def insert(self, tokens: Sequence[int], payloads: Sequence[Any],
               overwrite: bool = False) -> list[Any]:
        """Insert the full blocks of ``tokens`` with per-block payloads.

        Returns the payloads *newly stored* (blocks already present are
        left alone unless ``overwrite``, which replaces their payloads in
        place without counting them as new — the router's reassignment
        path; the engine never overwrites because equal tokens mean equal
        block content)."""
        blocks = self._blocks(tokens)
        if len(payloads) < len(blocks):
            raise ValueError(
                f"insert needs one payload per block: {len(blocks)} blocks, "
                f"{len(payloads)} payloads")
        node, i = self.root, 0
        while i < len(blocks):
            child = node.children.get(blocks[i])
            if child is None:
                run = tuple(t for b in blocks[i:] for t in b)
                vals = list(payloads[i:len(blocks)])
                leaf = _Node(run, vals, node)
                node.children[leaf.edge(self.bs)] = leaf
                self._touch(leaf)
                self.tokens += len(run)
                return vals
            nb = len(child.vals)
            j = 0
            while j < nb and i + j < len(blocks) \
                    and child.tokens[j * self.bs:(j + 1) * self.bs] \
                    == blocks[i + j]:
                if overwrite:
                    child.vals[j] = payloads[i + j]
                j += 1
            self._touch(child)
            if j < nb:
                if i + j == len(blocks):
                    return []           # fully contained in this run
                self._split(child, j)   # diverge mid-run: split at boundary
            i += j
            node = child
        return []

    # ------------------------------------------------------------ evict ----
    def _leaves(self) -> list[_Node]:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            if n is not self.root and not n.children:
                out.append(n)
            stack.extend(n.children.values())
        return out

    def _drop(self, node: _Node) -> list[Any]:
        parent = node.parent
        del parent.children[node.edge(self.bs)]
        self.tokens -= len(node.tokens)
        return list(node.vals)

    def evict(self, budget: int | None = None) -> list[Any]:
        """Drop least-recently-touched leaf runs until the resident token
        count fits ``budget`` (default: the constructor's).  Returns every
        payload dropped — the caller owns what to do with them
        (refcount decrement, then free only at zero)."""
        budget = self.budget if budget is None else int(budget)
        dropped: list[Any] = []
        while self.tokens > budget:
            leaves = self._leaves()
            if not leaves:
                break
            victim = min(leaves, key=lambda n: n.stamp)
            dropped.extend(self._drop(victim))
        return dropped

    def evict_blocks(self, n_blocks: int) -> list[Any]:
        """Drop LRU leaves until at least ``n_blocks`` payloads came out
        (or the index is empty) — the allocation-pressure path."""
        dropped: list[Any] = []
        while len(dropped) < n_blocks:
            leaves = self._leaves()
            if not leaves:
                break
            victim = min(leaves, key=lambda n: n.stamp)
            dropped.extend(self._drop(victim))
        return dropped

    # ------------------------------------------------------------- stats ---
    @property
    def n_nodes(self) -> int:
        n, stack = 0, [self.root]
        while stack:
            node = stack.pop()
            n += len(node.children)
            stack.extend(node.children.values())
        return n

    def stats(self) -> dict:
        return {"tokens": self.tokens, "nodes": self.n_nodes,
                "budget": self.budget}
