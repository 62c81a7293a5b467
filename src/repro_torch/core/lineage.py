"""The lineage graph — MGit's main data structure (paper §3, Tables 1-2).

Nodes are models; *provenance* edges track how models are derived from each
other; *versioning* edges link consecutive versions of one model. Nodes carry
optional creation functions (how to rebuild the model from its parents) and
test functions. The graph serializes its metadata to JSON at the end of every
mutating operation (mirroring the paper's CLI/Python dual interface), while
parameters live in the storage layer (``repro_torch.store``).
"""

from __future__ import annotations

import dataclasses
import fnmatch
import json
import os
import re
import warnings
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence

from repro_torch.core.artifact import ModelArtifact

# ---------------------------------------------------------------------------
# Creation functions
# ---------------------------------------------------------------------------

# Registry so creation functions serialize by name (graph metadata is JSON).
CREATION_REGISTRY: Dict[str, Callable[..., "CreationFunction"]] = {}


def register_creation_type(name: str):
    """Class decorator: make a creation-function type reconstructible by name."""

    def deco(cls):
        CREATION_REGISTRY[name] = cls
        cls.registry_name = name
        return cls

    return deco


class CreationFunction:
    """Protocol for creation functions ``cr`` (paper §3.1.2).

    ``__call__(parents) -> ModelArtifact`` builds the model from its provenance
    parents. ``initialize(parents)`` optionally builds an *empty* next version
    (used by the update cascade's first phase, Algorithm 2). ``mtl_group``
    (optional str) marks nodes that must be (re)trained together via a merged
    creation function.
    """

    registry_name: str = "base"
    mtl_group: Optional[str] = None

    def __init__(self, **config: Any) -> None:
        self.config = config

    def initialize(self, parents: Sequence["LineageNode"]) -> Optional[ModelArtifact]:
        return None

    def __call__(self, parents: Sequence["LineageNode"]) -> ModelArtifact:
        raise NotImplementedError

    def run_group(self, nodes: Sequence["LineageNode"]) -> List[ModelArtifact]:
        """Merged creation for an MTL group (paper §5): default falls back to
        per-node creation; MTL creation functions override this to share
        parameters / losses across the group."""
        return [node.creation_fn(node.get_parents()) for node in nodes]

    def to_json(self) -> Dict[str, Any]:
        return {"type": self.registry_name, "config": self.config,
                "mtl_group": self.mtl_group}

    @staticmethod
    def from_json(obj: Dict[str, Any]) -> "CreationFunction":
        cls = CREATION_REGISTRY[obj["type"]]
        cr = cls(**obj.get("config", {}))
        cr.mtl_group = obj.get("mtl_group")
        return cr


# ---------------------------------------------------------------------------
# Nodes
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LineageNode:
    name: str
    model_type: str = "generic"
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)
    creation_fn: Optional[CreationFunction] = None
    # adjacency (names, not objects — the graph owns the objects)
    parents: List[str] = dataclasses.field(default_factory=list)
    children: List[str] = dataclasses.field(default_factory=list)
    version_parents: List[str] = dataclasses.field(default_factory=list)
    version_children: List[str] = dataclasses.field(default_factory=list)
    # content: either in-memory artifact or a storage ref (manifest id)
    artifact: Optional[ModelArtifact] = dataclasses.field(default=None, repr=False)
    artifact_ref: Optional[str] = None
    _graph: Optional["LineageGraph"] = dataclasses.field(default=None, repr=False)

    def get_model(self) -> ModelArtifact:
        """Materialize the model (loading + decompressing from storage if needed)."""
        if self.artifact is not None:
            return self.artifact
        if self.artifact_ref is not None and self._graph is not None and self._graph.store:
            self.artifact = self._graph.store.load_artifact(self.artifact_ref)
            return self.artifact
        raise ValueError(f"node {self.name!r} has no artifact attached")

    def get_parents(self) -> List["LineageNode"]:
        return [self._graph.nodes[p] for p in self.parents]

    def get_children(self) -> List["LineageNode"]:
        return [self._graph.nodes[c] for c in self.children]

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "model_type": self.model_type,
            "metadata": self.metadata,
            "creation_fn": self.creation_fn.to_json() if self.creation_fn else None,
            "parents": self.parents,
            "children": self.children,
            "version_parents": self.version_parents,
            "version_children": self.version_children,
            "artifact_ref": self.artifact_ref,
        }

    @staticmethod
    def from_json(obj: Dict[str, Any]) -> "LineageNode":
        cr = obj.get("creation_fn")
        return LineageNode(
            name=obj["name"],
            model_type=obj.get("model_type", "generic"),
            metadata=obj.get("metadata", {}),
            creation_fn=CreationFunction.from_json(cr) if cr else None,
            parents=list(obj.get("parents", [])),
            children=list(obj.get("children", [])),
            version_parents=list(obj.get("version_parents", [])),
            version_children=list(obj.get("version_children", [])),
            artifact_ref=obj.get("artifact_ref"),
        )


# ---------------------------------------------------------------------------
# Test functions
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RegisteredTest:
    name: str
    fn: Callable[[ModelArtifact], float]
    node_name: Optional[str] = None    # bound to one model…
    model_type: Optional[str] = None   # …or all models of a type
    # Optional param-key prefix the test exclusively depends on. Declaring a
    # scope lets the diagnostics runner (DESIGN.md §9.3) key memoized results
    # by the scoped parameter content: versions whose scoped submodule is
    # bit-identical share one ledger entry and are never re-tested.
    scope: Optional[str] = None

    def applies_to(self, node: LineageNode) -> bool:
        if self.node_name is not None:
            return node.name == self.node_name
        if self.model_type is not None:
            return node.model_type == self.model_type
        return True


def compile_test_pattern(pattern: Optional[str], match: str = "regex"
                         ) -> Callable[[str], bool]:
    """Build a test-name predicate for ONE explicit matching mode.

    ``match`` is ``"regex"`` (``re.search``), ``"glob"`` (``fnmatch``), or
    ``"legacy"`` — the deprecated regex-OR-glob union that
    ``run_tests(re_pattern=...)`` historically applied (a glob like ``acc*``
    silently matched via fnmatch even when the regex interpretation did
    not). ``pattern=None`` matches everything."""
    if pattern is None:
        return lambda name: True
    if match == "regex":
        rx = re.compile(pattern)
        return lambda name: rx.search(name) is not None
    if match == "glob":
        return lambda name: fnmatch.fnmatch(name, pattern)
    if match == "legacy":
        rx = re.compile(pattern)
        return lambda name: (rx.search(name) is not None
                             or fnmatch.fnmatch(name, pattern))
    raise ValueError(f"unknown pattern match mode {match!r}")


# ---------------------------------------------------------------------------
# The graph
# ---------------------------------------------------------------------------


class LineageGraph:
    """Adjacency-list lineage graph with JSON metadata persistence (paper §3)."""

    def __init__(self, path: Optional[str] = None, store: Any = None,
                 autosave: bool = True) -> None:
        self.path = path
        self.store = store
        self.autosave = autosave and path is not None
        self.nodes: Dict[str, LineageNode] = {}
        self.tests: List[RegisteredTest] = []
        if path is not None and os.path.exists(self._meta_path()):
            self._load()

    # -- persistence ---------------------------------------------------------
    def _meta_path(self) -> str:
        return os.path.join(self.path, "lineage.json")

    def to_payload(self) -> Dict[str, Any]:
        """The graph's JSON document — what ``save`` persists and what the
        remote sync protocol exchanges (``repro_torch.remote``)."""
        return {"nodes": [n.to_json() for n in self.nodes.values()]}

    def save(self) -> None:
        if self.path is None:
            return
        os.makedirs(self.path, exist_ok=True)
        # Atomic AND durable: fsync before the rename, so a crash at any
        # point leaves either the complete old document or the complete new
        # one — never a torn lineage.json (a concurrent pull may read it).
        tmp = self._meta_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_payload(), f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._meta_path())

    def _load(self) -> None:
        with open(self._meta_path()) as f:
            self._install_payload(json.load(f))

    def _install_payload(self, payload: Dict[str, Any]) -> None:
        for obj in payload["nodes"]:
            node = LineageNode.from_json(obj)
            node._graph = self
            self.nodes[node.name] = node

    def replace_nodes(self, payload: Dict[str, Any]) -> None:
        """Swap in a merged document (remote sync): rebuild every node from
        JSON — cached in-memory artifacts are dropped, refs reload lazily
        from the store — and persist."""
        self.nodes = {}
        self._install_payload(payload)
        self._commit()

    def _commit(self) -> None:
        if self.autosave:
            self.save()

    # -- lower-level API (Table 2) --------------------------------------------
    def add_node(self, x: Optional[ModelArtifact], xn: str,
                 cr: Optional[CreationFunction] = None,
                 model_type: Optional[str] = None,
                 persist: bool = True, **metadata: Any) -> LineageNode:
        """Add model ``x`` as node named ``xn``; optionally register ``cr``."""
        if xn in self.nodes:
            node = self.nodes[xn]
            if x is not None:
                if node.model_type == "generic":  # placeholder from add_edge
                    node.model_type = model_type or x.model_type
                self._attach_artifact(node, x, persist=persist)
            if cr is not None:
                node.creation_fn = cr
            self._commit()
            return node
        node = LineageNode(
            name=xn,
            model_type=model_type or (x.model_type if x is not None else "generic"),
            creation_fn=cr,
            metadata=metadata,
        )
        node._graph = self
        self.nodes[xn] = node
        if x is not None:
            self._attach_artifact(node, x, persist=persist)
        self._commit()
        return node

    def _attach_artifact(self, node: LineageNode, artifact: ModelArtifact,
                         persist: bool = True) -> None:
        node.artifact = artifact
        if persist and self.store is not None:
            parent_ref = self._storage_parent_ref(node)
            node.artifact_ref = self.store.commit_artifact(
                node.name, artifact, parent_ref=parent_ref,
                tests=[t for t in self.tests if t.applies_to(node)])

    def _storage_parent_ref(self, node: LineageNode) -> Optional[str]:
        """Pick the storage delta-parent: version parent first, else provenance."""
        for pname in node.version_parents + node.parents:
            p = self.nodes.get(pname)
            if p is not None and p.artifact_ref is not None:
                return p.artifact_ref
        return None

    def _ensure(self, name: str) -> LineageNode:
        if name not in self.nodes:
            self.add_node(None, name)
        return self.nodes[name]

    def add_edge(self, x: str, y: str) -> None:
        """Provenance edge x -> y (y derived from x)."""
        xn, yn = self._ensure(x), self._ensure(y)
        if y not in xn.children:
            xn.children.append(y)
        if x not in yn.parents:
            yn.parents.append(x)
        self._maybe_recompress(yn)
        self._commit()

    def add_version_edge(self, x: str, y: str) -> None:
        """Versioning edge x -> y (y is the next version of x)."""
        xn, yn = self._ensure(x), self._ensure(y)
        if xn.model_type != yn.model_type:
            raise ValueError(
                f"version edge requires same model type: {xn.model_type} != {yn.model_type}")
        if y not in xn.version_children:
            xn.version_children.append(y)
        if x not in yn.version_parents:
            yn.version_parents.append(x)
        self._maybe_recompress(yn)
        self._commit()

    def _maybe_recompress(self, node: LineageNode) -> None:
        """A node committed full *before* its parent edge existed can now be
        delta-compressed against that parent — re-commit (API-order
        robustness: add_node(artifact) then add_edge is as valid as the
        reverse). The superseded full manifest is released and GC'd."""
        if self.store is None or node.artifact_ref is None:
            return
        try:
            manifest = self.store.get_manifest(node.artifact_ref)
        except Exception:
            return
        if manifest.get("depth", 0) > 0:
            return  # already a delta
        parent_ref = self._storage_parent_ref(node)
        if parent_ref is None or parent_ref == node.artifact_ref:
            return
        artifact = node.get_model()
        old_ref = node.artifact_ref
        node.artifact_ref = self.store.commit_artifact(
            node.name, artifact, parent_ref=parent_ref,
            tests=[t for t in self.tests if t.applies_to(node)])
        if node.artifact_ref != old_ref:
            # the cached artifact is a lazy view bound to old_ref — drop it
            # BEFORE releasing, or later accesses resolve against dead objects
            node.artifact = None
            self.store.release(old_ref)
            self.store.gc()
        else:
            # the delta was refused (no saving, or a registered test moved
            # by more than t_thr), so the re-commit stored the same full
            # manifest and took a second reference to it and its objects:
            # give that one back. The reference package keeps it, and its
            # fsck then reports refcount drift.
            self.store.release(old_ref)

    def remove_edge(self, x: str, y: str, type: str = "provenance") -> None:
        xn, yn = self.nodes[x], self.nodes[y]
        if type == "provenance":
            if y in xn.children:
                xn.children.remove(y)
            if x in yn.parents:
                yn.parents.remove(x)
        elif type == "versioning":
            if y in xn.version_children:
                xn.version_children.remove(y)
            if x in yn.version_parents:
                yn.version_parents.remove(x)
        else:
            raise ValueError(f"unknown edge type {type!r}")
        self._commit()

    def remove_node(self, x: str) -> None:
        """Remove node ``x`` and its (provenance) sub-tree."""
        if x not in self.nodes:
            return
        node = self.nodes[x]
        for child in list(node.children) + list(node.version_children):
            self.remove_node(child)
        for p in list(node.parents):
            self.remove_edge(p, x, "provenance")
        for p in list(node.version_parents):
            self.remove_edge(p, x, "versioning")
        if self.store is not None and node.artifact_ref is not None:
            self.store.release(node.artifact_ref)
        del self.nodes[x]
        self._commit()

    def register_creation_function(self, x: str, cr: CreationFunction) -> None:
        self.nodes[x].creation_fn = cr
        self._commit()

    # -- test functions (Table 2) ---------------------------------------------
    def register_test_function(self, t: Callable[[ModelArtifact], float], tn: str,
                               x: Optional[str] = None,
                               mt: Optional[str] = None,
                               scope: Optional[str] = None) -> None:
        if (x is None) == (mt is None):
            raise ValueError("exactly one of x (node) or mt (model type) must be given")
        self.tests.append(RegisteredTest(name=tn, fn=t, node_name=x,
                                         model_type=mt, scope=scope))

    def deregister_test_function(self, tn: str, x: Optional[str] = None,
                                 mt: Optional[str] = None) -> None:
        self.tests = [
            t for t in self.tests
            if not (t.name == tn and t.node_name == x and t.model_type == mt)
        ]

    def tests_for(self, node: LineageNode) -> List[RegisteredTest]:
        return [t for t in self.tests if t.applies_to(node)]

    # -- queries ---------------------------------------------------------------
    def get_next_version(self, x: str) -> Optional[LineageNode]:
        node = self.nodes[x]
        if node.version_children:
            return self.nodes[node.version_children[0]]
        return None

    def roots(self) -> List[LineageNode]:
        return [n for n in self.nodes.values() if not n.parents]

    def get_model(self, x: str) -> ModelArtifact:
        return self.nodes[x].get_model()

    # -- higher-level API (delegates; see traversal/merge/cascade modules) -----
    def traversal(self, order: str = "bfs", start: Optional[str] = None,
                  edge_types: Sequence[str] = ("provenance",),
                  skip_fn: Optional[Callable[[LineageNode], bool]] = None,
                  terminate_fn: Optional[Callable[[LineageNode], bool]] = None,
                  ) -> Iterator[LineageNode]:
        from repro_torch.core import traversal as trav
        return trav.traverse(self, order=order, start=start, edge_types=edge_types,
                             skip_fn=skip_fn, terminate_fn=terminate_fn)

    def run_tests(self, i: Iterable[LineageNode],
                  re_pattern: Optional[str] = None,
                  pattern: Optional[str] = None,
                  match: str = "regex") -> Dict[str, Dict[str, float]]:
        """Run registered tests whose name matches ``pattern`` on nodes from ``i``.

        ``pattern``/``match`` select ONE explicit matching mode (``"regex"``
        or ``"glob"``). ``re_pattern`` is a deprecated shim that keeps the
        historical regex-OR-glob union behavior; prefer the explicit form.
        This is the eager serial path — the memoized parallel runner lives in
        ``repro_torch.diag.runner`` (DESIGN.md §9.1)."""
        if re_pattern is not None:
            if pattern is not None:
                raise ValueError("pass either re_pattern (deprecated) or "
                                 "pattern=, not both")
            warnings.warn(
                "run_tests(re_pattern=...) matches as regex OR glob; pass "
                "pattern=... with match='regex' or match='glob' instead",
                DeprecationWarning, stacklevel=2)
            pattern, match = re_pattern, "legacy"
        matcher = compile_test_pattern(pattern, match)
        results: Dict[str, Dict[str, float]] = {}
        for node in i:
            node_results: Dict[str, float] = {}
            for t in self.tests_for(node):
                if not matcher(t.name):
                    continue
                node_results[t.name] = float(t.fn(node.get_model()))
            if node_results:
                results[node.name] = node_results
        return results

    def run_function(self, i: Iterable[LineageNode],
                     f: Callable[[ModelArtifact], Any]) -> Dict[str, Any]:
        return {node.name: f(node.get_model()) for node in i}

    def merge(self, x1: str, x2: str, ancestor: Optional[str] = None):
        from repro_torch.core.merge import merge as _merge
        return _merge(self, x1, x2, ancestor=ancestor)

    def run_update_cascade(self, m: str, m_prime: str,
                           skip_fn: Optional[Callable[[LineageNode], bool]] = None,
                           terminate_fn: Optional[Callable[[LineageNode], bool]] = None,
                           gate: Optional[Any] = None) -> List[str]:
        from repro_torch.core.cascade import run_update_cascade as _cascade
        return _cascade(self, m, m_prime, skip_fn=skip_fn,
                        terminate_fn=terminate_fn, gate=gate)

    # -- misc -------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.nodes)

    def __contains__(self, name: str) -> bool:
        return name in self.nodes

    def log(self) -> str:
        """git-log style textual rendering (used by the CLI)."""
        lines = []
        for root in self.roots():
            stack = [(root, 0)]
            seen = set()
            while stack:
                node, depth = stack.pop()
                if node.name in seen:
                    continue
                seen.add(node.name)
                ver = f" [v->{','.join(node.version_children)}]" if node.version_children else ""
                lines.append("  " * depth + f"* {node.name} ({node.model_type}){ver}")
                for c in reversed(node.children):
                    stack.append((self.nodes[c], depth + 1))
        return "\n".join(lines)
