"""LayerGraph IR — the DAG representation of a model that MGit's ``diff`` operates on.

The paper uses torch.fx DAGs (Reed et al., 2022); this package keeps the plain
LayerGraph of the reference package instead, so models *emit* a LayerGraph
alongside their flat parameter dict:
nodes are layers (op type + parameter metadata), edges are dataflow. ``diff``
(Algorithm 3) runs hash-table graph matching over two LayerGraphs.

The IR is deliberately framework-agnostic metadata: shapes/dtypes/content-hashes,
never live arrays, so it serializes to JSON and scales to thousands of layers.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple


def _stable_hash(*parts: Any) -> str:
    """Deterministic hash of JSON-serializable parts (order-sensitive)."""
    payload = json.dumps(parts, sort_keys=True, default=str).encode()
    return hashlib.sha256(payload).hexdigest()[:16]


@dataclasses.dataclass
class LayerNode:
    """One layer (op) in the model DAG.

    Attributes:
      name: unique name within the graph (e.g. ``"block3/attn/wq"``).
      op_type: layer kind (e.g. ``"linear"``, ``"rmsnorm"``, ``"ssd"``).
      params: mapping param-name -> (shape tuple, dtype str). Metadata only.
      param_hashes: optional mapping param-name -> content hash (filled in when the
        artifact's parameters are known; used for *contextual* diff).
      attrs: static attributes that change structure (e.g. n_heads, window).
    """

    name: str
    op_type: str
    params: Dict[str, Tuple[Tuple[int, ...], str]] = dataclasses.field(default_factory=dict)
    param_hashes: Dict[str, str] = dataclasses.field(default_factory=dict)
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def structural_hash(self) -> str:
        """Hash of everything *except* parameter values."""
        return _stable_hash(self.op_type, sorted(self.params.items()), sorted(self.attrs.items()))

    def contextual_hash(self) -> str:
        """Hash including parameter content (falls back to structural if unknown)."""
        if not self.param_hashes:
            return self.structural_hash()
        return _stable_hash(self.structural_hash(), sorted(self.param_hashes.items()))

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "op_type": self.op_type,
            "params": {k: [list(s), d] for k, (s, d) in self.params.items()},
            "param_hashes": dict(self.param_hashes),
            "attrs": dict(self.attrs),
        }

    @staticmethod
    def from_json(obj: Mapping[str, Any]) -> "LayerNode":
        return LayerNode(
            name=obj["name"],
            op_type=obj["op_type"],
            params={k: (tuple(v[0]), v[1]) for k, v in obj["params"].items()},
            param_hashes=dict(obj.get("param_hashes", {})),
            attrs=dict(obj.get("attrs", {})),
        )


class LayerGraph:
    """A DAG of :class:`LayerNode` with dataflow edges.

    Insertion order of nodes is preserved and used as a topological-order
    tiebreak (model builders emit layers in execution order).
    """

    def __init__(self) -> None:
        self.nodes: Dict[str, LayerNode] = {}
        self.edges: List[Tuple[str, str]] = []
        self._succ: Dict[str, List[str]] = {}
        self._pred: Dict[str, List[str]] = {}

    # -- construction ------------------------------------------------------
    def add_node(self, node: LayerNode) -> LayerNode:
        if node.name in self.nodes:
            raise ValueError(f"duplicate layer name {node.name!r}")
        self.nodes[node.name] = node
        self._succ.setdefault(node.name, [])
        self._pred.setdefault(node.name, [])
        return node

    def add_edge(self, src: str, dst: str) -> None:
        if src not in self.nodes or dst not in self.nodes:
            raise KeyError(f"edge endpoints must exist: {src!r} -> {dst!r}")
        self.edges.append((src, dst))
        self._succ[src].append(dst)
        self._pred[dst].append(src)

    # -- queries -----------------------------------------------------------
    def successors(self, name: str) -> Sequence[str]:
        return self._succ.get(name, [])

    def predecessors(self, name: str) -> Sequence[str]:
        return self._pred.get(name, [])

    def topo_order(self) -> List[str]:
        """Kahn topological order; insertion order breaks ties."""
        indeg = {n: len(self._pred[n]) for n in self.nodes}
        order: List[str] = []
        ready = [n for n in self.nodes if indeg[n] == 0]  # insertion-ordered
        while ready:
            n = ready.pop(0)
            order.append(n)
            for m in self._succ[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    ready.append(m)
        if len(order) != len(self.nodes):
            raise ValueError("LayerGraph has a cycle")
        return order

    def reachable_from(self, starts: Iterable[str]) -> set:
        """All nodes reachable (downstream) from ``starts`` via DFS."""
        seen: set = set()
        stack = list(starts)
        while stack:
            n = stack.pop()
            for m in self._succ.get(n, []):
                if m not in seen:
                    seen.add(m)
                    stack.append(m)
        return seen

    def set_param_hashes(self, hashes: Mapping[str, Mapping[str, str]]) -> None:
        """Attach content hashes: {layer_name: {param_name: hash}}."""
        for lname, phashes in hashes.items():
            if lname in self.nodes:
                self.nodes[lname].param_hashes.update(phashes)

    def param_names(self) -> List[Tuple[str, str]]:
        """All (layer_name, param_name) pairs in topological order."""
        out = []
        for lname in self.topo_order():
            for pname in self.nodes[lname].params:
                out.append((lname, pname))
        return out

    # -- serialization -----------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        return {
            "nodes": [self.nodes[n].to_json() for n in self.nodes],
            "edges": [list(e) for e in self.edges],
        }

    @staticmethod
    def from_json(obj: Mapping[str, Any]) -> "LayerGraph":
        g = LayerGraph()
        for n in obj["nodes"]:
            g.add_node(LayerNode.from_json(n))
        for src, dst in obj["edges"]:
            g.add_edge(src, dst)
        return g

    # -- convenience builders ----------------------------------------------
    @staticmethod
    def chain(layers: Sequence[LayerNode]) -> "LayerGraph":
        """Linear chain graph (common case: sequential model)."""
        g = LayerGraph()
        prev: Optional[str] = None
        for node in layers:
            g.add_node(node)
            if prev is not None:
                g.add_edge(prev, node.name)
            prev = node.name
        return g

    def __len__(self) -> int:
        return len(self.nodes)

    def __repr__(self) -> str:
        return f"LayerGraph(nodes={len(self.nodes)}, edges={len(self.edges)})"
